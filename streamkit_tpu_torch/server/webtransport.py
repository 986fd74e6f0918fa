# SPDX-License-Identifier: Apache-2.0
"""WebTransport MoQ acceptor: UDP/QUIC server binding the MoQ relay +
gateway, plus the certificate-fingerprint HTTP endpoints.

Parity targets:
* ``apps/skit/src/server.rs:1975-2085`` — WebTransport endpoint setup with
  auto-generated certificate
* ``apps/skit/src/server.rs:593-630`` — ``/api/v1/moq/fingerprints`` (JSON)
  and ``/certificate.sha256`` (plain text, consumed by MoQ web players for
  ``serverCertificateHashes``)
* ``apps/skit/src/moq_gateway.rs:40-140`` — fingerprint registry + route
  resolution

Every accepted WebTransport session speaks the MoQ session protocol
(:mod:`..moq.session`, which hands a moq-lite session to
:mod:`..moq.lite_session`); PUBLISH/SUBSCRIBE names resolve to gateway
routes (moq-peer nodes) or relay broadcasts.

Port of ``streamkit_tpu/server/webtransport.py``: the two HTTP routes go on
the port's own router (:mod:`.http`) under the server's base path, and they
answer 404 once the acceptor is gone (its UDP bind failed), so no client
pins the certificate of an acceptor that is not listening.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
from typing import List, Optional

from ..core.moq_gateway import MoqGateway
from ..moq.relay import MoqRelay
from ..moq.session import serve_moq_session
from ..quic.endpoint import QuicProtocol, serve as quic_serve
from ..quic.h3 import H3Connection, SessionRequest
from ..quic.tls import generate_self_signed
from . import http as web

log = logging.getLogger("skit.webtransport")

__all__ = ["WebTransportServer", "add_fingerprint_routes"]


class WebTransportServer:
    """UDP acceptor serving MoQ-over-WebTransport. Raises
    :class:`..quic._libcrypto.LibcryptoUnavailable` where OpenSSL's libcrypto
    does not load (the certificate is made here)."""

    def __init__(
        self,
        relay: MoqRelay,
        gateway: Optional[MoqGateway],
        host: str = "0.0.0.0",
        port: int = 4443,
    ) -> None:
        self.relay = relay
        self.gateway = gateway
        self.host = host
        self.port = port
        self.cert_der, self.private_key = generate_self_signed("streamkit-tpu-moq")
        self.fingerprint = hashlib.sha256(self.cert_der).hexdigest()
        self._server = None
        self._transport = None
        self._tasks: List[asyncio.Task] = []

    @property
    def fingerprints(self) -> List[str]:
        return [self.fingerprint]

    async def start(self) -> int:
        """Bind and serve; ``port`` 0 binds an ephemeral port. → the bound port."""
        self._server, self._transport = await quic_serve(
            self.host, self.port, self.cert_der, self.private_key, self._on_connection
        )
        actual = self._transport.get_extra_info("sockname")[1]
        self.port = actual
        log.info("WebTransport MoQ acceptor on udp/%d (fp %s…)", actual, self.fingerprint[:16])
        return actual

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        if self._server is not None:
            self._server.close()

    async def _on_connection(self, proto: QuicProtocol) -> None:
        try:
            await proto.handshake_done
        except ConnectionError:
            return
        h3 = H3Connection(proto, True)
        h3.start()
        # first event must be the session CONNECT; accept any /moq* path
        while True:
            ev = await h3.events.get()
            if isinstance(ev, SessionRequest):
                if ev.path.startswith("/moq") or ev.path == "/":
                    h3.accept_session(ev.session_id)
                    self._tasks.append(
                        asyncio.ensure_future(
                            serve_moq_session(h3, ev.session_id, self.relay, self.gateway)
                        )
                    )
                    return  # serve_moq_session consumes the event queue now
                h3.accept_session(ev.session_id, status=404)


def add_fingerprint_routes(app: web.Application, prefix: str = "") -> None:
    """``GET /api/v1/moq/fingerprints`` → ``{"fingerprints", "port"}`` and
    ``GET /certificate.sha256`` → the hex fingerprint, read from
    ``app["state"].webtransport`` at request time."""

    def acceptor():
        wt = app["state"].webtransport
        if wt is None:
            raise web.HTTPNotFound(text="WebTransport acceptor is not running")
        return wt

    async def fingerprints(_req: web.Request) -> web.Response:
        wt = acceptor()
        # port included so browser clients can dial the UDP acceptor
        return web.json_response({"fingerprints": wt.fingerprints, "port": wt.port})

    async def cert_sha256(_req: web.Request) -> web.Response:
        return web.Response(text=acceptor().fingerprint, content_type="text/plain")

    app.router.add_get(f"{prefix}/api/v1/moq/fingerprints", fingerprints)
    app.router.add_get(f"{prefix}/certificate.sha256", cert_sha256)
