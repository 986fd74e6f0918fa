# SPDX-License-Identifier: Apache-2.0
"""asyncio UDP endpoints for QUIC: server (DCID-demuxed) and client.

Parity note: plays the role of quinn's Endpoint in the reference
(``apps/skit/src/server.rs:1975-2085`` binds the WebTransport acceptor).
"""

from __future__ import annotations

import asyncio
import os
from typing import Awaitable, Callable, Dict, List, Optional, Tuple

from .connection import CloseEvent, HandshakeEvent, QuicConnection
from .packet import PacketType, peek_header
from .tls import TlsSession, TransportParams

__all__ = ["QuicProtocol", "QuicServer", "QuicClient", "serve", "connect"]

TIMER_TICK = 0.05
SOCK_BUF = 4 * 1024 * 1024


def _tune_socket(transport) -> None:
    import socket

    sock = transport.get_extra_info("socket")
    if sock is not None:
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, SOCK_BUF)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, SOCK_BUF)
        except OSError:
            pass


class QuicProtocol:
    """One connection + its transmit/timer plumbing and event queue."""

    # Give up on connections with no inbound datagrams for this long — reaps
    # half-open peers (e.g. a garbage Initial that never completes the
    # handshake) so server CID-table entries don't leak forever.
    IDLE_TIMEOUT = 60.0

    def __init__(self, conn: QuicConnection, sendto: Callable[[bytes], None]) -> None:
        self.conn = conn
        self._sendto = sendto
        self.events: asyncio.Queue = asyncio.Queue()
        self.handshake_done = asyncio.get_event_loop().create_future()
        self._timer_task: Optional[asyncio.Task] = None
        self.closed = asyncio.Event()
        self._last_rx = conn._now()

    def start(self) -> None:
        if self._timer_task is None:
            self._timer_task = asyncio.ensure_future(self._timer_loop())
        self.transmit()

    def feed(self, datagram: bytes) -> None:
        self._last_rx = self.conn._now()
        self.conn.receive_datagram(datagram)
        self._drain_events()
        self.transmit()

    def _drain_events(self) -> None:
        for ev in self.conn.events:
            if isinstance(ev, HandshakeEvent) and not self.handshake_done.done():
                self.handshake_done.set_result(ev.alpn)
            elif isinstance(ev, CloseEvent):
                if not self.handshake_done.done():
                    self.handshake_done.set_exception(
                        ConnectionError(f"closed during handshake: {ev.reason}")
                    )
                self.closed.set()
            self.events.put_nowait(ev)
        self.conn.events = []

    def transmit(self) -> None:
        for d in self.conn.datagrams_to_send():
            self._sendto(d)

    async def _timer_loop(self) -> None:
        while not self.conn.closed:
            await asyncio.sleep(TIMER_TICK)
            if self.conn._now() - self._last_rx > self.IDLE_TIMEOUT:
                self.conn.close(0, "idle timeout")
            self.conn.handle_timer()
            self._drain_events()
            self.transmit()
        self.closed.set()

    def close(self, error_code: int = 0, reason: str = "") -> None:
        self.conn.close(error_code, reason)
        self.transmit()
        if self._timer_task is not None:
            self._timer_task.cancel()
            self._timer_task = None
        self.closed.set()


class QuicServer(asyncio.DatagramProtocol):
    """UDP server endpoint: demux datagrams to connections by DCID."""

    def __init__(
        self,
        cert_der: bytes,
        private_key,
        on_connection: Callable[[QuicProtocol], Awaitable[None]],
        alpn: str = "h3",
    ) -> None:
        self.cert_der = cert_der
        self.private_key = private_key
        self.on_connection = on_connection
        self.alpn = alpn
        self.transport: Optional[asyncio.DatagramTransport] = None
        self._by_cid: Dict[bytes, QuicProtocol] = {}
        self._tasks: List[asyncio.Task] = []

    def connection_made(self, transport) -> None:
        self.transport = transport
        _tune_socket(transport)

    def datagram_received(self, data: bytes, addr) -> None:
        try:
            hdr = peek_header(data, 0, 8)
        except (IndexError, ValueError):
            return
        dcid = hdr["dcid"]
        proto = self._by_cid.get(dcid)
        if proto is None and hdr["type"] == PacketType.INITIAL:
            proto = self._accept(dcid, addr)
        if proto is not None:
            proto.feed(data)

    def _accept(self, original_dcid: bytes, addr) -> QuicProtocol:
        scid = os.urandom(8)
        tls = TlsSession(
            True,
            TransportParams(initial_scid=scid, original_dcid=original_dcid),
            alpn=self.alpn,
            cert_der=self.cert_der,
            private_key=self.private_key,
        )
        conn = QuicConnection(True, tls, original_dcid, scid=scid)
        proto = QuicProtocol(conn, lambda d: self.transport.sendto(d, addr))
        # route by both the client-chosen original DCID and our SCID
        self._by_cid[original_dcid] = proto
        self._by_cid[scid] = proto
        proto.start()
        self._tasks.append(asyncio.ensure_future(self.on_connection(proto)))
        self._tasks.append(
            asyncio.ensure_future(self._reap_on_close(proto, (original_dcid, scid)))
        )
        return proto

    async def _reap_on_close(self, proto: QuicProtocol, cids: Tuple[bytes, ...]) -> None:
        """Remove the CID routes once the connection closes (CloseEvent or
        idle timeout) so _by_cid doesn't accumulate dead entries."""
        await proto.closed.wait()
        for cid in cids:
            if self._by_cid.get(cid) is proto:
                del self._by_cid[cid]

    def close(self) -> None:
        for proto in set(self._by_cid.values()):
            proto.close()
        for t in self._tasks:
            t.cancel()
        if self.transport is not None:
            self.transport.close()


class QuicClient(asyncio.DatagramProtocol):
    """UDP client endpoint owning a single connection."""

    def __init__(
        self, pinned_fingerprints: Optional[List[bytes]], alpn: str = "h3", server_name: str = "localhost"
    ) -> None:
        self.pinned = pinned_fingerprints
        self.alpn = alpn
        self.server_name = server_name
        self.transport: Optional[asyncio.DatagramTransport] = None
        self.protocol: Optional[QuicProtocol] = None

    def connection_made(self, transport) -> None:
        self.transport = transport
        _tune_socket(transport)
        original_dcid = os.urandom(8)
        scid = os.urandom(8)
        tls = TlsSession(
            False,
            TransportParams(initial_scid=scid),
            alpn=self.alpn,
            pinned_fingerprints=self.pinned,
            server_name=self.server_name,
        )
        conn = QuicConnection(False, tls, original_dcid, scid=scid)
        self.protocol = QuicProtocol(conn, lambda d: self.transport.sendto(d))
        self.protocol.start()

    def datagram_received(self, data: bytes, addr) -> None:
        if self.protocol is not None:
            self.protocol.feed(data)

    def close(self) -> None:
        if self.protocol is not None:
            self.protocol.close()
        if self.transport is not None:
            self.transport.close()


async def serve(
    host: str,
    port: int,
    cert_der: bytes,
    private_key,
    on_connection: Callable[[QuicProtocol], Awaitable[None]],
    alpn: str = "h3",
) -> Tuple[QuicServer, asyncio.DatagramTransport]:
    loop = asyncio.get_running_loop()
    transport, server = await loop.create_datagram_endpoint(
        lambda: QuicServer(cert_der, private_key, on_connection, alpn), local_addr=(host, port)
    )
    return server, transport


async def connect(
    host: str,
    port: int,
    pinned_fingerprints: Optional[List[bytes]] = None,
    alpn: str = "h3",
    server_name: str = "localhost",
    timeout: float = 10.0,
) -> Tuple[QuicClient, QuicProtocol]:
    loop = asyncio.get_running_loop()
    transport, client = await loop.create_datagram_endpoint(
        lambda: QuicClient(pinned_fingerprints, alpn, server_name), remote_addr=(host, port)
    )
    proto = client.protocol
    assert proto is not None
    await asyncio.wait_for(proto.handshake_done, timeout)
    return client, proto
