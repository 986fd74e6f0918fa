# SPDX-License-Identifier: Apache-2.0
"""Media-over-X gateway: decouples transport serving from media nodes.

Parity with reference ``crates/core/src/moq_gateway.rs:14-68``:

* nodes call :meth:`MoqGateway.register_route(path)` and receive a channel
  of incoming :class:`MoqConnection` handles,
* the server-side acceptor (WebSocket today; a QUIC/WebTransport C++ shim
  can bind the same interface later) resolves paths and hands connections
  over, waiting up to 30 s for a route to appear (pre-connect wait,
  reference ``apps/skit/src/moq_gateway.rs:80-140``),
* a process-global gateway installed once by the server
  (``init_moq_gateway`` / ``get_moq_gateway``).

Wire framing (the "hang timestamps" analog, documented for clients):
every media message is ``u8 flags | u64be timestamp_us | payload``;
flags bit0 = key/first-of-group. Control messages are JSON text frames.
"""

from __future__ import annotations

import asyncio
import struct
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .channel import Channel, ChannelClosed, ChannelFull

__all__ = [
    "MoqConnection",
    "MoqGateway",
    "init_moq_gateway",
    "get_moq_gateway",
    "encode_media_frame",
    "decode_media_frame",
]

ROUTE_WAIT_SECS = 30.0
_HEADER = struct.Struct(">BQ")


def encode_media_frame(payload: bytes, timestamp_us: int, key: bool = False) -> bytes:
    return _HEADER.pack(1 if key else 0, max(0, timestamp_us)) + payload


def decode_media_frame(frame: bytes) -> Tuple[bytes, int, bool]:
    flags, ts = _HEADER.unpack_from(frame)
    return frame[_HEADER.size :], ts, bool(flags & 1)


@dataclass
class MoqConnection:
    """One accepted media connection (direction from the client's view)."""

    path: str
    direction: str  # "publish" (client sends media) | "subscribe" (client receives)
    incoming: Channel = field(default_factory=lambda: Channel(100, "moq_in"))
    outgoing: Channel = field(default_factory=lambda: Channel(100, "moq_out"))
    remote: str = ""

    def close(self) -> None:
        self.incoming.close()
        self.outgoing.close()


class MoqGateway:
    """path → route channel registry with pre-connect wait."""

    def __init__(self) -> None:
        self._routes: Dict[str, Channel] = {}
        self._lock = asyncio.Lock()

    async def register_route(self, path: str) -> Channel:
        """Called by nodes: returns the channel of incoming MoqConnections."""
        async with self._lock:
            if path in self._routes and not self._routes[path].is_closed:
                raise ValueError(f"route already registered: {path}")
            ch = Channel(16, name=f"route:{path}")
            self._routes[path] = ch
            return ch

    async def unregister_route(self, path: str) -> None:
        async with self._lock:
            ch = self._routes.pop(path, None)
            if ch is not None:
                ch.close()

    async def accept_connection(self, conn: MoqConnection) -> bool:
        """Server acceptor: deliver a connection to its route, waiting up to
        ROUTE_WAIT_SECS for the route to be registered."""
        deadline = time.monotonic() + ROUTE_WAIT_SECS
        while time.monotonic() < deadline:
            async with self._lock:
                ch = self._routes.get(conn.path)
            if ch is not None and not ch.is_closed:
                try:
                    await ch.send(conn)
                    return True
                except ChannelClosed:
                    return False
            await asyncio.sleep(0.1)
        return False

    def routes(self) -> list:
        return sorted(self._routes)

    def has_route(self, path: str) -> bool:
        ch = self._routes.get(path)
        return ch is not None and not ch.is_closed


_GATEWAY: Optional[MoqGateway] = None


def init_moq_gateway(gateway: Optional[MoqGateway] = None) -> MoqGateway:
    global _GATEWAY
    _GATEWAY = gateway or MoqGateway()
    return _GATEWAY


def get_moq_gateway() -> Optional[MoqGateway]:
    return _GATEWAY
