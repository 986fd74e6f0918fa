# SPDX-License-Identifier: Apache-2.0
"""In-process MoQ relay: named broadcasts with group-based delivery.

Reference model (``crates/transport/moq/src/peer.rs:459-880`` and the
moq-lite protocol the reference's publisher/subscriber nodes speak to an
external relay): media is organized as *broadcasts* → *tracks* → *groups*
of frames; subscribers that fall behind skip to the newest group rather
than buffering unboundedly (``moq/constants.rs:22-46`` group duration).

TPU-native redesign: the relay lives in the serving process. Publisher and
subscriber *nodes* meet here directly (zero-copy bytes hand-off, no network
hop), and external transports (WebSocket gateway binding, the
WebTransport/QUIC acceptor) bridge remote clients onto the same broadcast
namespace.
"""

from __future__ import annotations

import asyncio
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Set

__all__ = [
    "Frame",
    "Broadcast",
    "BroadcastConsumer",
    "MoqRelay",
    "init_moq_relay",
    "get_moq_relay",
]

# How many *groups* a slow subscriber may queue before the relay drops the
# oldest complete group (MoQ group-based congestion response).
MAX_QUEUED_GROUPS = 8
# Announce wait: how long a subscriber waits for a broadcast to appear
# (mirrors the gateway's pre-connect route wait, apps/skit/src/moq_gateway.rs:80-140).
ANNOUNCE_WAIT_SECS = 30.0


@dataclass(frozen=True)
class Frame:
    """One media frame: payload + microsecond timestamp + group-start flag."""

    payload: bytes
    timestamp_us: int = 0
    key: bool = False  # True = first frame of a new group


class BroadcastConsumer:
    """Read side of a broadcast subscription.

    Frames are queued per-group; when more than MAX_QUEUED_GROUPS complete
    groups are pending, the oldest groups are discarded whole so the
    subscriber jumps forward in coherent units (never mid-group).
    """

    def __init__(self, broadcast: "Broadcast") -> None:
        self._broadcast = broadcast
        self._groups: Deque[List[Frame]] = deque()
        self._current: Optional[List[Frame]] = None
        self._event = asyncio.Event()
        self._closed = False
        self.dropped_groups = 0

    def _push(self, frame: Frame) -> None:
        if self._closed:
            return
        if frame.key or self._current is None:
            self._current = []
            self._groups.append(self._current)
            # congestion response: drop oldest *complete* groups
            while len(self._groups) > MAX_QUEUED_GROUPS:
                self._groups.popleft()
                self.dropped_groups += 1
        self._current.append(frame)
        self._event.set()

    def _close(self) -> None:
        self._closed = True
        self._event.set()

    @property
    def closed(self) -> bool:
        return self._closed

    async def recv(self) -> Optional[Frame]:
        """Next frame, or None once the broadcast ends."""
        while True:
            while self._groups:
                group = self._groups[0]
                if group:
                    frame = group.pop(0)
                    if not group and group is not self._current:
                        self._groups.popleft()
                    return frame
                if group is self._current:
                    break  # drained the live group; wait for more frames
                self._groups.popleft()
            if self._closed:
                return None
            self._event.clear()
            await self._event.wait()

    def close(self) -> None:
        self._closed = True
        self._event.set()
        self._broadcast._consumers.discard(self)


class Broadcast:
    """One named broadcast: a single producer, N consumers."""

    def __init__(self, relay: "MoqRelay", name: str) -> None:
        self.relay = relay
        self.name = name
        self._consumers: Set[BroadcastConsumer] = set()
        self._ended = False
        self.frames_published = 0

    def publish(self, payload: bytes, timestamp_us: int = 0, key: bool = False) -> None:
        frame = Frame(payload, timestamp_us, key)
        self.frames_published += 1
        for c in list(self._consumers):
            c._push(frame)

    def subscribe(self) -> BroadcastConsumer:
        c = BroadcastConsumer(self)
        if self._ended:
            c._close()
        else:
            self._consumers.add(c)
        return c

    @property
    def subscriber_count(self) -> int:
        return len(self._consumers)

    def end(self) -> None:
        """Producer is done: close consumers and retract the announcement."""
        if self._ended:
            return
        self._ended = True
        for c in list(self._consumers):
            c._close()
        self._consumers.clear()
        self.relay._retract(self.name, self)


class MoqRelay:
    """Broadcast namespace: announce (publish) + subscribe with announce-wait."""

    def __init__(self) -> None:
        self._broadcasts: Dict[str, Broadcast] = {}
        self._waiters: Dict[str, List[asyncio.Event]] = {}

    def announce(self, name: str, replace: bool = True) -> Broadcast:
        """Start publishing a broadcast. An existing publisher on the same
        name is ended (reconnect semantics, peer.rs single publisher slot)
        unless replace=False, in which case ValueError is raised."""
        old = self._broadcasts.get(name)
        if old is not None:
            if not replace:
                raise ValueError(f"broadcast already announced: {name}")
            old.end()
        b = Broadcast(self, name)
        self._broadcasts[name] = b
        for ev in self._waiters.pop(name, []):
            ev.set()
        return b

    def _retract(self, name: str, broadcast: Broadcast) -> None:
        if self._broadcasts.get(name) is broadcast:
            del self._broadcasts[name]

    def get(self, name: str) -> Optional[Broadcast]:
        return self._broadcasts.get(name)

    def announced(self) -> List[dict]:
        """Catalog of live broadcasts (served by the announce API)."""
        return [
            {
                "name": b.name,
                "subscribers": b.subscriber_count,
                "frames": b.frames_published,
            }
            for b in self._broadcasts.values()
        ]

    async def subscribe(
        self, name: str, wait: Optional[float] = None
    ) -> Optional[BroadcastConsumer]:
        """Subscribe to a broadcast, waiting up to ``wait`` seconds for it
        to be announced. Returns None on timeout."""
        if wait is None:
            wait = ANNOUNCE_WAIT_SECS
        deadline = asyncio.get_running_loop().time() + wait
        while True:
            b = self._broadcasts.get(name)
            if b is not None:
                return b.subscribe()
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                return None
            ev = asyncio.Event()
            self._waiters.setdefault(name, []).append(ev)
            try:
                await asyncio.wait_for(ev.wait(), timeout=remaining)
            except asyncio.TimeoutError:
                return None
            finally:
                ws = self._waiters.get(name)
                if ws and ev in ws:
                    ws.remove(ev)


_GLOBAL: Optional[MoqRelay] = None


def init_moq_relay() -> MoqRelay:
    global _GLOBAL
    _GLOBAL = MoqRelay()
    return _GLOBAL


def get_moq_relay() -> MoqRelay:
    """Process-global relay (auto-created: nodes can meet in-process even
    without a server, e.g. in tests and the oneshot runner)."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = MoqRelay()
    return _GLOBAL
