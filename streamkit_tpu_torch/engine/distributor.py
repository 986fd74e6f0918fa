# SPDX-License-Identifier: Apache-2.0
"""Pin distributor: data-plane fan-out for one output pin.

Parity with reference ``engine/src/dynamic_pin_distributor.rs:27-370``:

* ``ConnectionMode.RELIABLE`` — synchronized backpressure: try_send fast
  path, then awaited send (producer stalls until every reliable destination
  has accepted).
* ``ConnectionMode.BEST_EFFORT`` — a 1-slot newest-packet buffer per
  destination: when the destination is full, the pending packet is replaced
  (drop-old) and the drop is counted.
* single-destination fast path (no clone),
* closed destinations are auto-pruned,
* per-distributor packet/drop counters for observability.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..core import Channel, ChannelClosed, ChannelFull, ConnectionMode, Packet

__all__ = ["Destination", "PinDistributor"]


@dataclass
class Destination:
    conn_id: str  # "to_node:to_pin"
    channel: Channel
    mode: ConnectionMode = ConnectionMode.RELIABLE
    # best-effort state: newest pending packet + flusher task
    _pending: Optional[Packet] = None
    _flusher: Optional[asyncio.Task] = None
    dropped: int = 0
    delivered: int = 0


class PinDistributor:
    """Fan-out actor for one ``node:pin``. Owns the pin's input channel."""

    def __init__(self, node_name: str, pin_name: str, capacity: int) -> None:
        self.node_name = node_name
        self.pin_name = pin_name
        self.input = Channel(capacity, name=f"dist:{node_name}:{pin_name}")
        self._dests: Dict[str, Destination] = {}
        self._task: Optional[asyncio.Task] = None
        self.packets = 0
        self.drops = 0

    # -- connection management (PinConfigMsg equivalents) -----------------------
    def add_connection(self, conn_id: str, channel: Channel, mode: ConnectionMode) -> None:
        self._dests[conn_id] = Destination(conn_id, channel, mode)

    def remove_connection(self, conn_id: str, close: bool = True) -> Optional[Destination]:
        """Remove a destination. ``close=False`` for explicit Disconnect — the
        receiver's channel stays open so the pin can be reconnected later
        (reference semantics: the node's input channel lives with the node,
        not the connection)."""
        dest = self._dests.pop(conn_id, None)
        if dest is not None:
            if dest._flusher is not None:
                dest._flusher.cancel()
            if close:
                dest.channel.close()
        return dest

    @property
    def destinations(self) -> Dict[str, Destination]:
        return dict(self._dests)

    def start(self) -> asyncio.Task:
        self._task = asyncio.ensure_future(self._run())
        return self._task

    def stop(self) -> None:
        self.input.close()

    async def _run(self) -> None:
        try:
            while True:
                packet = await self.input.recv_optional()
                if packet is None:
                    break
                self.packets += 1
                await self._distribute(packet)
        finally:
            for dest in self._dests.values():
                if dest._flusher is not None:
                    dest._flusher.cancel()
                dest.channel.close()

    async def _distribute(self, packet: Packet) -> None:
        """Reference ``distribute_packet`` (dyn_pin_distributor.rs:182-370)."""
        dead = []
        dests = list(self._dests.values())
        # single-destination fast path: no clone
        multi = len(dests) > 1
        pending_sends = []
        for dest in dests:
            pkt = packet.clone() if multi else packet
            if dest.mode is ConnectionMode.RELIABLE:
                try:
                    dest.channel.try_send(pkt)
                    dest.delivered += 1
                except ChannelFull:
                    pending_sends.append((dest, pkt))
                except ChannelClosed:
                    dead.append(dest.conn_id)
            else:
                self._best_effort_send(dest, pkt, dead)
        # await stalled reliable sends concurrently (FuturesUnordered analog)
        if pending_sends:
            async def await_send(dest: Destination, pkt: Packet) -> None:
                try:
                    await dest.channel.send(pkt)
                    dest.delivered += 1
                except ChannelClosed:
                    dead.append(dest.conn_id)

            await asyncio.gather(*(await_send(d, p) for d, p in pending_sends))
        for conn_id in dead:
            self.remove_connection(conn_id)

    def _best_effort_send(self, dest: Destination, pkt: Packet, dead: list) -> None:
        """Newest-packet-kept semantics: replace the pending packet when full."""
        try:
            dest.channel.try_send(pkt)
            dest.delivered += 1
            return
        except ChannelClosed:
            dead.append(dest.conn_id)
            return
        except ChannelFull:
            pass
        if dest._pending is not None:
            dest.dropped += 1
            self.drops += 1
        dest._pending = pkt
        if dest._flusher is None or dest._flusher.done():
            dest._flusher = asyncio.ensure_future(self._flush_pending(dest))

    async def _flush_pending(self, dest: Destination) -> None:
        while dest._pending is not None:
            pkt = dest._pending
            dest._pending = None
            try:
                await dest.channel.send(pkt)
                dest.delivered += 1
            except ChannelClosed:
                # prune directly: this runs detached from _distribute
                self._dests.pop(dest.conn_id, None)
                return
