# SPDX-License-Identifier: Apache-2.0
"""Processor-node trait, per-node context, and output routing.

Parity with reference ``crates/core/src/node.rs:33-333``:

* :class:`ProcessorNode` — actor-style node: declare pins, async
  ``initialize()`` (Tier-1 pin discovery), async ``run(ctx)``.
* :class:`NodeContext` — the node's I/O world: input channels, control
  channel, output sender, state/stats/telemetry emitters, cancellation.
* :class:`OutputSender` — try_send fast-path then awaited send; Direct
  (pin → channel) or Routed ((node, pin, packet) → shared router) modes.

Host nodes are asyncio tasks; device nodes batch their work across
sessions through the engine's ``DeviceBatcher`` (``ctx.batcher``).
:meth:`ProcessorNode.device_fn` is kept for interface parity; no node of the
port returns one.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, List, Optional

from .channel import Channel, ChannelClosed, ChannelFull
from .control import NodeControlMessage
from .pins import InputPin, OutputPin, PinUpdate
from .state import NodeState, emit_state
from .types import Packet

__all__ = ["OutputSender", "NodeContext", "ProcessorNode", "NodeFactory"]


class OutputSender:
    """Routes packets from a node's output pins (reference ``node.rs:33-180``).

    Direct mode: each pin maps to one downstream channel (oneshot engine).
    Routed mode: all packets go to one router channel tagged with
    ``(node_name, pin_name, packet)`` (dynamic engine pin distributors, tests).
    """

    def __init__(
        self,
        node_name: str,
        direct: Optional[Dict[str, Channel]] = None,
        routed: Optional[Channel] = None,
    ) -> None:
        if (direct is None) == (routed is None):
            raise ValueError("exactly one of direct/routed must be given")
        self.node_name = node_name
        self._direct = direct
        self._routed = routed

    @property
    def pins(self) -> List[str]:
        return list(self._direct.keys()) if self._direct is not None else []

    def add_pin(self, pin: str, ch: Channel) -> None:
        assert self._direct is not None
        self._direct[pin] = ch

    def remove_pin(self, pin: str) -> None:
        if self._direct is not None:
            self._direct.pop(pin, None)

    async def send(self, pin: str, packet: Packet) -> None:
        """Send on a pin; raises ChannelClosed if the downstream is gone.

        try_send fast path, then awaited send (reference ``node.rs:98-140``).
        """
        if self._direct is not None:
            ch = self._direct.get(pin)
            if ch is None:
                raise ChannelClosed(f"{self.node_name}:{pin} (unconnected)")
            try:
                ch.try_send(packet)
                return
            except ChannelFull:
                await ch.send(packet)
            return
        assert self._routed is not None
        item = (self.node_name, pin, packet)
        try:
            self._routed.try_send(item)
        except ChannelFull:
            await self._routed.send(item)

    def close(self) -> None:
        """Signal EOF downstream on every pin."""
        if self._direct is not None:
            for ch in self._direct.values():
                ch.close()


@dataclass
class NodeContext:
    """Everything a running node needs (reference ``node.rs:191-257``)."""

    node_name: str
    inputs: Dict[str, Channel] = field(default_factory=dict)
    control_rx: Optional[Channel] = None
    output: Optional[OutputSender] = None
    batch_size: int = 32
    state_tx: Optional[Channel] = None
    stats_tx: Optional[Channel] = None
    telemetry_tx: Optional[Channel] = None
    session_id: Optional[str] = None
    cancellation: Optional[asyncio.Event] = None
    pin_management_rx: Optional[Channel] = None
    audio_pool: Any = None
    params: Optional[dict] = None  # resolved node params (for mirrors/UI)
    resources: Any = None  # shared ResourceManager
    batcher: Any = None  # process-wide DeviceBatcher (continuous batching)
    # lazily-created, REUSED cancellation waiter (see recv_with_cancellation)
    _cancel_task: Any = None
    _cancel_task_refs: int = 0

    # -- convenience -----------------------------------------------------------
    def emit_state(self, state: NodeState) -> None:
        emit_state(self.state_tx, self.node_name, state)

    @property
    def cancelled(self) -> bool:
        return self.cancellation is not None and self.cancellation.is_set()

    async def recv_with_cancellation(self, pin: str = "in") -> Optional[Packet]:
        """Receive one packet, returning None on EOF *or* cancellation
        (reference ``node.rs:246-257``)."""
        ch = self.inputs.get(pin)
        if ch is None:
            return None
        if self.cancellation is None:
            return await ch.recv_optional()
        if self.cancellation.is_set():
            self._drop_cancel_task()
            return None
        # fast path: data already queued — no task machinery at all
        try:
            return ch.try_recv()
        except ChannelClosed:
            self._drop_cancel_task()
            return None
        except ChannelFull:  # empty, would block
            pass
        # the cancellation waiter is created ONCE per context and reused:
        # two fresh tasks per packet (the naive select) measurably dominated
        # the per-packet cost of the whole data plane at 128 sessions
        cancel_task = self._cancel_task
        if cancel_task is None or cancel_task.done():
            cancel_task = asyncio.ensure_future(self.cancellation.wait())
            self._cancel_task = cancel_task
        recv_task = asyncio.ensure_future(ch.recv_optional())
        self._cancel_task_refs += 1
        try:
            done, _ = await asyncio.wait(
                {recv_task, cancel_task}, return_when=asyncio.FIRST_COMPLETED
            )
        finally:
            self._cancel_task_refs -= 1
        if recv_task in done:
            result = recv_task.result()
            if result is None:  # EOF: this recv loop is over
                self._drop_cancel_task()
            return result
        recv_task.cancel()
        self._drop_cancel_task()
        return None

    def _drop_cancel_task(self) -> None:
        # refcounted: a multi-pin node (mixer) may have concurrent recvs
        # awaiting the SAME waiter — cancelling it under them would read as
        # a spurious engine cancellation on the other pins
        if self._cancel_task is not None and self._cancel_task_refs == 0:
            self._cancel_task.cancel()
            self._cancel_task = None

    def release(self) -> None:
        """Engine hook: reclaim context resources after ``node.run`` returns
        (today: the reused cancellation waiter)."""
        if self._cancel_task is not None:
            self._cancel_task.cancel()
            self._cancel_task = None

    async def recv_batch(
        self, pin: str = "in", max_batch: int = 32
    ) -> Optional[List[Packet]]:
        """Await one packet, then greedily drain up to ``max_batch`` queued
        ones without further awaits (reference ``helpers.rs:69-118``).
        Returns None on EOF/cancellation. Hot nodes use this to amortize
        per-packet event-loop wakeups at high session counts."""
        first = await self.recv_with_cancellation(pin)
        if first is None:
            return None
        ch = self.inputs.get(pin)
        from .helpers import batch_packets_greedy

        return batch_packets_greedy(ch, first, max_batch)

    def poll_control(self) -> Optional[NodeControlMessage]:
        """Non-blocking control-channel read."""
        if self.control_rx is None:
            return None
        try:
            return self.control_rx.try_recv()
        except (ChannelClosed, ChannelFull):
            return None

    async def wait_for_start(self) -> bool:
        """Block until a Start control message (source nodes; reference
        ``core/file_read.rs`` waits for Start before emitting). Returns False
        if shutdown/cancelled first."""
        if self.control_rx is None:
            return True
        while True:
            if self.cancelled:
                return False
            msg = await self._recv_control()
            if msg is None:
                return False
            if msg.op == "start":
                return True
            if msg.op == "shutdown":
                return False
            # UpdateParams before start: ignore here; node saw it via poll later.

    async def _recv_control(self) -> Optional[NodeControlMessage]:
        assert self.control_rx is not None
        if self.cancellation is None:
            return await self.control_rx.recv_optional()
        recv_task = asyncio.ensure_future(self.control_rx.recv_optional())
        cancel_task = asyncio.ensure_future(self.cancellation.wait())
        try:
            done, _ = await asyncio.wait(
                {recv_task, cancel_task}, return_when=asyncio.FIRST_COMPLETED
            )
            if recv_task in done:
                return recv_task.result()
            return None
        finally:
            for t in (recv_task, cancel_task):
                if not t.done():
                    t.cancel()


class ProcessorNode:
    """Base node (reference ``node.rs:260-330``).

    Subclasses override pin declarations and ``run``. Device-capable nodes
    (pure functions of PCM/feature tensors) also override :meth:`device_fn`
    to return a fusable ``fn(state, batch) -> (state, batch)`` that the
    engine may fuse/batch instead of running ``run()`` packet-at-a-time.
    """

    KIND: str = ""

    def input_pins(self) -> List[InputPin]:
        return []

    def output_pins(self) -> List[OutputPin]:
        return []

    def content_type(self) -> Optional[str]:
        """Static output content-type for Binary producers (e.g. muxers)."""
        return None

    def supports_dynamic_pins(self) -> bool:
        return False

    async def initialize(self) -> PinUpdate:
        """Tier-1 async init: discover pins from external sources."""
        return PinUpdate.NoChange()

    async def run(self, ctx: NodeContext) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    # -- device extension (interface parity) ----------------------------------
    def device_fn(self):
        """Return a fusable device function, or None for host-only nodes."""
        return None


# A factory takes optional JSON params and returns a node instance.
NodeFactory = Callable[[Optional[dict]], ProcessorNode]
