# SPDX-License-Identifier: Apache-2.0
"""Dynamic engine: long-lived, live-patchable session pipelines.

Parity with reference ``engine/src/dynamic_actor.rs:100-1032`` +
``dynamic_handle.rs``:

* one control-plane actor per session; data plane = one task per node plus
  one :class:`PinDistributor` per output pin — packets never traverse the
  actor,
* graph mutations: AddNode / RemoveNode / Connect / Disconnect / TuneNode,
* on-demand dynamic-pin creation at connect time,
* ready-gating: ``Start`` is sent to source nodes only when *all* nodes are
  Ready/Running (``check_and_activate_pipeline``, ``dynamic_actor.rs:165-243``),
* graceful-then-abort shutdown ladders (node 5 s, engine 2 s + 1 s),
* state/stats/telemetry fan-out to subscriber channels (lossy for slow
  subscribers, pruned when closed).
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ..core import (
    Channel,
    ChannelClosed,
    ChannelFull,
    ConfigurationError,
    ConnectionMode,
    EngineControlMessage,
    NodeContext,
    NodeControlMessage,
    NodeRegistry,
    OutputSender,
    ProcessorNode,
    StreamKitError,
    ValidationFailure,
    can_connect_any,
)
from ..core.pins import InputPin, OutputPin, PinCardinality, PinManagementMessage, PinUpdate
from ..core.state import NodeState, NodeStateKind, NodeStateUpdate, StopReason
from ..core.types import PacketType
from . import constants
from .distributor import PinDistributor
from .graph_builder import _find_input_pin, _find_output_pin

log = logging.getLogger(__name__)

__all__ = ["DynamicEngine", "DynamicEngineHandle", "DynamicEngineConfig", "start_dynamic_engine"]


@dataclass
class DynamicEngineConfig:
    """Reference ``dynamic_config.rs:13-37``."""

    session_id: str = ""
    packet_batch_size: int = constants.PACKET_BATCH_SIZE
    node_input_capacity: int = constants.NODE_INPUT_CAPACITY
    pin_distributor_capacity: int = constants.PIN_DISTRIBUTOR_CAPACITY


@dataclass
class _NodeEntry:
    node: ProcessorNode
    kind: str
    params: Optional[dict]
    ctx: NodeContext
    task: Optional[asyncio.Task]
    control_tx: Channel
    pin_mgmt_tx: Channel
    input_pins: List[InputPin]
    output_pins: List[OutputPin]
    distributors: Dict[str, PinDistributor] = field(default_factory=dict)
    dist_tasks: Dict[str, asyncio.Task] = field(default_factory=dict)
    state: NodeState = field(default_factory=NodeState.initializing)
    started: bool = False  # Start signal delivered


@dataclass
class _Connection:
    from_node: str
    from_pin: str
    to_node: str
    to_pin: str
    mode: ConnectionMode
    channel: Channel

    @property
    def id(self) -> str:
        return f"{self.from_node}:{self.from_pin}->{self.to_node}:{self.to_pin}"


class DynamicEngine:
    """The per-session control-plane actor."""

    def __init__(
        self,
        registry: NodeRegistry,
        config: DynamicEngineConfig,
        resources=None,
        audio_pool=None,
        batcher=None,
    ) -> None:
        self.registry = registry
        self.config = config
        self.resources = resources
        self.audio_pool = audio_pool
        self.batcher = batcher
        self.nodes: Dict[str, _NodeEntry] = {}
        self.connections: Dict[str, _Connection] = {}
        self.control_rx = Channel(constants.ENGINE_CONTROL_CAPACITY, name="engine_control")
        self.state_rx = Channel(constants.STATE_CHANNEL_CAPACITY, name="states")
        self.stats_rx = Channel(constants.STATS_CHANNEL_CAPACITY, name="stats")
        self.telemetry_rx = Channel(constants.TELEMETRY_CHANNEL_CAPACITY, name="telemetry")
        self._state_subs: List[Channel] = []
        self._stats_subs: List[Channel] = []
        self._telemetry_subs: List[Channel] = []
        self._shutdown = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self.stats_snapshots: Dict[str, object] = {}

    # ------------------------------------------------------------------ actor
    async def run(self) -> None:
        """Actor loop: select over control / state / stats / telemetry."""
        pending = {
            "control": asyncio.ensure_future(self.control_rx.recv_optional()),
            "state": asyncio.ensure_future(self.state_rx.recv_optional()),
            "stats": asyncio.ensure_future(self.stats_rx.recv_optional()),
            "telemetry": asyncio.ensure_future(self.telemetry_rx.recv_optional()),
        }
        try:
            while not self._shutdown.is_set():
                done, _ = await asyncio.wait(
                    pending.values(), return_when=asyncio.FIRST_COMPLETED
                )
                for key in list(pending):
                    fut = pending[key]
                    if fut not in done:
                        continue
                    item = fut.result()
                    if key == "control":
                        if item is None:
                            self._shutdown.set()
                            break
                        await self._handle_control(item)
                        pending[key] = asyncio.ensure_future(self.control_rx.recv_optional())
                    elif key == "state":
                        if item is not None:
                            self._handle_state_update(item)
                            await self._check_and_activate()
                        pending[key] = asyncio.ensure_future(self.state_rx.recv_optional())
                    elif key == "stats":
                        if item is not None:
                            self.stats_snapshots[item.node_name] = item.stats
                            self._fanout(self._stats_subs, item)
                        pending[key] = asyncio.ensure_future(self.stats_rx.recv_optional())
                    else:
                        if item is not None:
                            self._fanout(self._telemetry_subs, item)
                        pending[key] = asyncio.ensure_future(self.telemetry_rx.recv_optional())
        finally:
            for fut in pending.values():
                fut.cancel()
            await self._shutdown_all()

    def _fanout(self, subs: List[Channel], item) -> None:
        """Lossy fan-out: drop for full subscribers, prune closed ones
        (reference retain policy, ``dynamic_actor.rs:248-387``)."""
        for ch in list(subs):
            try:
                ch.try_send(item)
            except ChannelClosed:
                subs.remove(ch)
            except ChannelFull:
                pass

    def _handle_state_update(self, update: NodeStateUpdate) -> None:
        entry = self.nodes.get(update.node_name)
        if entry is not None:
            entry.state = update.state
        self._fanout(self._state_subs, update)

    # ------------------------------------------------------------- activation
    async def _check_and_activate(self) -> None:
        """Send Start to source nodes once ALL nodes are Ready/Running.

        Source = node with no declared input pins (reference
        ``dynamic_actor.rs:165-243``). Additional robustness beyond the
        reference: the source must have at least one attached downstream
        destination, otherwise its packets would fall into an empty
        distributor while the client is still wiring the graph (the
        reference has this race; clients win it by message ordering).
        """
        if not self.nodes:
            return
        if not all(e.state.is_ready_or_running for e in self.nodes.values()):
            return
        # "whole pipeline ready": every declared (non-dynamic) input pin of
        # every node must have an incoming connection, so no intermediate
        # distributor drops packets into the void mid-wiring. Dynamic pin
        # families (mixers) are exempt — their pins exist per connection.
        connected_inputs = {(c.to_node, c.to_pin) for c in self.connections.values()}
        for name, entry in self.nodes.items():
            for pin in entry.input_pins:
                if pin.cardinality.is_dynamic:
                    continue
                if (name, pin.name) not in connected_inputs:
                    return
        for name, entry in self.nodes.items():
            if entry.started:
                continue
            if entry.input_pins:
                continue  # not a source
            if not any(d.destinations for d in entry.distributors.values()):
                continue  # source with nothing downstream: keep holding
            try:
                entry.control_tx.try_send(NodeControlMessage.start())
                entry.started = True
            except (ChannelClosed, ChannelFull):
                pass

    # ---------------------------------------------------------------- control
    async def _handle_control(self, msg: EngineControlMessage) -> None:
        reply = msg.reply
        try:
            if msg.op == "add_node":
                await self._add_node(msg.node_id, msg.kind, msg.params)
                result = None
            elif msg.op == "remove_node":
                await self._remove_node(msg.node_id)
                result = None
            elif msg.op == "connect":
                await self._connect(msg.from_node, msg.from_pin, msg.to_node, msg.to_pin, msg.mode)
                await self._check_and_activate()  # wiring may unblock sources
                result = None
            elif msg.op == "disconnect":
                self._disconnect(msg.from_node, msg.from_pin, msg.to_node, msg.to_pin)
                result = None
            elif msg.op == "tune_node":
                entry = self.nodes.get(msg.node_id)
                if entry is None:
                    raise ValidationFailure(f"unknown node {msg.node_id!r}")
                # never block the control actor on a full node channel
                # (reference: try_send fast path, spawned send fallback)
                try:
                    entry.control_tx.try_send(msg.message)
                except ChannelFull:
                    asyncio.ensure_future(entry.control_tx.send(msg.message))
                except ChannelClosed:
                    raise ValidationFailure(f"node {msg.node_id!r} is shut down")
                if msg.message and msg.message.op == "update_params":
                    merged = dict(entry.params or {})
                    if isinstance(msg.message.params, dict):
                        merged.update(msg.message.params)
                    entry.params = merged
                result = None
            elif msg.op == "shutdown":
                self._shutdown.set()
                result = None
            elif msg.op == "query_pipeline":
                result = self.pipeline_snapshot()
            elif msg.op == "query_states":
                result = {n: e.state for n, e in self.nodes.items()}
            elif msg.op == "query_stats":
                result = dict(self.stats_snapshots)
            elif msg.op == "subscribe_state":
                ch = Channel(constants.SUBSCRIBER_CHANNEL_CAPACITY)
                self._state_subs.append(ch)
                result = ch
            elif msg.op == "subscribe_stats":
                ch = Channel(constants.SUBSCRIBER_CHANNEL_CAPACITY)
                self._stats_subs.append(ch)
                result = ch
            elif msg.op == "subscribe_telemetry":
                ch = Channel(constants.SUBSCRIBER_CHANNEL_CAPACITY)
                self._telemetry_subs.append(ch)
                result = ch
            else:
                raise ValidationFailure(f"unknown engine op {msg.op!r}")
            if reply is not None and not reply.done():
                reply.set_result(result)
        except Exception as e:  # noqa: BLE001 — errors go back to the caller
            if reply is not None and not reply.done():
                reply.set_exception(e)
            else:
                log.error("engine op %s failed: %s", msg.op, e)

    # ---------------------------------------------------------------- add node
    async def _add_node(self, node_id: str, kind: str, params: Optional[dict]) -> None:
        if node_id in self.nodes:
            raise ValidationFailure(f"node {node_id!r} already exists")
        node = await self.registry.create_node_async(kind, params, resources=self.resources)
        update = await node.initialize()  # Tier-1 pin discovery
        if isinstance(update, PinUpdate.Updated):
            in_pins, out_pins = update.inputs, update.outputs
        else:
            in_pins, out_pins = node.input_pins(), node.output_pins()

        control = Channel(constants.CONTROL_CHANNEL_CAPACITY, name=f"{node_id}:control")
        pin_mgmt = Channel(constants.CONTROL_CHANNEL_CAPACITY, name=f"{node_id}:pins")
        distributors: Dict[str, PinDistributor] = {}
        dist_tasks: Dict[str, asyncio.Task] = {}
        direct: Dict[str, Channel] = {}
        for pin in out_pins:
            if pin.cardinality.is_dynamic:
                continue  # dynamic output pins materialize at connect time
            dist = PinDistributor(node_id, pin.name, self.config.pin_distributor_capacity)
            distributors[pin.name] = dist
            dist_tasks[pin.name] = dist.start()
            direct[pin.name] = dist.input

        # input channels are created with the node (reference
        # ``initialize_node``, dynamic_actor.rs:393-495): a later Connect only
        # attaches the distributor, so nodes block on empty pins instead of
        # seeing instant EOF, and Disconnect/reconnect reuses the channel.
        inputs: Dict[str, Channel] = {}
        for pin in in_pins:
            if not pin.cardinality.is_dynamic:
                inputs[pin.name] = Channel(
                    self.config.node_input_capacity, name=f"{node_id}:{pin.name}"
                )
        ctx = NodeContext(
            node_name=node_id,
            inputs=inputs,
            control_rx=control,
            output=OutputSender(node_id, direct=direct),
            batch_size=self.config.packet_batch_size,
            state_tx=self.state_rx,
            stats_tx=self.stats_rx,
            telemetry_tx=self.telemetry_rx,
            session_id=self.config.session_id,
            cancellation=asyncio.Event(),
            pin_management_rx=pin_mgmt,
            audio_pool=self.audio_pool,
            params=params,
            resources=self.resources,
            batcher=self.batcher,
        )
        entry = _NodeEntry(
            node=node,
            kind=kind,
            params=params,
            ctx=ctx,
            task=None,
            control_tx=control,
            pin_mgmt_tx=pin_mgmt,
            input_pins=in_pins,
            output_pins=out_pins,
            distributors=distributors,
            dist_tasks=dist_tasks,
        )
        self.nodes[node_id] = entry
        entry.task = asyncio.ensure_future(self._run_node(entry))

    async def _run_node(self, entry: _NodeEntry) -> None:
        name = entry.ctx.node_name
        from ..utils.tracing import get_tracer

        # reference: info_span!("node_run", ...) around every node task
        # (dynamic_actor.rs:485-490)
        span = get_tracer().span(
            "node_run",
            {
                "node.name": name,
                "node.kind": getattr(entry.node, "KIND", type(entry.node).__name__),
                "session.id": entry.ctx.session_id or "",
            },
        )
        try:
            with span:
                await entry.node.run(entry.ctx)
            if entry.state.kind not in (NodeStateKind.STOPPED, NodeStateKind.FAILED):
                entry.state = NodeState.stopped(StopReason.COMPLETED)
        except asyncio.CancelledError:
            entry.state = NodeState.stopped(StopReason.SHUTDOWN)
        except Exception as e:  # noqa: BLE001
            log.exception("node %s crashed", name)
            entry.state = NodeState.failed(f"{type(e).__name__}: {e}")
            self._fanout(self._state_subs, NodeStateUpdate(name, entry.state))
        finally:
            entry.ctx.release()
            for dist in entry.distributors.values():
                dist.stop()

    # ---------------------------------------------------------------- connect
    def _resolve_output_type(self, node_id: str, pin_name: str, _depth: int = 0) -> PacketType:
        """Runtime Passthrough resolution (oneshot resolves at compile time)."""
        entry = self.nodes[node_id]
        pin = _find_output_pin(entry.output_pins, pin_name)
        if pin is None:
            raise ValidationFailure(f"node {node_id!r} has no output pin {pin_name!r}")
        t = pin.produces_type
        if not t.is_passthrough or _depth > constants.MAX_TYPE_INFERENCE_ITERATIONS:
            return t
        for c in self.connections.values():
            if c.to_node == node_id:
                return self._resolve_output_type(c.from_node, c.from_pin, _depth + 1)
        return t  # unresolved passthrough: defer (validated when upstream connects)

    async def _connect(
        self, from_node: str, from_pin: str, to_node: str, to_pin: str, mode: ConnectionMode
    ) -> None:
        if from_node not in self.nodes:
            raise ValidationFailure(f"unknown source node {from_node!r}")
        if to_node not in self.nodes:
            raise ValidationFailure(f"unknown destination node {to_node!r}")
        src, dst = self.nodes[from_node], self.nodes[to_node]

        conn_id = f"{from_node}:{from_pin}->{to_node}:{to_pin}"
        if conn_id in self.connections:
            raise ValidationFailure(f"connection already exists: {conn_id}")

        in_pin = _find_input_pin(dst.input_pins, to_pin)
        if in_pin is None:
            raise ValidationFailure(f"node {to_node!r} has no input pin {to_pin!r}")
        out_type = self._resolve_output_type(from_node, from_pin)
        accepts = in_pin.accepts_types
        if (
            not out_type.is_passthrough
            and not any(t.is_passthrough for t in accepts)
            and not can_connect_any(out_type, accepts)
        ):
            raise ValidationFailure(
                f"type mismatch: {from_node}:{from_pin} produces {out_type.display()} but "
                f"{to_node}:{to_pin} accepts [{', '.join(t.display() for t in accepts)}]"
            )

        # one-cardinality input pins allow a single incoming connection
        if not in_pin.cardinality.is_dynamic:
            for c in self.connections.values():
                if c.to_node == to_node and c.to_pin == to_pin:
                    raise ValidationFailure(f"input pin {to_node}:{to_pin} is already connected")

        # distributor for the source pin (materialize dynamic output pins here)
        dist = src.distributors.get(from_pin)
        if dist is None:
            out_pin = _find_output_pin(src.output_pins, from_pin)
            if out_pin is None:
                raise ValidationFailure(f"node {from_node!r} has no output pin {from_pin!r}")
            dist = PinDistributor(from_node, from_pin, self.config.pin_distributor_capacity)
            src.distributors[from_pin] = dist
            src.dist_tasks[from_pin] = dist.start()
            src.ctx.output.add_pin(from_pin, dist.input)
            if out_pin.cardinality.is_dynamic:
                src.pin_mgmt_tx.try_send(
                    PinManagementMessage(op="added_output", pin_name=from_pin)
                )

        # destination channel: reuse the node's existing pin channel; dynamic
        # input pins are materialized on demand
        ch = dst.ctx.inputs.get(to_pin)
        if ch is None:
            ch = Channel(self.config.node_input_capacity, name=conn_id)
            dst.ctx.inputs[to_pin] = ch
            if in_pin.cardinality.is_dynamic:
                dst.pin_mgmt_tx.try_send(
                    PinManagementMessage(op="added_input", pin_name=to_pin, channel=ch)
                )
        dist.add_connection(f"{to_node}:{to_pin}", ch, mode)
        self.connections[conn_id] = _Connection(from_node, from_pin, to_node, to_pin, mode, ch)

    def _disconnect(self, from_node: str, from_pin: str, to_node: str, to_pin: str) -> None:
        conn_id = f"{from_node}:{from_pin}->{to_node}:{to_pin}"
        conn = self.connections.pop(conn_id, None)
        if conn is None:
            raise ValidationFailure(f"no such connection: {conn_id}")
        src = self.nodes.get(from_node)
        if src is not None:
            dist = src.distributors.get(from_pin)
            if dist is not None:
                dist.remove_connection(f"{to_node}:{to_pin}", close=False)
        dst = self.nodes.get(to_node)
        if dst is not None:
            dst.pin_mgmt_tx.try_send(PinManagementMessage(op="remove_input", pin_name=to_pin))

    # -------------------------------------------------------------- remove node
    async def _remove_node(self, node_id: str) -> None:
        entry = self.nodes.get(node_id)
        if entry is None:
            raise ValidationFailure(f"unknown node {node_id!r}")
        # drop all connections touching this node
        for conn_id in [cid for cid, c in self.connections.items() if node_id in (c.from_node, c.to_node)]:
            c = self.connections.pop(conn_id)
            src = self.nodes.get(c.from_node)
            if src is not None and c.from_pin in src.distributors:
                # keep the downstream channel open: the engine owns node input
                # channels (reference retains a sender), so a surviving
                # downstream pin can be reconnected to a new source later
                src.distributors[c.from_pin].remove_connection(
                    f"{c.to_node}:{c.to_pin}", close=False
                )
        await self._shutdown_node(entry)
        del self.nodes[node_id]

    async def _shutdown_node(self, entry: _NodeEntry) -> None:
        """Graceful-then-abort (reference ``dynamic_actor.rs:809-866``)."""
        try:
            entry.control_tx.try_send(NodeControlMessage.shutdown())
        except (ChannelClosed, ChannelFull):
            pass
        # graceful phase: close inputs so the node drains and exits on EOF —
        # cancellation is NOT set yet, so queued packets still flush
        for ch in entry.ctx.inputs.values():
            ch.close()
        if entry.task is not None:
            try:
                await asyncio.wait_for(
                    asyncio.shield(entry.task), timeout=constants.NODE_GRACEFUL_SHUTDOWN_SECS
                )
            except (asyncio.TimeoutError, Exception):  # noqa: BLE001
                if entry.ctx.cancellation is not None:
                    entry.ctx.cancellation.set()
                entry.task.cancel()
                try:
                    await entry.task
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
        for dist in entry.distributors.values():
            dist.stop()

    async def _shutdown_all(self) -> None:
        """Engine shutdown: close all inputs first so blocked nodes exit
        (reference ``dynamic_actor.rs:939-1028``)."""
        # graceful phase: close all inputs so blocked nodes drain and exit on
        # EOF; cancellation stays unset so in-flight packets flush downstream
        for entry in self.nodes.values():
            for ch in entry.ctx.inputs.values():
                ch.close()
            try:
                entry.control_tx.try_send(NodeControlMessage.shutdown())
            except (ChannelClosed, ChannelFull):
                pass
        tasks = [e.task for e in self.nodes.values() if e.task is not None]
        if tasks:
            done, pending = await asyncio.wait(
                tasks, timeout=constants.ENGINE_GRACEFUL_SHUTDOWN_SECS
            )
            if pending:
                for entry in self.nodes.values():
                    if entry.ctx.cancellation is not None:
                        entry.ctx.cancellation.set()
                for t in pending:
                    t.cancel()
                await asyncio.wait(pending, timeout=constants.ENGINE_ABORT_GRACE_SECS)
        for entry in self.nodes.values():
            for dist in entry.distributors.values():
                dist.stop()

    # ---------------------------------------------------------------- queries
    def pipeline_snapshot(self) -> dict:
        """Mirror of the live graph (for GetPipeline)."""
        return {
            "nodes": {
                n: {"kind": e.kind, "params": e.params, "state": e.state.to_json()}
                for n, e in self.nodes.items()
            },
            "connections": [
                {
                    "from_node": c.from_node,
                    "from_pin": c.from_pin,
                    "to_node": c.to_node,
                    "to_pin": c.to_pin,
                    "mode": c.mode.value,
                }
                for c in self.connections.values()
            ],
        }


class DynamicEngineHandle:
    """Client handle (reference ``dynamic_handle.rs:82-170``)."""

    def __init__(self, engine: DynamicEngine, task: asyncio.Task) -> None:
        self._engine = engine
        self._task = task
        self.session_id = engine.config.session_id

    async def _request(self, msg: EngineControlMessage):
        msg.reply = asyncio.get_running_loop().create_future()
        await self._engine.control_rx.send(msg)
        return await msg.reply

    # graph mutations ---------------------------------------------------------
    async def add_node(self, node_id: str, kind: str, params: Optional[dict] = None) -> None:
        await self._request(EngineControlMessage(op="add_node", node_id=node_id, kind=kind, params=params))

    async def remove_node(self, node_id: str) -> None:
        await self._request(EngineControlMessage(op="remove_node", node_id=node_id))

    async def connect(
        self,
        from_node: str,
        from_pin: str,
        to_node: str,
        to_pin: str,
        mode: ConnectionMode = ConnectionMode.RELIABLE,
    ) -> None:
        await self._request(
            EngineControlMessage(
                op="connect",
                from_node=from_node,
                from_pin=from_pin,
                to_node=to_node,
                to_pin=to_pin,
                mode=mode,
            )
        )

    async def disconnect(self, from_node: str, from_pin: str, to_node: str, to_pin: str) -> None:
        await self._request(
            EngineControlMessage(
                op="disconnect", from_node=from_node, from_pin=from_pin, to_node=to_node, to_pin=to_pin
            )
        )

    async def tune_node(self, node_id: str, message: NodeControlMessage) -> None:
        await self._request(EngineControlMessage(op="tune_node", node_id=node_id, message=message))

    # queries -----------------------------------------------------------------
    async def get_pipeline(self) -> dict:
        return await self._request(EngineControlMessage(op="query_pipeline"))

    async def get_node_states(self) -> Dict[str, NodeState]:
        return await self._request(EngineControlMessage(op="query_states"))

    async def get_node_stats(self) -> dict:
        return await self._request(EngineControlMessage(op="query_stats"))

    async def subscribe_state(self) -> Channel:
        return await self._request(EngineControlMessage(op="subscribe_state"))

    async def subscribe_stats(self) -> Channel:
        return await self._request(EngineControlMessage(op="subscribe_stats"))

    async def subscribe_telemetry(self) -> Channel:
        return await self._request(EngineControlMessage(op="subscribe_telemetry"))

    # shutdown ----------------------------------------------------------------
    async def shutdown_and_wait(self) -> None:
        try:
            await self._engine.control_rx.send(EngineControlMessage(op="shutdown"))
        except ChannelClosed:
            pass
        try:
            await asyncio.wait_for(self._task, timeout=constants.HANDLE_SHUTDOWN_TIMEOUT_SECS)
        except asyncio.TimeoutError:
            self._task.cancel()


def start_dynamic_engine(
    registry: NodeRegistry,
    config: Optional[DynamicEngineConfig] = None,
    resources=None,
    audio_pool=None,
    batcher=None,
) -> DynamicEngineHandle:
    """Spawn a dynamic engine actor (reference ``Engine::start_dynamic_actor``)."""
    engine = DynamicEngine(registry, config or DynamicEngineConfig(), resources, audio_pool, batcher)
    task = asyncio.ensure_future(engine.run())
    return DynamicEngineHandle(engine, task)
