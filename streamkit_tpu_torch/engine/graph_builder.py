# SPDX-License-Identifier: Apache-2.0
"""Graph wiring for the oneshot engine.

Parity with reference ``engine/src/graph_builder.rs:58-430``:

* Tier-1 async ``initialize()`` pass (pin discovery),
* full DAG wiring — fan *in* (mixers) AND fan *out* (one output pin feeding
  several destinations, Reliable semantics with closed-branch pruning).
  This EXCEEDS the reference, whose oneshot engine fails fast on fan-out
  (``graph_builder.rs:71-85``) and supports it only in the dynamic engine's
  pin distributors (``dynamic_pin_distributor.rs:182-370``),
* iterative Passthrough output-type inference (≤100 iterations),
* type + cardinality validation via :func:`can_connect`,
* per-connection bounded channel; one asyncio task per node with final-state
  reporting and output-EOF propagation on exit.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..api.messages import Connection, Pipeline
from ..core import (
    Channel,
    ChannelClosed,
    ChannelFull,
    NodeContext,
    OutputSender,
    ProcessorNode,
    StreamKitError,
    ValidationFailure,
    can_connect_any,
)
from ..core.pins import InputPin, OutputPin, PinCardinality, PinUpdate
from ..core.state import NodeState, StopReason, emit_state
from ..core.types import PacketType
from . import constants

log = logging.getLogger(__name__)

__all__ = ["WiredGraph", "wire_and_spawn_graph", "resolve_passthrough_types"]


class _FanoutChannel:
    """Producer-side surface delivering every packet to N branch channels.

    Oneshot DAG fan-out (exceeds reference: its oneshot engine rejects
    fan-out, ``graph_builder.rs:71-85``). Semantics mirror the dynamic
    engine's Reliable distributor (``engine/distributor.py``): every live
    branch must take the packet (synchronized backpressure), packets are
    cloned per extra branch (COW — cheap), closed branches are pruned, and
    the producer sees ``ChannelClosed`` only when ALL branches are gone.
    """

    def __init__(self, branches: List[Channel], name: str = "") -> None:
        self._branches = list(branches)
        self.name = name

    @staticmethod
    def _clone(item):
        return item.clone() if hasattr(item, "clone") else item

    def _live(self) -> List[Channel]:
        live = [b for b in self._branches if not b.is_closed]
        self._branches = live
        if not live:
            raise ChannelClosed(self.name)
        return live

    def try_send(self, item) -> None:
        live = self._live()
        # all-or-nothing: no branch is written unless every branch has room
        # (there is no await between the check and the writes, so this is
        # atomic under the event loop)
        if any(b.is_full for b in live):
            raise ChannelFull(self.name)
        for i, b in enumerate(live):
            b.try_send(item if i == 0 else self._clone(item))

    async def send(self, item) -> None:
        delivered = False
        for i, b in enumerate(self._live()):
            try:
                await b.send(item if i == 0 else self._clone(item))
                delivered = True
            except ChannelClosed:
                continue  # pruned on the next call
        if not delivered:
            raise ChannelClosed(self.name)

    def close(self) -> None:
        for b in self._branches:
            b.close()


@dataclass
class WiredGraph:
    tasks: Dict[str, asyncio.Task] = field(default_factory=dict)
    contexts: Dict[str, NodeContext] = field(default_factory=dict)
    control_txs: Dict[str, Channel] = field(default_factory=dict)
    channels: List[Channel] = field(default_factory=list)

    async def join(self) -> Dict[str, Optional[BaseException]]:
        results: Dict[str, Optional[BaseException]] = {}
        for name, task in self.tasks.items():
            try:
                await task
                results[name] = None
            except asyncio.CancelledError:
                results[name] = None
            except BaseException as e:  # noqa: BLE001 - report, don't crash engine
                results[name] = e
        return results

    def cancel(self) -> None:
        for task in self.tasks.values():
            task.cancel()


def _find_input_pin(pins: List[InputPin], pin_name: str) -> Optional[InputPin]:
    """Exact match, else dynamic-prefix match (``in_0`` matches prefix ``in``)."""
    for p in pins:
        if p.name == pin_name:
            return p
    for p in pins:
        if p.cardinality.is_dynamic and p.cardinality.prefix:
            prefix = p.cardinality.prefix
            if pin_name == prefix or pin_name.startswith(prefix + "_"):
                return p
    return None


def _find_output_pin(pins: List[OutputPin], pin_name: str) -> Optional[OutputPin]:
    for p in pins:
        if p.name == pin_name:
            return p
    for p in pins:
        if p.cardinality.is_dynamic and p.cardinality.prefix:
            prefix = p.cardinality.prefix
            if pin_name == prefix or pin_name.startswith(prefix + "_"):
                return p
    return None


def resolve_passthrough_types(
    nodes: Dict[str, ProcessorNode],
    input_pins: Dict[str, List[InputPin]],
    output_pins: Dict[str, List[OutputPin]],
    connections: List[Connection],
) -> Dict[str, PacketType]:
    """Iteratively resolve Passthrough output types (``graph_builder.rs:135-210``).

    Returns a map ``"node:pin" -> resolved PacketType`` for every output pin.
    A Passthrough output resolves to the (resolved) type feeding the node's
    input. Unresolved passthroughs after the iteration cap raise.
    """
    resolved: Dict[str, PacketType] = {}
    for name, pins in output_pins.items():
        for p in pins:
            resolved[f"{name}:{p.name}"] = p.produces_type

    # also register concrete types for connection-named dynamic pins
    for c in connections:
        key = f"{c.from_node}:{c.from_pin}"
        if key not in resolved:
            pin = _find_output_pin(output_pins.get(c.from_node, []), c.from_pin)
            if pin is not None:
                resolved[key] = pin.produces_type

    for _ in range(constants.MAX_TYPE_INFERENCE_ITERATIONS):
        changed = False
        for name in nodes:
            # the type feeding this node = resolved type of the connection into it
            feeding: Optional[PacketType] = None
            for c in connections:
                if c.to_node == name:
                    t = resolved.get(f"{c.from_node}:{c.from_pin}")
                    if t is not None and not t.is_passthrough:
                        feeding = t
                        break
            if feeding is None:
                continue
            for p in output_pins.get(name, []):
                key = f"{name}:{p.name}"
                if resolved.get(key) is not None and resolved[key].is_passthrough:
                    resolved[key] = feeding
                    changed = True
        if not changed:
            break

    unresolved = [
        k
        for k, t in resolved.items()
        if t.is_passthrough
        and any(f"{c.from_node}:{c.from_pin}" == k for c in connections)
    ]
    if unresolved:
        raise ValidationFailure(f"could not resolve Passthrough types for: {unresolved}")
    return resolved


async def wire_and_spawn_graph(
    nodes: Dict[str, ProcessorNode],
    pipeline: Pipeline,
    *,
    io_channels: Optional[Dict[Tuple[str, str], Channel]] = None,
    state_tx: Optional[Channel] = None,
    stats_tx: Optional[Channel] = None,
    telemetry_tx: Optional[Channel] = None,
    cancellation: Optional[asyncio.Event] = None,
    session_id: Optional[str] = None,
    media_capacity: int = constants.ONESHOT_MEDIA_CAPACITY,
    audio_pool=None,
    resources=None,
    batcher=None,
) -> WiredGraph:
    """Validate, wire, and spawn a static pipeline graph.

    ``io_channels`` maps ``(node_name, "in"|"out")`` to externally-owned
    channels (HTTP body in / response out) that bypass connection wiring.
    """
    connections = pipeline.connections
    cancellation = cancellation or asyncio.Event()

    # ---- fan-out wiring plan (exceeds reference: graph_builder.rs:71-85
    # rejects this; here one output pin may feed several destinations)
    fanout_groups: Dict[str, List[Connection]] = {}
    for c in connections:
        fanout_groups.setdefault(f"{c.from_node}:{c.from_pin}", []).append(c)
    seen_inputs: Dict[str, Connection] = {}
    for c in connections:
        key = f"{c.to_node}:{c.to_pin}"
        if key in seen_inputs:
            raise ValidationFailure(f"input pin {key} has multiple incoming connections")
        seen_inputs[key] = c

    # ---- Tier-1 initialize pass (graph_builder.rs:90-120)
    input_pins: Dict[str, List[InputPin]] = {}
    output_pins: Dict[str, List[OutputPin]] = {}
    for name, node in nodes.items():
        update = await node.initialize()
        if isinstance(update, PinUpdate.Updated):
            input_pins[name] = update.inputs
            output_pins[name] = update.outputs
        else:
            input_pins[name] = node.input_pins()
            output_pins[name] = node.output_pins()

    # ---- type inference + validation
    resolved = resolve_passthrough_types(nodes, input_pins, output_pins, connections)
    for c in connections:
        if c.from_node not in nodes:
            raise ValidationFailure(f"connection references unknown node {c.from_node!r}")
        if c.to_node not in nodes:
            raise ValidationFailure(f"connection references unknown node {c.to_node!r}")
        out_pin = _find_output_pin(output_pins[c.from_node], c.from_pin)
        if out_pin is None:
            raise ValidationFailure(f"node {c.from_node!r} has no output pin {c.from_pin!r}")
        in_pin = _find_input_pin(input_pins[c.to_node], c.to_pin)
        if in_pin is None:
            raise ValidationFailure(f"node {c.to_node!r} has no input pin {c.to_pin!r}")
        out_type = resolved[f"{c.from_node}:{c.from_pin}"]
        accepts = in_pin.accepts_types
        # a Passthrough input accepts whatever (it forwards); Any likewise
        if not any(t.is_passthrough for t in accepts) and not can_connect_any(out_type, accepts):
            raise ValidationFailure(
                f"type mismatch: {c.from_node}:{c.from_pin} produces {out_type.display()} "
                f"but {c.to_node}:{c.to_pin} accepts "
                f"[{', '.join(t.display() for t in accepts)}]"
            )

    # ---- channel creation + context assembly
    io_channels = io_channels or {}
    graph = WiredGraph()
    inputs_map: Dict[str, Dict[str, Channel]] = {n: {} for n in nodes}
    outputs_map: Dict[str, Dict[str, Channel]] = {n: {} for n in nodes}

    for key, group in fanout_groups.items():
        branches: List[Channel] = []
        for c in group:
            ch = Channel(media_capacity, name=c.id)
            graph.channels.append(ch)
            inputs_map[c.to_node][c.to_pin] = ch
            branches.append(ch)
        first = group[0]
        outputs_map[first.from_node][first.from_pin] = (
            branches[0] if len(branches) == 1 else _FanoutChannel(branches, name=key)
        )

    for (node_name, direction), ch in io_channels.items():
        if direction == "in":
            inputs_map[node_name]["in"] = ch
        else:
            outputs_map[node_name]["out"] = ch

    for name, node in nodes.items():
        control = Channel(constants.CONTROL_CHANNEL_CAPACITY, name=f"{name}:control")
        graph.control_txs[name] = control
        ctx = NodeContext(
            node_name=name,
            inputs=inputs_map[name],
            control_rx=control,
            output=OutputSender(name, direct=outputs_map[name]),
            batch_size=constants.PACKET_BATCH_SIZE,
            state_tx=state_tx,
            stats_tx=stats_tx,
            telemetry_tx=telemetry_tx,
            session_id=session_id,
            cancellation=cancellation,
            audio_pool=audio_pool,
            params=pipeline.nodes[name].params if name in pipeline.nodes else None,
            resources=resources,
            batcher=batcher,
        )
        graph.contexts[name] = ctx

    # ---- spawn (graph_builder.rs:310-430)
    for name, node in nodes.items():
        graph.tasks[name] = asyncio.ensure_future(_run_node(node, graph.contexts[name]))
    return graph


async def _run_node(node: ProcessorNode, ctx: NodeContext) -> None:
    """Run a node task with final-state reporting and EOF propagation."""
    from ..utils.tracing import get_tracer

    # reference: info_span!("node_run", node.name, node.kind)
    # (graph_builder.rs:421)
    span = get_tracer().span(
        "node_run",
        {
            "node.name": ctx.node_name,
            "node.kind": getattr(node, "KIND", type(node).__name__),
            "session.id": ctx.session_id or "",
        },
    )
    try:
        with span:
            await node.run(ctx)
    except asyncio.CancelledError:
        emit_state(ctx.state_tx, ctx.node_name, NodeState.stopped(StopReason.SHUTDOWN))
        raise
    except StreamKitError as e:
        log.error("node %s failed: %s", ctx.node_name, e)
        emit_state(ctx.state_tx, ctx.node_name, NodeState.failed(str(e)))
        raise
    except Exception as e:  # noqa: BLE001
        log.exception("node %s crashed", ctx.node_name)
        emit_state(ctx.state_tx, ctx.node_name, NodeState.failed(f"{type(e).__name__}: {e}"))
        raise
    finally:
        ctx.release()
        # EOF propagation: downstream sees closed inputs and drains out
        if ctx.output is not None:
            ctx.output.close()
