# SPDX-License-Identifier: Apache-2.0
"""Basic core nodes: passthrough, sink, bytes input/output (oneshot roles).

Parity targets:
* ``core::passthrough`` — ``nodes/src/core/passthrough.rs`` (no-op forwarder)
* ``core::sink`` — ``nodes/src/core/sink.rs`` (terminal discard)
* ``streamkit::http_input`` — ``nodes/src/core/bytes_input.rs:18-28``
* ``streamkit::http_output`` — ``nodes/src/core/bytes_output.rs:17-53``
"""

from __future__ import annotations

from typing import List, Optional

from ...core import (
    ChannelClosed,
    InputPin,
    NodeContext,
    NodeStatsTracker,
    OutputPin,
    Packet,
    PacketType,
    PinCardinality,
    ProcessorNode,
    parse_config_optional,
)
from ...core.state import NodeState, StopReason


class PassthroughNode(ProcessorNode):
    """Forwards packets unchanged (``core::passthrough``)."""

    KIND = "core::passthrough"

    def __init__(self, params: Optional[dict]) -> None:
        parse_config_optional(params, {})

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.any()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.passthrough())]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        while True:
            pkt = await ctx.recv_with_cancellation("in")
            if pkt is None:
                break
            stats.packet_received()
            try:
                await ctx.output.send("out", pkt)
            except ChannelClosed:
                ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
                stats.flush()
                return
            stats.packet_sent()
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))


class SinkNode(ProcessorNode):
    """Discards all packets (``core::sink``)."""

    KIND = "core::sink"

    def __init__(self, params: Optional[dict]) -> None:
        parse_config_optional(params, {})

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.any()])]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        while True:
            pkt = await ctx.recv_with_cancellation("in")
            if pkt is None:
                break
            stats.packet_received()
            stats.packet_discarded()
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))


class BytesInputNode(ProcessorNode):
    """Oneshot HTTP-body source: raw bytes chunks → Binary packets.

    The engine injects the body channel as input pin ``in`` (bytes objects,
    not Packets). ``input_content_type`` is set by the oneshot runner.
    """

    KIND = "streamkit::http_input"

    def __init__(self, params: Optional[dict]) -> None:
        parse_config_optional(params, {})
        self.input_content_type: Optional[str] = None

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.binary())]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        ch = ctx.inputs.get("in")
        seq = 0
        while ch is not None:
            chunk = await ch.recv_optional()
            if chunk is None:
                break
            pkt = Packet.new_binary(bytes(chunk), content_type=self.input_content_type)
            try:
                await ctx.output.send("out", pkt)
            except ChannelClosed:
                ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
                return
            seq += 1
        ctx.emit_state(NodeState.stopped(StopReason.COMPLETED))


class BytesOutputNode(ProcessorNode):
    """Oneshot HTTP-response sink: packets → raw bytes chunks.

    Binary packets pass their payload through; Text/Transcription are
    encoded as UTF-8 (reference ``bytes_output.rs:17-53``).
    """

    KIND = "streamkit::http_output"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(params, {"content_type": None})
        self._content_type = cfg["content_type"]

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.any()])]

    def content_type(self) -> Optional[str]:
        return self._content_type

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        out = ctx.output  # direct channel registered under pin "out"
        while True:
            pkt = await ctx.recv_with_cancellation("in")
            if pkt is None:
                break
            if pkt.binary is not None:
                data = pkt.binary
            elif pkt.text is not None:
                data = pkt.text.encode()
            elif pkt.transcription is not None:
                data = pkt.transcription.text.encode()
            else:
                continue  # audio/custom payloads are not valid HTTP bodies
            try:
                await out.send("out", data)
            except ChannelClosed:
                break
        ctx.emit_state(NodeState.stopped(StopReason.COMPLETED))
