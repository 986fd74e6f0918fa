# SPDX-License-Identifier: Apache-2.0
"""Telemetry observation nodes.

Parity targets:
* ``core::telemetry_tap`` — ``nodes/src/core/telemetry_tap.rs:48-70``:
  passthrough that observes packets and emits telemetry events
  (packet-type filter, glob event filter, rate limit, audio-level sampling)
* ``core::telemetry_out`` — ``nodes/src/core/telemetry_out.rs:5-9``:
  terminal node forwarding packets to the session telemetry bus
"""

from __future__ import annotations

import fnmatch
from typing import List, Optional

import numpy as np

from ...core import (
    ChannelClosed,
    InputPin,
    NodeContext,
    NodeStatsTracker,
    OutputPin,
    Packet,
    PacketType,
    ProcessorNode,
    TelemetryEmitter,
    parse_config_optional,
)
from ...core.state import NodeState, StopReason


def _packet_summary(pkt: Packet, sample_audio_level: bool) -> dict:
    d: dict = {"packet_kind": pkt.kind.value}
    if pkt.metadata:
        if pkt.metadata.timestamp_us is not None:
            d["timestamp_us"] = pkt.metadata.timestamp_us
        if pkt.metadata.sequence is not None:
            d["sequence"] = pkt.metadata.sequence
    if pkt.audio is not None:
        d["sample_rate"] = pkt.audio.format.sample_rate
        d["channels"] = pkt.audio.format.channels
        d["frames"] = pkt.audio.frames_per_channel
        if sample_audio_level:
            s = pkt.audio.samples
            d["rms"] = float(np.sqrt(np.mean(s * s))) if len(s) else 0.0
            d["peak"] = float(np.abs(s).max()) if len(s) else 0.0
    elif pkt.text is not None:
        d["text_len"] = len(pkt.text)
    elif pkt.transcription is not None:
        d["text"] = pkt.transcription.text
    elif pkt.custom is not None:
        d["type_id"] = pkt.custom.type_id
    elif pkt.binary is not None:
        d["bytes"] = len(pkt.binary)
        d["content_type"] = pkt.content_type
    return d


class TelemetryTapNode(ProcessorNode):
    """Observes packets in-line and emits telemetry (``core::telemetry_tap``)."""

    KIND = "core::telemetry_tap"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(
            params,
            {
                "event_type": "tap.packet",
                "packet_kinds": None,  # e.g. ["audio", "text"]; None = all
                "event_filter": "*",  # glob applied to event_type
                "max_events_per_sec": 10.0,
                "sample_audio_level": True,
            },
        )
        self.event_type = str(cfg["event_type"])
        self.packet_kinds = cfg["packet_kinds"]
        self.event_filter = str(cfg["event_filter"])
        self.rate = float(cfg["max_events_per_sec"])
        self.sample_audio_level = bool(cfg["sample_audio_level"])

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.any()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.passthrough())]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        emitter = TelemetryEmitter(ctx.node_name, ctx.telemetry_tx, self.rate)
        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                observe = self.packet_kinds is None or pkt.kind.value in self.packet_kinds
                if observe and fnmatch.fnmatch(self.event_type, self.event_filter):
                    emitter.emit(self.event_type, _packet_summary(pkt, self.sample_audio_level))
                await ctx.output.send("out", pkt)
                stats.packet_sent()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))


class TelemetryOutNode(ProcessorNode):
    """Terminal node: forwards packets to the telemetry bus (``core::telemetry_out``)."""

    KIND = "core::telemetry_out"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(
            params, {"event_type": "telemetry.packet", "max_events_per_sec": 50.0}
        )
        self.event_type = str(cfg["event_type"])
        self.rate = float(cfg["max_events_per_sec"])

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.any()])]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        emitter = TelemetryEmitter(ctx.node_name, ctx.telemetry_tx, self.rate)
        while True:
            pkt = await ctx.recv_with_cancellation("in")
            if pkt is None:
                break
            stats.packet_received()
            # Custom packets keep their own payload; others get a summary
            if pkt.custom is not None:
                emitter.emit(
                    self.event_type,
                    {"type_id": pkt.custom.type_id, "data": pkt.custom.data},
                    timestamp_us=pkt.metadata.timestamp_us if pkt.metadata else None,
                )
            else:
                emitter.emit(self.event_type, _packet_summary(pkt, True))
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))
