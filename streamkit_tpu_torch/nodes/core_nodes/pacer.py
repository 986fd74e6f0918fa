# SPDX-License-Identifier: Apache-2.0
"""Pacing nodes: release packets on their timing metadata.

Parity targets:
* ``core::pacer`` — ``nodes/src/core/pacer.rs:20-66``: speed multiplier,
  bounded internal queue, optional initial burst at 10× speed with a
  >300 ms input-gap reset (per-segment bursts for TTS responses).
* ``audio::pacer`` — ``nodes/src/audio/pacer.rs:34-42``: audio-aware pacer
  that synthesizes silence frames on underrun, keeping a steady clock for
  downstream mixers/encoders; optional ``initial_format`` starts the clock
  before the first frame arrives.
"""

from __future__ import annotations

import asyncio
import time
from typing import List, Optional

import numpy as np

from ...core import (
    AudioFormat,
    AudioFrame,
    ChannelClosed,
    ConfigurationError,
    InputPin,
    NodeContext,
    NodeStatsTracker,
    OutputPin,
    Packet,
    PacketMetadata,
    PacketType,
    ProcessorNode,
    parse_config_optional,
)
from ...core.state import NodeState, StopReason

BURST_SPEEDUP = 10.0
BURST_GAP_RESET_SECS = 0.3  # reference pacer.rs:43-66


def _packet_duration_secs(pkt: Packet) -> float:
    """Timing source preference (reference pacer.rs:60-66)."""
    if pkt.metadata and pkt.metadata.duration_us:
        return pkt.metadata.duration_us / 1e6
    if pkt.audio is not None:
        f = pkt.audio.format
        return pkt.audio.frames_per_channel / f.sample_rate
    return 0.0


class PacerNode(ProcessorNode):
    """Releases packets per duration metadata (``core::pacer``)."""

    KIND = "core::pacer"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(
            params, {"speed": 1.0, "buffer_size": 16, "initial_burst_packets": 0}
        )
        self.speed = float(cfg["speed"])
        self.buffer_size = int(cfg["buffer_size"])
        self.initial_burst = int(cfg["initial_burst_packets"])
        if self.speed <= 0:
            raise ConfigurationError("Speed must be greater than 0")
        if self.buffer_size <= 0:
            raise ConfigurationError("Buffer size must be greater than 0")

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.any()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.passthrough())]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        burst_left = self.initial_burst
        last_recv = time.monotonic()
        next_release = time.monotonic()
        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                now = time.monotonic()
                stats.packet_received()
                # live-tunable speed (reference: UpdateParams control)
                msg = ctx.poll_control()
                if msg and msg.op == "update_params" and isinstance(msg.params, dict):
                    self.speed = float(msg.params.get("speed", self.speed))
                if now - last_recv > BURST_GAP_RESET_SECS:
                    burst_left = self.initial_burst  # new logical segment
                    next_release = now
                last_recv = now
                duration = _packet_duration_secs(pkt) / self.speed
                if burst_left > 0:
                    duration /= BURST_SPEEDUP
                    burst_left -= 1
                delay = next_release - time.monotonic()
                if delay > 0:
                    await asyncio.sleep(delay)
                else:
                    next_release = time.monotonic()  # fell behind: reset clock
                await ctx.output.send("out", pkt)
                stats.packet_sent()
                next_release += duration
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))


class AudioPacerNode(ProcessorNode):
    """Audio pacer that fills underruns with silence (``audio::pacer``)."""

    KIND = "audio::pacer"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(
            params,
            {
                "frame_samples_per_channel": 960,
                "initial_sample_rate": None,
                "initial_channels": None,
                "max_silence_secs": None,  # None = pace forever until EOF
            },
        )
        self.frame_samples = int(cfg["frame_samples_per_channel"])
        self.initial_format = None
        if cfg["initial_sample_rate"]:
            self.initial_format = AudioFormat(
                int(cfg["initial_sample_rate"]), int(cfg["initial_channels"] or 1)
            )
        self.max_silence_secs = cfg["max_silence_secs"]

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.raw_audio()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.raw_audio())]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        fmt = self.initial_format
        ch = ctx.inputs.get("in")
        tick: Optional[float] = None
        next_release = time.monotonic()
        silence_run = 0.0
        try:
            while not ctx.cancelled:
                if fmt is not None and tick is None:
                    tick = self.frame_samples / fmt.sample_rate
                    next_release = time.monotonic()
                if tick is None:
                    # clock not started: block for the first frame
                    pkt = await ctx.recv_with_cancellation("in")
                    if pkt is None:
                        break
                    if pkt.audio is None:
                        continue
                    fmt = pkt.audio.format
                    tick = self.frame_samples / fmt.sample_rate
                    next_release = time.monotonic() + tick
                    await ctx.output.send("out", pkt)
                    stats.packet_received()
                    stats.packet_sent()
                    continue
                # paced loop: take a real frame if available, else synthesize
                delay = next_release - time.monotonic()
                if delay > 0:
                    await asyncio.sleep(delay)
                next_release += tick
                try:
                    pkt = ch.try_recv() if ch is not None else None
                except ChannelClosed:
                    break
                except Exception:
                    pkt = None
                if pkt is not None and pkt.audio is not None:
                    silence_run = 0.0
                    stats.packet_received()
                    fmt = pkt.audio.format
                    await ctx.output.send("out", pkt)
                    stats.packet_sent()
                else:
                    if ch is not None and ch.is_closed:
                        break
                    silence_run += tick
                    if self.max_silence_secs is not None and silence_run > self.max_silence_secs:
                        break
                    assert fmt is not None
                    frame = AudioFrame(
                        np.zeros(self.frame_samples * fmt.channels, dtype=np.float32), fmt
                    )
                    await ctx.output.send(
                        "out",
                        Packet.new_audio(
                            frame,
                            PacketMetadata(duration_us=(self.frame_samples * 1_000_000) // fmt.sample_rate),
                        ),
                    )
                    stats.packet_sent()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))
