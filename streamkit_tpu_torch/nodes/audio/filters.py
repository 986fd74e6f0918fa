# SPDX-License-Identifier: Apache-2.0
"""Audio filter nodes: gain, resampler, mixer — device-computed.

Parity targets:
* ``audio::gain`` — ``nodes/src/audio/filters/gain.rs`` (COW in-place f32
  multiply, live-tunable 0–4 via UpdateParams)
* ``audio::resampler`` — ``nodes/src/audio/filters/resampler.rs`` (fixed
  chunk_frames, exact Opus output frame sizes, stream-state init on first
  frame, hard error on mid-stream format change)
* ``audio::mixer`` — ``nodes/src/audio/filters/mixer.rs`` broadcast-sync
  mode (one frame per input per round, missing/EOF pins → silence/retired,
  channel up/down-mix); the clocked mode lives in the dynamic engine.

Port of ``streamkit_tpu/nodes/audio/filters.py``. The sample math runs
through :mod:`streamkit_tpu_torch.ops` on the device the node was registered
with (``register_nodes(device=)``); with a batcher, gain frames and
slot-table resampler chunks of all sessions batch into one call per kind.
The per-node host loop is only packet plumbing.
"""

from __future__ import annotations

import asyncio
import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ...core import (
    AudioFormat,
    AudioFrame,
    ChannelClosed,
    ChannelFull,
    ConfigurationError,
    InputPin,
    NodeContext,
    NodeStatsTracker,
    OutputPin,
    Packet,
    PacketMetadata,
    PacketType,
    PinCardinality,
    ProcessorNode,
    RuntimeNodeError,
    parse_config_optional,
    require_param,
)
from ...core.state import NodeState, StopReason
from ...device import resolve_device
from ...ops.dsp import apply_gain, mix_frames
from ...ops.resample import (
    LinearResampler,
    RubatoResampler,
    max_output_frames,
    resample_chunk,
)


def opus_frame_sizes(rate: int) -> tuple:
    """The Opus frame sizes (2.5, 5, 10, 20, 40 and 60 ms) at ``rate``.

    The JAX package checks ``output_frame_size`` against the 48 kHz sizes
    whatever the target rate, so it refuses ``live_captions.yml``'s 20 ms
    frames at 16 kHz (320); the port checks against the target rate's own
    sizes (the same set at 48 kHz)."""
    return tuple(rate * q // 400 for q in (1, 2, 4, 8, 16, 24)) if rate % 400 == 0 else ()


class GainNode(ProcessorNode):
    """Multiplies samples by a tunable gain (``audio::gain``)."""

    KIND = "audio::gain"

    def __init__(self, params: Optional[dict], device=None) -> None:
        cfg = parse_config_optional(params, {"gain": 1.0})
        self.gain = float(cfg["gain"])
        self._validate(self.gain)
        self.device = resolve_device(device)

    @staticmethod
    def _validate(g: float) -> None:
        if not (0.0 <= g <= 4.0):  # reference gain.rs:16-67 range
            raise ConfigurationError(f"gain must be in [0, 4], got {g}")

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.raw_audio()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.passthrough())]

    def device_fn(self):
        return apply_gain

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        dev = self.device
        # continuous batching: gain frames from all sessions fuse into one
        # [B, n] * [B, 1] device call per tick
        if ctx.batcher is not None:
            ctx.batcher.register(
                "audio::gain",
                lambda samples_b, gains_b: samples_b.to(dev) * gains_b.to(dev)[:, None],
                max_batch=256,
            )
        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                msg = ctx.poll_control()
                if msg and msg.op == "update_params" and isinstance(msg.params, dict):
                    g = float(msg.params.get("gain", self.gain))
                    self._validate(g)
                    self.gain = g
                if pkt.audio is None:
                    stats.packet_discarded()
                    continue
                if ctx.batcher is not None:
                    # pow-2 length bucketing: raw per-packet lengths would
                    # make every distinct size its own (kind, shape)
                    # coalescing group under mixed-length traffic. Padded
                    # tail is sliced off after the call (gain is elementwise).
                    n = pkt.audio.samples.size
                    bucket = max(128, 1 << (n - 1).bit_length())
                    buf = pkt.audio.samples
                    if bucket != n:
                        buf = np.zeros(bucket, dtype=np.float32)
                        buf[:n] = pkt.audio.samples
                    out = await ctx.batcher.submit("audio::gain", buf, np.float32(self.gain))
                    out = np.asarray(out)[:n]
                else:
                    samples = torch.tensor(pkt.audio.samples, device=dev)
                    out = apply_gain(samples, self.gain).cpu().numpy()
                frame = AudioFrame(out, pkt.audio.format)
                await ctx.output.send("out", Packet.new_audio(frame, pkt.metadata))
                stats.packet_sent()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))


class ResamplerNode(ProcessorNode):
    """Sample-rate conversion with exact output framing (``audio::resampler``)."""

    KIND = "audio::resampler"

    def __init__(self, params: Optional[dict], device=None) -> None:
        cfg = parse_config_optional(
            params,
            {
                "target_sample_rate": 48000,
                "chunk_frames": 960,
                "output_frame_size": 960,
                # "device": chunks batch across sessions into slot-table
                # device calls (oneshot/bulk: big chunks amortize dispatch).
                # "host": the identical LinearResampler arithmetic on the
                # host — the right choice for 20 ms live streams at high
                # session counts, where a per-chunk device dispatch costs
                # more than the 960-sample interpolation itself. Same
                # algorithm, byte-identical output.
                "backend": "device",
                # "rubato" (default): bit-exact reference parity — rubato
                # FastFixedIn/Linear's f64 ratio accumulator semantics
                # (resampler.rs:231-244), host-resident (sequential f64
                # state), golden-tested bit-for-bit vs a scalar oracle.
                # "exact": this repo's zero-drift rational-phase spec
                # (ops/resample.py) — the slot-table form; identical to
                # rubato at integer ratios up to stream priming/offset.
                "compat": "rubato",
            },
        )
        if params is not None:
            require_param(params, "target_sample_rate")
        self.target_rate = int(cfg["target_sample_rate"])
        self.chunk_frames = int(cfg["chunk_frames"])
        self.output_frame_size = int(cfg["output_frame_size"])
        self.backend = str(cfg["backend"])
        if self.backend not in ("device", "host"):
            raise ConfigurationError("backend must be device|host")
        self.compat = str(cfg["compat"])
        if self.compat not in ("rubato", "exact"):
            raise ConfigurationError("compat must be rubato|exact")
        if self.target_rate <= 0:
            raise ConfigurationError("target_sample_rate must be greater than 0")
        if self.chunk_frames <= 0:
            raise ConfigurationError("chunk_frames must be greater than 0")
        sizes = opus_frame_sizes(self.target_rate)
        if self.output_frame_size != 0 and self.output_frame_size not in sizes:
            raise ConfigurationError(f"output_frame_size must be 0 (disabled) or one of {sizes}")
        self.device = resolve_device(device)

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.raw_audio()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.raw_audio(AudioFormat(self.target_rate, 0)))]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        resampler: Optional[LinearResampler] = None
        batched: Optional[tuple] = None  # (kind, table, slot) when batching
        in_fmt: Optional[AudioFormat] = None
        in_buf = np.zeros(0, dtype=np.float32)
        out_buf = np.zeros(0, dtype=np.float32)
        total_in_frames = 0
        total_out_frames = 0
        out_fmt: Optional[AudioFormat] = None

        async def emit_frames(final: bool) -> None:
            nonlocal out_buf
            assert out_fmt is not None
            fsize = self.output_frame_size * out_fmt.channels if self.output_frame_size else 0
            while True:
                if fsize:
                    if len(out_buf) < fsize:
                        break
                    chunk, out_buf = out_buf[:fsize], out_buf[fsize:]
                else:
                    if len(out_buf) == 0:
                        break
                    chunk, out_buf = out_buf, np.zeros(0, dtype=np.float32)
                frame = AudioFrame(chunk, out_fmt)
                meta = PacketMetadata(duration_us=frame.duration_us())
                await ctx.output.send("out", Packet.new_audio(frame, meta))
                stats.packet_sent()
            if final and len(out_buf) > 0 and self.output_frame_size:
                # pad the final partial frame to the exact size (reference flush)
                pad = np.zeros(fsize - len(out_buf), dtype=np.float32)
                frame = AudioFrame(np.concatenate([out_buf, pad]), out_fmt)
                out_buf = np.zeros(0, dtype=np.float32)
                await ctx.output.send(
                    "out", Packet.new_audio(frame, PacketMetadata(duration_us=frame.duration_us()))
                )
                stats.packet_sent()

        try:
            while True:
                batch = await ctx.recv_batch("in")
                if batch is None:
                    break
                new_samples = []
                for pkt in batch:
                    stats.packet_received()
                    if pkt.audio is None:
                        stats.packet_discarded()
                        continue
                    fmt = pkt.audio.format
                    if in_fmt is None:
                        in_fmt = fmt
                        out_fmt = AudioFormat(self.target_rate, fmt.channels)
                        if self.compat == "rubato":
                            # reference-parity mode: host-resident f64
                            # accumulator (inherently sequential state) —
                            # never the device slot table
                            resampler = RubatoResampler(
                                fmt.sample_rate, self.target_rate,
                                self.chunk_frames, fmt.channels,
                            )
                        else:
                            resampler = LinearResampler(
                                fmt.sample_rate, self.target_rate, self.chunk_frames, fmt.channels
                            )
                        if (
                            ctx.batcher is not None
                            and self.backend == "device"
                            and self.compat != "rubato"
                        ):
                            # per-session phase/history live in a device slot
                            # table; chunks from all sessions batch per config
                            batched = _resampler_slot_kind(
                                ctx.batcher, fmt.sample_rate, self.target_rate,
                                self.chunk_frames, fmt.channels, self.device,
                            )
                    elif fmt != in_fmt:
                        raise RuntimeNodeError(
                            f"mid-stream format change: {in_fmt} -> {fmt} (not supported)"
                        )
                    new_samples.append(pkt.audio.samples)
                if not new_samples:
                    continue
                new_samples.insert(0, in_buf)
                in_buf = np.concatenate(new_samples)
                chunk_samples = self.chunk_frames * in_fmt.channels
                if batched is not None:
                    # fixed-shape device chunks (slot-table program)
                    while len(in_buf) >= chunk_samples:
                        chunk, in_buf = in_buf[:chunk_samples], in_buf[chunk_samples:]
                        kind, table, slot = batched
                        deint = chunk.reshape(self.chunk_frames, in_fmt.channels)
                        out_block, n_valid = await ctx.batcher.submit(
                            kind, np.int32(slot), deint
                        )
                        out = np.asarray(out_block)[: int(n_valid)].reshape(-1)
                        total_in_frames += self.chunk_frames
                        total_out_frames += len(out) // in_fmt.channels
                        out_buf = np.concatenate([out_buf, out])
                        await emit_frames(final=False)
                elif len(in_buf) >= chunk_samples:
                    # host path is length-agnostic: resample EVERYTHING
                    # buffered in ONE numpy call (per-chunk calls dominated
                    # ingress cost at 128 sessions)
                    n_chunks = len(in_buf) // chunk_samples
                    take = n_chunks * chunk_samples
                    chunk, in_buf = in_buf[:take], in_buf[take:]
                    out = resampler.process(chunk)
                    total_in_frames += n_chunks * self.chunk_frames
                    total_out_frames += len(out) // in_fmt.channels
                    out_buf = np.concatenate([out_buf, out])
                    await emit_frames(final=False)
            if self.compat == "rubato" and resampler is not None and in_fmt is not None:
                # reference EOF semantics: any buffered-but-unchunked input
                # plus the node-level remainder run through a FRESH resampler
                # sized to the remainder (resampler.rs:558-570)
                if len(in_buf):
                    out_buf = np.concatenate([out_buf, resampler.process(in_buf)])
                out_buf = np.concatenate([out_buf, resampler.flush()])
                await emit_frames(final=True)
            # EOF flush (exact mode): pad the remainder to a full chunk, emit
            # only the exact number of outputs owed (rational bookkeeping)
            elif resampler is not None and in_fmt is not None:
                rem_frames = len(in_buf) // in_fmt.channels
                total_in_frames += rem_frames
                owed = -(-total_in_frames * resampler.dst_num // resampler.src_num)  # ceil
                owed -= total_out_frames
                if owed > 0:
                    pad_frames = self.chunk_frames - rem_frames
                    padded = np.concatenate(
                        [in_buf, np.zeros(pad_frames * in_fmt.channels, dtype=np.float32)]
                    )
                    if batched is not None:
                        kind, table, slot = batched
                        deint = padded.reshape(self.chunk_frames, in_fmt.channels)
                        out_block, n_valid = await ctx.batcher.submit(
                            kind, np.int32(slot), deint
                        )
                        out = np.asarray(out_block)[: int(n_valid)].reshape(-1)
                    else:
                        out = resampler.process(padded)
                    out = out[: owed * in_fmt.channels]
                    out_buf = np.concatenate([out_buf, out])
                await emit_frames(final=True)
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        finally:
            if batched is not None:
                _, table, slot = batched
                table.free(slot)
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))


# shared resampler slot tables, keyed by (kind, resolved device): one table
# per configuration and physical device, whichever alias named the device
_RESAMPLER_TABLES: Dict[tuple, tuple] = {}
_RESAMPLER_LOCK = threading.Lock()


def _resampler_slot_kind(batcher, src_rate: int, dst_rate: int, chunk: int, channels: int, device=None):
    """Device-resident (phase, history) rows + batched resample step on
    ``device``; returns ``(kind, table, slot)``. The kind is registered with
    ``host_inputs=True``: the batch arrives unpadded (a padded batch repeats
    its last slot, which the table refuses) and the step moves it to the
    table's device."""
    from ...engine.slots import SlotTable

    dev = resolve_device(device)
    g = math.gcd(src_rate, dst_rate)
    src_num, dst_num = src_rate // g, dst_rate // g
    max_out = max_output_frames(chunk, src_rate, dst_rate)
    kind = f"resample:{src_rate}:{dst_rate}:{chunk}:{channels}"
    with _RESAMPLER_LOCK:
        entry = _RESAMPLER_TABLES.get((kind, str(dev)))
        if entry is None:
            def init_row():
                return {
                    "phase": torch.tensor(dst_num, dtype=torch.int32),
                    "history": torch.zeros((channels,), dtype=torch.float32),
                }

            table = SlotTable(init_row, max_slots=256, device=dev)

            def fn(rows, chunks_b):
                out, n_valid, new_phase, new_hist = resample_chunk(
                    rows["history"], chunks_b, rows["phase"], src_num, dst_num, max_out
                )
                return {"phase": new_phase, "history": new_hist}, out, n_valid

            entry = (table, table.make_step(fn))
            _RESAMPLER_TABLES[(kind, str(dev))] = entry
    batcher.register(kind, entry[1], max_batch=128, host_inputs=True)
    if batcher.registered_kinds()[kind].fn is not entry[1]:
        raise ConfigurationError(f"batch kind {kind} already serves another device's slot table")
    return kind, entry[0], entry[0].alloc()


def resampler_slot_table(src_rate: int, dst_rate: int, chunk: int, channels: int, device=None):
    """The shared slot table of one ``compat: exact`` resampler configuration
    on ``device`` (``None`` before a node has used it): its ``in_use`` count
    shows whether every session freed its slot."""
    entry = _RESAMPLER_TABLES.get((f"resample:{src_rate}:{dst_rate}:{chunk}:{channels}", str(resolve_device(device))))
    return None if entry is None else entry[0]


class MixerNode(ProcessorNode):
    """N-input audio mixer, broadcast-synchronized mode (``audio::mixer``)."""

    KIND = "audio::mixer"

    def __init__(self, params: Optional[dict], device=None) -> None:
        cfg = parse_config_optional(
            params,
            {
                "num_inputs": None,
                "sync_timeout_ms": 200,
                "output_channels": None,
                # clocked mode (reference ClockedMixerConfig, mixer.rs:23-54)
                "clocked": False,
                "frame_samples_per_channel": 960,
                "sample_rate": 48000,
                "jitter_buffer_frames": 3,
                "generate_silence": True,
            },
        )
        self.num_inputs = int(cfg["num_inputs"]) if cfg["num_inputs"] else None
        self.sync_timeout = float(cfg["sync_timeout_ms"]) / 1000.0
        self.output_channels = cfg["output_channels"]
        self.clocked = bool(cfg["clocked"])
        self.frame_samples = int(cfg["frame_samples_per_channel"])
        self.clock_rate = int(cfg["sample_rate"])
        self.jitter_frames = int(cfg["jitter_buffer_frames"])
        self.generate_silence = bool(cfg["generate_silence"])
        self.device = resolve_device(device)

    def _mix(self, frames: List[AudioFrame], out_channels: int, out_samples: int) -> np.ndarray:
        """Mix on the node's device; the result comes back to the host."""
        return mix_frames(
            [torch.tensor(f.samples, device=self.device) for f in frames],
            [f.format.channels for f in frames],
            out_channels,
            out_samples,
        ).cpu().numpy()

    def supports_dynamic_pins(self) -> bool:
        return True

    def input_pins(self) -> List[InputPin]:
        if self.num_inputs:
            if self.num_inputs == 1:
                return [InputPin("in", [PacketType.raw_audio()])]
            return [
                InputPin(f"in_{i}", [PacketType.raw_audio()]) for i in range(self.num_inputs)
            ]
        return [InputPin("in", [PacketType.raw_audio()], PinCardinality.dynamic("in"))]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.raw_audio())]

    async def run(self, ctx: NodeContext) -> None:
        if self.clocked:
            await self._run_clocked(ctx)
            return
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        retired: set = set()  # pins that reached EOF
        out_fmt: Optional[AudioFormat] = None
        saw_pins = False
        try:
            while not ctx.cancelled:
                # dynamic mode: pins may be added/removed while running — take
                # a fresh view each round (reference run_dynamic, mixer.rs:448)
                open_pins = {p: ch for p, ch in ctx.inputs.items() if p not in retired}
                if not open_pins:
                    if saw_pins or ctx.inputs:
                        break  # all pins retired → input closed
                    await asyncio.sleep(0.01)  # waiting for first connection
                    continue
                saw_pins = True
                # one synchronized round: one frame per open pin. Phase 1 —
                # poll all pins fairly until any produces (or all retire);
                # phase 2 — give stragglers sync_timeout, then mix without
                # them (missing pins → silence, reference mixer.rs:448).
                frames: List[AudioFrame] = []
                got: dict = {}
                deadline: Optional[float] = None
                while not ctx.cancelled:
                    progress = False
                    for pin in sorted(open_pins):
                        if pin in got:
                            continue
                        try:
                            pkt = open_pins[pin].try_recv()
                        except ChannelClosed:
                            retired.add(pin)
                            continue
                        except ChannelFull:  # empty (would block)
                            continue
                        progress = True
                        if pkt.audio is not None:
                            stats.packet_received()
                            got[pin] = pkt.audio
                    open_pins = {p: c for p, c in open_pins.items() if p not in retired}
                    if not open_pins or len(got) == len(open_pins):
                        break
                    if got and deadline is None:
                        deadline = time.monotonic() + self.sync_timeout
                    if deadline is not None and time.monotonic() >= deadline:
                        break
                    if not progress:
                        await asyncio.sleep(0.002)
                frames = [got[p] for p in sorted(got)]
                if not frames:
                    continue
                if out_fmt is None:
                    ch_out = int(self.output_channels or frames[0].format.channels)
                    out_fmt = AudioFormat(frames[0].format.sample_rate, ch_out)
                out_frames = max(f.frames_per_channel for f in frames)
                out_samples = out_frames * out_fmt.channels
                mixed = self._mix(frames, out_fmt.channels, out_samples)
                frame = AudioFrame(mixed, out_fmt)
                await ctx.output.send(
                    "out", Packet.new_audio(frame, PacketMetadata(duration_us=frame.duration_us()))
                )
                stats.packet_sent()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))


# appended to MixerNode: clocked mode implementation
async def _mixer_run_clocked(self, ctx: NodeContext) -> None:
    """Clocked mode (reference ``run_clocked_audio_thread``, mixer.rs:1242):

    a steady tick at ``frame_samples_per_channel / sample_rate`` pulls one
    frame per input from per-pin jitter buffers (bounded deques,
    overwrite-oldest — reference's lock-free rings) and mixes whatever is
    present; missing inputs are silence. The reference dedicates an OS
    thread; here a paced asyncio task gives the same cadence, and the mix
    itself is the batched device kernel.
    """
    import collections

    ctx.emit_state(NodeState.running())
    stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
    out_ch_count = int(self.output_channels or 1)
    fmt = AudioFormat(self.clock_rate, out_ch_count)
    tick = self.frame_samples / self.clock_rate
    jitter: Dict[str, collections.deque] = {}
    eof: set = set()
    seq = 0

    async def fill_jitter() -> None:
        """Drain input pins into jitter rings (overwrite-oldest)."""
        for pin, ch in list(ctx.inputs.items()):
            ring = jitter.setdefault(pin, collections.deque(maxlen=self.jitter_frames))
            while True:
                try:
                    pkt = ch.try_recv()
                except ChannelClosed:
                    eof.add(pin)
                    break
                except ChannelFull:  # empty
                    break
                if pkt.audio is not None:
                    stats.packet_received()
                    ring.append(pkt.audio)  # deque(maxlen) drops oldest

    next_tick = time.monotonic()
    try:
        while not ctx.cancelled:
            await fill_jitter()
            open_pins = [p for p in ctx.inputs if p not in eof]
            if not open_pins and jitter and all(not r for r in jitter.values()):
                break  # all inputs closed and drained
            frames = []
            for pin in sorted(jitter):
                ring = jitter[pin]
                if ring:
                    frames.append(ring.popleft())
            if frames or self.generate_silence:
                out_samples = self.frame_samples * out_ch_count
                if frames:
                    mixed = self._mix(frames, out_ch_count, out_samples)
                else:
                    mixed = np.zeros(out_samples, dtype=np.float32)
                frame = AudioFrame(mixed, fmt)
                await ctx.output.send(
                    "out",
                    Packet.new_audio(
                        frame,
                        PacketMetadata(
                            timestamp_us=int(seq * tick * 1e6),
                            duration_us=frame.duration_us(),
                            sequence=seq,
                        ),
                    ),
                )
                seq += 1
                stats.packet_sent()
            next_tick += tick
            delay = next_tick - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            else:
                next_tick = time.monotonic()  # fell behind: reset clock
    except ChannelClosed:
        ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
        stats.flush()
        return
    stats.flush()
    ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))


MixerNode._run_clocked = _mixer_run_clocked
