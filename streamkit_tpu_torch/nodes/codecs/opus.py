# SPDX-License-Identifier: Apache-2.0
"""Opus codec nodes — host-side entropy coding via libopus (ctypes).

Parity targets: ``audio::opus::decoder`` / ``audio::opus::encoder``
(``nodes/src/audio/codecs/opus.rs:102-535``): decoder outputs 48 kHz f32
(mono or stereo per stream), encoder lazily initializes from the first
frame's format and supports bitrate config. The reference runs libopus on
``spawn_blocking`` threads; here codec calls run in the default executor so
the event loop never blocks (entropy coding stays on the host by design:
it is sequential bit parsing, no work for the card).

Port of ``streamkit_tpu/nodes/codecs/opus.py``. The batched decode goes
through the port's own ingest library (``csrc/ingest.cpp``, built with g++
at first use by :mod:`...ops._build`), never the JAX package's
``native/build`` one.
"""

from __future__ import annotations

import asyncio
import ctypes
import ctypes.util
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
    RuntimeNodeError,
    parse_config_optional,
)
from ...core.state import NodeState, StopReason

_OPUS_APPLICATION_AUDIO = 2049
_OPUS_SET_BITRATE_REQUEST = 4002
_OPUS_SET_COMPLEXITY_REQUEST = 4010
_MAX_FRAME_SAMPLES = 5760  # 120 ms @ 48 kHz
_MAX_PACKET_BYTES = 4000


class OpusLib:
    """Lazy libopus loader."""

    _lib = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls._lib is None:
            name = ctypes.util.find_library("opus") or "libopus.so.0"
            lib = ctypes.CDLL(name)
            lib.opus_decoder_create.restype = ctypes.c_void_p
            lib.opus_decoder_create.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
            ]
            lib.opus_decode_float.restype = ctypes.c_int
            lib.opus_decode_float.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ]
            lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
            lib.opus_encoder_create.restype = ctypes.c_void_p
            lib.opus_encoder_create.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
            ]
            lib.opus_encode_float.restype = ctypes.c_int
            lib.opus_encode_float.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.c_char_p, ctypes.c_int,
            ]
            lib.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
            lib.opus_encoder_ctl.restype = ctypes.c_int
            # variadic: declare the fixed args so the handle isn't truncated
            # to 32 bits (classic ctypes segfault)
            lib.opus_encoder_ctl.argtypes = [ctypes.c_void_p, ctypes.c_int]
            cls._lib = lib
        return cls._lib


def _batch_shim() -> ctypes.CDLL:
    """The port's ingest library (``csrc/ingest.cpp``), built at first use;
    a failed build raises."""
    from ...engine import ingest
    from ...ops import _build

    return _build.load(ingest.SOURCE, ingest._declare)


class OpusDecoder:
    def __init__(self, sample_rate: int = 48000, channels: int = 2) -> None:
        lib = OpusLib.get()
        err = ctypes.c_int(0)
        self._dec = lib.opus_decoder_create(sample_rate, channels, ctypes.byref(err))
        if err.value != 0 or not self._dec:
            raise RuntimeNodeError(f"opus_decoder_create failed: {err.value}")
        self.sample_rate = sample_rate
        self.channels = channels
        self._buf = (ctypes.c_float * (_MAX_FRAME_SAMPLES * channels))()

    def decode(self, packet: bytes) -> np.ndarray:
        lib = OpusLib.get()
        n = lib.opus_decode_float(
            self._dec, packet, len(packet), self._buf, _MAX_FRAME_SAMPLES, 0
        )
        if n < 0:
            raise RuntimeNodeError(f"opus_decode_float error {n}")
        return np.ctypeslib.as_array(self._buf)[: n * self.channels].copy()

    def decode_batch(self, packets) -> list:
        """Decode many packets in ONE native call of the port's ingest
        library (one ctypes round trip per batch instead of per 20 ms
        packet — the marshalling cost of per-packet calls measurably
        dominated ingress at 128 realtime sessions)."""
        if not packets:
            return []
        ctx = self._batch_ctx()
        shim = _batch_shim()
        n = len(packets)
        data = b"".join(packets)
        offsets = np.zeros(n + 1, dtype=np.int32)
        np.cumsum([len(p) for p in packets], out=offsets[1:])
        out = np.empty((n, _MAX_FRAME_SAMPLES * self.channels), dtype=np.float32)
        lens = np.zeros(n, dtype=np.int32)
        shim.skopus_batch_decode(
            ctx, data,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            _MAX_FRAME_SAMPLES,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        results = []
        for i in range(n):
            if lens[i] < 0:
                raise RuntimeNodeError(f"opus_decode_float error {int(lens[i])}")
            results.append(out[i, : int(lens[i]) * self.channels].copy())
        return results

    def _batch_ctx(self):
        """Lazily create the native batch-decoder context."""
        ctx = getattr(self, "_bctx", None)
        if ctx is None:
            ctx = _batch_shim().skopus_batch_create(self.sample_rate, self.channels)
            if not ctx:
                raise RuntimeNodeError("skopus_batch_create failed (libopus not loadable by the shim)")
            self._bctx = ctx
        return ctx

    def __del__(self):
        if getattr(self, "_bctx", None):
            try:
                _batch_shim().skopus_batch_destroy(self._bctx)
            except Exception:
                pass
            self._bctx = None
        if getattr(self, "_dec", None):
            try:
                OpusLib.get().opus_decoder_destroy(self._dec)
            except Exception:
                pass
            self._dec = None


class OpusEncoder:
    def __init__(self, sample_rate: int, channels: int, bitrate: Optional[int] = None) -> None:
        if sample_rate not in (8000, 12000, 16000, 24000, 48000):
            raise ConfigurationError(f"opus does not support {sample_rate} Hz input")
        lib = OpusLib.get()
        err = ctypes.c_int(0)
        self._enc = lib.opus_encoder_create(
            sample_rate, channels, _OPUS_APPLICATION_AUDIO, ctypes.byref(err)
        )
        if err.value != 0 or not self._enc:
            raise RuntimeNodeError(f"opus_encoder_create failed: {err.value}")
        self.sample_rate = sample_rate
        self.channels = channels
        if bitrate:
            lib.opus_encoder_ctl(self._enc, _OPUS_SET_BITRATE_REQUEST, ctypes.c_int(bitrate))
        self._out = ctypes.create_string_buffer(_MAX_PACKET_BYTES)

    def encode(self, pcm: np.ndarray) -> bytes:
        """``pcm``: interleaved f32, must be a valid opus frame size."""
        lib = OpusLib.get()
        frames = len(pcm) // self.channels
        arr = np.ascontiguousarray(pcm, dtype=np.float32)
        ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        n = lib.opus_encode_float(self._enc, ptr, frames, self._out, _MAX_PACKET_BYTES)
        if n < 0:
            raise RuntimeNodeError(f"opus_encode_float error {n}")
        return self._out.raw[:n]

    def __del__(self):
        if getattr(self, "_enc", None):
            try:
                OpusLib.get().opus_encoder_destroy(self._enc)
            except Exception:
                pass
            self._enc = None


class OpusDecoderNode(ProcessorNode):
    """OpusAudio → RawAudio f32 (``audio::opus::decoder``).

    ``sample_rate`` (default 48000) selects the DECODE output rate: Opus
    decoders natively synthesize at any of 8/12/16/24/48 kHz regardless of
    the encode rate (RFC 6716 §2), so a decoder followed by a resampler to
    one of those rates collapses into one node — the YAML compiler's
    fuse-decode-resample pass does exactly that (yaml_compiler.py), saving
    the resample stage AND the per-packet channel hop, and the low-rate
    synthesis itself is cheaper than 48 kHz. The reference's decoder is
    fixed at 48 kHz (``audio/codecs/opus.rs:102-140``); this exceeds it."""

    KIND = "audio::opus::decoder"

    NATIVE_RATES = (8000, 12000, 16000, 24000, 48000)

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(params, {"channels": 1, "sample_rate": 48000})
        self.channels = int(cfg["channels"])
        self.sample_rate = int(cfg["sample_rate"])
        if self.sample_rate not in self.NATIVE_RATES:
            raise ConfigurationError(
                f"opus cannot decode at {self.sample_rate} Hz "
                f"(native rates: {self.NATIVE_RATES})"
            )

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.opus_audio()])]

    def output_pins(self) -> List[OutputPin]:
        return [
            OutputPin(
                "out", PacketType.raw_audio(AudioFormat(self.sample_rate, self.channels))
            )
        ]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        decoder = OpusDecoder(self.sample_rate, self.channels)
        loop = asyncio.get_running_loop()
        fmt = AudioFormat(self.sample_rate, self.channels)

        def decode_batch(packets):
            # ONE executor round trip for the whole greedy batch: a per-20 ms
            # -packet hop costs more event-loop time than the decode itself
            # (the libopus call is ~30 µs; the spawn_blocking parity is kept
            # — decode never runs on the event loop — but amortized, like the
            # reference's batch_packets_greedy ingestion). Inside, the whole
            # batch is ONE native call of the port's ingest library.
            return decoder.decode_batch(packets)

        try:
            while True:
                batch = await ctx.recv_batch("in")
                if batch is None:
                    break
                payloads = []
                metas = []
                for pkt in batch:
                    stats.packet_received()
                    if pkt.binary is None:
                        stats.packet_discarded()
                        continue
                    payloads.append(pkt.binary)
                    metas.append(pkt.metadata)
                if not payloads:
                    continue
                pcms = await loop.run_in_executor(None, decode_batch, payloads)
                for pcm, in_meta in zip(pcms, metas):
                    frame = AudioFrame(pcm, fmt)
                    meta = PacketMetadata(
                        timestamp_us=in_meta.timestamp_us if in_meta else None,
                        duration_us=frame.duration_us(),
                        sequence=in_meta.sequence if in_meta else None,
                    )
                    await ctx.output.send("out", Packet.new_audio(frame, meta))
                    stats.packet_sent()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))


class OpusEncoderNode(ProcessorNode):
    """RawAudio → OpusAudio (``audio::opus::encoder``). Lazy init from first
    frame's format (reference ``opus.rs:453-535``)."""

    KIND = "audio::opus::encoder"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(
            params, {"bitrate": 64000, "frame_size": 960, "complexity": None}
        )
        self.bitrate = int(cfg["bitrate"])
        self.frame_size = int(cfg["frame_size"])  # samples per opus frame @48k
        if self.frame_size not in (120, 240, 480, 960, 1920, 2880):
            raise ConfigurationError(
                f"opus encoder: invalid frame_size {self.frame_size} "
                "(valid: 120/240/480/960/1920/2880 @48kHz)"
            )

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.raw_audio()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.opus_audio())]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        encoder: Optional[OpusEncoder] = None
        buf = np.zeros(0, dtype=np.float32)
        frame_samples = self.frame_size  # samples @48k per channel (default 20 ms)
        loop = asyncio.get_running_loop()
        seq = 0
        fmt: Optional[AudioFormat] = None
        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                if pkt.audio is None:
                    stats.packet_discarded()
                    continue
                if encoder is None:
                    fmt = pkt.audio.format
                    frame_samples = (fmt.sample_rate * 20) // 1000
                    encoder = OpusEncoder(fmt.sample_rate, fmt.channels, self.bitrate)
                elif pkt.audio.format != fmt:
                    raise RuntimeNodeError("mid-stream format change not supported by opus encoder")
                buf = np.concatenate([buf, pkt.audio.samples])
                chunk = frame_samples * fmt.channels
                while len(buf) >= chunk:
                    pcm, buf = buf[:chunk], buf[chunk:]
                    data = await loop.run_in_executor(None, encoder.encode, pcm)
                    dur = (frame_samples * 1_000_000) // fmt.sample_rate
                    meta = PacketMetadata(timestamp_us=seq * dur, duration_us=dur, sequence=seq)
                    seq += 1
                    await ctx.output.send(
                        "out", Packet.new_binary(data, content_type="audio/opus", metadata=meta)
                    )
                    stats.packet_sent()
            # EOF: pad the final partial frame with silence
            if encoder is not None and len(buf) > 0:
                pad = np.zeros(frame_samples * fmt.channels - len(buf), dtype=np.float32)
                data = await loop.run_in_executor(None, encoder.encode, np.concatenate([buf, pad]))
                dur = (frame_samples * 1_000_000) // fmt.sample_rate
                await ctx.output.send(
                    "out",
                    Packet.new_binary(
                        data,
                        content_type="audio/opus",
                        metadata=PacketMetadata(timestamp_us=seq * dur, duration_us=dur, sequence=seq),
                    ),
                )
                stats.packet_sent()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))


def register(registry) -> None:
    OpusLib.get()  # raises OSError if libopus is absent (caller gates)
    registry.register(
        OpusDecoderNode.KIND, lambda p: OpusDecoderNode(p), "Decodes Opus packets to raw audio"
    )
    registry.register(
        OpusEncoderNode.KIND, lambda p: OpusEncoderNode(p), "Encodes raw audio to Opus packets"
    )
