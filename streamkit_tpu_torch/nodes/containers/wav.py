# SPDX-License-Identifier: Apache-2.0
"""WAV (RIFF) container nodes.

Parity target: ``containers::wav::demuxer`` — ``nodes/src/containers/wav.rs:87``
(incremental RIFF parse: Binary chunks in → RawAudio frames out).

Extension beyond the reference: ``containers::wav::muxer`` (RawAudio →
Binary ``audio/wav``) so utility pipelines can round-trip WAV without an
external encoder; streamed with open-ended RIFF sizes.
"""

from __future__ import annotations

import struct
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
    SampleFormat,
    parse_config_optional,
)
from ...core.state import NodeState, StopReason

_FMT_PCM = 1
_FMT_FLOAT = 3
_FMT_EXTENSIBLE = 0xFFFE


class WavDemuxerNode(ProcessorNode):
    """Incremental RIFF/WAV parser (``containers::wav::demuxer``)."""

    KIND = "containers::wav::demuxer"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(params, {"frame_samples_per_channel": 960})
        self.frame_samples = int(cfg["frame_samples_per_channel"])

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.binary()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.raw_audio())]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        buf = bytearray()
        state = "riff"  # riff → chunks → data
        fmt: Optional[AudioFormat] = None
        bits = 16
        audio_fmt_code = _FMT_PCM
        data_remaining = 0
        pcm_buf = bytearray()
        seq = 0

        def bytes_per_frame() -> int:
            assert fmt is not None
            return (bits // 8) * fmt.channels

        async def emit_pcm(final: bool = False) -> None:
            nonlocal pcm_buf, seq
            assert fmt is not None
            frame_bytes = self.frame_samples * bytes_per_frame()
            while len(pcm_buf) >= frame_bytes or (final and pcm_buf):
                take = min(frame_bytes, len(pcm_buf)) if final else frame_bytes
                take -= take % bytes_per_frame()
                if take == 0:
                    break
                raw, pcm_buf = bytes(pcm_buf[:take]), pcm_buf[take:]
                if audio_fmt_code == _FMT_FLOAT:
                    samples = np.frombuffer(raw, dtype="<f4").astype(np.float32)
                elif bits == 16:
                    samples = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
                elif bits == 32:
                    samples = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
                elif bits == 8:
                    samples = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
                else:
                    raise RuntimeNodeError(f"unsupported WAV bit depth: {bits}")
                frame = AudioFrame(samples, fmt)
                meta = PacketMetadata(duration_us=frame.duration_us(), sequence=seq)
                seq += 1
                await ctx.output.send("out", Packet.new_audio(frame, meta))
                stats.packet_sent()

        try:
            eof = False
            while not eof:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    eof = True
                else:
                    stats.packet_received()
                    if pkt.binary is None:
                        stats.packet_discarded()
                        continue
                    buf.extend(pkt.binary)
                # incremental parse
                progressed = True
                while progressed:
                    progressed = False
                    if state == "riff" and len(buf) >= 12:
                        if buf[0:4] != b"RIFF" or buf[8:12] != b"WAVE":
                            raise RuntimeNodeError("not a RIFF/WAVE stream")
                        del buf[:12]
                        state = "chunks"
                        progressed = True
                    elif state == "chunks" and len(buf) >= 8:
                        cid = bytes(buf[0:4])
                        csize = struct.unpack("<I", buf[4:8])[0]
                        if cid == b"data":
                            del buf[:8]
                            data_remaining = csize if csize != 0xFFFFFFFF else -1
                            # zero-size data chunk: nothing to stream, keep
                            # scanning chunks (guards an infinite spin)
                            state = "data" if data_remaining != 0 else "chunks"
                            progressed = True
                        elif len(buf) >= 8 + csize + (csize & 1):
                            body = bytes(buf[8 : 8 + csize])
                            del buf[: 8 + csize + (csize & 1)]
                            if cid == b"fmt ":
                                code, channels, rate = struct.unpack("<HHI", body[0:8])
                                bits = struct.unpack("<H", body[14:16])[0]
                                if code == _FMT_EXTENSIBLE and len(body) >= 26:
                                    code = struct.unpack("<H", body[24:26])[0]
                                audio_fmt_code = code
                                if code not in (_FMT_PCM, _FMT_FLOAT):
                                    raise RuntimeNodeError(f"unsupported WAV format code {code}")
                                fmt = AudioFormat(rate, channels)
                            progressed = True
                    elif state == "data" and fmt is not None and buf:
                        take = len(buf) if data_remaining < 0 else min(len(buf), data_remaining)
                        if take == 0:
                            state = "chunks"  # defensive: never spin on take=0
                            progressed = True
                            continue
                        pcm_buf.extend(buf[:take])
                        del buf[:take]
                        if data_remaining > 0:
                            data_remaining -= take
                            if data_remaining == 0:
                                state = "chunks"
                        await emit_pcm()
                        progressed = bool(buf)
            if fmt is not None:
                await emit_pcm(final=True)
            elif pcm_buf or buf:
                raise RuntimeNodeError("WAV stream ended before fmt chunk")
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.COMPLETED))


class WavMuxerNode(ProcessorNode):
    """RawAudio → WAV bytes (streamed; extension node, no reference analog)."""

    KIND = "containers::wav::muxer"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(params, {"bits": 16})
        self.bits = int(cfg["bits"])
        if self.bits not in (16, 32):
            raise ConfigurationError("bits must be 16 (PCM) or 32 (float)")

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.raw_audio()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.binary())]

    def content_type(self) -> Optional[str]:
        return "audio/wav"

    def _header(self, fmt: AudioFormat) -> bytes:
        code = _FMT_PCM if self.bits == 16 else _FMT_FLOAT
        byte_rate = fmt.sample_rate * fmt.channels * self.bits // 8
        block_align = fmt.channels * self.bits // 8
        return b"".join(
            [
                b"RIFF",
                struct.pack("<I", 0xFFFFFFFF),  # streaming: unknown total size
                b"WAVE",
                b"fmt ",
                struct.pack("<IHHIIHH", 16, code, fmt.channels, fmt.sample_rate, byte_rate, block_align, self.bits),
                b"data",
                struct.pack("<I", 0xFFFFFFFF),
            ]
        )

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        header_sent = False
        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                if pkt.audio is None:
                    stats.packet_discarded()
                    continue
                if not header_sent:
                    await ctx.output.send(
                        "out",
                        Packet.new_binary(self._header(pkt.audio.format), content_type="audio/wav"),
                    )
                    header_sent = True
                x = pkt.audio.samples
                if self.bits == 16:
                    data = (np.clip(x * 32768.0, -32768, 32767).round().astype("<i2")).tobytes()
                else:
                    data = x.astype("<f4").tobytes()
                await ctx.output.send("out", Packet.new_binary(data, content_type="audio/wav"))
                stats.packet_sent()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))
