# SPDX-License-Identifier: Apache-2.0
"""WebM (Matroska/EBML) muxer for Opus streams.

Parity target: ``containers::webm::muxer`` (``nodes/src/containers/webm.rs:
253-309``): OpusAudio packets → streaming ``video/webm`` byte stream (live
mode: unknown segment size, clustered SimpleBlocks).

Minimal EBML writer — only the elements live WebM playback needs
(EBML header, Segment, Info, Tracks with A_OPUS + OpusHead CodecPrivate,
Clusters of SimpleBlocks).
"""

from __future__ import annotations

import struct
from typing import List, Optional

from ...core import (
    ChannelClosed,
    InputPin,
    NodeContext,
    NodeStatsTracker,
    OutputPin,
    Packet,
    PacketType,
    ProcessorNode,
    parse_config_optional,
)
from ...core.state import NodeState, StopReason
from .ogg import _opus_packet_samples, opus_head

_UNKNOWN_SIZE = b"\x01\xff\xff\xff\xff\xff\xff\xff"  # 8-byte vint, all ones


def _vint_size(n: int) -> bytes:
    """EBML variable-length size encoding."""
    for length in range(1, 9):
        if n < (1 << (7 * length)) - 1:
            data = n | (1 << (7 * length))
            return data.to_bytes(length, "big")
    raise ValueError("size too large")


def _element(eid: bytes, payload: bytes) -> bytes:
    return eid + _vint_size(len(payload)) + payload


def _uint(eid: bytes, value: int) -> bytes:
    n = max(1, (value.bit_length() + 7) // 8)
    return _element(eid, value.to_bytes(n, "big"))


def _float(eid: bytes, value: float) -> bytes:
    return _element(eid, struct.pack(">f", value))


def _string(eid: bytes, value: str) -> bytes:
    return _element(eid, value.encode())


def webm_header(channels: int, sample_rate: int) -> bytes:
    ebml = _element(
        b"\x1a\x45\xdf\xa3",
        _uint(b"\x42\x86", 1)  # EBMLVersion
        + _uint(b"\x42\xf7", 1)  # EBMLReadVersion
        + _uint(b"\x42\xf2", 4)  # EBMLMaxIDLength
        + _uint(b"\x42\xf3", 8)  # EBMLMaxSizeLength
        + _string(b"\x42\x82", "webm")  # DocType
        + _uint(b"\x42\x87", 4)  # DocTypeVersion
        + _uint(b"\x42\x85", 2),  # DocTypeReadVersion
    )
    info = _element(
        b"\x15\x49\xa9\x66",
        _uint(b"\x2a\xd7\xb1", 1_000_000)  # TimecodeScale: 1ms ticks
        + _string(b"\x4d\x80", "streamkit-tpu")  # MuxingApp
        + _string(b"\x57\x41", "streamkit-tpu"),  # WritingApp
    )
    audio = _element(
        b"\xe1",
        _float(b"\xb5", float(sample_rate)) + _uint(b"\x9f", channels),
    )
    track_entry = _element(
        b"\xae",
        _uint(b"\xd7", 1)  # TrackNumber
        + _uint(b"\x73\xc5", 1)  # TrackUID
        + _uint(b"\x83", 2)  # TrackType: audio
        + _string(b"\x86", "A_OPUS")  # CodecID
        + _element(b"\x63\xa2", opus_head(channels))  # CodecPrivate
        + audio,
    )
    tracks = _element(b"\x16\x54\xae\x6b", track_entry)
    # Segment with unknown size (live streaming), then Info + Tracks
    return ebml + b"\x18\x53\x80\x67" + _UNKNOWN_SIZE + info + tracks


def simple_block(payload: bytes, relative_ms: int) -> bytes:
    relative_ms = max(-32768, min(32767, relative_ms))  # int16 timecode field
    body = b"\x81" + struct.pack(">h", relative_ms) + b"\x80" + payload
    return _element(b"\xa3", body)


def cluster_header(timecode_ms: int, blocks: bytes) -> bytes:
    return _element(b"\x1f\x43\xb6\x75", _uint(b"\xe7", timecode_ms) + blocks)


class WebmMuxerNode(ProcessorNode):
    """OpusAudio → Binary(video/webm) (``containers::webm::muxer``)."""

    KIND = "containers::webm::muxer"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(
            params,
            {
                "channels": 1,
                "sample_rate": 48000,
                "chunk_size": 65536,
                "cluster_duration_ms": 1000,
                "streaming_mode": "live",
            },
        )
        self.channels = int(cfg["channels"])
        self.sample_rate = int(cfg["sample_rate"])
        self.cluster_ms = int(cfg["cluster_duration_ms"])

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.opus_audio()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.binary())]

    def content_type(self) -> Optional[str]:
        return "video/webm"

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        header_sent = False
        cluster_start_ms = 0
        cluster_blocks = bytearray()
        pos_ms = 0.0

        async def flush_cluster() -> None:
            nonlocal cluster_blocks, cluster_start_ms
            if not cluster_blocks:
                return
            await ctx.output.send(
                "out",
                Packet.new_binary(
                    cluster_header(cluster_start_ms, bytes(cluster_blocks)),
                    content_type="video/webm",
                ),
            )
            stats.packet_sent()
            cluster_blocks = bytearray()

        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                if pkt.binary is None:
                    stats.packet_discarded()
                    continue
                if not header_sent:
                    await ctx.output.send(
                        "out",
                        Packet.new_binary(
                            webm_header(self.channels, self.sample_rate),
                            content_type="video/webm",
                        ),
                    )
                    stats.packet_sent()
                    header_sent = True
                ts_ms = int(pos_ms)
                if ts_ms - cluster_start_ms >= self.cluster_ms:
                    await flush_cluster()
                    cluster_start_ms = ts_ms
                cluster_blocks += simple_block(pkt.binary, ts_ms - cluster_start_ms)
                pos_ms += _opus_packet_samples(pkt.binary) / 48.0
            await flush_cluster()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))
