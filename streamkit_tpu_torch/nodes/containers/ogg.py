# SPDX-License-Identifier: Apache-2.0
"""Ogg/Opus container nodes.

Parity targets: ``containers::ogg::demuxer`` / ``containers::ogg::muxer``
(``nodes/src/containers/ogg.rs:88-300``): incremental page parsing (Binary
chunks → Opus packets with granule-derived timestamps) and Ogg/Opus
packetization (OpusHead/OpusTags + lacing + page CRC).

Pure-Python implementation of the Ogg framing layer (RFC 3533) — the byte
work is trivial next to codec/DSP cost and keeping it in-process avoids a
libogg ctypes dance.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from ...core import (
    ChannelClosed,
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

# ---------------------------------------------------------------------------
# Ogg CRC-32: poly 0x04c11db7, init 0, no reflection, no final xor (RFC 3533)
# ---------------------------------------------------------------------------
_CRC_TABLE = []
for _i in range(256):
    _r = _i << 24
    for _ in range(8):
        _r = ((_r << 1) ^ 0x04C11DB7) & 0xFFFFFFFF if _r & 0x80000000 else (_r << 1) & 0xFFFFFFFF
    _CRC_TABLE.append(_r)


def ogg_crc(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _CRC_TABLE[((crc >> 24) & 0xFF) ^ b]
    return crc


class OggPageReader:
    """Incremental page parser + packet assembler."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._partial: bytearray = bytearray()  # continued packet in progress

    def feed(self, data: bytes) -> List[Tuple[bytes, int]]:
        """Feed bytes → list of (packet, granule_of_page)."""
        self._buf.extend(data)
        out: List[Tuple[bytes, int]] = []
        while True:
            idx = self._buf.find(b"OggS")
            if idx < 0:
                if len(self._buf) > 3:
                    del self._buf[:-3]
                break
            if idx > 0:
                del self._buf[:idx]
            if len(self._buf) < 27:
                break
            (
                version,
                header_type,
                granule,
                serial,
                seq,
                crc,
                n_segments,
            ) = struct.unpack_from("<BBqIIIB", self._buf, 4)
            header_len = 27 + n_segments
            if len(self._buf) < header_len:
                break
            lacing = self._buf[27:header_len]
            body_len = sum(lacing)
            if len(self._buf) < header_len + body_len:
                break
            body = bytes(self._buf[header_len : header_len + body_len])
            del self._buf[: header_len + body_len]
            if version != 0:
                raise RuntimeNodeError(f"unsupported Ogg version {version}")
            # continuation flag: first packet continues self._partial
            pos = 0
            packet = self._partial if (header_type & 0x01) else bytearray()
            if not (header_type & 0x01):
                self._partial = bytearray()
            for lace in lacing:
                packet.extend(body[pos : pos + lace])
                pos += lace
                if lace < 255:
                    out.append((bytes(packet), granule))
                    packet = bytearray()
            self._partial = packet  # non-empty iff last lace was 255
        return out


class OggPageWriter:
    def __init__(self, serial: int = 0x5354) -> None:
        self.serial = serial
        self.page_seq = 0

    def page(self, packets: List[bytes], granule: int, header_type: int = 0) -> bytes:
        """Build one or more pages (splits at Ogg's 255-segment page limit)."""
        out = bytearray()
        lacing = bytearray()
        body = bytearray()

        def flush(final: bool) -> None:
            nonlocal lacing, body
            if not lacing and not final:
                return
            out.extend(self._page_raw(bytes(lacing), bytes(body), granule,
                                      header_type if final else header_type & ~0x04))
            lacing = bytearray()
            body = bytearray()

        for pkt in packets:
            n = len(pkt)
            laces = n // 255 + 1
            if len(lacing) + laces > 255:
                flush(final=False)
            while n >= 255:
                lacing.append(255)
                n -= 255
            lacing.append(n)
            body.extend(pkt)
        flush(final=True)
        return bytes(out)

    def _page_raw(self, lacing: bytes, body: bytes, granule: int, header_type: int) -> bytes:
        header = bytearray(
            struct.pack(
                "<4sBBqIIIB",
                b"OggS",
                0,
                header_type,
                granule,
                self.serial,
                self.page_seq,
                0,
                len(lacing),
            )
        )
        header.extend(lacing)
        self.page_seq += 1
        page = bytes(header) + body
        crc = ogg_crc(page)
        return page[:22] + struct.pack("<I", crc) + page[26:]


def opus_head(channels: int, preskip: int = 312, input_rate: int = 48000) -> bytes:
    return struct.pack("<8sBBHIhB", b"OpusHead", 1, channels, preskip, input_rate, 0, 0)


def opus_tags(vendor: str = "streamkit-tpu") -> bytes:
    v = vendor.encode()
    return b"OpusTags" + struct.pack("<I", len(v)) + v + struct.pack("<I", 0)


class OggDemuxerNode(ProcessorNode):
    """Binary → OpusAudio packets (``containers::ogg::demuxer``)."""

    KIND = "containers::ogg::demuxer"

    def __init__(self, params: Optional[dict]) -> None:
        parse_config_optional(params, {})

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.binary()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.opus_audio())]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        reader = OggPageReader()
        preskip = 0
        headers_seen = 0
        seq = 0
        last_granule = 0
        sample_pos = 0  # 48k samples of audio emitted
        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                if pkt.binary is None:
                    stats.packet_discarded()
                    continue
                for packet, granule in reader.feed(pkt.binary):
                    if headers_seen == 0:
                        if packet[:8] != b"OpusHead":
                            raise RuntimeNodeError("ogg stream is not Opus")
                        preskip = struct.unpack_from("<H", packet, 10)[0]
                        headers_seen = 1
                        continue
                    if headers_seen == 1:
                        headers_seen = 2  # OpusTags
                        continue
                    # audio packet: duration from TOC byte
                    dur_samples = _opus_packet_samples(packet)
                    ts_us = (sample_pos * 1_000_000) // 48_000
                    sample_pos += dur_samples
                    meta = PacketMetadata(
                        timestamp_us=ts_us,
                        duration_us=(dur_samples * 1_000_000) // 48_000,
                        sequence=seq,
                    )
                    seq += 1
                    await ctx.output.send(
                        "out", Packet.new_binary(packet, content_type="audio/opus", metadata=meta)
                    )
                    stats.packet_sent()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.COMPLETED))


def _opus_packet_samples(packet: bytes) -> int:
    """Samples @48 kHz in an opus packet, from the TOC byte (RFC 6716 §3.1)."""
    if not packet:
        return 0
    toc = packet[0]
    config = toc >> 3
    # frame sizes in samples @48k per config
    if config < 12:  # SILK NB/MB/WB: 10, 20, 40, 60 ms
        base = (480, 960, 1920, 2880)[config % 4]
    elif config < 16:  # hybrid: 10, 20 ms
        base = (480, 960)[config % 2]
    else:  # CELT: 2.5, 5, 10, 20 ms
        base = (120, 240, 480, 960)[(config - 16) % 4]
    code = toc & 0x3
    if code == 0:
        frames = 1
    elif code in (1, 2):
        frames = 2
    else:
        frames = packet[1] & 0x3F if len(packet) > 1 else 1
    return base * frames


class OggMuxerNode(ProcessorNode):
    """OpusAudio → Binary audio/ogg (``containers::ogg::muxer``)."""

    KIND = "containers::ogg::muxer"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(
            params, {"channels": 1, "chunk_size": 65536, "packets_per_page": 50}
        )
        self.channels = int(cfg["channels"])
        self.packets_per_page = int(cfg["packets_per_page"])

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.opus_audio()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.binary())]

    def content_type(self) -> Optional[str]:
        return "audio/ogg"

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        writer = OggPageWriter()
        granule = 0
        pending: List[bytes] = []
        header_sent = False

        async def flush_page(eos: bool = False) -> None:
            nonlocal pending
            if not pending and not eos:
                return
            page = writer.page(pending, granule, header_type=0x04 if eos else 0)
            pending = []
            await ctx.output.send("out", Packet.new_binary(page, content_type="audio/ogg"))
            stats.packet_sent()

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
                    head = writer.page([opus_head(self.channels)], 0, header_type=0x02)
                    tags = writer.page([opus_tags()], 0)
                    await ctx.output.send(
                        "out", Packet.new_binary(head + tags, content_type="audio/ogg")
                    )
                    stats.packet_sent()
                    header_sent = True
                granule += _opus_packet_samples(pkt.binary)
                pending.append(pkt.binary)
                if len(pending) >= self.packets_per_page:
                    await flush_page()
            if header_sent:
                await flush_page(eos=True)
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))
