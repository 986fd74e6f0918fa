# SPDX-License-Identifier: Apache-2.0
"""Text-processing nodes: JSON serialization and streaming text chunking.

Parity targets:
* ``core::json_serialize`` — ``nodes/src/core/json_serialize.rs`` (any packet
  → Binary(application/json) using the reference's externally-tagged Packet
  JSON; optional pretty / NDJSON)
* ``core::text_chunker`` — ``nodes/src/core/text_chunker.rs`` (sentence/
  clause-boundary chunking so streaming TTS can start synthesis early)
"""

from __future__ import annotations

import json
import re
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


class JsonSerializeNode(ProcessorNode):
    """Serializes packets to the reference's Packet JSON (``core::json_serialize``)."""

    KIND = "core::json_serialize"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(params, {"pretty": False, "newline_delimited": False})
        self.pretty = bool(cfg["pretty"])
        self.newline_delimited = bool(cfg["newline_delimited"])

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.any()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.binary())]

    def content_type(self) -> Optional[str]:
        return "application/json"

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        while True:
            pkt = await ctx.recv_with_cancellation("in")
            if pkt is None:
                break
            stats.packet_received()
            obj = pkt.to_reference_json()
            data = json.dumps(obj, indent=2 if self.pretty else None).encode()
            if self.newline_delimited:
                data += b"\n"
            try:
                await ctx.output.send(
                    "out", Packet.new_binary(data, content_type="application/json")
                )
            except ChannelClosed:
                ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
                stats.flush()
                return
            stats.packet_sent()
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))


# sentence terminators + clause boundaries (reference text_chunker.rs)
_SENTENCE_RE = re.compile(r"(.*?[.!?…]+(?:\s+|$))", re.S)
_CLAUSE_RE = re.compile(r"(.*?[,;:]+(?:\s+|$))", re.S)


class TextChunkerNode(ProcessorNode):
    """Splits streaming text at sentence/clause boundaries (``core::text_chunker``).

    Buffers incoming Text packets; emits complete sentences as soon as they
    appear. If the buffer exceeds ``max_chunk_chars``, falls back to clause
    boundaries, then to a hard cut. Flushes the remainder on EOF.
    """

    KIND = "core::text_chunker"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(
            params,
            {
                "min_chunk_chars": 1,
                "min_length": None,  # reference param name (text_chunker.rs)
                "max_chunk_chars": 400,
                "emit_partial_on_eof": True,
                "split_mode": "sentences",  # reference core::text_chunker
            },
        )
        if str(cfg["split_mode"]) not in ("sentences", "clauses"):
            raise ConfigurationError(
                f"text_chunker: unknown split_mode {cfg['split_mode']!r} "
                "(sentences | clauses)"
            )
        self.split_mode = str(cfg["split_mode"])
        self.min_chunk = int(cfg["min_length"] or cfg["min_chunk_chars"])
        self.max_chunk = int(cfg["max_chunk_chars"])
        self.emit_partial = bool(cfg["emit_partial_on_eof"])
        self._buf = ""

    def input_pins(self) -> List[InputPin]:
        # Binary accepted too: the reference pipes raw HTTP text bodies into
        # the chunker (kokoro-tts.yml: http_input -> text_chunker)
        return [
            InputPin("in", [PacketType.text(), PacketType.transcription(), PacketType.binary()])
        ]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.text())]

    def _extract_chunks(self, eof: bool = False) -> List[str]:
        chunks: List[str] = []
        while True:
            m = _SENTENCE_RE.match(self._buf)
            if m and len(m.group(1).strip()) >= self.min_chunk:
                chunks.append(m.group(1).strip())
                self._buf = self._buf[m.end(1) :]
                continue
            if len(self._buf) > self.max_chunk:
                m = _CLAUSE_RE.match(self._buf)
                if m and 0 < len(m.group(1)) <= self.max_chunk:
                    chunks.append(m.group(1).strip())
                    self._buf = self._buf[m.end(1) :]
                    continue
                chunks.append(self._buf[: self.max_chunk].strip())
                self._buf = self._buf[self.max_chunk :]
                continue
            break
        if eof and self.emit_partial and self._buf.strip():
            chunks.append(self._buf.strip())
            self._buf = ""
        return [c for c in chunks if c]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                if pkt.text is not None:
                    text = pkt.text
                elif pkt.transcription is not None:
                    text = pkt.transcription.text
                elif pkt.binary is not None:
                    text = pkt.binary.decode("utf-8", errors="replace")
                else:
                    stats.packet_discarded()
                    continue
                self._buf += text
                for chunk in self._extract_chunks():
                    await ctx.output.send("out", Packet.new_text(chunk, pkt.metadata))
                    stats.packet_sent()
            for chunk in self._extract_chunks(eof=True):
                await ctx.output.send("out", Packet.new_text(chunk))
                stats.packet_sent()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))
