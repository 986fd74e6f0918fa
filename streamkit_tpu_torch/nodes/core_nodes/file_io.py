# SPDX-License-Identifier: Apache-2.0
"""File source/sink nodes.

Parity targets:
* ``core::file_reader`` — ``nodes/src/core/file_read.rs`` (chunked source;
  waits for a ``Start`` control signal before emitting, so the dynamic
  engine's ready-gating holds packets until the whole pipeline is up)
* ``core::file_writer`` — ``nodes/src/core/file_write.rs`` (Binary → disk;
  paths validated against ``security.allowed_write_paths``)
"""

from __future__ import annotations

import asyncio
import os
from typing import List, Optional

from ...core import (
    ChannelClosed,
    ConfigurationError,
    InputPin,
    NodeContext,
    NodeStatsTracker,
    OutputPin,
    Packet,
    PacketType,
    ProcessorNode,
    parse_config_optional,
    require_param,
)
from ...core.state import NodeState, StopReason

# set by the server from security config; empty = allow everything (dev mode)
_ALLOWED_READ_PREFIXES: List[str] = []
_ALLOWED_WRITE_PREFIXES: List[str] = []


def set_security_paths(read_prefixes: List[str], write_prefixes: List[str]) -> None:
    """Install path allowlists (reference ``security.allowed_file_paths``)."""
    global _ALLOWED_READ_PREFIXES, _ALLOWED_WRITE_PREFIXES
    _ALLOWED_READ_PREFIXES = [os.path.realpath(p) for p in read_prefixes]
    _ALLOWED_WRITE_PREFIXES = [os.path.realpath(p) for p in write_prefixes]


def _check_path(path: str, prefixes: List[str], action: str) -> str:
    real = os.path.realpath(path)
    if prefixes and not any(real == p or real.startswith(p + os.sep) for p in prefixes):
        raise ConfigurationError(f"path {path!r} not allowed for {action}")
    return real


class FileReaderNode(ProcessorNode):
    """Chunked file source (``core::file_reader``)."""

    KIND = "core::file_reader"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(params, {"path": None, "chunk_size": 8192})
        if params is not None:
            require_param(params, "path")
        self.path = cfg["path"]
        self.chunk_size = int(cfg["chunk_size"])
        if self.chunk_size <= 0:
            raise ConfigurationError("chunk_size must be > 0")

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.binary())]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.ready())
        if not await ctx.wait_for_start():
            ctx.emit_state(NodeState.stopped(StopReason.SHUTDOWN))
            return
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        path = _check_path(self.path, _ALLOWED_READ_PREFIXES, "read")
        loop = asyncio.get_running_loop()
        try:
            with open(path, "rb") as f:
                seq = 0
                while not ctx.cancelled:
                    chunk = await loop.run_in_executor(None, f.read, self.chunk_size)
                    if not chunk:
                        break
                    pkt = Packet.new_binary(chunk)
                    try:
                        await ctx.output.send("out", pkt)
                    except ChannelClosed:
                        ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
                        stats.flush()
                        return
                    stats.packet_sent()
                    seq += 1
        except OSError as e:
            raise ConfigurationError(f"file read failed: {e}") from e
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.COMPLETED))


class FileWriterNode(ProcessorNode):
    """Binary → disk sink (``core::file_writer``)."""

    KIND = "core::file_writer"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(params, {"path": None, "append": False})
        if params is not None:
            require_param(params, "path")
        self.path = cfg["path"]
        self.append = bool(cfg["append"])

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.binary()])]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        path = _check_path(self.path, _ALLOWED_WRITE_PREFIXES, "write")
        loop = asyncio.get_running_loop()
        mode = "ab" if self.append else "wb"
        with open(path, mode) as f:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                if pkt.binary is not None:
                    await loop.run_in_executor(None, f.write, pkt.binary)
                    stats.packet_sent()
                else:
                    stats.packet_discarded()
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))
