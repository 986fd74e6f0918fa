# SPDX-License-Identifier: Apache-2.0
"""Universal audio decoder node via the libav C++ shim.

Parity target: ``audio::flac::decoder`` (``nodes/src/audio/codecs/flac.rs``:
symphonia probe+decode on a blocking thread) — implemented against the
port's ``csrc/av_decode.cpp`` (libavformat/libavcodec; a copy of the JAX
package's shim), which also covers M4A/OGG/anything ffmpeg probes. The shim
is built with ``g++`` into ``_build/`` at first use (:mod:`...ops._build`)
and links the libraries ``pkg-config`` names. Where g++, ``pkg-config`` or
one of those libraries is absent the kind is not registered
(:func:`av_available`); a shim that fails to build or load where they are
present raises. The async↔blocking bridge mirrors the
reference's ``StreamingReader`` (``nodes/src/streaming_utils.rs:10-48``):
the decode loop runs on an executor thread pulling bytes from a thread-safe
queue fed by the node's async input.
"""

from __future__ import annotations

import asyncio
import ctypes
import os
import queue as _queue
import shutil
import subprocess
import threading
from typing import List, Optional

import numpy as np

from ...core import (
    AudioFormat,
    AudioFrame,
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
from ...ops import _build

SOURCE = _build.Source("av_decode.cpp", "g++",
                       pkg_config=("libavformat", "libavcodec", "libavutil", "libswresample"))

ReadCb = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int)


def _declare(lib) -> None:
    lib.skav_open.restype = ctypes.c_void_p
    lib.skav_open.argtypes = [ReadCb, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.skav_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.skav_decode.restype = ctypes.c_int
    lib.skav_decode.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.skav_close.argtypes = [ctypes.c_void_p]


class AvLib:
    @staticmethod
    def get() -> ctypes.CDLL:
        """The shim, built and loaded once per process; raises
        ``RuntimeError`` (no compiler, no libav) or ``OSError``."""
        return _build.load(SOURCE, _declare)


_available: Optional[bool] = None
unavailable_reason = ""  # which host tool or library is absent, when one is


def _missing() -> str:
    """What this host lacks to build the shim (g++, ``pkg-config`` or one of
    the libav packages), or ``""`` when nothing is missing."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        return "g++ not found"
    exe = shutil.which("pkg-config")
    if exe is None:
        return "pkg-config not found"
    proc = subprocess.run([exe, "--exists", "--print-errors", *SOURCE.pkg_config], capture_output=True, text=True)
    if proc.returncode != 0:
        return f"pkg-config {' '.join(SOURCE.pkg_config)}: {proc.stderr.strip()}"[:500]
    return ""


def av_available() -> bool:
    """Whether the shim's compiler and libraries are present here (checked
    once per process); where they are, the shim is built and loaded, and a
    failed build or load raises."""
    global _available, unavailable_reason
    if _available is None:
        reason = _missing()
        if not reason:
            AvLib.get()
        unavailable_reason, _available = reason, not reason
    return _available


class _BlockingDecoder:
    """Owns the shim handle; runs entirely on one worker thread."""

    MAX_CHUNK = 48000  # samples per decode pull

    def __init__(self) -> None:
        self.in_queue: _queue.Queue = _queue.Queue(maxsize=32)
        self.out_queue: _queue.Queue = _queue.Queue(maxsize=32)
        self._leftover = b""

        self._eof = False

        @ReadCb
        def read_cb(_opaque, buf, buf_size):
            data = self._leftover
            if not data:
                if self._eof:
                    return -1  # EOF is sticky: libav re-reads after EOF
                item = self.in_queue.get()  # blocks the worker thread only
                if item is None:
                    self._eof = True
                    return -1
                data = item
            take = min(len(data), buf_size)
            ctypes.memmove(buf, data[:take], take)
            self._leftover = data[take:]
            return take

        self._read_cb = read_cb  # keepalive

    def run(self) -> None:
        """Worker thread: open, decode until EOF, push (rate, ch, pcm) tuples."""
        lib = AvLib.get()
        err = ctypes.create_string_buffer(256)
        handle = lib.skav_open(self._read_cb, None, err, len(err))
        if not handle:
            self.out_queue.put(RuntimeNodeError(f"decode open failed: {err.value.decode()}"))
            return
        try:
            rate = ctypes.c_int(0)
            ch = ctypes.c_int(0)
            lib.skav_info(handle, ctypes.byref(rate), ctypes.byref(ch))
            buf = (ctypes.c_float * self.MAX_CHUNK)()
            while True:
                n = lib.skav_decode(handle, buf, self.MAX_CHUNK)
                if n == 0:
                    break
                if n < 0:
                    self.out_queue.put(RuntimeNodeError(f"decode error {n}"))
                    return
                pcm = np.ctypeslib.as_array(buf)[:n].copy()
                self.out_queue.put((rate.value, ch.value, pcm))
        finally:
            lib.skav_close(handle)
            self.out_queue.put(None)  # EOF marker


class AvDecoderNode(ProcessorNode):
    """Binary → RawAudio via libav (``audio::flac::decoder`` et al.)."""

    KIND = "audio::flac::decoder"

    def __init__(self, params: Optional[dict]) -> None:
        parse_config_optional(params, {})

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.binary()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.raw_audio())]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        dec = _BlockingDecoder()
        worker = threading.Thread(target=dec.run, daemon=True)
        worker.start()
        loop = asyncio.get_running_loop()
        seq = 0

        async def pump_in() -> None:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    await loop.run_in_executor(None, dec.in_queue.put, None)
                    return
                stats.packet_received()
                if pkt.binary:
                    await loop.run_in_executor(None, dec.in_queue.put, pkt.binary)

        pump_task = asyncio.ensure_future(pump_in())
        try:
            while True:
                item = await loop.run_in_executor(None, dec.out_queue.get)
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                rate, channels, pcm = item
                frame = AudioFrame(pcm, AudioFormat(rate, channels))
                meta = PacketMetadata(duration_us=frame.duration_us(), sequence=seq)
                seq += 1
                await ctx.output.send("out", Packet.new_audio(frame, meta))
                stats.packet_sent()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        finally:
            pump_task.cancel()
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.COMPLETED))


def register(registry) -> None:
    AvLib.get()
    registry.register(
        AvDecoderNode.KIND,
        lambda p: AvDecoderNode(p),
        "Decodes FLAC (and other libav formats) to raw audio",
    )
