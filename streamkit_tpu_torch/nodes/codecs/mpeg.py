# SPDX-License-Identifier: Apache-2.0
"""MP3 decoder node — host-side via libmpg123 (ctypes).

Parity target: ``audio::mp3::decoder`` (``nodes/src/audio/codecs/mp3.rs``,
symphonia probe+decode on a blocking thread): Binary chunks in → RawAudio
f32 out, streaming feed-decode.
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

_MPG123_OK = 0
_MPG123_NEW_FORMAT = -11
_MPG123_NEED_MORE = -10
_MPG123_DONE = -12
_MPG123_ENC_FLOAT_32 = 0x200


class Mpg123Lib:
    _lib = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls._lib is None:
            name = ctypes.util.find_library("mpg123") or "libmpg123.so.0"
            lib = ctypes.CDLL(name)
            lib.mpg123_init()
            lib.mpg123_new.restype = ctypes.c_void_p
            lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
            lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
            lib.mpg123_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
            lib.mpg123_decode_frame.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.mpg123_getformat.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
            lib.mpg123_format.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int
            ]
            lib.mpg123_delete.argtypes = [ctypes.c_void_p]
            cls._lib = lib
        return cls._lib


class Mp3Decoder:
    """Streaming feed/decode wrapper."""

    def __init__(self) -> None:
        lib = Mpg123Lib.get()
        err = ctypes.c_int(0)
        self._h = lib.mpg123_new(None, ctypes.byref(err))
        if not self._h:
            raise RuntimeNodeError(f"mpg123_new failed: {err.value}")
        lib.mpg123_open_feed(self._h)
        self.format: Optional[AudioFormat] = None

    def feed_decode(self, data: bytes) -> List[np.ndarray]:
        lib = Mpg123Lib.get()
        if data:
            lib.mpg123_feed(self._h, data, len(data))
        out: List[np.ndarray] = []
        while True:
            num = ctypes.c_long(0)
            audio = ctypes.c_void_p(0)
            nbytes = ctypes.c_size_t(0)
            rc = lib.mpg123_decode_frame(
                self._h, ctypes.byref(num), ctypes.byref(audio), ctypes.byref(nbytes)
            )
            if rc == _MPG123_NEW_FORMAT:
                rate = ctypes.c_long(0)
                ch = ctypes.c_int(0)
                enc = ctypes.c_int(0)
                lib.mpg123_getformat(self._h, ctypes.byref(rate), ctypes.byref(ch), ctypes.byref(enc))
                # force float32 output
                lib.mpg123_format_none(self._h)
                lib.mpg123_format(self._h, rate, ch.value, _MPG123_ENC_FLOAT_32)
                self.format = AudioFormat(int(rate.value), int(ch.value))
                continue
            if rc in (_MPG123_NEED_MORE, _MPG123_DONE):
                break
            if rc != _MPG123_OK:
                raise RuntimeNodeError(f"mpg123_decode_frame error {rc}")
            if nbytes.value and audio.value:
                buf = ctypes.string_at(audio.value, nbytes.value)
                out.append(np.frombuffer(buf, dtype=np.float32).copy())
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            try:
                Mpg123Lib.get().mpg123_delete(self._h)
            except Exception:
                pass
            self._h = None


class Mp3DecoderNode(ProcessorNode):
    """Binary(mp3) → RawAudio (``audio::mp3::decoder``)."""

    KIND = "audio::mp3::decoder"

    def __init__(self, params: Optional[dict]) -> None:
        parse_config_optional(params, {})

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.binary()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.raw_audio())]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        dec = Mp3Decoder()
        loop = asyncio.get_running_loop()
        seq = 0
        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                if pkt.binary is None:
                    stats.packet_discarded()
                    continue
                chunks = await loop.run_in_executor(None, dec.feed_decode, pkt.binary)
                for pcm in chunks:
                    assert dec.format is not None
                    frame = AudioFrame(pcm, dec.format)
                    meta = PacketMetadata(duration_us=frame.duration_us(), sequence=seq)
                    seq += 1
                    await ctx.output.send("out", Packet.new_audio(frame, meta))
                    stats.packet_sent()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.COMPLETED))


def register(registry) -> None:
    Mpg123Lib.get()
    registry.register(
        Mp3DecoderNode.KIND, lambda p: Mp3DecoderNode(p), "Decodes MP3 to raw audio (libmpg123)"
    )
