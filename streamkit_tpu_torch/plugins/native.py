# SPDX-License-Identifier: Apache-2.0
"""Native plugin host: dlopen C-ABI plugins and adapt them to ProcessorNodes.

Port of the JAX package's ``plugins/native.py``: the C ABI
(``native/include/streamkit_plugin.h``) is the same, symbol name and version
included, so a plugin built for the JAX server loads here unchanged. Parity
with reference ``crates/plugin-native/src/lib.rs:50-150`` +
``wrapper.rs:145-563``:

* load a shared library, resolve ``streamkit_tpu_plugin_api``, check ABI v2,
  read metadata, register into the NodeRegistry,
* :class:`NativeNodeWrapper` adapts the C vtable to the async node world:
  every FFI call (``process``/``update_params``/``flush``) runs on an
  executor thread (the reference's ``spawn_blocking``); outputs come back
  through C callback shims that enqueue onto the node's output channels.
"""

from __future__ import annotations

import asyncio
import ctypes
import json
import logging
import os
from typing import List, Optional

import numpy as np

from ..core import (
    AudioFormat,
    AudioFrame,
    ChannelClosed,
    CustomPacketData,
    InputPin,
    NodeContext,
    NodeRegistry,
    NodeStatsTracker,
    OutputPin,
    Packet,
    PacketMetadata,
    PacketType,
    PluginError,
    ProcessorNode,
    TelemetryEmitter,
    TranscriptionData,
)
from ..core.state import NodeState, StopReason

__all__ = ["LoadedNativePlugin", "NativeNodeWrapper", "load_native_plugin", "load_plugins_dir"]

log = logging.getLogger(__name__)

SK_ABI_VERSION = 2  # native/include/streamkit_plugin.h


class SkPacketC(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_int32),
        ("samples", ctypes.POINTER(ctypes.c_float)),
        ("n_samples", ctypes.c_size_t),
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("text", ctypes.c_char_p),
        ("type_id", ctypes.c_char_p),
        ("json", ctypes.c_char_p),
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("data_len", ctypes.c_size_t),
        ("content_type", ctypes.c_char_p),
        ("timestamp_us", ctypes.c_int64),
        ("duration_us", ctypes.c_int64),
        ("sequence", ctypes.c_int64),
    ]


OutputCb = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(SkPacketC))
TelemetryCb = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p)


class SkPluginApiC(ctypes.Structure):
    _fields_ = [
        ("abi_version", ctypes.c_uint32),
        ("kind", ctypes.c_char_p),
        ("description", ctypes.c_char_p),
        ("param_schema_json", ctypes.c_char_p),
        ("create", ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t)),
        ("process", ctypes.CFUNCTYPE(
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(SkPacketC),
            OutputCb, TelemetryCb, ctypes.c_void_p)),
        ("update_params", ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p, ctypes.c_char_p)),
        ("flush", ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p, OutputCb, ctypes.c_void_p)),
        ("destroy", ctypes.CFUNCTYPE(None, ctypes.c_void_p)),
    ]


def _packet_to_c(pkt: Packet, keepalive: list) -> SkPacketC:
    c = SkPacketC()
    c.timestamp_us = pkt.metadata.timestamp_us if pkt.metadata and pkt.metadata.timestamp_us is not None else -1
    c.duration_us = pkt.metadata.duration_us if pkt.metadata and pkt.metadata.duration_us is not None else -1
    c.sequence = pkt.metadata.sequence if pkt.metadata and pkt.metadata.sequence is not None else -1
    if pkt.audio is not None:
        c.kind = 0
        arr = np.ascontiguousarray(pkt.audio.samples, dtype=np.float32)
        keepalive.append(arr)
        c.samples = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        c.n_samples = arr.shape[0]
        c.sample_rate = pkt.audio.format.sample_rate
        c.channels = pkt.audio.format.channels
    elif pkt.text is not None:
        c.kind = 1
        b = pkt.text.encode()
        keepalive.append(b)
        c.text = b
    elif pkt.transcription is not None:
        c.kind = 2
        b = pkt.transcription.text.encode()
        keepalive.append(b)
        c.text = b
    elif pkt.custom is not None:
        c.kind = 3
        tid = pkt.custom.type_id.encode()
        data = json.dumps(pkt.custom.data).encode()
        keepalive.extend([tid, data])
        c.type_id = tid
        c.json = data
    else:
        c.kind = 4
        data = pkt.binary or b""
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        keepalive.append(buf)
        c.data = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8))
        c.data_len = len(data)
        if pkt.content_type:
            b = pkt.content_type.encode()
            keepalive.append(b)
            c.content_type = b
    return c


def _packet_from_c(c: SkPacketC) -> Optional[Packet]:
    meta = PacketMetadata(
        timestamp_us=c.timestamp_us if c.timestamp_us >= 0 else None,
        duration_us=c.duration_us if c.duration_us >= 0 else None,
        sequence=c.sequence if c.sequence >= 0 else None,
    )
    if c.kind == 0:
        if not c.samples or c.n_samples == 0:
            return None
        samples = np.ctypeslib.as_array(c.samples, shape=(c.n_samples,)).copy()
        fmt = AudioFormat(c.sample_rate, max(1, c.channels))
        return Packet.new_audio(AudioFrame(samples, fmt), meta)
    if c.kind == 1:
        return Packet.new_text((c.text or b"").decode("utf-8", "replace"), meta)
    if c.kind == 2:
        return Packet.new_transcription(
            TranscriptionData(text=(c.text or b"").decode("utf-8", "replace")), meta
        )
    if c.kind == 3:
        data = json.loads(c.json.decode()) if c.json else None
        return Packet.new_custom(CustomPacketData((c.type_id or b"").decode(), data), meta)
    if c.kind == 4:
        data = bytes(ctypes.cast(c.data, ctypes.POINTER(ctypes.c_uint8 * c.data_len)).contents) if c.data and c.data_len else b""
        ctype = c.content_type.decode() if c.content_type else None
        return Packet.new_binary(data, content_type=ctype, metadata=meta)
    return None


class LoadedNativePlugin:
    """A dlopened plugin library (reference ``LoadedNativePlugin::load``)."""

    def __init__(self, path: str) -> None:
        if not os.path.exists(path):
            raise PluginError(f"plugin library not found: {path}")
        try:
            self._lib = ctypes.CDLL(path)
        except OSError as e:
            raise PluginError(f"failed to load {path}: {e}") from e
        try:
            entry = self._lib.streamkit_tpu_plugin_api
        except AttributeError as e:
            raise PluginError(f"{path}: missing streamkit_tpu_plugin_api symbol") from e
        entry.restype = ctypes.POINTER(SkPluginApiC)
        self.api = entry().contents
        if self.api.abi_version != SK_ABI_VERSION:
            raise PluginError(
                f"{path}: ABI version {self.api.abi_version} != {SK_ABI_VERSION}"
            )
        self.path = path
        self.kind = self.api.kind.decode()
        self.description = (self.api.description or b"").decode()

    def create_instance(self, params: Optional[dict]):
        err = ctypes.create_string_buffer(512)
        handle = self.api.create(json.dumps(params or {}).encode(), err, len(err))
        if not handle:
            raise PluginError(f"{self.kind}: create failed: {err.value.decode()}")
        return handle


class NativeNodeWrapper(ProcessorNode):
    """Adapts a native plugin instance to the node world (reference
    ``NativeNodeWrapper``, plugin-native/src/wrapper.rs:145-500)."""

    def __init__(self, plugin: LoadedNativePlugin, params: Optional[dict]) -> None:
        self.plugin = plugin
        self.params = params
        self.KIND = plugin.kind
        self._handle = None

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.any()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.passthrough())]

    async def run(self, ctx: NodeContext) -> None:
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        telemetry = TelemetryEmitter(ctx.node_name, ctx.telemetry_tx)
        loop = asyncio.get_running_loop()
        self._handle = self.plugin.create_instance(self.params)
        ctx.emit_state(NodeState.running())

        out_queue: List[Packet] = []  # filled by the callback shim (FFI thread)
        tel_queue: List[tuple] = []

        @OutputCb
        def output_shim(_ctx, pin, pkt_ptr):
            pkt = _packet_from_c(pkt_ptr.contents)
            if pkt is not None:
                out_queue.append(pkt)

        @TelemetryCb
        def telemetry_shim(_ctx, event_type, json_data):
            try:
                data = json.loads(json_data.decode()) if json_data else {}
            except json.JSONDecodeError:
                data = {"raw": (json_data or b"").decode("utf-8", "replace")}
            tel_queue.append(((event_type or b"").decode(), data))

        api = self.plugin.api

        def call_process(pin: str, pkt: Packet) -> int:
            keepalive: list = []
            c = _packet_to_c(pkt, keepalive)
            return api.process(
                self._handle, pin.encode(), ctypes.byref(c), output_shim, telemetry_shim, None
            )

        async def drain_queues() -> None:
            for event_type, data in tel_queue:
                telemetry.emit(event_type, data)
            tel_queue.clear()
            for pkt in out_queue:
                await ctx.output.send("out", pkt)
                stats.packet_sent()
            out_queue.clear()

        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                msg = ctx.poll_control()
                if msg and msg.op == "update_params":
                    rc = await loop.run_in_executor(
                        None, api.update_params, self._handle, json.dumps(msg.params or {}).encode()
                    )
                    if rc != 0:
                        telemetry.emit("plugin.error", {"op": "update_params", "rc": rc})
                rc = await loop.run_in_executor(None, call_process, "in", pkt)
                if rc != 0:
                    stats.packet_errored()
                    telemetry.emit("plugin.error", {"op": "process", "rc": rc})
                await drain_queues()
            rc = await loop.run_in_executor(None, api.flush, self._handle, output_shim, None)
            await drain_queues()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        finally:
            if self._handle:
                api.destroy(self._handle)
                self._handle = None
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))


def load_native_plugin(registry: NodeRegistry, path: str) -> LoadedNativePlugin:
    """Load a plugin library and register its kind."""
    plugin = LoadedNativePlugin(path)
    registry.register(
        plugin.kind,
        lambda params: NativeNodeWrapper(plugin, params),
        description=plugin.description or f"native plugin ({os.path.basename(path)})",
    )
    return plugin


def load_plugins_dir(registry: NodeRegistry, directory: str) -> List[LoadedNativePlugin]:
    """Scan a directory for .so plugins (reference UnifiedPluginManager scan)."""
    loaded = []
    if not os.path.isdir(directory):
        return loaded
    for fn in sorted(os.listdir(directory)):
        if fn.endswith(".so"):
            try:
                loaded.append(load_native_plugin(registry, os.path.join(directory, fn)))
            except PluginError as e:  # skip broken libraries, keep loading others
                log.warning("failed to load native plugin %s: %s", fn, e)
    return loaded
