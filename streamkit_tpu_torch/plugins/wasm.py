# SPDX-License-Identifier: Apache-2.0
"""WASM plugin host: sandboxed pure-compute plugins over the C++ interpreter.

Port of the JAX package's ``plugins/wasm.py``. Parity target: the reference
hosts Component-Model plugins via wasmtime with a 64 MiB store cap and
per-call limits (``crates/plugin-wasm/src/lib.rs:40-57,319``). The runtime is
the from-scratch interpreter in ``streamkit_tpu_torch/csrc/wasm_rt.cpp``
(same guardrails: 64 MiB memory cap, per-call fuel budget, no host imports
for core modules), built by the port itself with ``g++`` at first use.

Plugin ABI (documented divergence from the reference's WIT world — no
component model in this environment; see ``wasm_asm.py`` for the in-env SDK):

* ``sk_alloc(size: i32) -> i32`` — reserve a region in linear memory
* ``sk_process(ptr: i32, len: i32) -> i64`` — transform the payload in
  linear memory; returns ``(out_ptr << 32) | out_len`` (0 = drop packet)
* ``sk_set_f32(idx: i32, value: f32)`` — optional: numeric params, applied
  in sorted-key order at init and on live tunes
"""

from __future__ import annotations

import asyncio
import ctypes
import os
import struct
from typing import List, Optional

import numpy as np

from ..core import (
    AudioFrame,
    InputPin,
    NodeContext,
    NodeRegistry,
    NodeStatsTracker,
    OutputPin,
    Packet,
    PacketType,
    ProcessorNode,
)
from ..core.state import NodeState, StopReason
from ..ops import _build

__all__ = ["SOURCE", "WasmRuntime", "WasmInstance", "LoadedWasmPlugin", "WasmNodeWrapper", "load_wasm_plugin"]

SOURCE = _build.Source("wasm_rt.cpp", "g++")

DEFAULT_FUEL = 200_000_000  # per-call instruction budget (≈ tens of ms)
_ERRLEN = 256


def _declare(lib: ctypes.CDLL) -> None:
    vp, sz, cp = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p
    i64p = ctypes.POINTER(ctypes.c_int64)
    sigs = {
        "skwasm_load": (vp, [cp, sz, cp, sz]),
        "skwasm_free": (None, [vp]),
        "skwasm_call": (ctypes.c_int, [vp, cp, i64p, ctypes.c_int, i64p, ctypes.c_int, ctypes.c_uint64, cp, sz]),
        "skwasm_memory": (ctypes.POINTER(ctypes.c_uint8), [vp, ctypes.POINTER(sz)]),
        "skwasm_has_export": (ctypes.c_int, [vp, cp]),
        "skwasm_memory_grow": (ctypes.c_int, [vp, sz, cp, sz]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


class WasmRuntime:
    """ctypes binding to the port's build of ``csrc/wasm_rt.cpp``.

    The interpreter is compiled with ``g++`` into ``_build/`` at the first
    load of a plugin (:mod:`..ops._build`) and no other library is ever
    loaded in its place. Without ``g++`` loading a plugin raises a
    ``RuntimeError`` naming the runtime; where ``g++`` is present a failed
    build raises with the compiler's messages."""

    @staticmethod
    def lib() -> ctypes.CDLL:
        try:
            return _build.load(SOURCE, _declare)
        except RuntimeError as e:
            raise RuntimeError(f"the WASM plugin runtime (csrc/{SOURCE.file}) is unavailable: {e}") from e


class WasmInstance:
    """One instantiated module."""

    def __init__(self, wasm_bytes: bytes, fuel: int = DEFAULT_FUEL) -> None:
        self._lib = WasmRuntime.lib()
        err = ctypes.create_string_buffer(_ERRLEN)
        self._h = self._lib.skwasm_load(wasm_bytes, len(wasm_bytes), err, _ERRLEN)
        if not self._h:
            raise ValueError(f"wasm load failed: {err.value.decode()}")
        self.fuel = fuel

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.skwasm_free(h)
            self._h = None

    def has_export(self, name: str) -> bool:
        return bool(self._lib.skwasm_has_export(self._h, name.encode()))

    def call(self, name: str, *args: int, nresults: int = 1) -> List[int]:
        c_args = (ctypes.c_int64 * max(1, len(args)))(*args)
        c_res = (ctypes.c_int64 * max(1, nresults))()
        err = ctypes.create_string_buffer(_ERRLEN)
        rc = self._lib.skwasm_call(
            self._h, name.encode(), c_args, len(args), c_res, nresults, self.fuel, err, _ERRLEN
        )
        if rc != 0:
            raise RuntimeError(f"wasm call {name} failed: {err.value.decode()}")
        return list(c_res[:nresults])

    def memory(self) -> memoryview:
        size = ctypes.c_size_t()
        ptr = self._lib.skwasm_memory(self._h, ctypes.byref(size))
        return memoryview((ctypes.c_uint8 * size.value).from_address(
            ctypes.addressof(ptr.contents)
        )).cast("B")

    # -- plugin ABI helpers ---------------------------------------------------

    def write(self, data: bytes) -> int:
        """Allocate guest memory and copy data in. Returns guest pointer."""
        (ptr,) = self.call("sk_alloc", len(data))
        mem = self.memory()
        mem[ptr : ptr + len(data)] = data
        return ptr

    def process(self, data: bytes, f32_params: Optional[List[float]] = None) -> Optional[bytes]:
        if f32_params and self.has_export("sk_set_f32"):
            for i, v in enumerate(f32_params):
                bits = int.from_bytes(struct.pack("<f", float(v)), "little")
                self.call("sk_set_f32", i, bits, nresults=0)
        ptr = self.write(data)
        (packed,) = self.call("sk_process", ptr, len(data))
        packed &= (1 << 64) - 1
        out_ptr, out_len = packed >> 32, packed & 0xFFFFFFFF
        if out_len == 0:
            return None
        mem = self.memory()
        return bytes(mem[out_ptr : out_ptr + out_len])


class LoadedWasmPlugin:
    """Loaded module bytes + metadata; instantiated per node."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.wasm_bytes = open(path, "rb").read()
        self.name = os.path.splitext(os.path.basename(path))[0]
        self.kind = f"plugin::wasm::{self.name}"
        # validate now so load errors surface at upload time
        inst = WasmInstance(self.wasm_bytes)
        for req in ("sk_alloc", "sk_process"):
            if not inst.has_export(req):
                raise ValueError(f"wasm plugin missing required export {req!r}")

    def create_instance(self, params: Optional[dict]) -> "WasmNodeWrapper":
        return WasmNodeWrapper(self, params)


class WasmNodeWrapper(ProcessorNode):
    """Pipeline node backed by a WASM instance (one instance per node —
    plugins are single-threaded over their own linear memory).

    A binary packet's bytes are the payload, as in the JAX package. An audio
    packet's payload is its interleaved samples as little-endian f32, and the
    result is an audio packet of the same format and metadata; the JAX host
    passes audio packets through untouched (ROADMAP §3). Other packets pass
    through."""

    KIND = "plugin::wasm::<dynamic>"

    def __init__(self, plugin: LoadedWasmPlugin, params: Optional[dict]) -> None:
        self.plugin = plugin
        self.params = dict(params or {})

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.any()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.any())]

    def _f32_params(self) -> List[float]:
        vals = []
        for k in sorted(self.params):
            try:
                vals.append(float(self.params[k]))
            except (TypeError, ValueError):
                pass
        return vals

    async def run(self, ctx: NodeContext) -> None:
        inst = WasmInstance(self.plugin.wasm_bytes)
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        ctx.emit_state(NodeState.running())
        f32s = self._f32_params()
        loop = asyncio.get_running_loop()
        first = True
        while True:
            pkt = await ctx.recv_with_cancellation("in")
            if pkt is None:
                break
            stats.packet_received()
            msg = ctx.poll_control()
            if msg is not None and getattr(msg, "op", "") == "update_params":
                self.params.update(msg.params or {})
                f32s = self._f32_params()
                first = True
            if pkt.binary is None and pkt.audio is None:
                await ctx.output.send("out", pkt)
                continue
            if pkt.audio is not None:
                data = np.ascontiguousarray(pkt.audio.samples, dtype="<f4").tobytes()
            else:
                data = pkt.binary
            params = f32s if first else None
            first = False
            # interpreter work runs in the executor: keep the event loop live
            out = await loop.run_in_executor(None, inst.process, data, params)
            if out is None:
                continue
            if pkt.audio is not None:
                fmt = pkt.audio.format
                if len(out) % (4 * fmt.channels):
                    raise RuntimeError(f"{self.plugin.kind}: {len(out)} bytes are not whole f32 frames "
                                       f"of {fmt.channels} channel(s)")
                out_pkt = Packet.new_audio(AudioFrame(np.frombuffer(out, "<f4").copy(), fmt), pkt.metadata)
            else:
                out_pkt = Packet.new_binary(out, content_type=pkt.content_type, metadata=pkt.metadata)
            await ctx.output.send("out", out_pkt)
            stats.packet_sent()
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))


def load_wasm_plugin(registry: NodeRegistry, path: str):
    """Load + register a wasm plugin as ``plugin::wasm::<name>``.

    Layer-1 binaries (components — the reference's plugin format,
    ``wit/plugin.wit``) route to the component host; layer-0 core modules
    use the classic pure-compute ABI above."""
    with open(path, "rb") as f:
        head = f.read(8)
    if len(head) >= 8 and head[6:8] == b"\x01\x00":
        from .component import load_component_plugin

        return load_component_plugin(registry, path)
    plugin = LoadedWasmPlugin(path)

    def factory(params):
        return plugin.create_instance(params)

    registry.register(plugin.kind, lambda params: factory(params), description=f"WASM plugin {plugin.name}")
    return plugin
