# SPDX-License-Identifier: Apache-2.0
"""Tiny WebAssembly module assembler.

Port of the JAX package's ``plugins/wasm_asm.py``, plus
:func:`build_gain_wasm`, the example gain plugin that
``native/plugins/gain_wasm/build_gain_wasm.py`` assembles for the JAX package
(the same bytes).

The reference's WASM SDK compiles plugins from Rust/C via wasm toolchains
(``wit/plugin.wit``, ``sdks/``); this image has no wasm compiler, so this
module is the in-environment SDK: it assembles core wasm binaries directly
(types, functions, memory, globals, exports, code) for plugin authors and
tests. Opcodes are exposed as constants plus small helper encoders.

Example — an add function:

    b = WasmModuleBuilder()
    f = b.add_func([I32, I32], [I32],
                   body=bytes([LOCAL_GET, 0, LOCAL_GET, 1, I32_ADD, END]))
    b.export_func("add", f)
    wasm_bytes = b.build()
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

__all__ = ["WasmModuleBuilder", "build_gain_wasm", "leb", "sleb", "f32c"]

# value types
I32, I64, F32, F64 = 0x7F, 0x7E, 0x7D, 0x7C
VOID = 0x40

# opcodes (the subset plugin bodies typically need)
UNREACHABLE, NOP = 0x00, 0x01
BLOCK, LOOP, IF, ELSE, END = 0x02, 0x03, 0x04, 0x05, 0x0B
BR, BR_IF, RETURN, CALL = 0x0C, 0x0D, 0x0F, 0x10
DROP, SELECT = 0x1A, 0x1B
LOCAL_GET, LOCAL_SET, LOCAL_TEE = 0x20, 0x21, 0x22
GLOBAL_GET, GLOBAL_SET = 0x23, 0x24
I32_LOAD, I64_LOAD, F32_LOAD, F64_LOAD = 0x28, 0x29, 0x2A, 0x2B
I32_LOAD8_S, I32_LOAD8_U, I32_LOAD16_S, I32_LOAD16_U = 0x2C, 0x2D, 0x2E, 0x2F
I32_STORE, I64_STORE, F32_STORE, F64_STORE = 0x36, 0x37, 0x38, 0x39
I32_STORE8, I32_STORE16 = 0x3A, 0x3B
MEMORY_SIZE, MEMORY_GROW = 0x3F, 0x40
I32_CONST, I64_CONST, F32_CONST, F64_CONST = 0x41, 0x42, 0x43, 0x44
I32_EQZ, I32_EQ, I32_NE, I32_LT_S, I32_LT_U, I32_GT_S, I32_GT_U = (
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x4B,
)
I32_LE_S, I32_LE_U, I32_GE_S, I32_GE_U = 0x4C, 0x4D, 0x4E, 0x4F
I32_ADD, I32_SUB, I32_MUL, I32_DIV_S, I32_DIV_U = 0x6A, 0x6B, 0x6C, 0x6D, 0x6E
I32_AND, I32_OR, I32_XOR, I32_SHL, I32_SHR_S, I32_SHR_U = 0x71, 0x72, 0x73, 0x74, 0x75, 0x76
I64_ADD, I64_SUB, I64_MUL = 0x7C, 0x7D, 0x7E
I64_SHL, I64_OR = 0x86, 0x84
F32_ABS, F32_NEG, F32_SQRT = 0x8B, 0x8C, 0x91
F32_ADD, F32_SUB, F32_MUL, F32_DIV, F32_MIN, F32_MAX = 0x92, 0x93, 0x94, 0x95, 0x96, 0x97
F32_GT = 0x5E
F32_LT = 0x5D
I32_TRUNC_F32_S = 0xA8
I64_EXTEND_I32_S, I64_EXTEND_I32_U = 0xAC, 0xAD
F32_CONVERT_I32_S = 0xB2
F32_DEMOTE_F64 = 0xB6
I32_WRAP_I64 = 0xA7


def leb(v: int) -> bytes:
    """Unsigned LEB128."""
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def sleb(v: int) -> bytes:
    """Signed LEB128."""
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if (v == 0 and not (b & 0x40)) or (v == -1 and (b & 0x40)):
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def f32c(value: float) -> bytes:
    """f32.const opcode + immediate."""
    return bytes([F32_CONST]) + struct.pack("<f", value)


def memarg(align: int = 2, offset: int = 0) -> bytes:
    return leb(align) + leb(offset)


class WasmModuleBuilder:
    def __init__(self) -> None:
        self._types: List[Tuple[tuple, tuple]] = []
        self._imports: List[Tuple[str, str, int]] = []  # (module, field, type idx)
        self._funcs: List[int] = []  # type index per function
        self._bodies: List[bytes] = []
        self._locals: List[List[int]] = []
        self._globals: List[Tuple[int, bool, bytes]] = []  # (type, mut, init expr)
        self._exports: List[Tuple[str, int, int]] = []  # (name, kind, index)
        self._mem_min_pages = 1
        self._data: List[Tuple[int, bytes]] = []

    def add_import_func(self, module: str, field: str, params: Sequence[int],
                        results: Sequence[int]) -> int:
        """Declare a function import (must precede all add_func calls —
        imports occupy the front of the function index space). Returns the
        function index usable in CALL."""
        if self._funcs:
            raise ValueError("declare imports before local functions")
        self._imports.append((module, field, self._type_idx(params, results)))
        return len(self._imports) - 1

    def _type_idx(self, params: Sequence[int], results: Sequence[int]) -> int:
        key = (tuple(params), tuple(results))
        for i, t in enumerate(self._types):
            if t == key:
                return i
        self._types.append(key)
        return len(self._types) - 1

    def add_func(
        self,
        params: Sequence[int],
        results: Sequence[int],
        body: bytes,
        locals_: Optional[Sequence[int]] = None,
    ) -> int:
        """Add a function; ``body`` must end with END. Returns func index
        (offset past any imports — the shared function index space)."""
        self._funcs.append(self._type_idx(params, results))
        self._locals.append(list(locals_ or []))
        self._bodies.append(body)
        return len(self._imports) + len(self._funcs) - 1

    def add_global(self, vtype: int, mutable: bool, init_expr: bytes) -> int:
        """``init_expr`` must end with END, e.g. f32c(1.0)+bytes([END])."""
        self._globals.append((vtype, mutable, init_expr))
        return len(self._globals) - 1

    def set_memory(self, min_pages: int) -> None:
        self._mem_min_pages = min_pages

    def add_data(self, offset: int, data: bytes) -> None:
        self._data.append((offset, data))

    def export_func(self, name: str, func_idx: int) -> None:
        self._exports.append((name, 0, func_idx))

    def export_memory(self, name: str = "memory") -> None:
        self._exports.append((name, 2, 0))

    @staticmethod
    def _section(sid: int, payload: bytes) -> bytes:
        return bytes([sid]) + leb(len(payload)) + payload

    def build(self) -> bytes:
        out = bytearray(b"\x00asm\x01\x00\x00\x00")
        # types
        p = leb(len(self._types))
        for params, results in self._types:
            p += b"\x60" + leb(len(params)) + bytes(params)
            p += leb(len(results)) + bytes(results)
        out += self._section(1, p)
        # imports
        if self._imports:
            p = leb(len(self._imports))
            for module, field, tidx in self._imports:
                mb, fb = module.encode(), field.encode()
                p += leb(len(mb)) + mb + leb(len(fb)) + fb + b"\x00" + leb(tidx)
            out += self._section(2, p)
        # functions
        p = leb(len(self._funcs)) + b"".join(leb(t) for t in self._funcs)
        out += self._section(3, p)
        # memory
        out += self._section(5, leb(1) + b"\x00" + leb(self._mem_min_pages))
        # globals
        if self._globals:
            p = leb(len(self._globals))
            for vtype, mut, init in self._globals:
                p += bytes([vtype, 1 if mut else 0]) + init
            out += self._section(6, p)
        # exports
        p = leb(len(self._exports))
        for name, kind, idx in self._exports:
            nb = name.encode()
            p += leb(len(nb)) + nb + bytes([kind]) + leb(idx)
        out += self._section(7, p)
        # code
        p = leb(len(self._bodies))
        for locals_, body in zip(self._locals, self._bodies):
            # group consecutive same-type locals
            groups: List[Tuple[int, int]] = []
            for t in locals_:
                if groups and groups[-1][1] == t:
                    groups[-1] = (groups[-1][0] + 1, t)
                else:
                    groups.append((1, t))
            lb = leb(len(groups)) + b"".join(leb(c) + bytes([t]) for c, t in groups)
            fb = lb + body
            p += leb(len(fb)) + fb
        out += self._section(10, p)
        # data
        if self._data:
            p = leb(len(self._data))
            for offset, data in self._data:
                p += leb(0) + bytes([I32_CONST]) + sleb(offset) + bytes([END])
                p += leb(len(data)) + data
            out += self._section(11, p)
        return bytes(out)


def build_gain_wasm() -> bytes:
    """The example core-module gain plugin (``sk_alloc`` / ``sk_process`` /
    ``sk_set_f32``, see :mod:`.wasm`): multiplies little-endian f32 samples
    by a tunable gain (param 0, default 1.0) in place."""
    b = WasmModuleBuilder()
    heap = b.add_global(I32, True, bytes([I32_CONST]) + sleb(1024) + bytes([END]))
    gain = b.add_global(F32, True, f32c(1.0) + bytes([END]))

    # sk_alloc(size: i32) -> i32  (bump allocator + memory.grow on demand)
    body = bytes(
        [
            GLOBAL_GET, heap,
            LOCAL_SET, 1,                       # old = heap
            GLOBAL_GET, heap,
            LOCAL_GET, 0,
            I32_ADD,
            I32_CONST, 15,
            I32_ADD,
            I32_CONST, 0x70,                    # sleb(-16)
            I32_AND,
            GLOBAL_SET, heap,                   # heap = align16(heap + size)
            # need = ((heap + 65535) >> 16) - memory.size
            GLOBAL_GET, heap,
        ]
    ) + bytes([I32_CONST]) + sleb(65535) + bytes(
        [
            I32_ADD,
            I32_CONST, 16,
            I32_SHR_U,
            MEMORY_SIZE, 0,
            I32_SUB,
            LOCAL_TEE, 2,
            I32_CONST, 0,
            I32_GT_S,
            IF, VOID,
            LOCAL_GET, 2,
            MEMORY_GROW, 0,
            DROP,
            END,
            LOCAL_GET, 1,
            END,
        ]
    )
    alloc = b.add_func([I32], [I32], body, locals_=[I32, I32])

    # sk_set_f32(idx: i32, value: f32)
    body = bytes([LOCAL_GET, 0, I32_EQZ, IF, VOID, LOCAL_GET, 1, GLOBAL_SET, gain, END, END])
    set_f32 = b.add_func([I32, F32], [], body)

    # sk_process(ptr: i32, len: i32) -> i64 packed (ptr<<32 | len)
    body = bytes(
        [
            # n = len >> 2
            LOCAL_GET, 1,
            I32_CONST, 2,
            I32_SHR_U,
            LOCAL_SET, 3,
            BLOCK, VOID,
            LOOP, VOID,
            LOCAL_GET, 2,
            LOCAL_GET, 3,
            I32_GE_U,
            BR_IF, 1,
            # addr = ptr + (i << 2)
            LOCAL_GET, 0,
            LOCAL_GET, 2,
            I32_CONST, 2,
            I32_SHL,
            I32_ADD,
            LOCAL_TEE, 4,
            # value = f32.load(addr) * gain
            LOCAL_GET, 4,
            F32_LOAD,
        ]
    ) + memarg(2, 0) + bytes([GLOBAL_GET, gain, F32_MUL, F32_STORE]) + memarg(2, 0) + bytes(
        [
            # i += 1
            LOCAL_GET, 2,
            I32_CONST, 1,
            I32_ADD,
            LOCAL_SET, 2,
            BR, 0,
            END,
            END,
            # return (i64(ptr) << 32) | i64(len)
            LOCAL_GET, 0,
            I64_EXTEND_I32_U,
            I64_CONST, 32,
            I64_SHL,
            LOCAL_GET, 1,
            I64_EXTEND_I32_U,
            I64_OR,
            END,
        ]
    )
    process = b.add_func([I32, I32], [I64], body, locals_=[I32, I32, I32])

    b.export_memory()
    b.export_func("sk_alloc", alloc)
    b.export_func("sk_set_f32", set_f32)
    b.export_func("sk_process", process)
    return b.build()
