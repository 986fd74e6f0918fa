# SPDX-License-Identifier: Apache-2.0
"""Component-binary assembler: wraps a core module into a plugin component.

Port of the JAX package's ``plugins/component_asm.py``, unchanged.
The reference builds its WASM plugins with cargo-component against the
``streamkit:plugin`` world (``wit/plugin.wit``, ``sdks/plugin-sdk``); no
wasm toolchain ships in this image, so this module is the in-environment
component SDK. It emits the layer-1 component sections the loader
(``plugins/component.py``) consumes: type, import (host interface), alias,
core-module, canon (resource builtins + lower/lift), core-instance,
instance, and export sections — the same single-main-module shape
``cargo component`` produces for small plugins.

Section-order note: a strict component validator requires definitions
before use; toolchains satisfy it with an adapter/fixup module. Our loader
resolves references after a full parse, so this builder emits the simpler
forward-referencing order (canon lowers before the core instance whose
memory they name). The loader accepts both shapes.

``build_gain_component()`` assembles a complete *guest* gain plugin in raw
wasm (bump allocator, canonical-ABI lowered/lifted signatures, resource rep
state, host ``send-output`` call) and wraps it — the end-to-end fixture for
``tests/test_torch_wasm_component.py`` and for ``chip_smoke.py``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

from .component import (
    MAX_FLAT_PARAMS,
    MAX_FLAT_RESULTS,
    PRIM_BYTE,
    Resource,
    _align_to,
    _variant_cases,
    _discriminant_size,
    flatten_type,
    size_align,
    wit_plugin_world,
)
from .wasm_asm import leb, sleb

__all__ = ["ComponentBuilder", "build_plugin_component", "build_gain_component"]

NODE_IFACE = "streamkit:plugin/node@0.1.0"
HOST_IFACE = "streamkit:plugin/host@0.1.0"
EXPORT_SHIM = f"[export]{NODE_IFACE}"


def _name(s: str) -> bytes:
    b = s.encode()
    return leb(len(b)) + b


def _extern_name(s: str) -> bytes:
    return b"\x00" + _name(s)


class _TypeEncoder:
    """Encodes parser-shaped types into a component type section, memoized
    by structure (Resource objects by identity)."""

    def __init__(self) -> None:
        self.entries: List[bytes] = []
        self._memo: Dict[Any, int] = {}

    def _key(self, t: Any):
        return id(t) if isinstance(t, Resource) else t

    def index_of(self, t: Any) -> int:
        key = self._key(t)
        if key in self._memo:
            return self._memo[key]
        enc = self._encode_deftype(t)
        self.entries.append(enc)
        idx = len(self.entries) - 1
        self._memo[key] = idx
        return idx

    def valtype(self, t: Any) -> bytes:
        if isinstance(t, str):
            return bytes([PRIM_BYTE[t]])
        return sleb(self.index_of(t))

    def _encode_deftype(self, t: Any) -> bytes:
        if isinstance(t, Resource):
            return bytes([0x3F, 0x7F, 0x00])  # rep i32, no dtor
        if isinstance(t, str):
            return bytes([PRIM_BYTE[t]])
        kind = t[0]
        if kind == "record":
            out = bytearray([0x72]) + leb(len(t[1]))
            for fname, ft in t[1]:
                vt = self.valtype(ft)  # encode deps first
                out += _name(fname) + vt
            return bytes(out)
        if kind == "variant":
            out = bytearray([0x71]) + leb(len(t[1]))
            for cname, ct in t[1]:
                vt = b"\x01" + self.valtype(ct) if ct is not None else b"\x00"
                out += _name(cname) + vt + b"\x00"  # no refines
            return bytes(out)
        if kind == "list":
            return bytes([0x70]) + self.valtype(t[1])
        if kind == "tuple":
            return bytes([0x6F]) + leb(len(t[1])) + b"".join(self.valtype(x) for x in t[1])
        if kind == "flags":
            return bytes([0x6E]) + leb(len(t[1])) + b"".join(_name(n) for n in t[1])
        if kind == "enum":
            return bytes([0x6D]) + leb(len(t[1])) + b"".join(_name(n) for n in t[1])
        if kind == "option":
            return bytes([0x6B]) + self.valtype(t[1])
        if kind == "result":
            ok = b"\x01" + self.valtype(t[1]) if t[1] is not None else b"\x00"
            err = b"\x01" + self.valtype(t[2]) if t[2] is not None else b"\x00"
            return bytes([0x6A]) + ok + err
        if kind == "own":
            return bytes([0x69]) + leb(self.index_of(t[1]))
        if kind == "borrow":
            return bytes([0x68]) + leb(self.index_of(t[1]))
        if kind == "func":
            params = bytearray(leb(len(t[1])))
            for pname, pt in t[1]:
                vt = self.valtype(pt)
                params += _name(pname) + vt
            if t[2] is None:
                results = b"\x01\x00"
            else:
                results = b"\x00" + self.valtype(t[2])
            return bytes([0x40]) + bytes(params) + results
        raise ValueError(f"cannot encode type {t!r}")


class ComponentBuilder:
    """Accumulates component sections in emission order."""

    def __init__(self) -> None:
        self.sections: List[Tuple[int, bytes]] = []

    def section(self, sid: int, payload: bytes) -> None:
        self.sections.append((sid, payload))

    def build(self) -> bytes:
        out = bytearray(b"\x00asm\x0d\x00\x01\x00")
        for sid, payload in self.sections:
            out += bytes([sid]) + leb(len(payload)) + payload
        return bytes(out)


def build_plugin_component(core_module: bytes, post_returns: tuple = ()) -> bytes:
    """Wrap a core module implementing the ``streamkit:plugin/node`` world
    exports into a component binary.

    The core module must export ``memory``, ``cabi_realloc``, and the five
    mangled node functions (``{NODE_IFACE}#metadata`` etc.), and may import
    ``{HOST_IFACE}.send-output/.log`` plus the canon resource builtins from
    ``{EXPORT_SHIM}``.

    ``post_returns``: node-func names whose lifts carry a post-return
    (canonopt 0x05) pointing at the core export
    ``cabi_post_{NODE_IFACE}#{name}`` — the structure wit-bindgen emits for
    every result-returning export (see the reference's generated bindings,
    ``sdks/plugin-sdk/wasm/rust/src/generated/plugin.rs`` export_name
    attributes). A real ``cargo component`` guest binary cannot be vendored
    in this environment (no Rust toolchain, no network egress), so the
    fixture replicates wit-bindgen's emitted structure instead: interface-
    qualified export names, ``cabi_realloc``, and ``cabi_post_*``.
    """
    world = wit_plugin_world()
    enc = _TypeEncoder()
    ni = world["node-instance"]

    host_funcs = ("send-output", "log")
    node_funcs = (
        "metadata",
        "[constructor]node-instance",
        "[method]node-instance.process",
        "[method]node-instance.update-params",
        "[method]node-instance.cleanup",
    )

    # root functype indices (encodes all dependent world types too)
    ftidx = {n: enc.index_of(world["funcs"][n]) for n in host_funcs + node_funcs}
    ni_idx = enc.index_of(ni)

    # host instance type: outer-alias the functypes, export funcs
    host_decls = bytearray(leb(len(host_funcs) * 2))
    local = 0
    for n in host_funcs:
        # alias outer ct=1 idx=ftidx[n] as a local type
        host_decls += bytes([0x02, 0x03, 0x02]) + leb(1) + leb(ftidx[n])
        # export the func with externdesc func(local type idx)
        host_decls += bytes([0x04]) + _extern_name(n) + bytes([0x01]) + leb(local)
        local += 1
    host_inst_type = bytes([0x42]) + bytes(host_decls)
    enc.entries.append(host_inst_type)
    host_inst_tidx = len(enc.entries) - 1

    b = ComponentBuilder()
    # S7 type
    b.section(7, leb(len(enc.entries)) + b"".join(enc.entries))
    # S10 import: the host interface instance            -> instances[0]
    b.section(
        10,
        leb(1) + _extern_name(HOST_IFACE) + bytes([0x05]) + leb(host_inst_tidx),
    )
    # S6 alias: host funcs from instances[0]             -> funcs[0], funcs[1]
    alias = bytearray(leb(len(host_funcs)))
    for n in host_funcs:
        alias += bytes([0x01, 0x00]) + leb(0) + _name(n)
    b.section(6, bytes(alias))
    # S1 core module                                     -> core module 0
    b.section(1, core_module)
    # S8 canon: resource builtins + lowers               -> core funcs 0..4
    canon = bytearray(leb(3 + len(host_funcs)))
    canon += bytes([0x02]) + leb(ni_idx)  # resource.new        -> cf0
    canon += bytes([0x03]) + leb(ni_idx)  # resource.drop       -> cf1
    canon += bytes([0x04]) + leb(ni_idx)  # resource.rep        -> cf2
    for i in range(len(host_funcs)):      # lower host funcs    -> cf3, cf4
        canon += bytes([0x01, 0x00]) + leb(i) + leb(0)
    b.section(8, bytes(canon))
    # S2 core instances:
    #   0: inline exports {send-output: cf3, log: cf4}
    #   1: inline exports {[resource-*]node-instance: cf0..cf2}
    #   2: instantiate module 0 with the two shim instances
    ci = bytearray(leb(3))
    ci += bytes([0x01]) + leb(len(host_funcs))
    for i, n in enumerate(host_funcs):
        ci += _name(n) + bytes([0x00]) + leb(3 + i)
    builtins = (
        ("[resource-new]node-instance", 0),
        ("[resource-drop]node-instance", 1),
        ("[resource-rep]node-instance", 2),
    )
    ci += bytes([0x01]) + leb(len(builtins))
    for n, idx in builtins:
        ci += _name(n) + bytes([0x00]) + leb(idx)
    ci += bytes([0x00]) + leb(0) + leb(2)
    ci += _name(HOST_IFACE) + bytes([0x12]) + leb(0)
    ci += _name(EXPORT_SHIM) + bytes([0x12]) + leb(1)
    b.section(2, bytes(ci))
    # S6 core alias: memory + cabi_realloc + lifted exports from instance 2
    #   core funcs: cabi_realloc -> cf5, node funcs -> cf6..cf10,
    #   post-returns -> cf11...
    alias = bytearray(leb(2 + len(node_funcs) + len(post_returns)))
    alias += bytes([0x00, 0x02, 0x01]) + leb(2) + _name("memory")  # core mem 0
    alias += bytes([0x00, 0x00, 0x01]) + leb(2) + _name("cabi_realloc")
    for n in node_funcs:
        alias += bytes([0x00, 0x00, 0x01]) + leb(2) + _name(f"{NODE_IFACE}#{n}")
    post_cf = {}
    for j, n in enumerate(post_returns):
        alias += bytes([0x00, 0x00, 0x01]) + leb(2) + _name(
            f"cabi_post_{NODE_IFACE}#{n}"
        )
        post_cf[n] = 6 + len(node_funcs) + j
    b.section(6, bytes(alias))
    # S8 canon lift node funcs (opts: utf8, memory 0, realloc cf5,
    # post-return cf where the guest exports one)  -> funcs[2]..funcs[6]
    canon = bytearray(leb(len(node_funcs)))
    for i, n in enumerate(node_funcs):
        n_opts = 3 + (1 if n in post_cf else 0)
        opts = leb(n_opts) + bytes([0x00]) + bytes([0x03]) + leb(0) + bytes([0x04]) + leb(5)
        if n in post_cf:
            opts += bytes([0x05]) + leb(post_cf[n])
        canon += bytes([0x00, 0x00]) + leb(6 + i) + opts + leb(ftidx[n])
    b.section(8, bytes(canon))
    # S5 instance: inline-export the lifted funcs        -> instances[1]
    inst = bytearray(leb(1) + bytes([0x01]) + leb(len(node_funcs)))
    for i, n in enumerate(node_funcs):
        inst += _extern_name(n) + bytes([0x01]) + leb(2 + i)
    b.section(5, bytes(inst))
    # S11 export the node interface
    b.section(
        11, leb(1) + _extern_name(NODE_IFACE) + bytes([0x05]) + leb(1) + b"\x00"
    )
    return b.build()


# ----------------------------------------------------------- static lowering


class _StaticMemory:
    """Duck-typed stand-in for ComponentInstance so ``_Cabi`` can lower
    constant data (the metadata blob) into a Python bytearray at build
    time — guaranteeing the blob layout matches the loader's reader."""

    class _Core:
        def __init__(self, full: bytearray) -> None:
            self._full = full

        def memory(self) -> memoryview:
            return memoryview(self._full)

    def __init__(self, base: int, size: int = 1 << 20) -> None:
        self.base = base
        # one persistent buffer addressed as guest memory [0, base+size)
        self.full = bytearray(base + size)
        self.brk = 0
        self.core = _StaticMemory._Core(self.full)

    def call_core(self, name: str, *args: int, nresults: int = 1) -> List[int]:
        if name != "cabi_realloc":
            raise RuntimeError("static lowering only supports cabi_realloc")
        _old, _osz, align, size = args
        self.brk = _align_to(self.brk, align)
        ptr = self.base + self.brk
        self.brk += size
        if ptr + size > len(self.full):
            raise RuntimeError("static area overflow")
        return [ptr]


def lower_static(t: Any, value: Any, base: int) -> Tuple[int, bytes]:
    """Lower ``value`` of type ``t`` into a static blob that will live at
    guest address ``base``. Returns (root_ptr, blob_bytes)."""
    from .component import _Cabi

    sm = _StaticMemory(base)
    cabi = _Cabi(sm)  # type: ignore[arg-type]
    size, align = size_align(t)
    root = sm.call_core("cabi_realloc", 0, 0, align, size)[0]
    cabi.store(t, value, root)  # nested allocs land after the root record
    blob = bytes(sm.full[sm.base : sm.base + sm.brk])
    return root, blob


# --------------------------------------------------------------- gain guest


def build_gain_component(pin_out: str = "out") -> bytes:
    """A complete gain plugin as a component (the e2e test fixture).

    Guest behavior (mirrors the reference's example gain plugin semantics):
      * ``metadata()`` — static node-metadata record
      * ``constructor(params)`` — state = {gain f32}; a leading ASCII digit
        in the params string sets the gain (the ABI, not JSON parsing, is
        what this fixture exercises); registers the state pointer via
        ``[resource-new]node-instance``
      * ``process(self, pin, packet)`` — scales raw-audio samples in place
        and re-emits the packet through host ``send-output``
      * ``update-params(self, params)`` — same digit convention
      * ``cleanup(self)`` — no-op
    """
    from .wasm_asm import (
        BLOCK,
        BR,
        BR_IF,
        CALL,
        END,
        F32,
        F32_CONVERT_I32_S,
        F32_LOAD,
        F32_MUL,
        F32_STORE,
        GLOBAL_GET,
        GLOBAL_SET,
        I32,
        I32_ADD,
        I32_AND,
        I32_CONST,
        I32_EQZ,
        I32_GE_U,
        I32_LOAD,
        I32_LOAD8_U,
        I32_NE,
        I32_STORE,
        I32_STORE8,
        I32_SUB,
        LOCAL_GET,
        LOCAL_SET,
        LOCAL_TEE,
        LOOP,
        WasmModuleBuilder,
        f32c,
        memarg,
    )

    world = wit_plugin_world()
    m = WasmModuleBuilder()

    packet_flat = len(flatten_type(world["packet"]))  # disc + 5 joined
    send_params = [I32] * (2 + packet_flat + 1)  # string + packet + retptr
    imp_send = m.add_import_func(HOST_IFACE, "send-output", send_params, [])
    imp_rnew = m.add_import_func(EXPORT_SHIM, "[resource-new]node-instance", [I32], [I32])
    imp_rrep = m.add_import_func(EXPORT_SHIM, "[resource-rep]node-instance", [I32], [I32])

    HEAP_BASE = 0x1_0000  # static data lives below 64 KiB
    HEAP_CAP = 40 * (1 << 20)
    g_heap = m.add_global(I32, True, bytes([I32_CONST]) + sleb(HEAP_BASE) + bytes([END]))
    m.set_memory(672)  # 42 MiB: heap base + 40 MiB wrap arena (under 64 MiB cap)

    # ---- cabi_realloc: bump allocator with wraparound (test-scale) ----------
    #   (old, old_size, align, new_size) -> ptr
    body = bytes(
        [
            # heap = (heap + align-1) & ~(align-1)
            GLOBAL_GET, g_heap,
            LOCAL_GET, 2,
            I32_ADD,
            I32_CONST, 0x01,
            I32_SUB,
            I32_CONST, 0x00,
            LOCAL_GET, 2,
            I32_SUB,
            I32_AND,
            LOCAL_SET, 4,
            # if heap + size > CAP: heap = HEAP_BASE (wrap: test-scale arena)
            LOCAL_GET, 4,
            LOCAL_GET, 3,
            I32_ADD,
        ]
    ) + bytes([I32_CONST]) + sleb(HEAP_CAP) + bytes(
        [
            I32_GE_U,
            0x04, 0x40,  # if (void)
            I32_CONST,
        ]
    ) + sleb(HEAP_BASE) + bytes(
        [
            LOCAL_SET, 4,
            END,
            # global = ptr + new_size; return ptr
            LOCAL_GET, 4,
            LOCAL_GET, 3,
            I32_ADD,
            GLOBAL_SET, g_heap,
            LOCAL_GET, 4,
            END,
        ]
    )
    f_realloc = m.add_func([I32, I32, I32, I32], [I32], body, locals_=[I32])

    # ---- metadata() -> i32 (static blob ptr) -------------------------------
    META_BASE = 0x1000
    nm = world["node-metadata"]
    raw_audio_any = ("raw-audio", {"sample-rate": 0, "channels": 0, "sample-format": "float32"})
    meta_value = {
        "kind": "plugin::wasm::gain",
        "inputs": [{"name": "in", "accepts-types": [raw_audio_any]}],
        "outputs": [{"name": pin_out, "produces-type": raw_audio_any}],
        "param-schema": '{"gain": "number 0-9"}',
        "categories": ["audio", "effects"],
    }
    meta_ptr, meta_blob = lower_static(nm, meta_value, META_BASE)
    m.add_data(META_BASE, meta_blob)
    f_meta = m.add_func([], [I32], bytes([I32_CONST]) + sleb(meta_ptr) + bytes([END]))

    # static pin-name string + host-call result scratch
    PIN_ADDR = 0x200
    m.add_data(PIN_ADDR, pin_out.encode())
    SCRATCH = 0x240

    # ---- digit-parse helper: (disc, ptr, len, state_ptr) -> () --------------
    #   the FIRST ASCII digit anywhere in the params string sets the gain,
    #   so both bare "3" and JSON '{"gain": 3}' work
    body = bytes(
        [
            BLOCK, 0x40,
            LOCAL_GET, 0,
            I32_EQZ,
            BR_IF, 0,
            # for i in range(len): if digit(mem[ptr+i]): gain = it; break
            I32_CONST, 0,
            LOCAL_SET, 5,
            BLOCK, 0x40,
            LOOP, 0x40,
            LOCAL_GET, 5,
            LOCAL_GET, 2,
            I32_GE_U,
            BR_IF, 2,  # out of string: no digit found — leave gain alone
            LOCAL_GET, 1,
            LOCAL_GET, 5,
            I32_ADD,
            I32_LOAD8_U,
        ]
    ) + memarg(0, 0) + bytes(
        [
            I32_CONST, 48,
            I32_SUB,
            LOCAL_TEE, 4,
            I32_CONST, 10,
            0x49,  # i32.lt_u
            BR_IF, 1,  # found a digit -> exit loop to the store below
            LOCAL_GET, 5,
            I32_CONST, 1,
            I32_ADD,
            LOCAL_SET, 5,
            BR, 0,
            END,  # loop
            END,  # scan block
            LOCAL_GET, 3,
            LOCAL_GET, 4,
            F32_CONVERT_I32_S,
            F32_STORE,
        ]
    ) + memarg(2, 0) + bytes([END, END])
    f_setgain = m.add_func([I32, I32, I32, I32], [], body, locals_=[I32, I32])

    # ---- constructor(disc, ptr, len) -> handle ------------------------------
    body = (
        bytes([I32_CONST, 0, I32_CONST, 0, I32_CONST, 4, I32_CONST, 8, CALL])
        + leb(f_realloc)
        + bytes([LOCAL_SET, 3])
        # default gain 1.0
        + bytes([LOCAL_GET, 3])
        + f32c(1.0)
        + bytes([F32_STORE])
        + memarg(2, 0)
        # apply digit param if provided
        + bytes([LOCAL_GET, 0, LOCAL_GET, 1, LOCAL_GET, 2, LOCAL_GET, 3, CALL])
        + leb(f_setgain)
        # handle = resource-new(state)
        + bytes([LOCAL_GET, 3, CALL])
        + leb(imp_rnew)
        + bytes([END])
    )
    f_ctor = m.add_func([I32, I32, I32], [I32], body, locals_=[I32])

    # ---- process(rep, pin_ptr, pin_len, disc, p0..p4) -> i32 ----------------
    # Lifted export with a spilled result: the CALLEE returns a pointer to
    # the result<_,string> area (canonical ABI for exports; imports instead
    # take a caller retptr — see send-output below).
    # packet flat: disc, then joined [p0..p4]; audio case uses p0=rate,
    # p1=channels, p2=samples_ptr, p3=samples_len (p4 unused)
    n_pkt = packet_flat - 1  # joined payload slots
    ARG_REP, ARG_PPTR, ARG_PLEN, ARG_DISC = 0, 1, 2, 3
    ARG_P0 = 4
    L_I = 4 + n_pkt  # loop counter local
    RESULT_AREA = 0x260  # static result<_,string> cell (12 bytes)
    body = bytearray()
    # self arrives as the BORROW handle (canonical ABI); unwrap to the rep
    # pointer via [resource-rep], like wit-bindgen shims do
    body += bytes([LOCAL_GET, ARG_REP, CALL]) + leb(imp_rrep)
    body += bytes([LOCAL_SET, ARG_REP])
    # write ok result immediately: disc byte 0 at the result area
    body += bytes([I32_CONST]) + sleb(RESULT_AREA)
    body += bytes([I32_CONST, 0, I32_STORE8]) + memarg(0, 0)
    # only audio packets (disc 0) are transformed
    body += bytes([BLOCK, 0x40, LOCAL_GET, ARG_DISC, BR_IF, 0])
    # loop: samples[i] *= gain
    body += bytes([I32_CONST, 0, LOCAL_SET, L_I])
    body += bytes([BLOCK, 0x40, LOOP, 0x40])
    body += bytes([LOCAL_GET, L_I, LOCAL_GET, ARG_P0 + 3, I32_GE_U, BR_IF, 1])
    # addr = samples_ptr + 4*i
    body += bytes(
        [
            LOCAL_GET, ARG_P0 + 2,
            LOCAL_GET, L_I,
            I32_CONST, 4,
            0x6C,  # i32.mul
            I32_ADD,
            LOCAL_TEE, L_I + 1,
            LOCAL_GET, L_I + 1,
            F32_LOAD,
        ]
    ) + memarg(2, 0)
    body += bytes([LOCAL_GET, ARG_REP, F32_LOAD]) + memarg(2, 0)
    body += bytes([F32_MUL, F32_STORE]) + memarg(2, 0)
    body += bytes([LOCAL_GET, L_I, I32_CONST, 1, I32_ADD, LOCAL_SET, L_I])
    body += bytes([0x0C, 0])  # br 0 (continue loop)
    body += bytes([END, END])  # loop, block
    # send-output("out", packet...) with scratch retptr
    body += bytes([I32_CONST]) + sleb(PIN_ADDR)
    body += bytes([I32_CONST]) + sleb(len(pin_out))
    body += bytes([LOCAL_GET, ARG_DISC])
    for i in range(n_pkt):
        body += bytes([LOCAL_GET, ARG_P0 + i])
    body += bytes([I32_CONST]) + sleb(SCRATCH)
    body += bytes([CALL]) + leb(imp_send)
    body += bytes([END])  # outer block
    body += bytes([I32_CONST]) + sleb(RESULT_AREA)
    body += bytes([END])
    f_proc = m.add_func(
        [I32] * (4 + n_pkt), [I32], bytes(body), locals_=[I32, I32]
    )

    # ---- update-params(self-handle, disc, ptr, len) -> i32 (result ptr) ----
    body = (
        bytes([LOCAL_GET, 0, CALL])
        + leb(imp_rrep)
        + bytes([LOCAL_SET, 0])  # unwrap borrow handle -> rep
        + bytes([I32_CONST])
        + sleb(RESULT_AREA)
        + bytes([I32_CONST, 0, I32_STORE8])
        + memarg(0, 0)
        + bytes([LOCAL_GET, 1, LOCAL_GET, 2, LOCAL_GET, 3, LOCAL_GET, 0, CALL])
        + leb(f_setgain)
        + bytes([I32_CONST])
        + sleb(RESULT_AREA)
        + bytes([END])
    )
    f_upd = m.add_func([I32] * 4, [I32], body)

    # ---- cleanup(self-handle) -> () -----------------------------------------
    f_clean = m.add_func([I32], [], bytes([END]))

    # ---- post-returns (wit-bindgen structure) -------------------------------
    # Invoked by the host AFTER lifting a call's results (canonopt 0x05) to
    # reclaim the return area. process/update-params POISON the shared
    # RESULT_AREA discriminant (0xEE = invalid variant case): a host that
    # lifts after post-return deterministically fails instead of silently
    # reading freed memory. metadata's blob is static -> genuine no-op.
    poison = (
        bytes([I32_CONST]) + sleb(RESULT_AREA)
        + bytes([I32_CONST]) + sleb(0xEE)
        + bytes([I32_STORE8]) + memarg(0, 0)
        + bytes([END])
    )
    f_post_rr = m.add_func([I32], [], poison)
    f_post_meta = m.add_func([I32], [], bytes([END]))

    m.export_memory("memory")
    m.export_func("cabi_realloc", f_realloc)
    m.export_func(f"{NODE_IFACE}#metadata", f_meta)
    m.export_func(f"{NODE_IFACE}#[constructor]node-instance", f_ctor)
    m.export_func(f"{NODE_IFACE}#[method]node-instance.process", f_proc)
    m.export_func(f"{NODE_IFACE}#[method]node-instance.update-params", f_upd)
    m.export_func(f"{NODE_IFACE}#[method]node-instance.cleanup", f_clean)
    m.export_func(f"cabi_post_{NODE_IFACE}#metadata", f_post_meta)
    m.export_func(f"cabi_post_{NODE_IFACE}#[method]node-instance.process", f_post_rr)
    m.export_func(
        f"cabi_post_{NODE_IFACE}#[method]node-instance.update-params", f_post_rr
    )
    return build_plugin_component(
        m.build(),
        post_returns=(
            "metadata",
            "[method]node-instance.process",
            "[method]node-instance.update-params",
        ),
    )
