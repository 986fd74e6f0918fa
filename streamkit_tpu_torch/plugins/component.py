# SPDX-License-Identifier: Apache-2.0
"""WebAssembly Component Model host: loads component-binary plugins.

Port of the JAX package's ``plugins/component.py``. Parity target: the
reference hosts its WASM plugins as *components* — WIT
world ``streamkit:plugin/plugin`` (``wit/plugin.wit:83-130``) executed by
wasmtime's component support (``crates/plugin-wasm/src/lib.rs:40-57``,
bindgen in ``build.rs``). Round-2 shipped only a core-wasm host with a
bespoke ABI (``plugins/wasm.py``); this module closes the gap from scratch:

* a **component binary parser** (layer-1 ``\\0asm`` preamble) covering the
  section grammar a single-module plugin component uses: core-module,
  core-instance, alias, type, canon (lift/lower/resource.*), import,
  instance, and export sections. The type grammar was pinned against the
  reference's own binary WIT package
  (``sdks/plugin-sdk/wit/streamkit-plugin.wasm``) — see
  ``tests/test_wasm_component.py`` and ``tests/test_torch_wasm_component.py``.
* the **canonical ABI**: flattening (MAX_FLAT_PARAMS=16 /
  MAX_FLAT_RESULTS=1, spill-to-memory via ``cabi_realloc``), utf8 strings,
  records/variants/enums/options/results/lists/flags, and own/borrow
  resource handles with a host-side handle table.
* a **host runtime** binding the component's lowered imports
  (``streamkit:plugin/host`` ``send-output``/``log``, canon resource
  builtins, ``wasi:*`` stubs) onto the sandboxed core-wasm interpreter
  (the port's ``csrc/wasm_rt.cpp``, :class:`.wasm.WasmRuntime`) through its
  host-callback C API.

Scope notes (documented divergence): single main core module per component
(the shape ``cargo component`` emits for small plugins — no adapter-module
fusion), utf8 only, sync canon only, and WASI imports are served by stubs
(environ/clocks/random/stdout) rather than a full WASI implementation —
the reference grants plugins no ambient capabilities either (wasmtime
store limits, ``lib.rs:40-57``).
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "ComponentError",
    "Resource",
    "parse_component",
    "ParsedComponent",
    "ComponentInstance",
    "wit_plugin_world",
    "describe_wit_package",
]


class ComponentError(ValueError):
    """Malformed or unsupported component binary."""


# --------------------------------------------------------------------- types
#
# Component-model value types as plain Python data (shared by the parser,
# the canonical ABI, and the test-side component builder):
#   primitives          -> 'bool' 'u8' 's8' ... 'f64' 'char' 'string'
#   record              -> ('record', ((name, t), ...))
#   variant             -> ('variant', ((name, t | None), ...))
#   list                -> ('list', t)
#   tuple               -> ('tuple', (t, ...))
#   flags               -> ('flags', (name, ...))
#   enum                -> ('enum', (name, ...))
#   option              -> ('option', t)
#   result              -> ('result', ok | None, err | None)
#   own/borrow          -> ('own', Resource) / ('borrow', Resource)
#   func                -> ('func', ((pname, t), ...), result | None)
#   instance            -> ('instance', {export_name: ('func', ft) |
#                             ('type', t)})
#   component           -> ('component', {name: decl})


class Resource:
    """Generative resource identity (WIT ``resource``). Equality is object
    identity — two resource declarations are distinct types even with the
    same name, matching component-model semantics."""

    __slots__ = ("name",)

    def __init__(self, name: str = "resource") -> None:
        self.name = name

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<resource {self.name} @{id(self):x}>"


_PRIM_BY_BYTE = {
    0x7F: "bool",
    0x7E: "s8",
    0x7D: "u8",
    0x7C: "s16",
    0x7B: "u16",
    0x7A: "s32",
    0x79: "u32",
    0x78: "s64",
    0x77: "u64",
    0x76: "f32",
    0x75: "f64",
    0x74: "char",
    0x73: "string",
}
PRIM_BYTE = {v: k for k, v in _PRIM_BY_BYTE.items()}


class _Reader:
    __slots__ = ("d", "i", "end")

    def __init__(self, data: bytes, start: int = 0, end: Optional[int] = None):
        self.d = data
        self.i = start
        self.end = len(data) if end is None else end

    def eof(self) -> bool:
        return self.i >= self.end

    def u8(self) -> int:
        if self.i >= self.end:
            raise ComponentError("truncated component binary")
        b = self.d[self.i]
        self.i += 1
        return b

    def u32(self) -> int:
        r = s = 0
        while True:
            b = self.u8()
            r |= (b & 0x7F) << s
            s += 7
            if not b & 0x80:
                return r
            if s > 35:
                raise ComponentError("uleb too long")

    def s33(self) -> int:
        r = s = 0
        while True:
            b = self.u8()
            r |= (b & 0x7F) << s
            s += 7
            if not b & 0x80:
                if b & 0x40 and s < 64:
                    r -= 1 << s
                return r
            if s > 40:
                raise ComponentError("sleb too long")

    def raw(self, n: int) -> bytes:
        if self.end - self.i < n:
            raise ComponentError("truncated component binary")
        out = self.d[self.i : self.i + n]
        self.i += n
        return out

    def name(self) -> str:
        n = self.u32()
        return self.raw(n).decode("utf-8")

    def extern_name(self) -> str:
        """import/export name: tag byte (0x00 plain label, 0x01 interface
        id) + string — both resolve to the string."""
        tag = self.u8()
        if tag not in (0x00, 0x01):
            raise ComponentError(f"bad extern-name tag 0x{tag:02x}")
        return self.name()


# ------------------------------------------------------------ type decoding


class _Scope:
    """One nesting level of component index spaces. Instance/component
    *types* open fresh scopes whose outer aliases reach up through
    ``parent`` (binary format: alias target 0x02 ct idx)."""

    def __init__(self, parent: Optional["_Scope"] = None) -> None:
        self.parent = parent
        self.types: List[Any] = []
        self.instances: List[Any] = []
        self.funcs: List[Any] = []
        self.components: List[Any] = []
        self.values: List[Any] = []

    def outer(self, ct: int) -> "_Scope":
        s = self
        for _ in range(ct):
            if s.parent is None:
                raise ComponentError("outer alias past root scope")
            s = s.parent
        return s


def _read_valtype(r: _Reader, scope: _Scope) -> Any:
    v = r.s33()
    if v >= 0:
        try:
            return scope.types[v]
        except IndexError:
            raise ComponentError(f"valtype references unknown type {v}")
    byte = v & 0x7F
    prim = _PRIM_BY_BYTE.get(byte)
    if prim is None:
        raise ComponentError(f"unknown primitive valtype 0x{byte:02x}")
    return prim


def _read_deftype(r: _Reader, scope: _Scope) -> Any:
    """One deftype from a type section / decl context. Grammar pinned
    against the reference WIT package binary (see module docstring)."""
    tag = r.u8()
    if tag in _PRIM_BY_BYTE:
        return _PRIM_BY_BYTE[tag]
    if tag == 0x72:  # record
        fields = tuple((r.name(), _read_valtype(r, scope)) for _ in range(r.u32()))
        return ("record", fields)
    if tag == 0x71:  # variant
        cases = []
        for _ in range(r.u32()):
            cname = r.name()
            vt = _read_valtype(r, scope) if r.u8() else None
            if r.u8():  # refines — index, unused here
                r.u32()
            cases.append((cname, vt))
        return ("variant", tuple(cases))
    if tag == 0x70:  # list
        return ("list", _read_valtype(r, scope))
    if tag == 0x6F:  # tuple
        return ("tuple", tuple(_read_valtype(r, scope) for _ in range(r.u32())))
    if tag == 0x6E:  # flags
        return ("flags", tuple(r.name() for _ in range(r.u32())))
    if tag == 0x6D:  # enum
        return ("enum", tuple(r.name() for _ in range(r.u32())))
    if tag == 0x6B:  # option
        return ("option", _read_valtype(r, scope))
    if tag == 0x6A:  # result
        ok = _read_valtype(r, scope) if r.u8() else None
        err = _read_valtype(r, scope) if r.u8() else None
        return ("result", ok, err)
    if tag == 0x69:  # own
        return ("own", _resource_at(scope, r.u32()))
    if tag == 0x68:  # borrow
        return ("borrow", _resource_at(scope, r.u32()))
    if tag == 0x40:  # func
        params = tuple((r.name(), _read_valtype(r, scope)) for _ in range(r.u32()))
        rtag = r.u8()
        if rtag == 0x00:
            result = _read_valtype(r, scope)
        elif rtag == 0x01:
            if r.u8() != 0x00:
                raise ComponentError("named multi-results unsupported")
            result = None
        else:
            raise ComponentError(f"bad resultlist tag 0x{rtag:02x}")
        return ("func", params, result)
    if tag == 0x42:  # instance type
        return _read_instance_type(r, scope)
    if tag == 0x41:  # component type
        return _read_component_type(r, scope)
    if tag == 0x3F:  # resource type (rep i32, optional dtor)
        rep = r.u8()
        if rep != 0x7F:
            raise ComponentError("resource rep must be i32")
        if r.u8():
            r.u32()  # dtor core func idx — sandbox runs no dtors
        return Resource()
    raise ComponentError(f"unknown deftype tag 0x{tag:02x}")


def _resource_at(scope: _Scope, idx: int) -> Resource:
    try:
        t = scope.types[idx]
    except IndexError:
        raise ComponentError(f"own/borrow references unknown type {idx}")
    if not isinstance(t, Resource):
        raise ComponentError("own/borrow of non-resource type")
    return t


def _read_externdesc(r: _Reader, scope: _Scope) -> Tuple[str, Any]:
    """(sort-name, described type). Grammar: 0x00 0x11 core-module-type,
    0x01 functype-idx, 0x02 valuebound, 0x03 typebound, 0x04 component,
    0x05 instance."""
    tag = r.u8()
    if tag == 0x00:
        if r.u8() != 0x11:
            raise ComponentError("bad core-module externdesc")
        return ("core-module", r.u32())
    if tag == 0x01:
        idx = r.u32()
        try:
            ft = scope.types[idx]
        except IndexError:
            raise ComponentError(f"externdesc func type {idx} unknown")
        return ("func", ft)
    if tag == 0x02:
        bound = r.u8()
        if bound == 0x00:
            return ("value", _read_valtype(r, scope))
        raise ComponentError("bad value bound")
    if tag == 0x03:
        bound = r.u8()
        if bound == 0x00:  # eq
            idx = r.u32()
            try:
                return ("type", scope.types[idx])
            except IndexError:
                raise ComponentError(f"externdesc type {idx} unknown")
        if bound == 0x01:  # sub resource — generative
            return ("type", Resource())
        raise ComponentError("bad type bound")
    if tag == 0x04:
        idx = r.u32()
        try:
            return ("component", scope.components[idx])
        except IndexError:  # nested component types aren't tracked — opaque
            return ("component", None)
    if tag == 0x05:
        idx = r.u32()
        try:
            return ("instance", scope.types[idx])
        except IndexError:
            raise ComponentError(f"externdesc instance type {idx} unknown")
    raise ComponentError(f"unknown externdesc tag 0x{tag:02x}")


def _read_decl_alias(r: _Reader, scope: _Scope) -> None:
    """Alias inside a type-decl context (sort + target); appends to the
    matching local index space."""
    sort = r.u8()
    if sort == 0x00:  # core sort — skip core alias inside decls
        r.u8()
        tag = r.u8()
        if tag == 0x02:
            r.u32(), r.u32()
        else:
            r.u32(), r.name()
        return
    tag = r.u8()
    if tag == 0x02:  # outer
        ct, idx = r.u32(), r.u32()
        src = scope.outer(ct)
        if sort == 0x03:
            scope.types.append(src.types[idx])
        elif sort == 0x01:
            scope.funcs.append(src.funcs[idx])
        elif sort == 0x05:
            scope.instances.append(src.instances[idx])
        elif sort == 0x04:
            scope.components.append(src.components[idx])
        else:
            raise ComponentError(f"outer alias of sort {sort} unsupported")
        return
    if tag == 0x00:  # export of a component-level instance
        iidx, name = r.u32(), r.name()
        inst = scope.instances[iidx] if iidx < len(scope.instances) else None
        exp = None
        if isinstance(inst, tuple) and inst[0] == "instance":
            exp = inst[1].get(name)
        if sort == 0x03:
            scope.types.append(exp[1] if exp else ("unknown",))
        elif sort == 0x01:
            scope.funcs.append(exp[1] if exp else ("unknown",))
        else:
            raise ComponentError(f"export alias of sort {sort} unsupported")
        return
    raise ComponentError(f"unknown alias target 0x{tag:02x}")


def _read_instance_type(r: _Reader, parent: _Scope) -> Any:
    scope = _Scope(parent)
    exports: Dict[str, Tuple[str, Any]] = {}
    for _ in range(r.u32()):
        tag = r.u8()
        if tag == 0x00:  # core type decl — not used by plugin worlds
            raise ComponentError("core type decls unsupported in instance types")
        if tag == 0x01:
            scope.types.append(_read_deftype(r, scope))
        elif tag == 0x02:
            _read_decl_alias(r, scope)
        elif tag == 0x04:
            name = r.extern_name()
            desc = _read_externdesc(r, scope)
            exports[name] = desc
            # an exported type introduces a fresh index (export alias target)
            if desc[0] == "type":
                scope.types.append(desc[1])
            elif desc[0] == "func":
                scope.funcs.append(desc[1])
            elif desc[0] == "instance":
                scope.instances.append(desc[1])
        else:
            raise ComponentError(f"unknown instancedecl tag 0x{tag:02x}")
    return ("instance", exports)


def _read_component_type(r: _Reader, parent: _Scope) -> Any:
    scope = _Scope(parent)
    decls: Dict[str, Tuple[str, Any]] = {}
    for _ in range(r.u32()):
        tag = r.u8()
        if tag == 0x01:
            scope.types.append(_read_deftype(r, scope))
        elif tag == 0x02:
            _read_decl_alias(r, scope)
        elif tag == 0x03:  # importdecl
            name = r.extern_name()
            desc = _read_externdesc(r, scope)
            decls["import " + name] = desc
            if desc[0] == "type":
                scope.types.append(desc[1])
            elif desc[0] == "instance":
                scope.instances.append(desc[1])
            elif desc[0] == "func":
                scope.funcs.append(desc[1])
        elif tag == 0x04:  # exportdecl
            name = r.extern_name()
            desc = _read_externdesc(r, scope)
            decls["export " + name] = desc
            if desc[0] == "type":
                scope.types.append(desc[1])
            elif desc[0] == "instance":
                scope.instances.append(desc[1])
            elif desc[0] == "func":
                scope.funcs.append(desc[1])
        else:
            raise ComponentError(f"unknown componentdecl tag 0x{tag:02x}")
    return ("component", decls)


# ----------------------------------------------------------------- sections


class ParsedComponent:
    """Resolved index spaces of a component binary (single-level)."""

    def __init__(self) -> None:
        self.core_modules: List[bytes] = []
        # ('instantiate', module_idx, {argname: core_instance_idx}) |
        # ('exports', {name: ('func'|'memory'|..., idx)})
        self.core_instances: List[Tuple] = []
        # ('lower', func_idx, opts) | ('resource.new'|'resource.rep'|
        # 'resource.drop', Resource) | ('alias', core_inst_idx, name)
        self.core_funcs: List[Tuple] = []
        self.core_memories: List[Tuple] = []  # ('alias', core_inst_idx, name)
        self.scope = _Scope()
        # func space entries: ('lift', core_func_idx, opts, functype) |
        # ('import', interface, name, functype) | value from decl aliases
        self.funcs: List[Tuple] = self.scope.funcs
        # instance space: ('import', name, instance_type) |
        # ('inline', {name: ('func', idx)})
        self.instances: List[Tuple] = self.scope.instances
        self.imports: Dict[str, Tuple[str, Any]] = {}
        self.exports: Dict[str, Tuple[str, int]] = {}  # name -> (sort, idx)

    # -- resolution helpers ---------------------------------------------------

    def export_instance_funcs(self, name: str) -> Dict[str, Tuple]:
        """Funcs of an exported (inline) instance: {func_name: func_entry}."""
        sort, idx = self.exports[name]
        if sort != "instance":
            raise ComponentError(f"export {name!r} is a {sort}, not an instance")
        entry = self.instances[idx]
        if entry[0] != "inline":
            raise ComponentError("only inline-export instances are runnable")
        out = {}
        for fname, (fsort, fidx) in entry[1].items():
            if fsort == "func":
                out[fname] = self.funcs[fidx]
        return out

    def parsed_resource(self) -> Resource:
        """The component's (sole) exported resource identity — the type the
        canon resource builtins manage (node-instance for plugin worlds)."""
        for entry in self.core_funcs:
            if entry[0] == "resource.new":
                return entry[1]
        raise ComponentError("component declares no resource")

    def main_core_module(self) -> Tuple[int, bytes]:
        if not self.core_modules:
            raise ComponentError("component contains no core module")
        # the largest core module is the plugin; tiny shims/adapters are not
        # supported (documented scope)
        idx = max(range(len(self.core_modules)), key=lambda i: len(self.core_modules[i]))
        return idx, self.core_modules[idx]


def parse_component(data: bytes) -> ParsedComponent:
    """Parse a layer-1 component binary into resolved index spaces."""
    if len(data) < 8 or data[:4] != b"\x00asm":
        raise ComponentError("bad magic")
    version = int.from_bytes(data[4:6], "little")
    layer = int.from_bytes(data[6:8], "little")
    if layer != 1:
        raise ComponentError(f"not a component (layer {layer})")
    if version < 0x0A or version > 0x20:
        raise ComponentError(f"unsupported component binary version 0x{version:02x}")
    pc = ParsedComponent()
    r = _Reader(data, 8)
    try:
        _parse_sections(pc, r, data)
    except (IndexError, KeyError, OverflowError, MemoryError) as e:
        # hostile-input boundary: the upload endpoint feeds attacker bytes,
        # so any malformed index/count must surface as a parse error
        raise ComponentError(f"malformed component binary: {type(e).__name__}") from e
    return pc


def _parse_sections(pc: ParsedComponent, r: _Reader, data: bytes) -> None:
    while not r.eof():
        sid = r.u8()
        size = r.u32()
        sec_end = r.i + size
        if sec_end > len(data):
            raise ComponentError("truncated component binary (section overruns)")
        sr = _Reader(data, r.i, sec_end)
        if sid == 1:  # core module
            pc.core_modules.append(bytes(sr.raw(size)))
        elif sid == 2:  # core instance
            for _ in range(sr.u32()):
                tag = sr.u8()
                if tag == 0x00:
                    midx = sr.u32()
                    args = {}
                    for _ in range(sr.u32()):
                        aname = sr.name()
                        kind = sr.u8()
                        if kind != 0x12:
                            raise ComponentError("core instantiate arg must be an instance")
                        args[aname] = sr.u32()
                    pc.core_instances.append(("instantiate", midx, args))
                elif tag == 0x01:
                    exports = {}
                    for _ in range(sr.u32()):
                        ename = sr.name()
                        sort = sr.u8()
                        idx = sr.u32()
                        kind = {0x00: "func", 0x01: "table", 0x02: "memory", 0x03: "global"}.get(sort)
                        if kind is None:
                            raise ComponentError(f"bad core sort 0x{sort:02x}")
                        exports[ename] = (kind, idx)
                    pc.core_instances.append(("exports", exports))
                else:
                    raise ComponentError(f"bad core instance tag 0x{tag:02x}")
        elif sid == 6:  # alias
            for _ in range(sr.u32()):
                sort = sr.u8()
                if sort == 0x00:  # core sort
                    csort = sr.u8()
                    tag = sr.u8()
                    if tag != 0x01:
                        raise ComponentError("core alias must target a core-instance export")
                    iidx, name = sr.u32(), sr.name()
                    if csort == 0x00:
                        pc.core_funcs.append(("alias", iidx, name))
                    elif csort == 0x02:
                        pc.core_memories.append(("alias", iidx, name))
                    # tables/globals aren't referenced by canon — ignore
                else:
                    tag = sr.u8()
                    if tag == 0x02:  # outer — component-level, root scope only
                        ct, idx = sr.u32(), sr.u32()
                        src = pc.scope.outer(ct)
                        if sort == 0x03:
                            pc.scope.types.append(src.types[idx])
                        elif sort == 0x01:
                            pc.scope.funcs.append(src.funcs[idx])
                        else:
                            raise ComponentError(f"outer alias sort {sort} unsupported")
                    elif tag == 0x00:  # export of component-level instance
                        iidx, name = sr.u32(), sr.name()
                        entry = pc.instances[iidx]
                        if entry[0] == "import":
                            iface, itype = entry[1], entry[2]
                            if itype is not None and itype[0] == "instance":
                                desc = itype[1].get(name)
                            else:
                                desc = None
                            if sort == 0x01:  # func
                                ft = desc[1] if desc and desc[0] == "func" else None
                                pc.scope.funcs.append(("import", iface, name, ft))
                            elif sort == 0x03:
                                pc.scope.types.append(
                                    desc[1] if desc and desc[0] == "type" else ("unknown",)
                                )
                            else:
                                raise ComponentError(f"alias sort {sort} unsupported")
                        elif entry[0] == "inline":
                            fsort, fidx = entry[1][name]
                            if sort == 0x01 and fsort == "func":
                                pc.scope.funcs.append(pc.funcs[fidx])
                            else:
                                raise ComponentError("inline alias sort mismatch")
                        else:
                            raise ComponentError("alias of unsupported instance kind")
                    else:
                        raise ComponentError(f"bad alias target 0x{tag:02x}")
        elif sid == 7:  # type
            for _ in range(sr.u32()):
                pc.scope.types.append(_read_deftype(sr, pc.scope))
        elif sid == 8:  # canon
            for _ in range(sr.u32()):
                tag = sr.u8()
                if tag == 0x00:  # lift
                    if sr.u8() != 0x00:
                        raise ComponentError("bad canon lift encoding")
                    fidx = sr.u32()
                    opts = _read_canonopts(sr)
                    tidx = sr.u32()
                    ft = pc.scope.types[tidx]
                    if not (isinstance(ft, tuple) and ft[0] == "func"):
                        raise ComponentError("canon lift type is not a func")
                    pc.scope.funcs.append(("lift", fidx, opts, ft))
                elif tag == 0x01:  # lower
                    if sr.u8() != 0x00:
                        raise ComponentError("bad canon lower encoding")
                    fidx = sr.u32()
                    opts = _read_canonopts(sr)
                    pc.core_funcs.append(("lower", fidx, opts))
                elif tag == 0x02:
                    pc.core_funcs.append(("resource.new", _resource_at(pc.scope, sr.u32())))
                elif tag == 0x03:
                    pc.core_funcs.append(("resource.drop", _resource_at(pc.scope, sr.u32())))
                elif tag == 0x04:
                    pc.core_funcs.append(("resource.rep", _resource_at(pc.scope, sr.u32())))
                else:
                    raise ComponentError(f"unsupported canon tag 0x{tag:02x}")
        elif sid == 10:  # import
            for _ in range(sr.u32()):
                name = sr.extern_name()
                desc = _read_externdesc(sr, pc.scope)
                pc.imports[name] = desc
                if desc[0] == "instance":
                    pc.instances.append(("import", name, desc[1]))
                elif desc[0] == "func":
                    pc.scope.funcs.append(("import", name, name, desc[1]))
                elif desc[0] == "type":
                    pc.scope.types.append(desc[1])
        elif sid == 5:  # instance
            for _ in range(sr.u32()):
                tag = sr.u8()
                if tag == 0x01:
                    exports = {}
                    for _ in range(sr.u32()):
                        ename = sr.extern_name()
                        sort = sr.u8()
                        idx = sr.u32()
                        sname = {0x01: "func", 0x03: "type", 0x05: "instance"}.get(sort)
                        if sname is None:
                            raise ComponentError(f"inline export sort 0x{sort:02x} unsupported")
                        exports[ename] = (sname, idx)
                    pc.instances.append(("inline", exports))
                else:
                    raise ComponentError("component instantiation unsupported (single-component scope)")
        elif sid == 11:  # export
            for _ in range(sr.u32()):
                name = sr.extern_name()
                sort = sr.u8()
                idx = sr.u32()
                sname = {
                    0x01: "func",
                    0x03: "type",
                    0x04: "component",
                    0x05: "instance",
                }.get(sort)
                if sname is None and sort == 0x00:
                    sr.u32()  # core sort idx — ignore
                    continue
                if sname is None:
                    raise ComponentError(f"export sort 0x{sort:02x} unsupported")
                if sr.u8() == 0x01:  # ascribed type
                    _read_externdesc(sr, pc.scope)
                pc.exports[name] = (sname, idx)
                if sname == "type":
                    # re-exported type: same resolved object, new index
                    pc.scope.types.append(pc.scope.types[idx])
        elif sid in (0, 3, 4, 9, 12):
            pass  # custom / core-type / nested component / start / value
        else:
            raise ComponentError(f"unknown component section id {sid}")
        r.i = sec_end


def _read_canonopts(r: _Reader) -> Dict[str, Any]:
    opts: Dict[str, Any] = {"string-encoding": "utf8"}
    for _ in range(r.u32()):
        tag = r.u8()
        if tag == 0x00:
            opts["string-encoding"] = "utf8"
        elif tag == 0x01:
            opts["string-encoding"] = "utf16"
        elif tag == 0x02:
            opts["string-encoding"] = "latin1+utf16"
        elif tag == 0x03:
            opts["memory"] = r.u32()
        elif tag == 0x04:
            opts["realloc"] = r.u32()
        elif tag == 0x05:
            opts["post-return"] = r.u32()
        else:
            raise ComponentError(f"unknown canonopt 0x{tag:02x}")
    return opts


# ----------------------------------------------------------- canonical ABI


def _discriminant_size(n_cases: int) -> int:
    if n_cases <= 0x100:
        return 1
    if n_cases <= 0x10000:
        return 2
    return 4


def size_align(t: Any) -> Tuple[int, int]:
    """(byte size, alignment) of a lowered value in linear memory."""
    if t in ("bool", "u8", "s8"):
        return 1, 1
    if t in ("u16", "s16"):
        return 2, 2
    if t in ("u32", "s32", "f32", "char"):
        return 4, 4
    if t in ("u64", "s64", "f64"):
        return 8, 8
    if t == "string":
        return 8, 4
    kind = t[0]
    if kind == "list":
        return 8, 4
    if kind in ("own", "borrow"):
        return 4, 4
    if kind == "record":
        off = 0
        align = 1
        for _, ft in t[1]:
            s, a = size_align(ft)
            align = max(align, a)
            off = _align_to(off, a) + s
        return _align_to(off, align), align
    if kind == "tuple":
        return size_align(("record", tuple(("f", ft) for ft in t[1])))
    if kind == "flags":
        n = len(t[1])
        if n <= 8:
            return 1, 1
        if n <= 16:
            return 2, 2
        return 4, 4
    if kind in ("variant", "enum", "option", "result"):
        cases = _variant_cases(t)
        ds = _discriminant_size(len(cases))
        payload_align = 1
        payload_size = 0
        for _, ct in cases:
            if ct is not None:
                s, a = size_align(ct)
                payload_align = max(payload_align, a)
                payload_size = max(payload_size, s)
        align = max(ds, payload_align)
        size = _align_to(ds, payload_align) + payload_size
        return _align_to(size, align), align
    raise ComponentError(f"size_align: unsupported type {t!r}")


def _align_to(v: int, a: int) -> int:
    return (v + a - 1) // a * a


def _variant_cases(t: Any) -> Tuple[Tuple[str, Any], ...]:
    kind = t[0]
    if kind == "variant":
        return t[1]
    if kind == "enum":
        return tuple((n, None) for n in t[1])
    if kind == "option":
        return (("none", None), ("some", t[1]))
    if kind == "result":
        return (("ok", t[1]), ("error", t[2]))
    raise ComponentError("not a variant-like type")


_CORE_I32 = "i32"
_CORE_I64 = "i64"
_CORE_F32 = "f32"
_CORE_F64 = "f64"

MAX_FLAT_PARAMS = 16
MAX_FLAT_RESULTS = 1


def flatten_type(t: Any) -> List[str]:
    if t in ("bool", "u8", "s8", "u16", "s16", "u32", "s32", "char"):
        return [_CORE_I32]
    if t in ("u64", "s64"):
        return [_CORE_I64]
    if t == "f32":
        return [_CORE_F32]
    if t == "f64":
        return [_CORE_F64]
    if t == "string":
        return [_CORE_I32, _CORE_I32]
    kind = t[0]
    if kind == "list":
        return [_CORE_I32, _CORE_I32]
    if kind in ("own", "borrow"):
        return [_CORE_I32]
    if kind == "flags":
        return [_CORE_I32]
    if kind == "record":
        out: List[str] = []
        for _, ft in t[1]:
            out.extend(flatten_type(ft))
        return out
    if kind == "tuple":
        out = []
        for ft in t[1]:
            out.extend(flatten_type(ft))
        return out
    if kind in ("variant", "enum", "option", "result"):
        cases = _variant_cases(t)
        flat: List[str] = []
        for _, ct in cases:
            if ct is None:
                continue
            cf = flatten_type(ct)
            for i, core in enumerate(cf):
                if i < len(flat):
                    flat[i] = _join(flat[i], core)
                else:
                    flat.append(core)
        return [_CORE_I32] + flat
    raise ComponentError(f"flatten: unsupported type {t!r}")


def _join(a: str, b: str) -> str:
    if a == b:
        return a
    if {a, b} == {_CORE_I32, _CORE_F32}:
        return _CORE_I32
    return _CORE_I64


def _f32_to_bits(v: float) -> int:
    return struct.unpack("<I", struct.pack("<f", float(v)))[0]


def _bits_to_f32(b: int) -> float:
    return struct.unpack("<f", struct.pack("<I", b & 0xFFFFFFFF))[0]


def _f64_to_bits(v: float) -> int:
    return struct.unpack("<Q", struct.pack("<d", float(v)))[0]


def _bits_to_f64(b: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", b & 0xFFFFFFFFFFFFFFFF))[0]


class _Cabi:
    """Canonical-ABI lift/lower over one core instance's linear memory.

    Python-side value mapping:
      record -> dict, variant -> (case, payload|None), enum -> case str,
      option -> None | value, result -> ('ok', v) | ('error', v),
      flags -> set of names, list -> list (bytes for list<u8>),
      string -> str, own/borrow -> int handle/rep.
    """

    def __init__(self, inst: "ComponentInstance") -> None:
        self.inst = inst

    # -- memory helpers -------------------------------------------------------

    def _mem(self) -> memoryview:
        return self.inst.core.memory()

    def alloc(self, size: int, align: int) -> int:
        if size == 0:
            return 0
        ptr = self.inst.call_core("cabi_realloc", 0, 0, align, size)[0]
        ptr &= 0xFFFFFFFF
        if ptr == 0 or ptr + size > len(self._mem()):
            raise ComponentError("cabi_realloc returned a bad pointer")
        return ptr

    def read_bytes(self, ptr: int, n: int) -> bytes:
        mem = self._mem()
        if ptr + n > len(mem):
            raise ComponentError("guest pointer out of bounds")
        return bytes(mem[ptr : ptr + n])

    def write_bytes(self, ptr: int, data: bytes) -> None:
        mem = self._mem()
        if ptr + len(data) > len(mem):
            raise ComponentError("guest pointer out of bounds")
        mem[ptr : ptr + len(data)] = data

    # -- flat (core value) form ----------------------------------------------

    def lower_flat(self, t: Any, v: Any, out: List[int]) -> None:
        if t == "bool":
            out.append(1 if v else 0)
        elif t in ("u8", "u16", "u32", "char"):
            out.append(int(v if t != "char" else ord(v)) & 0xFFFFFFFF)
        elif t in ("s8", "s16", "s32"):
            out.append(int(v) & 0xFFFFFFFF)
        elif t in ("u64", "s64"):
            out.append(int(v) & 0xFFFFFFFFFFFFFFFF)
        elif t == "f32":
            out.append(_f32_to_bits(v))
        elif t == "f64":
            out.append(_f64_to_bits(v))
        elif t == "string":
            ptr, n = self.lower_string(v)
            out.extend((ptr, n))
        elif t[0] == "list":
            ptr, n = self.lower_list(t[1], v)
            out.extend((ptr, n))
        elif t[0] in ("own", "borrow"):
            out.append(int(v) & 0xFFFFFFFF)
        elif t[0] == "flags":
            bits = 0
            for i, name in enumerate(t[1]):
                if name in v:
                    bits |= 1 << i
            out.append(bits)
        elif t[0] == "record":
            for fname, ft in t[1]:
                self.lower_flat(ft, v[fname], out)
        elif t[0] == "tuple":
            for i, ft in enumerate(t[1]):
                self.lower_flat(ft, v[i], out)
        elif t[0] in ("variant", "enum", "option", "result"):
            cases = _variant_cases(t)
            disc, payload = self._variant_disc(t, v)
            flat = flatten_type(t)[1:]
            out.append(disc)
            ct = cases[disc][1]
            tmp: List[int] = []
            if ct is not None:
                self.lower_flat(ct, payload, tmp)
                # pad/convert to the joined core types
                ctf = flatten_type(ct)
                for i, core in enumerate(ctf):
                    if core == _CORE_F32 and flat[i] != _CORE_F32:
                        tmp[i] = tmp[i] & 0xFFFFFFFF
                    elif core == _CORE_F64 and flat[i] == _CORE_I64:
                        pass  # already bits
            tmp.extend(0 for _ in range(len(flat) - len(tmp)))
            out.extend(tmp)
        else:
            raise ComponentError(f"lower_flat: unsupported type {t!r}")

    def lift_flat(self, t: Any, it) -> Any:
        if t == "bool":
            return bool(next(it) & 1)
        if t == "u8":
            return next(it) & 0xFF
        if t == "u16":
            return next(it) & 0xFFFF
        if t in ("u32",):
            return next(it) & 0xFFFFFFFF
        if t == "char":
            return chr(next(it) & 0xFFFFFFFF)
        if t == "s8":
            v = next(it) & 0xFF
            return v - 0x100 if v >= 0x80 else v
        if t == "s16":
            v = next(it) & 0xFFFF
            return v - 0x10000 if v >= 0x8000 else v
        if t == "s32":
            v = next(it) & 0xFFFFFFFF
            return v - 0x100000000 if v >= 0x80000000 else v
        if t == "u64":
            return next(it) & 0xFFFFFFFFFFFFFFFF
        if t == "s64":
            v = next(it) & 0xFFFFFFFFFFFFFFFF
            return v - (1 << 64) if v >= 1 << 63 else v
        if t == "f32":
            return _bits_to_f32(next(it))
        if t == "f64":
            return _bits_to_f64(next(it))
        if t == "string":
            ptr, n = next(it) & 0xFFFFFFFF, next(it) & 0xFFFFFFFF
            return self.read_bytes(ptr, n).decode("utf-8")
        if t[0] == "list":
            ptr, n = next(it) & 0xFFFFFFFF, next(it) & 0xFFFFFFFF
            return self.load_list(t[1], ptr, n)
        if t[0] in ("own", "borrow"):
            return next(it) & 0xFFFFFFFF
        if t[0] == "flags":
            bits = next(it)
            return {name for i, name in enumerate(t[1]) if bits >> i & 1}
        if t[0] == "record":
            return {fname: self.lift_flat(ft, it) for fname, ft in t[1]}
        if t[0] == "tuple":
            return tuple(self.lift_flat(ft, it) for ft in t[1])
        if t[0] in ("variant", "enum", "option", "result"):
            cases = _variant_cases(t)
            disc = next(it) & 0xFFFFFFFF
            if disc >= len(cases):
                raise ComponentError("variant discriminant out of range")
            flat = flatten_type(t)[1:]
            vals = [next(it) for _ in flat]
            cname, ct = cases[disc]
            payload = None
            if ct is not None:
                ctf = flatten_type(ct)
                payload = self.lift_flat(ct, iter(vals[: len(ctf)]))
            return self._variant_value(t, disc, cname, payload)
        raise ComponentError(f"lift_flat: unsupported type {t!r}")

    # -- memory form ----------------------------------------------------------

    def store(self, t: Any, v: Any, ptr: int) -> None:
        if t in ("bool", "u8", "s8"):
            iv = (1 if v else 0) if t == "bool" else int(v)
            self.write_bytes(ptr, struct.pack("<b" if t == "s8" else "<B", iv & 0xFF if t != "s8" else ((iv + 0x80) % 0x100) - 0x80))
        elif t in ("u16", "s16"):
            self.write_bytes(ptr, struct.pack("<H", int(v) & 0xFFFF))
        elif t in ("u32", "s32"):
            self.write_bytes(ptr, struct.pack("<I", int(v) & 0xFFFFFFFF))
        elif t == "char":
            self.write_bytes(ptr, struct.pack("<I", ord(v)))
        elif t in ("u64", "s64"):
            self.write_bytes(ptr, struct.pack("<Q", int(v) & 0xFFFFFFFFFFFFFFFF))
        elif t == "f32":
            self.write_bytes(ptr, struct.pack("<f", float(v)))
        elif t == "f64":
            self.write_bytes(ptr, struct.pack("<d", float(v)))
        elif t == "string":
            sptr, n = self.lower_string(v)
            self.write_bytes(ptr, struct.pack("<II", sptr, n))
        elif t[0] == "list":
            lptr, n = self.lower_list(t[1], v)
            self.write_bytes(ptr, struct.pack("<II", lptr, n))
        elif t[0] in ("own", "borrow"):
            self.write_bytes(ptr, struct.pack("<I", int(v) & 0xFFFFFFFF))
        elif t[0] == "flags":
            bits = 0
            for i, name in enumerate(t[1]):
                if name in v:
                    bits |= 1 << i
            size, _ = size_align(t)
            self.write_bytes(ptr, bits.to_bytes(size, "little"))
        elif t[0] == "record":
            off = 0
            for fname, ft in t[1]:
                s, a = size_align(ft)
                off = _align_to(off, a)
                self.store(ft, v[fname], ptr + off)
                off += s
        elif t[0] == "tuple":
            off = 0
            for i, ft in enumerate(t[1]):
                s, a = size_align(ft)
                off = _align_to(off, a)
                self.store(ft, v[i], ptr + off)
                off += s
        elif t[0] in ("variant", "enum", "option", "result"):
            cases = _variant_cases(t)
            disc, payload = self._variant_disc(t, v)
            ds = _discriminant_size(len(cases))
            self.write_bytes(ptr, disc.to_bytes(ds, "little"))
            payload_align = max([1] + [size_align(ct)[1] for _, ct in cases if ct is not None])
            ct = cases[disc][1]
            if ct is not None:
                self.store(ct, payload, ptr + _align_to(ds, payload_align))
        else:
            raise ComponentError(f"store: unsupported type {t!r}")

    def load(self, t: Any, ptr: int) -> Any:
        if t == "bool":
            return bool(self.read_bytes(ptr, 1)[0] & 1)
        if t == "u8":
            return self.read_bytes(ptr, 1)[0]
        if t == "s8":
            return struct.unpack("<b", self.read_bytes(ptr, 1))[0]
        if t == "u16":
            return struct.unpack("<H", self.read_bytes(ptr, 2))[0]
        if t == "s16":
            return struct.unpack("<h", self.read_bytes(ptr, 2))[0]
        if t == "u32":
            return struct.unpack("<I", self.read_bytes(ptr, 4))[0]
        if t == "s32":
            return struct.unpack("<i", self.read_bytes(ptr, 4))[0]
        if t == "char":
            return chr(struct.unpack("<I", self.read_bytes(ptr, 4))[0])
        if t == "u64":
            return struct.unpack("<Q", self.read_bytes(ptr, 8))[0]
        if t == "s64":
            return struct.unpack("<q", self.read_bytes(ptr, 8))[0]
        if t == "f32":
            return struct.unpack("<f", self.read_bytes(ptr, 4))[0]
        if t == "f64":
            return struct.unpack("<d", self.read_bytes(ptr, 8))[0]
        if t == "string":
            sptr, n = struct.unpack("<II", self.read_bytes(ptr, 8))
            return self.read_bytes(sptr, n).decode("utf-8")
        kind = t[0]
        if kind == "list":
            lptr, n = struct.unpack("<II", self.read_bytes(ptr, 8))
            return self.load_list(t[1], lptr, n)
        if kind in ("own", "borrow"):
            return struct.unpack("<I", self.read_bytes(ptr, 4))[0]
        if kind == "flags":
            size, _ = size_align(t)
            bits = int.from_bytes(self.read_bytes(ptr, size), "little")
            return {name for i, name in enumerate(t[1]) if bits >> i & 1}
        if kind == "record":
            out = {}
            off = 0
            for fname, ft in t[1]:
                s, a = size_align(ft)
                off = _align_to(off, a)
                out[fname] = self.load(ft, ptr + off)
                off += s
            return out
        if kind == "tuple":
            vals = []
            off = 0
            for ft in t[1]:
                s, a = size_align(ft)
                off = _align_to(off, a)
                vals.append(self.load(ft, ptr + off))
                off += s
            return tuple(vals)
        if kind in ("variant", "enum", "option", "result"):
            cases = _variant_cases(t)
            ds = _discriminant_size(len(cases))
            disc = int.from_bytes(self.read_bytes(ptr, ds), "little")
            if disc >= len(cases):
                raise ComponentError("variant discriminant out of range")
            payload_align = max([1] + [size_align(ct)[1] for _, ct in cases if ct is not None])
            cname, ct = cases[disc]
            payload = None
            if ct is not None:
                payload = self.load(ct, ptr + _align_to(ds, payload_align))
            return self._variant_value(t, disc, cname, payload)
        raise ComponentError(f"load: unsupported type {t!r}")

    # -- strings / lists ------------------------------------------------------

    def lower_string(self, v: str) -> Tuple[int, int]:
        data = v.encode("utf-8")
        ptr = self.alloc(len(data), 1)
        self.write_bytes(ptr, data)
        return ptr, len(data)

    def lower_list(self, et: Any, v: Any) -> Tuple[int, int]:
        if et == "u8":
            data = bytes(v)
            ptr = self.alloc(len(data), 1)
            self.write_bytes(ptr, data)
            return ptr, len(data)
        if et == "f32":
            data = struct.pack(f"<{len(v)}f", *[float(x) for x in v])
            ptr = self.alloc(len(data), 4)
            self.write_bytes(ptr, data)
            return ptr, len(v)
        size, align = size_align(et)
        n = len(v)
        ptr = self.alloc(size * n, align)
        for i, item in enumerate(v):
            self.store(et, item, ptr + i * size)
        return ptr, n

    def load_list(self, et: Any, ptr: int, n: int) -> Any:
        if et == "u8":
            return self.read_bytes(ptr, n)
        if et == "f32":
            return list(struct.unpack(f"<{n}f", self.read_bytes(ptr, 4 * n)))
        size, _ = size_align(et)
        return [self.load(et, ptr + i * size) for i in range(n)]

    # -- variants -------------------------------------------------------------

    @staticmethod
    def _variant_disc(t: Any, v: Any) -> Tuple[int, Any]:
        kind = t[0]
        cases = _variant_cases(t)
        if kind == "enum":
            return t[1].index(v), None
        if kind == "option":
            return (0, None) if v is None else (1, v)
        if kind == "result":
            tag, payload = (v if isinstance(v, tuple) else (v, None))
            return (0, payload) if tag == "ok" else (1, payload)
        cname, payload = (v if isinstance(v, tuple) else (v, None))
        for i, (n, _) in enumerate(cases):
            if n == cname:
                return i, payload
        raise ComponentError(f"unknown variant case {cname!r}")

    @staticmethod
    def _variant_value(t: Any, disc: int, cname: str, payload: Any) -> Any:
        kind = t[0]
        if kind == "enum":
            return cname
        if kind == "option":
            return None if disc == 0 else payload
        if kind == "result":
            return ("ok", payload) if disc == 0 else ("error", payload)
        return (cname, payload)


# ------------------------------------------------------------------ runtime


def _bind_host_api(lib: ctypes.CDLL) -> None:
    """Add the host-import C entry points to the shared ctypes binding
    (idempotent; raises if the .so predates the component runtime)."""
    if getattr(lib, "_sk_component_bound", False):
        return
    try:
        lib.skwasm_import_count.restype = ctypes.c_int
        lib.skwasm_import_count.argtypes = [ctypes.c_void_p]
        lib.skwasm_import_name.restype = ctypes.c_int
        lib.skwasm_import_name.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.skwasm_import_arity.restype = ctypes.c_int
        lib.skwasm_import_arity.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.skwasm_set_host.restype = None
        lib.skwasm_set_host.argtypes = [ctypes.c_void_p, HOST_CB_T, ctypes.c_void_p]
    except AttributeError as e:
        raise ComponentError(
            "the WASM runtime library lacks host-import support (csrc/wasm_rt.cpp)"
        ) from e
    lib._sk_component_bound = True


HOST_CB_T = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.c_void_p,                  # user
    ctypes.c_uint32,                  # import idx
    ctypes.POINTER(ctypes.c_int64),   # args
    ctypes.c_uint32,
    ctypes.POINTER(ctypes.c_int64),   # results
    ctypes.c_uint32,
    # err buf: POINTER(c_char), NOT c_char_p — ctypes converts c_char_p
    # callback args to immutable Python bytes, and memmove into that is
    # heap corruption
    ctypes.POINTER(ctypes.c_char),
    ctypes.c_size_t,
)


class ComponentInstance:
    """One instantiated plugin component.

    ``host_funcs`` maps ``(interface_name, func_name)`` (e.g.
    ``("streamkit:plugin/host@0.1.0", "send-output")``) to Python callables
    receiving lifted arguments and returning the Python value of the func's
    result type. WASI imports get built-in stubs; anything else traps with
    a clear message — mirroring the reference's deny-by-default wasmtime
    linker (``crates/plugin-wasm/src/lib.rs``: only host + WASI p2 wired).
    """

    def __init__(
        self,
        parsed: ParsedComponent,
        host_funcs: Optional[Dict[Tuple[str, str], Callable]] = None,
        fuel: int = 0,
        logger: Optional[Callable[[str, str], None]] = None,
    ) -> None:
        from .wasm import WasmInstance, WasmRuntime

        self.parsed = parsed
        self.host_funcs = dict(host_funcs or {})
        self.logger = logger
        _bind_host_api(WasmRuntime.lib())
        _, module_bytes = parsed.main_core_module()
        self.core = WasmInstance(module_bytes)
        if fuel:
            self.core.fuel = fuel
        self.cabi = _Cabi(self)
        # resource handle tables: Resource -> {handle: rep}; shared counter
        self.handles: Dict[Resource, Dict[int, int]] = {}
        self._next_handle = 1
        self._lock = threading.RLock()
        self._pending_error: Optional[BaseException] = None
        self._bind_imports()

    # -- core call ------------------------------------------------------------

    def call_core(self, name: str, *args: int, nresults: int = 1) -> List[int]:
        return self.core.call(name, *[a & 0xFFFFFFFFFFFFFFFF for a in args], nresults=nresults)

    # -- import binding -------------------------------------------------------

    def _core_import_binding(self, module: str, field: str) -> Tuple:
        """Resolve a core (module, field) import through the component's
        core-instance instantiation args to a core-func entry."""
        for entry in self.parsed.core_instances:
            if entry[0] != "instantiate":
                continue
            args = entry[2]
            if module not in args:
                continue
            arg_inst = self.parsed.core_instances[args[module]]
            if arg_inst[0] != "exports":
                raise ComponentError("instantiate arg must be an inline-exports instance")
            if field in arg_inst[1]:
                kind, idx = arg_inst[1][field]
                if kind != "func":
                    raise ComponentError(f"core import {module}.{field} is not a func")
                return self.parsed.core_funcs[idx]
        raise ComponentError(f"unbound core import {module}.{field}")

    def _bind_imports(self) -> None:
        from .wasm import WasmRuntime, _ERRLEN  # noqa: F401

        lib = WasmRuntime.lib()
        n = lib.skwasm_import_count(self.core._h)
        self._handlers: List[Callable] = []
        for i in range(n):
            mbuf = ctypes.create_string_buffer(512)
            nbuf = ctypes.create_string_buffer(512)
            lib.skwasm_import_name(self.core._h, i, mbuf, 512, nbuf, 512)
            module = mbuf.value.decode()
            field = nbuf.value.decode()
            self._handlers.append(self._make_handler(module, field))

        def cb(user, idx, args, nargs, results, nresults, err, errlen):
            try:
                vals = [args[j] for j in range(nargs)]
                out = self._handlers[idx](vals)
                for j in range(min(nresults, len(out))):
                    results[j] = ctypes.c_int64(out[j] & 0xFFFFFFFFFFFFFFFF).value
                return 0
            except BaseException as e:  # noqa: BLE001 — must not unwind into C
                self._pending_error = e
                msg = f"{type(e).__name__}: {e}".encode()[: errlen - 1]
                ctypes.memmove(err, msg + b"\x00", len(msg) + 1)
                return 1

        # the interpreter calls back into Python from whichever thread runs
        # the call: the trampoline must live as long as the core instance
        # that holds its pointer, so that instance keeps it too
        self._cb = self.core._host_cb = HOST_CB_T(cb)
        lib.skwasm_set_host(self.core._h, self._cb, None)

    def _make_handler(self, module: str, field: str) -> Callable:
        if module.startswith("wasi:"):
            return self._wasi_stub(module, field)
        try:
            entry = self._core_import_binding(module, field)
        except ComponentError:
            def missing(vals, module=module, field=field):
                raise ComponentError(f"unbound core import {module}.{field}")
            return missing
        kind = entry[0]
        if kind == "lower":
            func_entry = self.parsed.funcs[entry[1]]
            if func_entry[0] != "import":
                raise ComponentError("canon lower of a non-imported function")
            _, iface, fname, ftype = func_entry
            if ftype is None:
                raise ComponentError(f"import {iface}.{fname} has no func type")
            impl = self.host_funcs.get((iface, fname))
            if impl is None and (iface, fname) == _HOST_LOG:
                impl = self._default_log
            if impl is None:
                def unimpl(vals, iface=iface, fname=fname):
                    raise ComponentError(f"host function {iface}.{fname} not provided")
                return unimpl
            return self._lowered_host_call(ftype, impl)
        if kind == "resource.new":
            rid = entry[1]
            def rnew(vals, rid=rid):
                with self._lock:
                    h = self._next_handle
                    self._next_handle += 1
                    self.handles.setdefault(rid, {})[h] = vals[0] & 0xFFFFFFFF
                return [h]
            return rnew
        if kind == "resource.rep":
            rid = entry[1]
            def rrep(vals, rid=rid):
                try:
                    return [self.handles[rid][vals[0] & 0xFFFFFFFF]]
                except KeyError:
                    raise ComponentError("unknown resource handle")
            return rrep
        if kind == "resource.drop":
            rid = entry[1]
            def rdrop(vals, rid=rid):
                with self._lock:
                    self.handles.get(rid, {}).pop(vals[0] & 0xFFFFFFFF, None)
                return []
            return rdrop
        if kind == "alias":
            # core import satisfied by another core instance's export — only
            # meaningful with multiple modules, which is out of scope
            def unsup(vals):
                raise ComponentError("multi-module core linking unsupported")
            return unsup
        raise ComponentError(f"unsupported core func binding {kind}")

    def _lowered_host_call(self, ftype: Tuple, impl: Callable) -> Callable:
        _, params, result = ftype
        ptypes = [pt for _, pt in params]
        flat_params: List[str] = []
        for pt in ptypes:
            flat_params.extend(flatten_type(pt))
        flat_results = flatten_type(result) if result is not None else []
        spill_params = len(flat_params) > MAX_FLAT_PARAMS
        spill_results = len(flat_results) > MAX_FLAT_RESULTS

        def handler(vals: List[int]) -> List[int]:
            cabi = self.cabi
            if spill_params:
                ptr = vals[0] & 0xFFFFFFFF
                args = []
                off = 0
                for pt in ptypes:
                    s, a = size_align(pt)
                    off = _align_to(off, a)
                    args.append(cabi.load(pt, ptr + off))
                    off += s
                rest = vals[1:]
            else:
                it = iter(vals)
                args = [cabi.lift_flat(pt, it) for pt in ptypes]
                rest = list(it)
            ret = impl(*args)
            if result is None:
                return []
            if spill_results:
                retptr = rest[-1] & 0xFFFFFFFF
                cabi.store(result, ret, retptr)
                return []
            out: List[int] = []
            cabi.lower_flat(result, ret, out)
            return out

        return handler

    def _default_log(self, level: str, message: str) -> None:
        if self.logger is not None:
            self.logger(level, message)

    # -- WASI stubs -----------------------------------------------------------

    def _wasi_stub(self, module: str, field: str) -> Callable:
        """Deterministic, capability-free stubs for the wasi:cli world
        surface a plugin may import but a pure packet transform never
        meaningfully uses. Unknown functions trap by name."""
        def stub(vals, module=module, field=field):
            if field in ("environ-get", "get-environment", "get-arguments"):
                return [0, 0] if len(vals) == 0 else [0]
            if field in ("environ-sizes-get",):
                return [0, 0]
            if field == "now" or field.endswith("clock-time-get"):
                return [0]
            if field in ("get-random-bytes", "random-get"):
                return [0]
            if field == "exit":
                raise ComponentError("plugin called wasi exit")
            raise ComponentError(f"wasi import {module}.{field} not supported in sandbox")
        return stub

    # -- lifted export calls --------------------------------------------------

    def exported_funcs(self, instance_export: str) -> Dict[str, Tuple]:
        return self.parsed.export_instance_funcs(instance_export)

    def call_lifted(self, func_entry: Tuple, *py_args: Any) -> Any:
        """Call a canon-lifted export with Python arguments."""
        if func_entry[0] != "lift":
            raise ComponentError("not a lifted function")
        _, core_idx, opts, ftype = func_entry
        core_entry = self.parsed.core_funcs[core_idx]
        if core_entry[0] != "alias":
            raise ComponentError("lift must target a core-instance export")
        core_name = core_entry[2]
        _, params, result = ftype
        ptypes = [pt for _, pt in params]
        if len(py_args) != len(ptypes):
            raise ComponentError(
                f"{core_name}: expected {len(ptypes)} args, got {len(py_args)}"
            )
        flat_params: List[str] = []
        for pt in ptypes:
            flat_params.extend(flatten_type(pt))
        flat_results = flatten_type(result) if result is not None else []
        cabi = self.cabi
        self._pending_error = None

        call_args: List[int] = []
        if len(flat_params) > MAX_FLAT_PARAMS:
            total = 0
            align = 1
            offs = []
            for pt in ptypes:
                s, a = size_align(pt)
                align = max(align, a)
                total = _align_to(total, a)
                offs.append(total)
                total += s
            ptr = cabi.alloc(total, align)
            for pt, v, off in zip(ptypes, py_args, offs):
                cabi.store(pt, v, ptr + off)
            call_args.append(ptr)
        else:
            for pt, v in zip(ptypes, py_args):
                cabi.lower_flat(pt, v, call_args)

        spill_results = len(flat_results) > MAX_FLAT_RESULTS
        nres = 0 if result is None else (1 if not spill_results else 1)
        if result is None:
            nres = 0
        try:
            res = self.call_core(core_name, *call_args, nresults=nres)
        except RuntimeError as e:
            if self._pending_error is not None:
                raise self._pending_error from e
            raise
        value: Any = None
        if result is not None:
            if spill_results:
                retptr = res[0] & 0xFFFFFFFF
                value = cabi.load(result, retptr)
            else:
                value = cabi.lift_flat(result, iter(res))
        if "post-return" in opts:
            post = self.parsed.core_funcs[opts["post-return"]]
            if post[0] == "alias" and res:
                self.call_core(post[2], res[0], nresults=0)
        return value


_HOST_LOG = ("streamkit:plugin/host@0.1.0", "log")


# ------------------------------------------------------- plugin world types


def wit_plugin_world() -> Dict[str, Any]:
    """The ``streamkit:plugin`` world's types as parser-shaped Python data
    (``wit/plugin.wit:4-131``). Shared by the component builder (tests/SDK),
    the host node wrapper, and as the semantic reference the parsed binary
    is validated against."""
    sample_format = ("enum", ("float32", "s16-le"))
    audio_format = (
        "record",
        (
            ("sample-rate", "u32"),
            ("channels", "u16"),
            ("sample-format", sample_format),
        ),
    )
    packet_type = (
        "variant",
        (
            ("raw-audio", audio_format),
            ("opus-audio", None),
            ("text", None),
            ("binary", None),
            ("custom", "string"),
            ("any", None),
        ),
    )
    custom_encoding = ("enum", ("json",))
    custom_packet = (
        "record",
        (
            ("type-id", "string"),
            ("encoding", custom_encoding),
            ("data", "string"),
        ),
    )
    input_pin = (
        "record",
        (("name", "string"), ("accepts-types", ("list", packet_type))),
    )
    output_pin = (
        "record",
        (("name", "string"), ("produces-type", packet_type)),
    )
    node_metadata = (
        "record",
        (
            ("kind", "string"),
            ("inputs", ("list", input_pin)),
            ("outputs", ("list", output_pin)),
            ("param-schema", "string"),
            ("categories", ("list", "string")),
        ),
    )
    audio_frame = (
        "record",
        (
            ("sample-rate", "u32"),
            ("channels", "u16"),
            ("samples", ("list", "f32")),
        ),
    )
    packet = (
        "variant",
        (
            ("audio", audio_frame),
            ("text", "string"),
            ("binary", ("list", "u8")),
            ("custom", custom_packet),
        ),
    )
    log_level = ("enum", ("debug", "info", "warn", "error"))
    node_instance = Resource("node-instance")
    res_str = ("result", None, "string")
    return {
        "sample-format": sample_format,
        "audio-format": audio_format,
        "packet-type": packet_type,
        "custom-encoding": custom_encoding,
        "custom-packet": custom_packet,
        "input-pin": input_pin,
        "output-pin": output_pin,
        "node-metadata": node_metadata,
        "audio-frame": audio_frame,
        "packet": packet,
        "log-level": log_level,
        "node-instance": node_instance,
        "funcs": {
            "metadata": ("func", (), node_metadata),
            "[constructor]node-instance": (
                "func",
                (("params", ("option", "string")),),
                ("own", node_instance),
            ),
            "[method]node-instance.process": (
                "func",
                (
                    ("self", ("borrow", node_instance)),
                    ("input-pin", "string"),
                    ("packet", packet),
                ),
                res_str,
            ),
            "[method]node-instance.update-params": (
                "func",
                (
                    ("self", ("borrow", node_instance)),
                    ("params", ("option", "string")),
                ),
                res_str,
            ),
            "[method]node-instance.cleanup": (
                "func",
                (("self", ("borrow", node_instance)),),
                None,
            ),
            "send-output": (
                "func",
                (("pin-name", "string"), ("packet", packet)),
                res_str,
            ),
            "log": (
                "func",
                (("level", log_level), ("message", "string")),
                None,
            ),
        },
    }


def describe_wit_package(data: bytes) -> Dict[str, Any]:
    """Summarize a binary WIT package (types-only component, e.g. the
    reference's ``sdks/plugin-sdk/wit/streamkit-plugin.wasm``):
    {package_export: {interface_export: {'funcs': {name: functype},
    'types': {name: t}}}}. Used by the parity test that pins our grammar
    to a reference-produced binary."""
    pc = parse_component(data)
    out: Dict[str, Any] = {}
    for name, (sort, idx) in pc.exports.items():
        if sort != "type":
            continue
        t = pc.scope.types[idx]
        if not (isinstance(t, tuple) and t[0] == "component"):
            out[name] = {"kind": "type"}
            continue
        ifaces: Dict[str, Any] = {}
        for dname, desc in t[1].items():
            if not dname.startswith("export "):
                continue
            ename = dname[len("export "):]
            if desc[0] == "instance" and isinstance(desc[1], tuple):
                funcs = {}
                types = {}
                for xname, xdesc in desc[1][1].items():
                    if xdesc[0] == "func":
                        funcs[xname] = xdesc[1]
                    elif xdesc[0] == "type":
                        types[xname] = xdesc[1]
                ifaces[ename] = {"funcs": funcs, "types": types}
            else:
                ifaces[ename] = {"kind": desc[0]}
        out[name] = ifaces
    return out


# ----------------------------------------------------------- node adapter


def _packet_to_wit(pkt) -> Optional[Tuple[str, Any]]:
    """Our Packet -> WIT ``packet`` variant value (None = unconvertible)."""
    from ..core.types import _PayloadKind

    if pkt.kind == _PayloadKind.AUDIO and pkt.audio is not None:
        f = pkt.audio
        return (
            "audio",
            {
                "sample-rate": f.format.sample_rate,
                "channels": f.format.channels,
                "samples": [float(x) for x in f.samples.reshape(-1)],
            },
        )
    if pkt.kind == _PayloadKind.TEXT and pkt.text is not None:
        return ("text", pkt.text)
    if pkt.kind == _PayloadKind.BINARY and pkt.binary is not None:
        return ("binary", bytes(pkt.binary))
    if pkt.kind == _PayloadKind.CUSTOM and pkt.custom is not None:
        import json

        return (
            "custom",
            {
                "type-id": pkt.custom.type_id,
                "encoding": "json",
                "data": json.dumps(pkt.custom.data),
            },
        )
    return None


def _wit_to_packet(v: Tuple[str, Any]):
    """WIT ``packet`` variant value -> our Packet."""
    import numpy as np

    from ..core.types import (
        AudioFormat,
        AudioFrame,
        CustomPacketData,
        Packet,
        SampleFormat,
    )

    case, payload = v
    if case == "audio":
        fmt = AudioFormat(
            sample_rate=int(payload["sample-rate"]),
            channels=max(1, int(payload["channels"])),
            sample_format=SampleFormat.F32,
        )
        samples = np.asarray(payload["samples"], dtype=np.float32)
        return Packet.new_audio(AudioFrame(samples, fmt))
    if case == "text":
        return Packet.new_text(payload)
    if case == "binary":
        return Packet.new_binary(bytes(payload))
    if case == "custom":
        import json

        return Packet.new_custom(
            CustomPacketData(type_id=payload["type-id"], data=json.loads(payload["data"]))
        )
    raise ComponentError(f"unsupported packet case {case!r}")


def _wit_pin_type(pt: Tuple[str, Any]):
    """WIT ``packet-type`` variant -> our PacketType."""
    from ..core.types import AudioFormat, PacketType, SampleFormat

    case, payload = pt if isinstance(pt, tuple) and len(pt) == 2 else (pt, None)
    if case == "raw-audio":
        fmt = None
        if payload and (payload.get("sample-rate") or payload.get("channels")):
            fmt = AudioFormat(
                sample_rate=int(payload.get("sample-rate", 0)),
                channels=int(payload.get("channels", 0)),
                sample_format=SampleFormat.F32
                if payload.get("sample-format") == "float32"
                else SampleFormat.S16LE,
            )
        return PacketType.raw_audio(fmt)
    if case == "opus-audio":
        return PacketType.opus_audio()
    if case == "text":
        return PacketType.text()
    if case == "binary":
        return PacketType.binary()
    if case == "custom":
        return PacketType.custom(payload or "*")
    return PacketType.any()


NODE_EXPORT = "streamkit:plugin/node@0.1.0"
HOST_EXPORT = "streamkit:plugin/host@0.1.0"


class LoadedComponentPlugin:
    """Parsed component + metadata; one fresh core instance per node."""

    def __init__(self, path: str) -> None:
        import json
        import os

        self.path = path
        self.data = open(path, "rb").read()
        self.parsed = parse_component(self.data)
        self.name = os.path.splitext(os.path.basename(path))[0]
        self.funcs = self.parsed.export_instance_funcs(NODE_EXPORT)
        for req in ("metadata", "[constructor]node-instance",
                    "[method]node-instance.process"):
            if req not in self.funcs:
                raise ComponentError(f"plugin component missing node export {req!r}")
        # metadata comes from a scratch instance at load time (upload-time
        # validation, like the reference's plugin install probe)
        scratch = ComponentInstance(self.parsed)
        self.metadata = scratch.call_lifted(self.funcs["metadata"])
        kind = str(self.metadata.get("kind") or "")
        self.kind = kind if kind.startswith("plugin::") else f"plugin::wasm::{self.name}"
        self.param_schema = self.metadata.get("param-schema", "")
        del scratch

    def parsed_resource(self) -> Resource:
        return self.parsed.parsed_resource()

    def create_instance(self, params: Optional[dict]) -> "ComponentNodeWrapper":
        return ComponentNodeWrapper(self, params)


from ..core.node import ProcessorNode as _ProcessorNode


class ComponentNodeWrapper(_ProcessorNode):
    """Pipeline node backed by a component instance (single-threaded over
    its own store, like the reference's per-node wasmtime store)."""

    KIND = "plugin::wasm::<component>"

    def __init__(self, plugin: LoadedComponentPlugin, params: Optional[dict]) -> None:
        self.plugin = plugin
        self.params = dict(params or {})

    # pins come from the plugin's own metadata
    def input_pins(self):
        from ..core import InputPin

        pins = []
        for p in self.plugin.metadata.get("inputs", []):
            pins.append(
                InputPin(p["name"], [_wit_pin_type(t) for t in p["accepts-types"]])
            )
        return pins or [InputPin("in", [_wit_pin_type(("any", None))])]

    def output_pins(self):
        from ..core import OutputPin

        pins = []
        for p in self.plugin.metadata.get("outputs", []):
            pins.append(OutputPin(p["name"], _wit_pin_type(p["produces-type"])))
        return pins or [OutputPin("out", _wit_pin_type(("any", None)))]

    async def run(self, ctx) -> None:
        import asyncio
        import json
        import logging

        from ..core import NodeStatsTracker
        from ..core.state import NodeState, StopReason

        log = logging.getLogger(f"plugin.wasm.{self.plugin.name}")
        outbox: List[Tuple[str, Any]] = []

        def send_output(pin: str, pkt: Tuple[str, Any]):
            outbox.append((pin, pkt))
            return ("ok", None)

        def host_log(level: str, message: str) -> None:
            getattr(log, "warning" if level == "warn" else level, log.info)(
                "%s", message
            )

        inst = ComponentInstance(
            self.plugin.parsed,
            host_funcs={
                (HOST_EXPORT, "send-output"): send_output,
                (HOST_EXPORT, "log"): host_log,
            },
            logger=host_log,
        )
        funcs = self.plugin.funcs
        params_json = json.dumps(self.params) if self.params else None
        # `self` for methods is the canonical BORROW lowering: the handle
        # index (wit-bindgen guests unwrap it via [resource-rep]) — passing
        # the rep directly would break real cargo-component plugins
        handle = inst.call_lifted(funcs["[constructor]node-instance"], params_json)
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        ctx.emit_state(NodeState.running())
        loop = asyncio.get_running_loop()
        in_names = [p.name for p in self.input_pins()]

        # merged receive across ALL declared input pins (multi-input
        # components would otherwise deadlock their undrained channels).
        # Bounded: the pumps must NOT strip the input Channels' backpressure
        # by draining them into unbounded memory.
        merged: "asyncio.Queue" = asyncio.Queue(maxsize=4)
        live = len(in_names)

        async def pump(pin: str) -> None:
            nonlocal live
            while True:
                pkt = await ctx.recv_with_cancellation(pin)
                if pkt is None:
                    live -= 1
                    if live == 0:
                        await merged.put((None, None))
                    return
                await merged.put((pin, pkt))

        pumps = [asyncio.ensure_future(pump(p)) for p in in_names]
        try:
            while True:
                pin, pkt = await merged.get()
                if pkt is None:
                    break
                stats.packet_received()
                msg = ctx.poll_control()
                if msg is not None and getattr(msg, "op", "") == "update_params":
                    self.params.update(msg.params or {})
                    if "[method]node-instance.update-params" in funcs:
                        res = inst.call_lifted(
                            funcs["[method]node-instance.update-params"],
                            handle,
                            json.dumps(self.params),
                        )
                        if res and res[0] == "error":
                            log.warning("update-params rejected: %s", res[1])
                wit = _packet_to_wit(pkt)
                if wit is None:
                    await ctx.output.send("out", pkt)
                    continue
                res = await loop.run_in_executor(
                    None,
                    inst.call_lifted,
                    funcs["[method]node-instance.process"],
                    handle,
                    pin,
                    wit,
                )
                if res and res[0] == "error":
                    log.warning("process error: %s", res[1])
                while outbox:
                    out_pin, out_wit = outbox.pop(0)
                    await ctx.output.send(out_pin, _wit_to_packet(out_wit))
                    stats.packet_sent()
        finally:
            for t in pumps:
                t.cancel()
            try:
                if "[method]node-instance.cleanup" in funcs:
                    inst.call_lifted(funcs["[method]node-instance.cleanup"], handle)
            except Exception:
                pass
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))


def is_component_binary(data: bytes) -> bool:
    return len(data) >= 8 and data[:4] == b"\x00asm" and data[6:8] == b"\x01\x00"


def load_component_plugin(registry, path: str) -> LoadedComponentPlugin:
    """Load + register a component plugin under its metadata kind."""
    plugin = LoadedComponentPlugin(path)
    registry.register(
        plugin.kind,
        lambda params: plugin.create_instance(params),
        description=f"WASM component plugin {plugin.name}",
    )
    return plugin
