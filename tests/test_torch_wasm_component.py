# SPDX-License-Identifier: Apache-2.0
"""The port's component-model host (``plugins/component.py``,
``plugins/component_asm.py``) against the JAX package's, on the same bytes.

Case for case the mirror of ``tests/test_wasm_component.py``: the binary
grammar, the canonical ABI's flattening, sizes and memory round trip, the
gain component end to end (metadata, resource handles, host
``send-output``, post-returns), the node adapter, the upload route and
hostile binaries. Each case runs both hosts and asserts equal results; the
JAX host runs on a runtime built here from ``native/shims/wasm_rt.cpp``
(``_torch_native``), the port on its own build of ``csrc/wasm_rt.cpp``."""

from __future__ import annotations

import asyncio
import os
import random
import shutil
import tempfile

import numpy as np
import pytest
import torch

import streamkit_tpu.core as jax_core
import streamkit_tpu.plugins.component as jax_component
import streamkit_tpu.plugins.component_asm as jax_asm
import streamkit_tpu.plugins.wasm as jax_wasm
import streamkit_tpu_torch.core as torch_core
import streamkit_tpu_torch.plugins.component as torch_component
import streamkit_tpu_torch.plugins.component_asm as torch_asm
import streamkit_tpu_torch.plugins.wasm as torch_wasm
from _torch_native import point_jax_wasm
from test_torch_plugins import both, call, file_form, on_both, same

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

COMPONENT = {"jax": jax_component, "torch": torch_component}
ASM = {"jax": jax_asm, "torch": torch_asm}
CORE = {"jax": jax_core, "torch": torch_core}
WASM = {"jax": jax_wasm, "torch": torch_wasm}

WIT_PKG = "/root/reference/sdks/plugin-sdk/wit/streamkit-plugin.wasm"
needs_ref = pytest.mark.skipif(not os.path.exists(WIT_PKG), reason="reference WIT package absent")
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ builds the WASM runtimes")


@pytest.fixture(scope="module")
def runtimes():
    if shutil.which("g++") is None:
        pytest.skip("g++ builds the WASM runtimes")
    return point_jax_wasm()


def plain(v):
    """A value with the hosts' ``Resource`` objects replaced by their names
    (resource identity is per parse, so per package)."""
    if isinstance(v, (jax_component.Resource, torch_component.Resource)):
        return ("resource", v.name)
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(plain(x) for x in v)
    return v


# ---------------------------------------------------------------- grammar
@needs_ref
def test_reference_wit_package_parses():
    data = open(WIT_PKG, "rb").read()
    d = same(both(lambda pkg: plain(COMPONENT[pkg].describe_wit_package(data))))
    node = d["node"]["streamkit:plugin/node@0.1.0"]
    assert set(node["funcs"]) >= {"metadata", "[constructor]node-instance", "[method]node-instance.process"}
    assert set(d["host"]["streamkit:plugin/host@0.1.0"]["funcs"]) == {"send-output", "log"}


def test_flatten_and_size_rules():
    def rules(pkg):
        c = COMPONENT[pkg]
        w = c.wit_plugin_world()
        return (len(c.flatten_type(w["packet"])), c.flatten_type(w["audio-frame"]),
                len(c.flatten_type(("result", None, "string"))), c.size_align(w["audio-format"]),
                c.size_align(w["packet-type"]), c.size_align("string"), c.size_align(("own", w["node-instance"])),
                sorted(w))

    got = same(both(rules))
    assert got[:7] == (6, ["i32", "i32", "i32", "i32"], 3, (8, 4), (12, 4), (8, 4), (4, 4))


def test_cabi_memory_roundtrip():
    t = ("record", (("name", "string"), ("tags", ("list", "string")), ("pos", ("tuple", ("u32", "s64"))),
                    ("flag", ("option", "f64")), ("st", ("result", "u8", "string")), ("mode", ("enum", ("a", "b", "c"))),
                    ("caps", ("flags", ("x", "y", "z"))), ("ch", "char"), ("blob", ("list", "u8"))))
    v = {"name": "héllo", "tags": ["a", "bb", ""], "pos": (7, -(1 << 40)), "flag": 2.5, "st": ("error", "nope"),
         "mode": "c", "caps": {"x", "z"}, "ch": "λ", "blob": b"\x00\x01\xff"}

    def roundtrip(pkg):
        sm = ASM[pkg]._StaticMemory(0x100)
        cabi = COMPONENT[pkg]._Cabi(sm)
        size, align = COMPONENT[pkg].size_align(t)
        ptr = sm.call_core("cabi_realloc", 0, 0, align, size)[0]
        cabi.store(t, v, ptr)
        return bytes(sm.full[ptr: ptr + size]), cabi.load(t, ptr)

    raw, back = same(both(roundtrip))
    assert back == v and len(raw) > 0


def test_static_metadata_blob_layout():
    value = {"kind": "plugin::wasm::x", "inputs": [{"name": "in", "accepts-types": [("text", None)]}],
             "outputs": [{"name": "out", "produces-type": ("text", None)}], "param-schema": "{}",
             "categories": ["t"]}

    def layout(pkg):
        w = COMPONENT[pkg].wit_plugin_world()
        ptr, blob = ASM[pkg].lower_static(w["node-metadata"], value, 0x2000)
        sm = ASM[pkg]._StaticMemory(0x2000)
        sm.full[0x2000: 0x2000 + len(blob)] = blob
        return ptr, blob, COMPONENT[pkg]._Cabi(sm).load(w["node-metadata"], ptr)

    ptr, _, back = same(both(layout))
    assert ptr == 0x2000 and back == value


# ------------------------------------------------------------- end-to-end
def _audio(rate, samples):
    return ("audio", {"sample-rate": rate, "channels": 1, "samples": samples})


@needs_gxx
def test_gain_component_end_to_end(runtimes):
    comp = torch_asm.build_gain_component()
    assert comp == jax_asm.build_gain_component() and comp[:8] == b"\x00asm\x0d\x00\x01\x00"

    def run(pkg):
        c, a = COMPONENT[pkg], ASM[pkg]
        pc = c.parse_component(comp)
        funcs = pc.export_instance_funcs(a.NODE_IFACE)
        sent = []
        inst = c.ComponentInstance(pc, host_funcs={
            (a.HOST_IFACE, "send-output"): lambda pin, pkt: (sent.append((pin, pkt)), ("ok", None))[1]})
        out = [sorted(funcs), inst.call_lifted(funcs["metadata"])]
        h = inst.call_lifted(funcs["[constructor]node-instance"], "3")
        out.append(inst.call_lifted(funcs["[method]node-instance.process"], h, "in", _audio(16000, [1.0, 2.0, -0.5])))
        out.append(inst.call_lifted(funcs["[method]node-instance.update-params"], h, "5"))
        out.append(inst.call_lifted(funcs["[method]node-instance.process"], h, "in", _audio(8000, [2.0])))
        out.append(inst.call_lifted(funcs["[method]node-instance.process"], h, "in", ("text", "hi")))
        inst.call_lifted(funcs["[method]node-instance.cleanup"], h)
        return out, sent

    (names, meta, *results), sent = same(both(run))
    assert {"metadata", "[constructor]node-instance", "[method]node-instance.process"} <= set(names)
    assert meta["kind"] == "plugin::wasm::gain" and meta["outputs"][0]["produces-type"][0] == "raw-audio"
    assert results == [("ok", None)] * 4
    assert [p[1][1]["samples"] for p in sent] == [[3.0, 6.0, -1.5], [10.0]]


@needs_gxx
def test_resource_handle_table(runtimes):
    import struct

    comp = torch_asm.build_gain_component()

    def run(pkg):
        c, a = COMPONENT[pkg], ASM[pkg]
        pc = c.parse_component(comp)
        funcs = pc.export_instance_funcs(a.NODE_IFACE)
        inst = c.ComponentInstance(pc)
        ni = pc.parsed_resource()
        h1 = inst.call_lifted(funcs["[constructor]node-instance"], None)
        h2 = inst.call_lifted(funcs["[constructor]node-instance"], "7")
        mem = inst.core.memory()
        gains = [struct.unpack("<f", mem[inst.handles[ni][h]: inst.handles[ni][h] + 4])[0] for h in (h1, h2)]
        return h1, h2, sorted(inst.handles[ni]), gains

    h1, h2, handles, gains = same(both(run))
    assert h1 != h2 and handles == sorted([h1, h2]) and gains == [1.0, 7.0]


@needs_gxx
def test_missing_host_function_traps_cleanly(runtimes):
    comp = torch_asm.build_gain_component()

    def run(pkg):
        c, a = COMPONENT[pkg], ASM[pkg]
        pc = c.parse_component(comp)
        funcs = pc.export_instance_funcs(a.NODE_IFACE)
        inst = c.ComponentInstance(pc)  # no send-output provided
        h = inst.call_lifted(funcs["[constructor]node-instance"], None)
        with pytest.raises(c.ComponentError, match="send-output not provided") as e:
            inst.call_lifted(funcs["[method]node-instance.process"], h, "in", _audio(1, [0.0]))
        return str(e.value)

    same(both(run))


def test_hostile_binaries_rejected():
    comp = torch_asm.build_gain_component()
    bad = bytearray(comp)
    bad[8] = 99
    cases = [b"nope", b"\x00asm\x01\x00\x00\x00", comp[: len(comp) // 2], bytes(bad)]

    def run(pkg):
        out = []
        for data in cases:
            with pytest.raises(COMPONENT[pkg].ComponentError) as e:
                COMPONENT[pkg].parse_component(data)
            out.append(str(e.value))
        return out

    msgs = same(both(run))
    assert "magic" in msgs[0] and "layer" in msgs[1]


# ----------------------------------------------------------- node adapter
@needs_gxx
def test_component_node_processes_audio_packets(runtimes):
    with tempfile.NamedTemporaryFile(suffix=".wasm", delete=False) as f:
        f.write(torch_asm.build_gain_component())
        path = f.name

    def run(pkg):
        core = CORE[pkg]
        reg = core.NodeRegistry()
        plugin = WASM[pkg].load_wasm_plugin(reg, path)
        node = reg.create_node(plugin.kind, {"gain": 2})

        async def main():
            inputs = {p.name: core.Channel(16) for p in node.input_pins()}
            out_ch = core.Channel(64)
            ctx = core.NodeContext(node_name="g", inputs=inputs,
                                   output=core.OutputSender("g", direct={p.name: out_ch for p in node.output_pins()}))
            fmt = core.AudioFormat(sample_rate=16000, channels=1)
            await inputs["in"].send(core.Packet.new_audio(core.AudioFrame(np.array([0.25, -0.5, 1.0], np.float32), fmt)))
            inputs["in"].close()
            await node.run(ctx)
            return await out_ch.recv_optional()

        out = asyncio.run(main())
        return plugin.kind, out.audio.samples.tolist(), out.audio.format.sample_rate

    try:
        assert same(both(run)) == ("plugin::wasm::gain", [0.5, -1.0, 2.0], 16000)
    finally:
        os.unlink(path)


@needs_gxx
def test_upload_component_plugin_via_api(runtimes, tmp_path):
    async def scenario(s, base, cfg):
        return await call(s, "POST", base + "/api/v1/plugins",
                          data=file_form(torch_asm.build_gain_component(), "cgain.wasm"))

    status, doc = same(on_both(tmp_path, scenario))
    assert status == 201 and doc["kind"] == "plugin::wasm::gain"


def test_component_parser_fuzz_never_crashes():
    """Byte flips and truncations: each host parses or raises, and both do
    the same for every input."""
    comp = bytearray(torch_asm.build_gain_component())
    rng = random.Random(0)
    inputs = []
    for _ in range(300):
        mutated = bytearray(comp)
        for _ in range(rng.randint(1, 8)):
            mutated[rng.randrange(len(mutated))] = rng.randrange(256)
        inputs.append(bytes(mutated))
    inputs += [bytes(comp[:cut]) for cut in range(8, len(comp), 97)]

    def run(pkg):
        out = []
        for data in inputs:
            try:
                COMPONENT[pkg].parse_component(data)
                out.append("parsed")
            except (COMPONENT[pkg].ComponentError, UnicodeDecodeError) as e:
                out.append(f"{type(e).__name__}: {e}")
        return out

    got = same(both(run))
    assert "parsed" in got and any(r.startswith("ComponentError") for r in got)


@needs_gxx
def test_post_returns_invoked_after_lift(runtimes):
    comp = torch_asm.build_gain_component()

    def run(pkg):
        c, a = COMPONENT[pkg], ASM[pkg]
        pc = c.parse_component(comp)
        funcs = pc.export_instance_funcs(a.NODE_IFACE)
        posted = sorted(n for n, f in funcs.items() if f[0] == "lift" and "post-return" in f[2])
        inst = c.ComponentInstance(pc, host_funcs={(a.HOST_IFACE, "send-output"): lambda pin, pkt: ("ok", None)})
        calls = []
        orig = inst.call_core

        def spy(name, *args, **kw):
            calls.append(name)
            return orig(name, *args, **kw)

        inst.call_core = spy
        inst.call_lifted(funcs["metadata"])
        h = inst.call_lifted(funcs["[constructor]node-instance"], "2")
        res = [inst.call_lifted(funcs["[method]node-instance.process"], h, "in", _audio(16000, [1.0]))
               for _ in range(3)]
        return posted, calls, res

    posted, calls, res = same(both(run))
    iface = torch_asm.NODE_IFACE
    assert {"metadata", "[method]node-instance.process", "[method]node-instance.update-params"} <= set(posted)
    assert res == [("ok", None)] * 3
    main_i = [i for i, c in enumerate(calls) if c == f"{iface}#[method]node-instance.process"]
    post_i = [i for i, c in enumerate(calls) if c == f"cabi_post_{iface}#[method]node-instance.process"]
    assert calls.count(f"cabi_post_{iface}#metadata") == 1 and len(post_i) == 3
    assert all(p > m for m, p in zip(main_i, post_i))


@needs_gxx
def test_host_callbacks_live_as_long_as_the_core_instance(runtimes):
    """The interpreter holds a pointer to the host callback: the port's core
    instance keeps the ctypes trampoline (and through it the component
    instance its handlers use) alive for as long as the core lives."""
    import gc
    import weakref

    pc = torch_component.parse_component(torch_asm.build_gain_component())
    funcs = pc.export_instance_funcs(torch_asm.NODE_IFACE)
    sent = []
    inst = torch_component.ComponentInstance(pc, host_funcs={
        (torch_asm.HOST_IFACE, "send-output"): lambda pin, pkt: (sent.append(pkt), ("ok", None))[1]})
    h = inst.call_lifted(funcs["[constructor]node-instance"], "2")
    core, ref = inst.core, weakref.ref(inst)
    assert core._host_cb is inst._cb
    del inst
    gc.collect()
    assert ref() is not None
    assert ref().call_lifted(funcs["[method]node-instance.process"], h, "in", _audio(8000, [1.5])) == ("ok", None)
    assert sent == [_audio(8000, [3.0])]
    del core
    gc.collect()
    assert ref() is None
