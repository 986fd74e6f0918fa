# SPDX-License-Identifier: Apache-2.0
"""The port's plugin hosts against the JAX package's, on the same plugin
files: the core-WASM host (``plugins/wasm.py`` over the port's own build of
``csrc/wasm_rt.cpp``), the native C-ABI host (``plugins/native.py``) and the
plugin routes (``server/plugins_api.py``) with the CLI's ``plugins`` command
and the load test's populate phase.

Case for case the mirror of ``tests/test_wasm_plugins.py``,
``tests/test_native_plugins.py`` and ``tests/test_server.py``'s
``test_plugin_endpoints``: each runs the same bytes through both hosts and
asserts equal results (return values, output bytes, trap messages, route
responses). The JAX host loads a runtime and the native gain plugin built
here from ``native/`` (``_torch_native``), never ``native/build/``. Then the
findings of the port: the four gains in front of the same sink give equal
bytes, the JAX load test's populate never loads a plugin, delete differs by
runtime across a restart, and a re-uploaded native library keeps its old
code in both hosts (ROADMAP §3)."""

from __future__ import annotations

import asyncio
import os
import re
import shutil
import subprocess
import tempfile

import aiohttp
import numpy as np
import pytest
import torch

import streamkit_tpu.api as jax_api
import streamkit_tpu.cli.loadtest as jax_lt
import streamkit_tpu.core as jax_core
import streamkit_tpu.engine as jax_engine
import streamkit_tpu.engine.dynamic as jax_dynamic
import streamkit_tpu.nodes as jax_nodes
import streamkit_tpu.plugins.native as jax_native
import streamkit_tpu.plugins.wasm as jax_wasm
import streamkit_tpu_torch.api as torch_api
import streamkit_tpu_torch.cli.loadtest as torch_lt
import streamkit_tpu_torch.core as torch_core
import streamkit_tpu_torch.engine as torch_engine
import streamkit_tpu_torch.engine.dynamic as torch_dynamic
import streamkit_tpu_torch.nodes as torch_nodes
import streamkit_tpu_torch.plugins.native as torch_native
import streamkit_tpu_torch.plugins.wasm as torch_wasm
from _torch_native import CXXFLAGS, NATIVE, build, point_jax_wasm
from streamkit_tpu_torch.ops import _build
from streamkit_tpu_torch.plugins import wasm_asm as asm
from streamkit_tpu_torch.plugins.component_asm import build_gain_component
from test_server import make_wav
from test_torch_server import configs as server_configs
from test_torch_server import same, serve

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

PACKAGES = ("jax", "torch")
WASM = {"jax": jax_wasm, "torch": torch_wasm}
NATIVE_HOST = {"jax": jax_native, "torch": torch_native}
CORE = {"jax": jax_core, "torch": torch_core}

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ builds every plugin runtime")


@pytest.fixture(scope="module", autouse=True)
def jax_runtime():
    return point_jax_wasm()


@pytest.fixture(scope="module")
def gain_so():
    return build("gain_cpp.so")


def registry(pkg):
    reg = CORE[pkg].NodeRegistry()
    if pkg == "jax":
        jax_nodes.register_nodes(reg)
    else:
        torch_nodes.register_nodes(reg, device="cpu")
    return reg


def both(fn):
    """``fn(pkg)`` for each package → {pkg: result}."""
    return {pkg: fn(pkg) for pkg in PACKAGES}


def trap(pkg, wasm_bytes, name, *args, fuel=None, nresults=1):
    """``name(*args)`` on a new instance → ("ok", results) or ("trap", message)."""
    kw = {} if fuel is None else {"fuel": fuel}
    inst = WASM[pkg].WasmInstance(wasm_bytes, **kw)
    try:
        return "ok", inst.call(name, *args, nresults=nresults)
    except RuntimeError as e:
        return "trap", str(e)


def oneshot(pkg, reg, yaml_text: str, body: bytes) -> bytes:
    api, engine = (jax_api, jax_engine) if pkg == "jax" else (torch_api, torch_engine)

    async def main():
        async def stream():
            yield body

        res = await engine.run_oneshot_pipeline(reg, api.compile_yaml(yaml_text), input_stream=stream())
        return await res.read_all()

    return asyncio.run(main())


def gain_yaml(kind: str, params: str) -> str:
    return f"""
mode: oneshot
steps:
  - kind: streamkit::http_input
  - kind: containers::wav::demuxer
  - kind: {kind}
    params: {params}
  - kind: containers::wav::muxer
  - kind: streamkit::http_output
"""


# -- the mirror of tests/test_wasm_plugins.py ----------------------------------
def test_add_function():
    b = asm.WasmModuleBuilder()
    f = b.add_func([asm.I32, asm.I32], [asm.I32], bytes([asm.LOCAL_GET, 0, asm.LOCAL_GET, 1, asm.I32_ADD, asm.END]))
    b.export_func("add", f)
    wasm = b.build()
    got = same(both(lambda pkg: (trap(pkg, wasm, "add", 2, 40), trap(pkg, wasm, "add", -5 & 0xFFFFFFFF, 3))))
    assert got[0] == ("ok", [42]) and got[1][1][0] & 0xFFFFFFFF == (-2 & 0xFFFFFFFF)


def test_fuel_exhaustion_stops_infinite_loop():
    b = asm.WasmModuleBuilder()
    f = b.add_func([], [], bytes([asm.BLOCK, asm.VOID, asm.LOOP, asm.VOID, asm.BR, 0, asm.END, asm.END, asm.END]))
    b.export_func("spin", f)
    wasm = b.build()
    kind, msg = same(both(lambda pkg: trap(pkg, wasm, "spin", fuel=10_000, nresults=0)))
    assert kind == "trap" and "fuel" in msg


def test_oob_memory_access_traps():
    b = asm.WasmModuleBuilder()
    f = b.add_func([asm.I32], [asm.I32], bytes([asm.LOCAL_GET, 0, asm.I32_LOAD]) + asm.memarg(2, 0) + bytes([asm.END]))
    b.export_func("peek", f)
    wasm = b.build()
    got = same(both(lambda pkg: (trap(pkg, wasm, "peek", 0), trap(pkg, wasm, "peek", 1 << 30))))
    assert got[0] == ("ok", [0]) and got[1][0] == "trap" and "memory" in got[1][1]


def test_memory_cap_64mib():
    """memory.grow past the 64 MiB cap returns -1 in both hosts."""
    b = asm.WasmModuleBuilder()
    f = b.add_func([asm.I32], [asm.I32], bytes([asm.LOCAL_GET, 0, asm.MEMORY_GROW, 0, asm.END]))
    b.export_func("grow", f)
    wasm = b.build()

    def grows(pkg):
        inst = WASM[pkg].WasmInstance(wasm)
        return inst.call("grow", 10), inst.call("grow", 2048)

    ok, refused = same(both(grows))
    assert ok[0] != 0xFFFFFFFF and refused[0] & 0xFFFFFFFF == 0xFFFFFFFF


def test_gain_plugin_process():
    """The port's ``build_gain_wasm`` is the bytes of the JAX package's
    example; both hosts give the same bytes, small and past a page."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "build_gain_wasm", os.path.join(NATIVE, "plugins", "gain_wasm", "build_gain_wasm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    wasm = asm.build_gain_wasm()
    assert wasm == mod.build()
    small = np.array([0.5, -1.0, 0.25, 2.0], np.float32)
    big = np.linspace(-1, 1, 200_000).astype(np.float32)

    def run(pkg):
        inst = WASM[pkg].WasmInstance(wasm)
        return inst.process(small.tobytes(), [3.0]), inst.process(big.tobytes(), [0.5])

    a, b = same(both(run))
    np.testing.assert_array_equal(np.frombuffer(a, np.float32), small * np.float32(3.0))
    np.testing.assert_array_equal(np.frombuffer(b, np.float32), big * np.float32(0.5))


def test_wasm_node_in_pipeline(tmp_path):
    """``plugin::wasm::gain`` between a file reader and writer in each
    package's dynamic engine: the same bytes, the input times 2."""
    wasm_path = tmp_path / "gain.wasm"
    wasm_path.write_bytes(asm.build_gain_wasm())
    x = np.array([0.1, 0.2, -0.3, 0.4] * 100, np.float32)
    src = tmp_path / "in.bin"
    src.write_bytes(x.tobytes())

    def run(pkg):
        dynamic = jax_dynamic if pkg == "jax" else torch_dynamic
        dst = tmp_path / f"out-{pkg}.bin"
        dst.write_bytes(b"")

        async def main():
            reg = registry(pkg)
            plugin = WASM[pkg].load_wasm_plugin(reg, str(wasm_path))
            handle = dynamic.start_dynamic_engine(reg, dynamic.DynamicEngineConfig(session_id=f"wasm-{pkg}"))
            await handle.add_node("reader", "core::file_reader", {"path": str(src)})
            await handle.add_node("gain", plugin.kind, {"gain": 2.0})
            await handle.add_node("writer", "core::file_writer", {"path": str(dst)})
            await handle.connect("reader", "out", "gain", "in")
            await handle.connect("gain", "out", "writer", "in")
            for _ in range(400):
                await asyncio.sleep(0.05)
                if os.path.getsize(dst) >= x.nbytes:
                    break
            await handle.shutdown_and_wait()
            return plugin.kind, dst.read_bytes()

        return asyncio.run(main())

    kind, out = same(both(run))
    assert kind == "plugin::wasm::gain"
    np.testing.assert_array_equal(np.frombuffer(out, np.float32), x * np.float32(2.0))


def test_unbounded_recursion_traps_not_segfaults():
    b = asm.WasmModuleBuilder()
    f = b.add_func([], [], bytes([asm.CALL, 0, asm.END]))
    b.export_func("recurse", f)
    wasm = b.build()
    kind, msg = same(both(lambda pkg: trap(pkg, wasm, "recurse", fuel=1_000_000_000, nresults=0)))
    assert kind == "trap" and "call stack" in msg


def test_truncated_f32_const_body_traps():
    b = asm.WasmModuleBuilder()
    f = b.add_func([], [asm.I32], bytes([asm.F32_CONST, 0x00, 0x00, asm.END]))
    b.export_func("bad", f)
    wasm = b.build()
    kind, msg = same(both(lambda pkg: trap(pkg, wasm, "bad")))
    assert kind == "trap" and re.search("eof|trunc|stack", msg)


def test_multiple_active_data_segments_all_applied():
    b = asm.WasmModuleBuilder()
    b.set_memory(1)
    b.add_data(16, bytes([0xAA]))
    b.add_data(32, bytes([0xBB]))
    f = b.add_func([asm.I32], [asm.I32],
                   bytes([asm.LOCAL_GET, 0, asm.I32_LOAD8_U]) + asm.memarg(0, 0) + bytes([asm.END]))
    b.export_func("peek8", f)
    wasm = b.build()
    got = same(both(lambda pkg: (trap(pkg, wasm, "peek8", 16), trap(pkg, wasm, "peek8", 32))))
    assert got == (("ok", [0xAA]), ("ok", [0xBB]))


def test_hostile_core_modules_are_refused_alike():
    """Bad magic, a truncated module and a module without the plugin ABI's
    exports: the same refusal (type and message) from both hosts."""
    gain = asm.build_gain_wasm()
    b = asm.WasmModuleBuilder()
    b.export_func("nothing", b.add_func([], [], bytes([asm.END])))
    bare = b.build()

    def refusals(pkg, tmp=tempfile.mkdtemp()):
        out = []
        for label, data in (("magic", b"nope\x01\x00\x00\x00"), ("cut", gain[: len(gain) // 2]), ("bare", bare)):
            path = os.path.join(tmp, f"{label}-{pkg}.wasm")
            with open(path, "wb") as f:
                f.write(data)
            try:
                WASM[pkg].load_wasm_plugin(registry(pkg), path)
                out.append((label, "loaded"))
            except (ValueError, RuntimeError) as e:
                out.append((label, type(e).__name__, str(e)))
        return out

    got = same(both(refusals))
    assert all(len(r) == 3 for r in got), got


def test_the_port_loads_its_own_runtime_with_sk_wasm_rt_set(jax_runtime):
    """``SK_WASM_RT`` names the JAX build (the tests set it for the JAX
    host); the port's runtime is still its own ``_build`` library of
    ``csrc/wasm_rt.cpp``."""
    assert os.environ["SK_WASM_RT"] == jax_runtime and os.path.exists(jax_runtime)
    lib = torch_wasm.WasmRuntime.lib()
    assert lib._name == torch_wasm.SOURCE.library() and lib._name.startswith(_build.BUILD_DIR)
    assert torch_wasm.SOURCE.path == os.path.join(os.path.dirname(_build.BUILD_DIR), "csrc", "wasm_rt.cpp")
    assert torch_wasm.WasmInstance(asm.build_gain_wasm())._lib is lib


def test_without_gxx_a_wasm_plugin_is_refused_naming_the_runtime(monkeypatch, tmp_path):
    """No library built and no compiler: loading a plugin raises a
    RuntimeError naming the runtime (the upload route answers 422 with it)."""
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "empty"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    path = tmp_path / "gain.wasm"
    path.write_bytes(asm.build_gain_wasm())
    with pytest.raises(RuntimeError, match=r"WASM plugin runtime \(csrc/wasm_rt.cpp\).*g\+\+ not found"):
        torch_wasm.load_wasm_plugin(torch_core.NodeRegistry(), str(path))


# -- the mirror of tests/test_native_plugins.py --------------------------------
def test_load_and_metadata(gain_so):
    def load(pkg):
        reg = CORE[pkg].NodeRegistry()
        plugin = NATIVE_HOST[pkg].load_native_plugin(reg, gain_so)
        return plugin.kind, plugin.description, int(plugin.api.abi_version), reg.contains(plugin.kind)

    assert same(both(load)) == ("plugin::native::gain_cpp", "Example native C++ gain plugin", 2, True)
    assert torch_native.SK_ABI_VERSION == jax_native.SK_ABI_VERSION == 2


def test_missing_library_raises():
    def load(pkg):
        with pytest.raises(CORE[pkg].PluginError, match="not found") as e:
            NATIVE_HOST[pkg].load_native_plugin(CORE[pkg].NodeRegistry(), "/nonexistent/lib.so")
        return str(e.value)

    same(both(load))


def test_native_gain_in_pipeline(gain_so):
    """WAV → native C++ gain ×2 → WAV through each package's oneshot engine:
    the same bytes."""
    body = make_wav((np.ones(9600) * 0.25).astype(np.float32))

    def run(pkg):
        reg = registry(pkg)
        NATIVE_HOST[pkg].load_native_plugin(reg, gain_so)
        return oneshot(pkg, reg, gain_yaml("plugin::native::gain_cpp", "{gain: 2.0}"), body)

    data = same(both(run))
    y = np.frombuffer(data[44:], dtype="<i2").astype(np.float32) / 32768.0
    np.testing.assert_allclose(y[:9600], 0.5, atol=2e-3)


def test_native_plugin_rejects_bad_params(gain_so):
    def run(pkg):
        core = CORE[pkg]
        reg = core.NodeRegistry()
        NATIVE_HOST[pkg].load_native_plugin(reg, gain_so)
        node = reg.create_node("plugin::native::gain_cpp", {"gain": 9.0})

        async def main():
            ctx = core.NodeContext(node_name="g", inputs={"in": core.Channel(4)},
                                   output=core.OutputSender("g", direct={"out": core.Channel(4)}))
            with pytest.raises(core.PluginError, match="gain must be in") as e:
                await node.run(ctx)
            return str(e.value)

        return asyncio.run(main())

    same(both(run))


# -- the four gains: native, core WASM, component and audio::gain ----------------
def test_four_gains_give_equal_bytes(gain_so, tmp_path):
    """WAV → gain 2 → WAV through the native plugin, the core-WASM plugin,
    the component and ``audio::gain`` (2: the component's guest reads one
    ASCII digit; a gain of 2 is exact in f32): the port's four outputs are
    equal, and equal to the JAX package's native, component and
    ``audio::gain`` outputs. The JAX core-WASM host passes audio packets
    through untouched: its output is the input's (ROADMAP §3)."""
    core_wasm = tmp_path / "wgain.wasm"
    core_wasm.write_bytes(asm.build_gain_wasm())
    component = tmp_path / "gain-component.wasm"
    component.write_bytes(build_gain_component())
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(8000) * 0.2).astype(np.float32)
    body = make_wav(x, 16000)
    steps = {"native": ("plugin::native::gain_cpp", "{gain: 2.0}"), "wasm": ("plugin::wasm::wgain", "{gain: 2.0}"),
             "component": ("plugin::wasm::gain", '{gain: "2"}'), "audio::gain": ("audio::gain", "{gain: 2.0}")}

    def run(pkg):
        reg = registry(pkg)
        NATIVE_HOST[pkg].load_native_plugin(reg, gain_so)
        kinds = [WASM[pkg].load_wasm_plugin(reg, str(p)).kind for p in (core_wasm, component)]
        assert kinds == ["plugin::wasm::wgain", "plugin::wasm::gain"]
        return {label: oneshot(pkg, reg, gain_yaml(*step), body) for label, step in steps.items()}

    got = both(run)
    assert len(set(got["torch"].values())) == 1
    for label in ("native", "component", "audio::gain"):
        assert got["jax"][label] == got["torch"][label], label
    passthrough = oneshot("jax", registry("jax"), gain_yaml("audio::gain", "{gain: 1.0}"), body)
    assert got["jax"]["wasm"] == passthrough != got["torch"]["wasm"]
    y = np.frombuffer(got["torch"]["wasm"][44:], "<i2")
    np.testing.assert_array_equal(y, np.clip(np.frombuffer(body[44:], "<i2").astype(np.int32) * 2, -32768, 32767))


# -- the routes, the CLI and the load test -----------------------------------------
def configs(tmp_path, **fields):
    """:func:`test_torch_server.configs` with a plugins directory of each
    package's own under ``tmp_path``."""
    out = server_configs(**fields)
    for pkg, cfg in out.items():
        cfg.plugins_dir = str(tmp_path / f"plugins-{pkg}")
    return out


def on_both(tmp_path, scenario, **cfg_fields):
    """``scenario(session, base, cfg)`` against each server → {pkg: result},
    each package's plugins directory written as ``<dir>``."""

    async def main():
        out = {}
        cfgs = configs(tmp_path, **cfg_fields)
        for pkg in PACKAGES:
            async with serve(pkg, cfgs[pkg]) as (app, base):
                async with aiohttp.ClientSession() as session:
                    out[pkg] = await scenario(session, base, cfgs[pkg])
        return out

    got = asyncio.run(main())
    return {pkg: _masked(v, str(tmp_path / f"plugins-{pkg}")) for pkg, v in got.items()}


def _masked(obj, directory):
    if isinstance(obj, dict):
        return {k: _masked(v, directory) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_masked(v, directory) for v in obj)
    if isinstance(obj, str):
        return obj.replace(directory, "<dir>")
    return obj


async def call(s, method, url, **kw):
    async with s.request(method, url, **kw) as r:
        return r.status, await r.json()


def file_form(data: bytes, filename: str):
    form = aiohttp.FormData()
    form.add_field("file", data, filename=filename)
    return form


def test_plugin_endpoints(tmp_path, gain_so):
    """List / upload / delete a native plugin over HTTP: the port's
    responses equal the JAX server's (reference plugins.rs)."""
    data = open(gain_so, "rb").read()

    async def scenario(s, base, cfg):
        out = [await call(s, "GET", base + "/api/v1/plugins")]
        out.append(await call(s, "POST", base + "/api/v1/plugins", data=file_form(data, "gain_cpp.so")))
        out.append(await call(s, "GET", base + "/api/v1/plugins"))
        status, nodes = await call(s, "GET", base + "/api/v1/schema/nodes")
        out.append((status, [n for n in nodes["nodes"] if n["kind"].startswith("plugin::native::gain")]))
        out.append(await call(s, "DELETE", base + "/api/v1/plugins/plugin::native::gain_cpp"))
        out.append(await call(s, "GET", base + "/api/v1/plugins"))
        out.append(os.path.exists(os.path.join(cfg.plugins_dir, "native", "gain_cpp.so")))
        return out

    out = same(on_both(tmp_path, scenario))
    assert out[0] == (200, {"plugins": []})
    assert out[1] == (201, {"kind": "plugin::native::gain_cpp", "description": "Example native C++ gain plugin"})
    (listed,) = out[2][1]["plugins"]
    assert listed["abi_version"] == 2 and listed["runtime"] == "native"
    assert listed["path"] == "<dir>/native/gain_cpp.so"
    assert len(out[3][1]) == 1
    assert out[4] == (200, {"deleted": "plugin::native::gain_cpp"}) and out[5] == (200, {"plugins": []})
    assert out[6] is False


def test_upload_wasm_and_component_plugins_via_api(tmp_path):
    """Both WASM formats through the upload route, listed, then deleted;
    a bad upload and a forbidden one answered alike."""

    async def scenario(s, base, cfg):
        out = [await call(s, "POST", base + "/api/v1/plugins", data=file_form(asm.build_gain_wasm(), "wgain.wasm"))]
        out.append(await call(s, "POST", base + "/api/v1/plugins",
                              data=file_form(build_gain_component(), "cgain.wasm")))
        out.append(await call(s, "GET", base + "/api/v1/plugins"))
        out.append(await call(s, "POST", base + "/api/v1/plugins", data=file_form(b"\x00asm junk", "bad.wasm")))
        out.append(await call(s, "POST", base + "/api/v1/plugins", data=file_form(b"x", "notes.txt")))
        out.append(await call(s, "DELETE", base + "/api/v1/plugins/plugin::wasm::wgain"))
        out.append(await call(s, "DELETE", base + "/api/v1/plugins/plugin::wasm::nope"))
        out.append(sorted(os.listdir(os.path.join(cfg.plugins_dir, "wasm"))))
        return out

    out = same(on_both(tmp_path, scenario))
    assert out[0] == (201, {"kind": "plugin::wasm::wgain", "description": "WASM plugin wgain"})
    assert out[1][0] == 201 and out[1][1]["kind"] == "plugin::wasm::gain"
    assert [(p["kind"], p["runtime"], p["abi_version"]) for p in out[2][1]["plugins"]] == [
        ("plugin::wasm::wgain", "wasm", 1), ("plugin::wasm::gain", "wasm", 1)]
    assert out[3][0] == 422 and out[4] == (422, {"error": "no .so or .wasm file part"})
    assert out[5] == (200, {"removed": "plugin::wasm::wgain"}) and out[6][0] == 404
    assert out[7] == ["cgain.wasm", "wgain.wasm"]  # a WASM delete keeps the file


def test_plugin_routes_check_permissions(tmp_path):
    roles = {"viewer": {"list_sessions": True}}

    async def scenario(s, base, cfg):
        return [await call(s, "POST", base + "/api/v1/plugins", data=file_form(asm.build_gain_wasm(), "w.wasm")),
                await call(s, "DELETE", base + "/api/v1/plugins/plugin::wasm::w"),
                await call(s, "GET", base + "/api/v1/plugins")]

    out = same(on_both(tmp_path, scenario, default_role="viewer", roles=roles))
    assert out[0] == (403, {"error": "permission denied: load_plugins"})
    assert out[1] == (403, {"error": "permission denied: delete_plugins"})
    assert out[2] == (200, {"plugins": []})


def test_delete_differs_by_runtime_across_a_restart(tmp_path, gain_so):
    """A WASM delete answers ``removed`` and keeps the file, so the plugin
    loads again at the next start; a native delete answers ``deleted`` and
    removes the file. Both servers, started twice on one plugins dir."""
    so = open(gain_so, "rb").read()

    async def first(s, base, cfg):
        for data, name in ((so, "gain_cpp.so"), (asm.build_gain_wasm(), "wgain.wasm")):
            assert (await call(s, "POST", base + "/api/v1/plugins", data=file_form(data, name)))[0] == 201
        return [await call(s, "DELETE", base + "/api/v1/plugins/plugin::native::gain_cpp"),
                await call(s, "DELETE", base + "/api/v1/plugins/plugin::wasm::wgain"),
                await call(s, "GET", base + "/api/v1/plugins")]

    async def second(s, base, cfg):
        status, doc = await call(s, "GET", base + "/api/v1/plugins")
        return status, [(p["kind"], p["runtime"]) for p in doc["plugins"]]

    got = same(on_both(tmp_path, first))
    assert got == [(200, {"deleted": "plugin::native::gain_cpp"}), (200, {"removed": "plugin::wasm::wgain"}),
                   (200, {"plugins": []})]
    assert same(on_both(tmp_path, second)) == (200, [("plugin::wasm::wgain", "wasm")])


def test_plugins_dir_loads_at_start_and_a_bad_file_only_warns(tmp_path, gain_so, caplog):
    for pkg in PACKAGES:
        d = tmp_path / f"plugins-{pkg}"
        (d / "native").mkdir(parents=True)
        (d / "wasm").mkdir()
        shutil.copy(gain_so, d / "native" / "gain_cpp.so")
        (d / "native" / "broken.so").write_bytes(b"not a library")
        (d / "wasm" / "wgain.wasm").write_bytes(asm.build_gain_wasm())
        (d / "wasm" / "cgain.wasm").write_bytes(build_gain_component())
        (d / "wasm" / "broken.wasm").write_bytes(b"\x00asm\x01\x00\x00\x00junk")

    async def scenario(s, base, cfg):
        status, doc = await call(s, "GET", base + "/api/v1/plugins")
        return status, [(p["kind"], p["runtime"]) for p in doc["plugins"]]

    with caplog.at_level("WARNING"):
        got = same(on_both(tmp_path, scenario))
    assert got == (200, [("plugin::native::gain_cpp", "native"), ("plugin::wasm::gain", "wasm"),
                         ("plugin::wasm::wgain", "wasm")])
    warned = [r.getMessage() for r in caplog.records if r.name.startswith("streamkit_tpu_torch")]
    assert any("broken.wasm" in m for m in warned) and any("broken.so" in m for m in warned), warned


def _gain_variant(tmp_path, description: str) -> bytes:
    """The example gain plugin with another description, built here."""
    src = open(os.path.join(NATIVE, "plugins", "gain", "gain_plugin.cpp")).read()
    src = src.replace('"../../sdk/streamkit_plugin_sdk.hpp"', f'"{NATIVE}/sdk/streamkit_plugin_sdk.hpp"')
    src = src.replace('"Example native C++ gain plugin"', f'"{description}"')
    cpp, so = tmp_path / "variant.cpp", tmp_path / "variant.so"
    cpp.write_text(src)
    subprocess.run(["g++", *CXXFLAGS, "-o", str(so), str(cpp)], check=True, capture_output=True)
    return so.read_bytes()


def test_a_reuploaded_native_library_keeps_its_old_code(tmp_path, gain_so):
    """Upload, delete (which removes the file), upload a changed library
    under the same file name: ``ctypes.CDLL`` dlopens the same path again,
    and the dynamic loader hands back the library it already maps, so both
    hosts answer with the old library's metadata (ROADMAP §3)."""
    v2 = _gain_variant(tmp_path, "gain plugin, second build")

    async def scenario(s, base, cfg):
        assert (await call(s, "POST", base + "/api/v1/plugins",
                           data=file_form(open(gain_so, "rb").read(), "gain_cpp.so")))[0] == 201
        assert (await call(s, "DELETE", base + "/api/v1/plugins/plugin::native::gain_cpp"))[0] == 200
        return await call(s, "POST", base + "/api/v1/plugins", data=file_form(v2, "gain_cpp.so"))

    assert same(on_both(tmp_path, scenario)) == (
        201, {"kind": "plugin::native::gain_cpp", "description": "Example native C++ gain plugin"})
    # a fresh path loads the new build in both hosts
    fresh = tmp_path / "fresh" / "gain_v2.so"
    fresh.parent.mkdir()
    fresh.write_bytes(v2)
    assert same(both(lambda pkg: NATIVE_HOST[pkg].load_native_plugin(
        CORE[pkg].NodeRegistry(), str(fresh)).description)) == "gain plugin, second build"


def test_populate_uploads_in_the_port_and_never_in_the_jax_package(tmp_path, capsys):
    """The JAX load test posts the raw file with query params; the upload
    route reads only a multipart ``file`` part and refuses it (the JAX
    server with 500, the port's with 400), and the JAX populate goes on
    with nothing loaded (nothing checks the status). The port uploads as the
    CLI does and raises on a refused upload."""
    wasm = tmp_path / "wgain.wasm"
    wasm.write_bytes(asm.build_gain_wasm())
    bad = tmp_path / "bad.wasm"
    bad.write_bytes(b"\x00asm junk")

    async def scenario(s, base, cfg):
        # what the JAX populate sends: the file as the raw body
        async with s.post(base + "/api/v1/plugins", data=wasm.read_bytes(),
                          params={"name": wasm.name, "runtime": "wasm"}) as r:
            out = {"raw": r.status}
        for pkg, lt in (("jax", jax_lt), ("torch", torch_lt)):
            await lt._populate(lt.LoadTestConfig(server=base, populate_plugins_wasm=[str(wasm)]))
            out[pkg] = (await call(s, "GET", base + "/api/v1/plugins"))[1]["plugins"]
            for p in out[pkg]:
                await call(s, "DELETE", base + f"/api/v1/plugins/{p['kind']}")
        with pytest.raises(RuntimeError, match="populate: .*bad.wasm was not loaded"):
            await torch_lt._populate(torch_lt.LoadTestConfig(server=base, populate_plugins_wasm=[str(bad)]))
        return out

    got = on_both(tmp_path, scenario)
    # the raw body: aiohttp's multipart reader asserts (500), the port's says 400
    assert (got["jax"].pop("raw"), got["torch"].pop("raw")) == (500, 400)
    got = same(got)
    assert got["jax"] == [] and [p["kind"] for p in got["torch"]] == ["plugin::wasm::wgain"]
    assert "populate: loaded plugin::wasm::wgain" in capsys.readouterr().out
