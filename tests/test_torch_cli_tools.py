# SPDX-License-Identifier: Apache-2.0
"""The CLI's shell and load test and the TypeScript generator in both
packages: the port's ``cli/shell.py``, ``cli/loadtest.py`` (on its own
client) and ``api/gen_ts_types.py`` against the JAX package's.

* The shell: both packages' shells run one command script against one port
  server (the JAX shell's aiohttp client and the port's client speak to the
  same routes); their outputs are equal once session ids are masked. Help,
  aliases and the completer's candidate sets are equal.
* The load test: every ``samples/loadtest/*.toml`` parses to an equal
  config; a quick mixed run against the port's server succeeds throughout
  (oneshot requests, dynamic sessions, live tunes) and leaves no session.
* ``gen_ts_types``: the same TypeScript, byte for byte, under a header that
  names each package's own generator.
* ``plugins list | load | delete`` against the port's server, a native and
  a WASM plugin (the routes themselves are held against the JAX server in
  ``tests/test_torch_plugins.py``).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import glob
import importlib
import os
import re
import wave

import numpy as np
import pytest
import torch

import streamkit_tpu.api.gen_ts_types as jax_gen
import streamkit_tpu.cli.client as jax_client
import streamkit_tpu.cli.loadtest as jax_lt
import streamkit_tpu.cli.shell as jax_shell
import streamkit_tpu_torch.api.gen_ts_types as torch_gen
import streamkit_tpu_torch.cli.client as torch_client
import streamkit_tpu_torch.cli.loadtest as torch_lt
import streamkit_tpu_torch.cli.shell as torch_shell
import streamkit_tpu_torch.moq.relay as torch_relay
from streamkit_tpu_torch.cli import main as torch_cli
from streamkit_tpu_torch.server import ServerConfig, create_app
from streamkit_tpu_torch.server import http as web

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = sorted(glob.glob(os.path.join(REPO, "samples", "loadtest", "*.toml")))
SHELLS = {"jax": (jax_client, jax_shell), "torch": (torch_client, torch_shell)}


@pytest.fixture(scope="module")
def media_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("climedia")
    sr = 16000
    t = np.arange(sr) / sr
    pcm = (np.sin(2 * np.pi * 440 * t) * 0.4 * 32767).astype(np.int16)
    with wave.open(str(d / "tone.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    (d / "gain.yaml").write_text(
        "mode: oneshot\nsteps:\n  - kind: streamkit::http_input\n  - kind: containers::wav::demuxer\n"
        "  - kind: audio::gain\n    params: {gain: 0.5}\n  - kind: containers::wav::muxer\n"
        "  - kind: streamkit::http_output\n    params: {content_type: audio/wav}\n")
    (d / "dyn.yaml").write_text(
        "mode: dynamic\nnodes:\n  p:\n    kind: core::passthrough\n  s:\n    kind: core::sink\n    needs: p\n")
    # a live session with a tunable gain and no codec library: paced WAV
    (d / "live_gain.yml").write_text(
        "mode: dynamic\nnodes:\n"
        f"  reader:\n    kind: core::file_reader\n    params: {{path: {d / 'tone.wav'}, chunk_size: 4096}}\n"
        "  demux:\n    kind: containers::wav::demuxer\n    needs: reader\n"
        "  pacer:\n    kind: core::pacer\n    params: {speed: 1, buffer_size: 16}\n    needs: demux\n"
        "  gain:\n    kind: audio::gain\n    params: {gain: 1.0}\n    needs: pacer\n"
        "  sink:\n    kind: core::sink\n    needs: gain\n")
    return d


async def _port_server(**fields):
    cfg = ServerConfig()
    cfg.moq_enabled = False  # file paths stay open: the path policy is process-wide
    for k, v in fields.items():
        setattr(cfg, k, v)
    app = create_app(cfg, device="cpu")
    runner = web.AppRunner(app)
    port = await runner.start("127.0.0.1", 0)
    return app, runner, f"http://127.0.0.1:{port}"


def _masked(text, ids):
    """Session ids (and other per-run strings in ``ids``), byte counts and
    node states (which depend on timing) masked."""
    for i, sid in enumerate(ids):
        text = text.replace(sid, f"<sid{i}>").replace(sid[:8], f"<sid{i}:8>")
    text = re.sub(r"^(  \S+ +\S+::\S+) +\S.*$", r"\1", text, flags=re.M)
    return re.sub(r"\d+ bytes", "N bytes", text)


async def _shell_script(pkg, base, flow, capsys):
    client_mod, shell_mod = SHELLS[pkg]
    async with client_mod.SkitClient(base) as client:
        await client.connect_ws()
        shell = shell_mod.Shell(client)
        ids = await flow(shell)
    return _masked(capsys.readouterr().out, ids)


def _in_both(media_dir, capsys, flow):
    """``flow(shell)`` with each package's shell against one port server →
    (JAX output, port output, the server's sessions at the end)."""

    async def main():
        app, runner, base = await _port_server()
        try:
            capsys.readouterr()
            outs = [await _shell_script(pkg, base, flow, capsys) for pkg in ("jax", "torch")]
            return outs, app["state"].sessions.list()
        finally:
            await runner.cleanup()

    (jax_out, torch_out), left = asyncio.run(main())
    assert torch_out == jax_out
    return torch_out, left


def test_shell_session_lifecycle_and_pipeline(media_dir, capsys):
    async def flow(shell):
        assert await shell.dispatch("create lifecycle-test")
        sid = shell.session
        for line in ("add reader core::passthrough", "add sink core::sink", "connect reader sink", "pipeline",
                     "add gain audio::gain", "tune gain gain 2.5", "tune gain '{\"gain\": 0.5}'", "sessions",
                     f"destroy {sid[:8]}"):
            assert await shell.dispatch(line)
        assert shell.session is None and {"reader", "sink", "gain"} <= set(shell.known_nodes)
        assert not await shell.dispatch("quit")
        return [sid]

    out, left = _in_both(media_dir, capsys, flow)
    assert "reader:out -> sink:in" in out and "core::passthrough" in out
    assert "destroyed <sid0>" in out and "error" not in out
    assert not left


def test_shell_create_from_yaml_and_oneshot(media_dir, capsys, tmp_path):
    async def flow(shell):
        await shell.dispatch(f"create {media_dir}/dyn.yaml --name from-yaml")
        sid = shell.session
        await shell.dispatch("destroy")
        out_path = tmp_path / f"out_{type(shell).__module__.split('.')[0]}.wav"
        await shell.dispatch(f"oneshot {media_dir}/gain.yaml {media_dir}/tone.wav {out_path}")
        await shell.dispatch("oneshot only-one-arg")
        await shell.dispatch("use")  # IndexError → an error line, the shell goes on
        await shell.dispatch('add x "unclosed')
        return [str(out_path), sid]

    out, left = _in_both(media_dir, capsys, flow)
    assert "created + selected <sid1> (from-yaml)" in out and "wrote N bytes (audio/wav) -> <sid0>" in out
    assert "error: usage: oneshot" in out and "parse error" in out
    outs = {}
    for pkg in ("streamkit_tpu", "streamkit_tpu_torch"):
        with wave.open(str(tmp_path / f"out_{pkg}.wav")) as w:
            outs[pkg] = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    with wave.open(str(media_dir / "tone.wav")) as w:
        orig = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    np.testing.assert_array_equal(outs["streamkit_tpu_torch"], outs["streamkit_tpu"])
    assert len(orig) == len(outs["streamkit_tpu_torch"])
    assert np.abs(outs["streamkit_tpu_torch"].astype(np.int32)).mean() < np.abs(orig.astype(np.int32)).mean()
    assert not left


def test_shell_help_and_completion_sets(media_dir, capsys):
    async def flow(shell):
        for line in ("help", "help tune", "help nope", "h lt", "ls", "bogus"):
            await shell.dispatch(line)
        await shell.dispatch("create completer-test")
        await shell.dispatch("add a core::passthrough")
        await shell._prime_completion()
        completer = importlib.import_module(type(shell).__module__).ShellCompleter(shell)
        sets = [sorted(completer._candidates(line, text)) for line, text in
                (("", ""), ("use ", ""), ("add x ", ""), ("nodes ", ""), ("tune ", ""), ("rm ", ""),
                 ("sessions ", ""))]
        print(sets[0], sets[4], sets[5], sets[6])
        assert shell.session in sets[1]
        assert {"core::passthrough", "audio::gain", "containers::webm::muxer"} <= set(sets[2]) and sets[2] == sets[3]
        sid = shell.session
        await shell.dispatch("destroy")
        return [sid]

    out, _ = _in_both(media_dir, capsys, flow)
    assert "tab completes" in out and "param value" in out and "unknown command 'nope'" in out
    assert "unknown command 'bogus' (try `help`)" in out
    assert torch_shell.COMMANDS == jax_shell.COMMANDS and torch_shell.ALIASES == jax_shell.ALIASES


@pytest.mark.parametrize("preset", PRESETS, ids=[os.path.basename(p) for p in PRESETS])
def test_loadtest_preset_parses_equal(preset):
    a, b = torch_lt.LoadTestConfig.from_toml(preset), jax_lt.LoadTestConfig.from_toml(preset)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.scenario in ("oneshot", "dynamic", "mixed")


def test_loadtest_metrics_match_jax():
    rng = np.random.default_rng(0)
    samples = rng.exponential(0.2, size=12_345)
    ms = {name: mod.Metrics("x") for name, mod in (("jax", jax_lt), ("torch", torch_lt))}
    for i, s in enumerate(samples):  # past the reservoir: the sampling RNG is seeded in both
        for m in ms.values():
            m.record(float(s), i % 97 != 0)
    a, b = ms["torch"].summary(), ms["jax"].summary()
    assert a.pop("p95_ms") == ms["torch"].percentile(95) * 1000
    assert a.pop("errors") == ["failed"]  # the port keeps the first distinct errors
    assert a == b and b["requests"] == len(samples)


def test_quick_mixed_loadtest_run(media_dir, capsys, tmp_path):
    """A 3-second mixed run against the port's server: oneshot gain
    requests at concurrency 2, two dynamic sessions whose gain is tuned
    every 200 ms; every request succeeds, no session is left. The populate
    phase uploads its plugin first: it is registered when the run starts."""
    from streamkit_tpu_torch.plugins.wasm_asm import build_gain_wasm

    (media_dir / "wgain.wasm").write_bytes(build_gain_wasm())
    cfg = torch_lt.LoadTestConfig(
        scenario="mixed", duration_secs=3.0, oneshot_concurrency=2, oneshot_pipeline=str(media_dir / "gain.yaml"),
        oneshot_input_file=str(media_dir / "tone.wav"), session_count=2, tune_interval_ms=200.0,
        dynamic_pipelines=[str(media_dir / "live_gain.yml")], real_time_updates=True, update_interval_ms=1000.0,
        populate_plugins_wasm=[str(media_dir / "wgain.wasm")])

    async def main():
        app, runner, base = await _port_server(plugins_dir=str(tmp_path / "plugins"))
        cfg.server = base
        try:
            results = await torch_lt.run_load_test(cfg)
            return results, app["state"].sessions.list(), [p.kind for p in app["state"].wasm_plugins]
        finally:
            await runner.cleanup()

    results, left, plugins = asyncio.run(main())
    out = capsys.readouterr().out
    assert "populate: loaded plugin::wasm::wgain" in out and "oneshot:" in out
    assert plugins == ["plugin::wasm::wgain"]
    assert set(results) == {"oneshot", "dynamic", "tune"}
    for kind in ("oneshot", "dynamic", "tune"):
        assert results[kind]["requests"] >= 2, results
        assert results[kind]["success_rate"] == 1.0, results[kind]
        assert results[kind]["p50_ms"] <= results[kind]["p95_ms"] <= results[kind]["max_ms"]
    assert not left


def test_cli_runs_shell_and_loadtest(media_dir, tmp_path, capsys, monkeypatch):
    """``skit-tpu-cli lt <toml>`` and ``shell`` run (no longer exit 2);
    every command is ported, and ``moq subscribe`` of a broadcast nobody
    announced fails as the JAX CLI's client code fails, with the relay's
    "broadcast not announced" (the JAX CLI itself has no ``--server`` for
    ``moq``, so its ``_run_moq`` is driven with the same fields)."""
    toml = tmp_path / "lt.toml"

    async def main():
        app, runner, base = await _port_server()
        toml.write_text(f'[server]\nurl = "{base}"\n[test]\nduration_secs = 1\nscenario = "dynamic"\n'
                        f'[dynamic]\nsession_count = 1\ntune_interval_ms = 100\n'
                        f'pipelines = ["{media_dir / "live_gain.yml"}"]\n[output]\nreal_time_updates = false\n')
        lines = iter(["sessions", "create cli-shell", "destroy", "quit"])
        monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
        monkeypatch.setattr(torch_shell, "HISTORY_FILE", str(tmp_path / "history"))
        try:
            rc_lt = await torch_cli._run(torch_cli.build_parser().parse_args(["lt", str(toml)]))
            rc_shell = await torch_cli._run(torch_cli.build_parser().parse_args(["shell", "-s", base]))
            return rc_lt, rc_shell, app["state"].sessions.list()
        finally:
            await runner.cleanup()

    rc_lt, rc_shell, left = asyncio.run(main())
    out = capsys.readouterr()
    assert (rc_lt, rc_shell) == (0, 0) and not left
    assert '"success_rate": 1.0' in out.out and "created + selected" in out.out
    assert torch_cli.NOT_PORTED == {}
    monkeypatch.setattr(torch_relay, "ANNOUNCE_WAIT_SECS", 0.2)

    async def unannounced():
        from streamkit_tpu.cli.main import _run_moq as jax_run_moq

        app, runner, base = await _port_server(moq_enabled=True, moq_port=0)
        try:
            wt_port = app["state"].webtransport.port
            fields = dict(server=base, moq_cmd="subscribe", broadcast="captions", frames=1, protocol="native",
                          moq_port=wt_port)
            with pytest.raises(ConnectionError) as jax_error:
                await jax_run_moq(argparse.Namespace(**fields))
            rc = await asyncio.get_running_loop().run_in_executor(
                None, torch_cli.main, ["moq", "subscribe", "captions", "-s", base, "--moq-port", str(wt_port)])
            return str(jax_error.value), rc
        finally:
            await runner.cleanup()

    jax_error, rc = asyncio.run(unannounced())
    assert jax_error == "broadcast not announced"
    assert rc == 1 and capsys.readouterr().err.strip().endswith("error: broadcast not announced")


def test_cli_plugins_commands(tmp_path, capsys):
    """``skit-tpu-cli plugins list | load | delete`` against the port's server."""
    from _torch_native import build
    from streamkit_tpu_torch.plugins.wasm_asm import build_gain_wasm

    gain_so = build("gain_cpp.so")
    wasm = tmp_path / "wgain.wasm"
    wasm.write_bytes(build_gain_wasm())

    async def main():
        app, runner, base = await _port_server(plugins_dir=str(tmp_path / "plugins"))
        try:
            loop = asyncio.get_running_loop()

            def cli(*args):
                return torch_cli.main(list(args))

            rcs = []
            for args in (("load", gain_so), ("load", str(wasm)), ("list",), ("delete", "plugin::native::gain_cpp"),
                         ("delete", "plugin::wasm::wgain"), ("list",), ("delete", "plugin::wasm::wgain")):
                rcs.append(await loop.run_in_executor(None, cli, "plugins", args[0], *args[1:], "-s", base))
            return rcs, app["state"].registry.kinds()
        finally:
            await runner.cleanup()

    rcs, kinds = asyncio.run(main())
    out = capsys.readouterr()
    assert rcs == [0, 0, 0, 0, 0, 0, 1]
    assert '"kind": "plugin::native::gain_cpp"' in out.out and '"runtime": "wasm"' in out.out
    assert "deleted plugin::wasm::wgain" in out.out and "error: HTTP 404" in out.err
    assert not [k for k in kinds if "gain_cpp" in k or "wgain" in k]


def test_gen_ts_types_equal():
    a, b = torch_gen.generate(), jax_gen.generate()
    head_a, _, body_a = a.partition("\n")
    head_b, _, body_b = b.partition("\n")
    assert body_a == body_b and "export interface PermissionsInfo" in body_a
    assert head_a == head_b.replace("streamkit_tpu.api", "streamkit_tpu_torch.api")


def test_client_close_with_a_live_socket_is_prompt(media_dir):
    """``SkitClient.close()`` with its control socket open returns at once:
    its reader is gone before the socket's close handshake reads the
    peer's reply (it used to wait out the 10 s close timeout)."""
    import time

    async def main():
        app, runner, base = await _port_server()
        try:
            client = torch_client.SkitClient(base)
            await client.__aenter__()
            await client.connect_ws()
            await client.request("listsessions")
            t0 = time.monotonic()
            await client.close()
            return time.monotonic() - t0
        finally:
            await runner.cleanup()

    assert asyncio.run(main()) < 5.0
