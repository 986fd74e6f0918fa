# SPDX-License-Identifier: Apache-2.0
"""The port's import boundary: it loads neither JAX nor the JAX package, and
its entry points refuse to fall back to the CPU when no card is present.

Runs in a fresh interpreter: this test process has JAX loaded already
(tests/conftest.py)."""

import os
import subprocess
import sys
import textwrap

import torch

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent(
    """
    import sys
    before = set(sys.modules)
    import streamkit_tpu_torch
    import streamkit_tpu_torch.api
    import streamkit_tpu_torch.api.gen_ts_types
    import streamkit_tpu_torch.api.messages
    import streamkit_tpu_torch.api.yaml_compiler
    import streamkit_tpu_torch.core
    import streamkit_tpu_torch.core.channel
    import streamkit_tpu_torch.core.control
    import streamkit_tpu_torch.core.errors
    import streamkit_tpu_torch.core.frame_pool
    import streamkit_tpu_torch.core.helpers
    import streamkit_tpu_torch.core.node
    import streamkit_tpu_torch.core.node_config
    import streamkit_tpu_torch.core.packet_meta
    import streamkit_tpu_torch.core.pins
    import streamkit_tpu_torch.core.registry
    import streamkit_tpu_torch.core.resource_manager
    import streamkit_tpu_torch.core.state
    import streamkit_tpu_torch.core.stats
    import streamkit_tpu_torch.core.telemetry
    import streamkit_tpu_torch.core.types
    import streamkit_tpu_torch.core.moq_gateway
    import streamkit_tpu_torch.device
    import streamkit_tpu_torch.engine
    import streamkit_tpu_torch.engine.audio_ring
    import streamkit_tpu_torch.engine.batcher
    import streamkit_tpu_torch.engine.constants
    import streamkit_tpu_torch.engine.distributor
    import streamkit_tpu_torch.engine.dynamic
    import streamkit_tpu_torch.engine.graph_builder
    import streamkit_tpu_torch.engine.ingest
    import streamkit_tpu_torch.engine.oneshot
    import streamkit_tpu_torch.engine.slots
    import streamkit_tpu_torch.engine.stt_serving
    import streamkit_tpu_torch.cli
    import streamkit_tpu_torch.cli.client
    import streamkit_tpu_torch.cli.loadtest
    import streamkit_tpu_torch.cli.main
    import streamkit_tpu_torch.cli.shell
    import streamkit_tpu_torch.models
    import streamkit_tpu_torch.models.kokoro
    import streamkit_tpu_torch.models.marian
    import streamkit_tpu_torch.models.matcha
    import streamkit_tpu_torch.models.nllb
    import streamkit_tpu_torch.models.sensevoice
    import streamkit_tpu_torch.models.seq2seq
    import streamkit_tpu_torch.models.silero_vad
    import streamkit_tpu_torch.models.sp_tokenizer
    import streamkit_tpu_torch.models.tts
    import streamkit_tpu_torch.models.vits
    import streamkit_tpu_torch.models.whisper
    import streamkit_tpu_torch.models.whisper.config
    import streamkit_tpu_torch.models.whisper.decode
    import streamkit_tpu_torch.models.whisper.load
    import streamkit_tpu_torch.models.whisper.model
    import streamkit_tpu_torch.models.whisper.streaming
    import streamkit_tpu_torch.models.whisper.tokenizer
    import streamkit_tpu_torch.nodes
    import streamkit_tpu_torch.nodes.audio.filters
    import streamkit_tpu_torch.nodes.codecs
    import streamkit_tpu_torch.nodes.codecs.av
    import streamkit_tpu_torch.nodes.codecs.mpeg
    import streamkit_tpu_torch.nodes.codecs.opus
    import streamkit_tpu_torch.nodes.containers.ogg
    import streamkit_tpu_torch.nodes.containers.wav
    import streamkit_tpu_torch.nodes.containers.webm
    import streamkit_tpu_torch.nodes.core_nodes.basic
    import streamkit_tpu_torch.nodes.core_nodes.file_io
    import streamkit_tpu_torch.nodes.core_nodes.pacer
    import streamkit_tpu_torch.nodes.core_nodes.script
    import streamkit_tpu_torch.nodes.core_nodes.telemetry_nodes
    import streamkit_tpu_torch.nodes.core_nodes.text
    import streamkit_tpu_torch.nodes.ml
    import streamkit_tpu_torch.nodes.ml._text_batching
    import streamkit_tpu_torch.nodes.ml.marian_node
    import streamkit_tpu_torch.nodes.ml.matcha_node
    import streamkit_tpu_torch.nodes.ml.sensevoice_node
    import streamkit_tpu_torch.nodes.ml.translate_node
    import streamkit_tpu_torch.nodes.ml.tts_node
    import streamkit_tpu_torch.nodes.ml.vad_node
    import streamkit_tpu_torch.nodes.ml.whisper_node
    import streamkit_tpu_torch.nodes.transport
    import streamkit_tpu_torch.nodes.transport.http
    import streamkit_tpu_torch.nodes.transport.moq
    import streamkit_tpu_torch.moq
    import streamkit_tpu_torch.moq.lite
    import streamkit_tpu_torch.moq.lite_session
    import streamkit_tpu_torch.moq.relay
    import streamkit_tpu_torch.moq.session
    import streamkit_tpu_torch.moq.wire
    import streamkit_tpu_torch.quic
    import streamkit_tpu_torch.quic._libcrypto
    import streamkit_tpu_torch.quic.connection
    import streamkit_tpu_torch.quic.crypto
    import streamkit_tpu_torch.quic.endpoint
    import streamkit_tpu_torch.quic.h3
    import streamkit_tpu_torch.quic.packet
    import streamkit_tpu_torch.quic.qpack
    import streamkit_tpu_torch.quic.tls
    import streamkit_tpu_torch.ops
    import streamkit_tpu_torch.ops._build
    import streamkit_tpu_torch.ops.attention
    import streamkit_tpu_torch.ops.cache_write
    import streamkit_tpu_torch.ops.dsp
    import streamkit_tpu_torch.ops.mel
    import streamkit_tpu_torch.ops.resample
    import streamkit_tpu_torch.ops.stream_attention
    import streamkit_tpu_torch.ops.tensor_parallel
    import streamkit_tpu_torch.ops.vad
    import streamkit_tpu_torch.parallel
    import streamkit_tpu_torch.plugins
    import streamkit_tpu_torch.plugins.component
    import streamkit_tpu_torch.plugins.component_asm
    import streamkit_tpu_torch.plugins.native
    import streamkit_tpu_torch.plugins.wasm
    import streamkit_tpu_torch.plugins.wasm_asm
    import streamkit_tpu_torch.parallel.train
    import streamkit_tpu_torch.parallel.dryrun
    import streamkit_tpu_torch.parallel.launch
    import streamkit_tpu_torch.parallel.mesh
    import streamkit_tpu_torch.parallel.serving
    import streamkit_tpu_torch.server
    import streamkit_tpu_torch.server.__main__
    import streamkit_tpu_torch.server.app
    import streamkit_tpu_torch.server.config
    import streamkit_tpu_torch.server.http
    import streamkit_tpu_torch.server.observability
    import streamkit_tpu_torch.server.otlp
    import streamkit_tpu_torch.server.permissions
    import streamkit_tpu_torch.server.plugins_api
    import streamkit_tpu_torch.server.profiling
    import streamkit_tpu_torch.server.samples
    import streamkit_tpu_torch.server.sessions
    import streamkit_tpu_torch.server.ui
    import streamkit_tpu_torch.server.webtransport
    import streamkit_tpu_torch.server.websocket
    import streamkit_tpu_torch.utils.jax_prng
    import streamkit_tpu_torch.utils.mjs
    import streamkit_tpu_torch.utils.speechsynth
    import streamkit_tpu_torch.utils.tracing
    import streamkit_tpu_torch.utils.checkpoint
    import streamkit_tpu_torch.utils.realspeech
    import streamkit_tpu_torch.tools
    import streamkit_tpu_torch.tools.eval_vad
    import streamkit_tpu_torch.tools.train_vad
    new = set(sys.modules) - before
    bad = sorted(
        m for m in new
        if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
        or m == "streamkit_tpu" or m.startswith("streamkit_tpu.")
        or m == "transformers" or m == "yaml"
        or m == "aiohttp" or m.startswith("aiohttp.") or m == "cryptography" or m.startswith("cryptography.")
    )
    assert not bad, bad
    assert "jax" not in sys.modules

    import torch
    if not torch.cuda.is_available():
        from streamkit_tpu_torch.engine import (
            DeviceBatcher, SessionAudioRing, SlotTable, SttServingEngine, get_audio_ring,
        )
        from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS, StreamTable, init_params, seeded_params
        from streamkit_tpu_torch.nodes.audio.filters import GainNode, MixerNode, ResamplerNode
        from streamkit_tpu_torch.ops.vad import vad_init_state
        from streamkit_tpu_torch.core import NodeRegistry
        from streamkit_tpu_torch.nodes import register_nodes
        from streamkit_tpu_torch.nodes.ml.vad_node import VadNode
        from streamkit_tpu_torch.nodes.ml.whisper_node import WhisperNode
        from streamkit_tpu_torch.models.nllb import NllbConfig, nllb_init_params
        from streamkit_tpu_torch.models.marian import MarianConfig, marian_init_params
        from streamkit_tpu_torch.models.vits import VitsConfig, vits_init_params
        from streamkit_tpu_torch.models.tts import (
            AcousticConfig, HifiGanConfig, acoustic_init_params, hifigan_init_params,
        )
        from streamkit_tpu_torch.nodes.ml._text_batching import BucketedGreedy
        from streamkit_tpu_torch.nodes.ml.marian_node import MarianTranslateNode
        from streamkit_tpu_torch.nodes.ml.translate_node import TranslateNode
        from streamkit_tpu_torch.nodes.ml.tts_node import TtsNode
        from streamkit_tpu_torch.models.kokoro import KokoroConfig, kokoro_init_params, load_kokoro_dir
        from streamkit_tpu_torch.models.matcha import MatchaConfig, matcha_init_params
        from streamkit_tpu_torch.models.sensevoice import SenseVoiceConfig, sensevoice_init_params
        from streamkit_tpu_torch.nodes.ml.matcha_node import MatchaTtsNode
        from streamkit_tpu_torch.nodes.ml.sensevoice_node import SenseVoiceNode
        from streamkit_tpu_torch.parallel import make_mesh, run_ranks, train_state_from_numpy
        from streamkit_tpu_torch.parallel.dryrun import dryrun_multichip
        from streamkit_tpu_torch.tools import eval_vad, train_vad
        import numpy as np
        small = dict(d_model=8, encoder_layers=1, decoder_layers=1, heads=2, ffn_dim=8, max_positions=8)

        for name, call in [
            ("init_params", lambda: init_params(WHISPER_CONFIGS["tiny"])),
            ("SessionAudioRing", lambda: SessionAudioRing(max_slots=2, ring_samples=1024)),
            ("DeviceBatcher", lambda: DeviceBatcher()),
            ("vad_init_state", lambda: vad_init_state()),
            ("get_audio_ring", lambda: get_audio_ring()),
            ("StreamTable", lambda: StreamTable(WHISPER_CONFIGS["tiny"], torch.float32, max_slots=1)),
            ("SttServingEngine", lambda: SttServingEngine()),
            ("register_nodes", lambda: register_nodes(NodeRegistry())),
            ("WhisperNode", lambda: WhisperNode(None)),
            ("VadNode", lambda: VadNode(None)),
            ("seeded_params", lambda: seeded_params(WHISPER_CONFIGS["tiny"])),
            ("SlotTable", lambda: SlotTable(lambda: {"x": torch.zeros(1)}, max_slots=2)),
            ("GainNode", lambda: GainNode(None)),
            ("ResamplerNode", lambda: ResamplerNode(None)),
            ("MixerNode", lambda: MixerNode(None)),
            ("nllb_init_params", lambda: nllb_init_params(NllbConfig(vocab_size=8, **small))),
            ("marian_init_params", lambda: marian_init_params(MarianConfig(vocab_size=8, pad_token_id=7,
                                                                           decoder_start_token_id=7, **small))),
            ("vits_init_params", lambda: vits_init_params(VitsConfig(hidden_size=8, ffn_dim=8, flow_size=8,
                                                                     upsample_initial_channel=16))),
            ("acoustic_init_params", lambda: acoustic_init_params(AcousticConfig(d_model=8, heads=2))),
            ("hifigan_init_params", lambda: hifigan_init_params(HifiGanConfig(upsample_initial_channel=16))),
            ("BucketedGreedy", lambda: BucketedGreedy("tag", 8, 1, None)),
            ("TranslateNode", lambda: TranslateNode(None)),
            ("MarianTranslateNode", lambda: MarianTranslateNode(None)),
            ("TtsNode", lambda: TtsNode(None)),
            ("kokoro_init_params", lambda: kokoro_init_params(KokoroConfig(n_tokens=4, hidden=8, style_dim=4))),
            ("load_kokoro_dir", lambda: load_kokoro_dir("samples/kokoro-golden")),
            ("matcha_init_params", lambda: matcha_init_params(MatchaConfig(vocab_size=8, d_model=8, ffn_dim=8,
                                                                           dec_channels=8, enc_layers=1,
                                                                           dec_layers=1))),
            ("sensevoice_init_params", lambda: sensevoice_init_params(SenseVoiceConfig(vocab_size=8, d_model=8,
                                                                                       ffn_dim=8, layers=1))),
            ("MatchaTtsNode", lambda: MatchaTtsNode(None)),
            ("SenseVoiceNode", lambda: SenseVoiceNode(None)),
            ("create_app", lambda: __import__("streamkit_tpu_torch.server", fromlist=["x"]).create_app()),
            ("train_state_from_numpy", lambda: train_state_from_numpy({}, {}, {}, 0, WHISPER_CONFIGS["tiny"])),
            ("make_mesh", lambda: make_mesh()),
            ("run_ranks", lambda: run_ranks(print, 1)),
            ("dryrun_multichip", lambda: dryrun_multichip(2)),
            ("train_vad.init_training", lambda: train_vad.init_training()),
            ("train_vad.main", lambda: train_vad.main(out="unused.npz")),
            ("eval_vad.evaluate", lambda: eval_vad.evaluate(np.zeros(4096, np.float32))),
        ]:
            try:
                call()
            except RuntimeError as e:
                assert "no CUDA device" in str(e), (name, e)
            else:
                raise AssertionError(f"{name} ran without a card and without device=")
        # with device="cpu" the mesh asks for its process group, not a card
        try:
            make_mesh(device="cpu")
        except RuntimeError as e:
            assert "process group" in str(e), e
        else:
            raise AssertionError("make_mesh ran without a process group")
        print("RAISED")
    print("OK")
    """
)


def test_port_imports_no_jax_and_needs_explicit_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK"), proc.stdout


_CLI_WITHOUT_TORCH = textwrap.dedent(
    """
    import sys, time
    t0 = time.monotonic()
    import streamkit_tpu_torch.cli.main as cli
    try:
        cli.main(["--help"])
    except SystemExit as e:
        assert e.code == 0, e.code
    loaded = sorted(m for m in ("torch", "streamkit_tpu_torch.server.app") if m in sys.modules)
    assert not loaded, loaded
    print(f"OK {time.monotonic() - t0:.3f}")
    """
)


def test_cli_starts_without_torch():
    """``import streamkit_tpu_torch.cli.main`` and ``main(["--help"])`` load
    neither torch nor the server's app: the client needs only
    ``server/http.py``, and ``server/__init__.py`` resolves its names at
    first use."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_WITHOUT_TORCH], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "OK" in proc.stdout.splitlines()[-1], proc.stdout
    assert "usage: skit-tpu-cli" in proc.stdout, proc.stdout


def test_server_exports_resolve_lazily():
    """The server package keeps its exports, each the object its module
    defines, and names nothing else."""
    import pytest

    import streamkit_tpu_torch.server as server
    from streamkit_tpu_torch.server import app, config, permissions, sessions

    homes = {"AppState": app, "create_app": app, "run_server": app, "ServerConfig": config,
             "load_config": config, "Permissions": permissions, "RoleStore": permissions,
             "Session": sessions, "SessionManager": sessions}
    assert sorted(server.__all__) == sorted(homes)
    for name, module in homes.items():
        assert getattr(server, name) is getattr(module, name)
    with pytest.raises(AttributeError):
        server.no_such_name


def _public_names(path: str) -> set:
    """Top-level functions, classes and assigned names not starting with
    ``_``, read from the source (nothing is imported)."""
    import ast

    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {e.id for t in node.targets for e in ast.walk(t) if isinstance(e, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


# the JAX package's public names the port does not carry, each recorded in
# ROADMAP.md §3 "Public names the port does not carry"
SURFACE_EXCEPTIONS = {
    ("ops/attention.py", "use_flash_attention"),
    ("ops/attention.py", "BLOCK_Q"),
    ("ops/attention.py", "BLOCK_K"),
    ("nodes/audio/filters.py", "VALID_OPUS_FRAME_SIZES"),
}


def test_every_jax_module_and_public_name_has_its_counterpart():
    jax_root = os.path.join(REPO, "streamkit_tpu")
    port_root = os.path.join(REPO, "streamkit_tpu_torch")
    missing_files, missing_names = [], set()
    for root, _, names in os.walk(jax_root):
        for n in names:
            if not n.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, n), jax_root).replace(os.sep, "/")
            port = os.path.join(port_root, rel)
            if not os.path.exists(port):
                missing_files.append(rel)
                continue
            missing_names |= {(rel, name) for name in _public_names(os.path.join(root, n)) - _public_names(port)}
    assert not missing_files, missing_files
    assert missing_names == SURFACE_EXCEPTIONS, (sorted(missing_names - SURFACE_EXCEPTIONS),
                                                 sorted(SURFACE_EXCEPTIONS - missing_names))
    with open(os.path.join(REPO, "ROADMAP.md"), encoding="utf-8") as f:
        roadmap = f.read()
    section = roadmap.split("### 3.", 1)[1].split("\n## ", 1)[0]
    recorded = section.split("**Public names the port does not carry", 1)[1]
    for rel, name in SURFACE_EXCEPTIONS:
        assert f"`{name}`" in recorded and rel in recorded, (rel, name)


_NO_YAML = textwrap.dedent(
    """
    import sys
    sys.modules["yaml"] = None  # any import of PyYAML now fails
    from streamkit_tpu_torch.api import compile_pipeline_dict, compile_yaml
    p = compile_pipeline_dict({"mode": "oneshot", "steps": [
        {"kind": "streamkit::http_input"}, {"kind": "containers::wav::demuxer"},
        {"kind": "plugin::native::whisper", "params": {"model_size": "large-v3"}},
        {"kind": "core::json_serialize"}, {"kind": "streamkit::http_output"}]})
    assert [n.kind for n in p.nodes.values()][2] == "plugin::native::whisper", p
    try:
        compile_yaml("mode: oneshot")
    except ImportError:
        print("OK")
    """
)


def test_api_works_without_yaml():
    """Pipelines compile from dicts where PyYAML is not installed; only
    ``compile_yaml`` needs it, at call time."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_YAML], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK"), proc.stdout


_BLOCKED = textwrap.dedent(
    """
    import sys
    for name in ("aiohttp", "jax", "cryptography"):
        sys.modules[name] = None  # any import of them now fails
    import asyncio, json, tempfile
    from streamkit_tpu_torch.server import ServerConfig, create_app
    from streamkit_tpu_torch.server.http import AppRunner, ClientSession, FormData
    from streamkit_tpu_torch.plugins.wasm_asm import build_gain_wasm
    from streamkit_tpu_torch.moq.session import MoqClient
    import streamkit_tpu_torch.cli.main
    import streamkit_tpu_torch.cli.loadtest
    import streamkit_tpu_torch.cli.shell
    import streamkit_tpu_torch.server.__main__

    async def main():
        cfg = ServerConfig()
        cfg.otlp_endpoint = "http://127.0.0.1:1"  # nothing listens: the pusher counts failures
        cfg.otlp_interval_secs = 0.05
        cfg.script_fetch_allowlist = [{"url": "http://127.0.0.1:1/*", "methods": ["GET"]}]
        plugins = tempfile.TemporaryDirectory()
        cfg.plugins_dir = plugins.name
        cfg.moq_port = 0  # the WebTransport acceptor on an ephemeral UDP port
        app = create_app(cfg, device="cpu")
        runner = AppRunner(app)
        port = await runner.start("127.0.0.1", 0)
        base = f"http://127.0.0.1:{port}"
        try:
            s = ClientSession(timeout=60)
            health = await (await s.get(base + "/healthz")).json()
            heap = await (await s.get(base + "/api/v1/profile/heap?duration_secs=0")).json()
            trace = await (await s.get(base + "/api/v1/profile/device?duration_secs=0.1")).json()
            form = FormData()
            form.add_field("file", build_gain_wasm(), filename="wgain.wasm")
            uploaded = await s.post(base + "/api/v1/plugins", data=form)
            uploaded = (uploaded.status, await uploaded.json())
            fps = await (await s.get(base + "/api/v1/moq/fingerprints")).json()
            room = app["state"].moq_relay.announce("room")
            moq = MoqClient()
            await moq.connect("127.0.0.1", fps["port"], [bytes.fromhex(f) for f in fps["fingerprints"]])
            sub = await moq.subscribe("room", timeout=10)
            await asyncio.sleep(0.2)
            room.publish(b"frame", 20_000, key=True)
            frame = await sub.recv(timeout=10)
            moq.close()
            ws = await s.ws_connect(base + "/api/v1/control")
            await ws.send_json({"type": "request", "correlation_id": "c", "payload": {"action": "listsessions"}})
            listed = (await ws.receive(timeout=10)).json()
            await ws.close()
            for _ in range(200):
                if app["state"].otlp.failures >= 1:
                    break
                await asyncio.sleep(0.05)
        finally:
            await runner.cleanup()
            plugins.cleanup()
        assert app["state"].otlp.failures >= 1 and app["state"].otlp.exports == 0
        assert health == {"status": "ok"}, health
        assert fps["port"] > 0 and len(fps["fingerprints"]) == 1, fps
        assert frame == (b"frame", 20_000, True), frame
        assert heap["device"] == {"device": "cpu"}, heap
        assert "traceEvents" in trace, list(trace)
        assert listed["payload"] == {"action": "sessionslisted", "sessions": []}, listed
        assert uploaded == (201, {"kind": "plugin::wasm::wgain", "description": "WASM plugin wgain"}), uploaded

    asyncio.run(main())
    print("OK")
    """
)


def test_server_runs_without_aiohttp_jax_or_cryptography():
    """The server, the CLI and the transport nodes import, and the server
    answers HTTP, WebSocket, both profile routes, a plugin upload, the MoQ
    fingerprint route and a WebTransport MoQ subscribe from the port's own
    client (QUIC on OpenSSL's libcrypto), in an interpreter where
    ``aiohttp``, ``jax`` and ``cryptography`` cannot be imported: the port
    needs none of them on the machine with the card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK"), proc.stdout


def test_no_port_module_names_the_jax_package():
    """No source of the port (nor ``chip_smoke.py``) names a module of
    ``streamkit_tpu``: the port keeps its own copies."""
    import re

    pattern = re.compile(r"\bstreamkit_tpu\.\w")
    offenders = []
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "streamkit_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if pattern.search(line):
                    offenders.append(f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}")
    assert len(files) > 80 and not offenders, offenders
