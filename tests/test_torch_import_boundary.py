# SPDX-License-Identifier: Apache-2.0
"""The port's import boundary: it loads neither JAX nor the JAX package, and
its entry points refuse to fall back to the CPU when no card is present.

Runs in a fresh interpreter: this test process has JAX loaded already
(tests/conftest.py)."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent(
    """
    import sys
    before = set(sys.modules)
    import streamkit_tpu_torch
    import streamkit_tpu_torch.api
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
    import streamkit_tpu_torch.nodes.codecs.opus
    import streamkit_tpu_torch.nodes.containers.ogg
    import streamkit_tpu_torch.nodes.containers.wav
    import streamkit_tpu_torch.nodes.core_nodes.basic
    import streamkit_tpu_torch.nodes.core_nodes.file_io
    import streamkit_tpu_torch.nodes.core_nodes.pacer
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
    import streamkit_tpu_torch.ops
    import streamkit_tpu_torch.ops._build
    import streamkit_tpu_torch.ops.attention
    import streamkit_tpu_torch.ops.cache_write
    import streamkit_tpu_torch.ops.dsp
    import streamkit_tpu_torch.ops.mel
    import streamkit_tpu_torch.ops.resample
    import streamkit_tpu_torch.ops.stream_attention
    import streamkit_tpu_torch.ops.vad
    import streamkit_tpu_torch.utils.jax_prng
    import streamkit_tpu_torch.utils.speechsynth
    import streamkit_tpu_torch.utils.tracing
    new = set(sys.modules) - before
    bad = sorted(
        m for m in new
        if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
        or m == "streamkit_tpu" or m.startswith("streamkit_tpu.")
        or m == "transformers" or m == "yaml"
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
        ]:
            try:
                call()
            except RuntimeError as e:
                assert "no CUDA device" in str(e), (name, e)
            else:
                raise AssertionError(f"{name} ran without a card and without device=")
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
