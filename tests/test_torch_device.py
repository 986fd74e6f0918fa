# SPDX-License-Identifier: Apache-2.0
"""Device aliases and random weights, on the CPU.

* One physical device is one key: ``resolve_device`` names ``cpu:0`` as
  ``cpu`` (and ``cuda`` as ``cuda:{current}``, checked on the card in
  ``test_torch_kernels_cuda.py``), so the process-wide audio ring, stream
  table, resampler slot table and the whisper node's model cache key are one
  object per device whichever alias the caller used.
* One config is one model: the serving engine and the whisper node draw a
  checkpoint-less model through the same ``seeded_params`` (seed 0 on the
  CPU, then moved), as the reference's one ``PRNGKey(0)`` serves both.

Exact comparisons (object identity, equal tensors)."""

import asyncio

import pytest
import torch

from streamkit_tpu_torch.device import resolve_device
from streamkit_tpu_torch.engine import audio_ring
from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS, WhisperConfig, get_stream_table, seeded_params

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

TINY = WhisperConfig(n_mels=80, n_audio_ctx=64, n_audio_state=32, n_audio_head=2, n_audio_layer=1, n_vocab=51865,
                     n_text_ctx=16, n_text_state=32, n_text_head=2, n_text_layer=1)


@pytest.fixture
def small_rings(monkeypatch):
    saved = dict(audio_ring._RINGS)
    audio_ring._RINGS.clear()
    monkeypatch.setenv("SK_RING_SLOTS", "4")
    yield
    audio_ring._RINGS.clear()
    audio_ring._RINGS.update(saved)


@pytest.mark.parametrize("alias", ["cpu", "cpu:0", torch.device("cpu"), torch.device("cpu", 0)])
def test_resolve_device_names_the_cpu_one_way(alias):
    dev = resolve_device(alias)
    assert dev == torch.device("cpu") and str(dev) == "cpu" and dev.index is None


def test_one_audio_ring_per_device(small_rings):
    assert audio_ring.get_audio_ring("cpu") is audio_ring.get_audio_ring("cpu:0")
    assert audio_ring.get_audio_ring(torch.device("cpu", 0)) is audio_ring.get_audio_ring("cpu")
    assert list(audio_ring._RINGS) == ["cpu"]


def test_one_stream_table_per_device():
    tag = "device-alias-test"
    a = get_stream_table(tag, TINY, torch.float32, device="cpu", max_slots=1, enc_t=64, dec_t=16)
    b = get_stream_table(tag, TINY, torch.float32, device="cpu:0", max_slots=1, enc_t=64, dec_t=16)
    assert a is b


def test_one_resampler_table_per_device():
    from streamkit_tpu_torch.engine import DeviceBatcher
    from streamkit_tpu_torch.nodes.audio.filters import _RESAMPLER_TABLES, _resampler_slot_kind

    batcher = DeviceBatcher(device="cpu")
    kind_a, table_a, slot_a = _resampler_slot_kind(batcher, 32000, 16000, 960, 1, "cpu")
    kind_b, table_b, slot_b = _resampler_slot_kind(batcher, 32000, 16000, 960, 1, "cpu:0")
    assert kind_a == kind_b and table_a is table_b and slot_a != slot_b
    assert [k for k in _RESAMPLER_TABLES if k[0] == kind_a] == [(kind_a, "cpu")]
    table_a.free(slot_a)
    table_a.free(slot_b)


def test_one_model_key_per_device():
    """The whisper node keys its model by the resolved device: a registry
    made with ``cpu:0`` and one made with ``cpu`` share one load."""
    from streamkit_tpu_torch.core import NodeRegistry, ResourceManager
    from streamkit_tpu_torch.nodes import register_nodes
    from streamkit_tpu_torch.nodes.ml.whisper_node import WhisperNode

    assert WhisperNode(None, device="cpu:0").device == WhisperNode(None, device="cpu").device
    WHISPER_CONFIGS["alias-test"] = TINY
    try:
        resources = ResourceManager()

        class Ctx:
            def __init__(self):
                self.resources = resources

        for device in ("cpu", "cpu:0"):
            reg = NodeRegistry()
            register_nodes(reg, device=device)
            node = reg.create_node("plugin::native::whisper", {"model_size": "alias-test"})
            asyncio.run(node._load_model(Ctx()))
        assert resources.misses == 1 and resources.hits == 1
    finally:
        WHISPER_CONFIGS.pop("alias-test", None)


def test_engine_and_node_draw_one_model(monkeypatch, small_rings):
    """Both entry points draw through ``seeded_params`` (a CPU generator from
    seed 0, then moved): on a card the engine's weights are the node's
    (checked there); here the draw is spied and its result compared."""
    from streamkit_tpu_torch.core import ResourceManager
    from streamkit_tpu_torch.engine import stt_serving
    from streamkit_tpu_torch.nodes.ml import whisper_node

    calls = []

    def spy(cfg, dtype, device):
        calls.append((cfg, dtype, resolve_device(device)))
        return seeded_params(cfg, dtype, device)

    monkeypatch.setattr(stt_serving, "seeded_params", spy)
    monkeypatch.setattr(whisper_node, "seeded_params", spy)
    WHISPER_CONFIGS["draw-test"] = TINY
    try:
        eng = stt_serving.SttServingEngine(model_size="draw-test", dtype="float32", max_sessions=1,
                                           window_buckets=[1.0], device="cpu")

        async def start_stop():
            await eng.start()
            await eng.stop()

        asyncio.run(start_stop())
        node = whisper_node.WhisperNode({"model_size": "draw-test"}, device="cpu")

        class Ctx:
            resources = ResourceManager()

        _, node_params, _ = asyncio.run(node._load_model(Ctx()))
    finally:
        WHISPER_CONFIGS.pop("draw-test", None)
    assert [c[1:] for c in calls] == [(torch.float32, torch.device("cpu"))] * 2
    assert calls[0][0] is calls[1][0] is TINY
    eng_sd, node_sd = eng._params.state_dict(), node_params.state_dict()
    assert eng_sd.keys() == node_sd.keys()
    assert all(torch.equal(eng_sd[k], node_sd[k]) for k in eng_sd)
