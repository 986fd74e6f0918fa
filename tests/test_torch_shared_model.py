# SPDX-License-Identifier: Apache-2.0
"""``SttServingEngine(resources=)``: the engine takes its model from a shared
``ResourceManager`` under the ``WhisperNode``'s key (path, size, dtype,
device), as the JAX package's engine and node share one
(``engine/stt_serving.py`` and ``nodes/ml/whisper_node.py`` there).

* a node's request and an engine on one manager build the model once, and
  the engine serves with the node's very parameters;
* an engine's events are the same with and without a manager;
* on a mesh (two gloo ranks at tp = 2) the manager keeps the whole params
  and each rank's engine a sharded copy.

The ranks import this module, so it imports only the port at its top.
"""

import asyncio
import os

import numpy as np
import torch.distributed as dist
import torch

from streamkit_tpu_torch.api import compile_pipeline_dict
from streamkit_tpu_torch.core import NodeRegistry, ResourceManager
from streamkit_tpu_torch.engine import audio_ring, run_oneshot_pipeline
from streamkit_tpu_torch.engine.stt_serving import SttServingEngine
from streamkit_tpu_torch.nodes import register_nodes
from streamkit_tpu_torch.parallel import make_mesh, run_ranks
from streamkit_tpu_torch.utils.speechsynth import synth_speech_with_plan

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

SR = 16_000


def _speech(seconds: float, seed: int) -> np.ndarray:
    return synth_speech_with_plan(seconds, SR, seed=seed)[0].astype(np.float32)


def _wav(audio: np.ndarray) -> bytes:
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _engine(final_mode="stream", **kw):
    return SttServingEngine(model_size="tiny", dtype="float32", max_sessions=2, final_mode=final_mode,
                            window_buckets=[8.0], partial_interval_ms=250.0, device="cpu", **kw)


async def _serve(eng, seconds=4.0):
    """One session of ``seconds`` of speech and 1 s of silence → its events."""
    await eng.start()
    events = []
    sid = eng.open_session(events.append)
    audio = np.concatenate([_speech(seconds, seed=5), np.zeros(SR, np.float32)])
    for off in range(0, audio.size, 8000):
        eng.push(sid, audio[off : off + 8000])
        await asyncio.sleep(0.05)
    deadline = asyncio.get_running_loop().time() + 120
    while asyncio.get_running_loop().time() < deadline and not any(e["type"] == "final" for e in events):
        await asyncio.sleep(0.1)
    eng.close_session(sid)
    await eng.stop()
    return events


def _small_ring():
    saved = dict(audio_ring._RINGS)
    audio_ring._RINGS["cpu"] = audio_ring.SessionAudioRing(max_slots=8, device="cpu")
    return saved


def _restore_ring(saved):
    audio_ring._RINGS.clear()
    audio_ring._RINGS.update(saved)


def test_node_and_engine_build_one_model():
    """A ``WhisperNode`` request fills the manager; the engine then takes the
    same object: one build, one entry, the node's parameters."""
    registry = NodeRegistry()
    register_nodes(registry, device="cpu")
    pipeline = compile_pipeline_dict({"mode": "oneshot", "steps": [
        {"kind": "streamkit::http_input"}, {"kind": "containers::wav::demuxer"},
        {"kind": "plugin::native::whisper", "params": {"model_size": "tiny", "dtype": "float32", "max_tokens": 4,
                                                       "language": "en"}},
        {"kind": "core::json_serialize", "params": {"newline_delimited": True}},
        {"kind": "streamkit::http_output"}]})
    resources = ResourceManager()
    body = _wav(np.concatenate([_speech(2.0, seed=1), np.zeros(SR, np.float32)]))

    async def main():
        async def stream():
            yield body

        result = await run_oneshot_pipeline(registry, pipeline, input_stream=stream(), resources=resources)
        await result.read_all()
        (entry,) = resources._entries.values()
        node_model = entry.value
        eng = _engine(resources=resources)
        await eng.start()
        try:
            return node_model, (eng._cfg, eng._params, eng._detok)
        finally:
            await eng.stop()

    saved = _small_ring()
    try:
        node_model, engine_model = asyncio.run(main())
    finally:
        _restore_ring(saved)
    assert resources.misses == 1 and resources.hits == 1 and resources.stats()["entries"] == 1
    assert all(a is b for a, b in zip(node_model, engine_model))


def test_engine_events_equal_with_and_without_a_manager():
    """Exact-mode finals (a re-decode of the segment: no timing in it) and
    the segmentation are equal with a fresh model and with the manager's,
    built by a first engine and taken by a second. Partials and stream
    finals depend on how blocks meet the fused calls, so they are not
    compared."""
    saved = _small_ring()
    try:
        plain = asyncio.run(_serve(_engine("exact")))
        resources = ResourceManager()
        shared = asyncio.run(_serve(_engine("exact", resources=resources)))
        again = asyncio.run(_serve(_engine("exact", resources=resources)))
    finally:
        _restore_ring(saved)

    def segments(events):
        return [(e["type"], e.get("text"), e.get("start_ms"), e.get("end_ms")) for e in events
                if e["type"] in ("speech_start", "final")]

    assert any(e["type"] == "final" and e["text"] for e in plain)
    assert segments(shared) == segments(plain) == segments(again)
    assert (resources.misses, resources.hits) == (1, 1)


def _mesh_rank() -> dict:
    """Each of two gloo ranks starts ``SttServingEngine(mesh=, resources=)``
    at tp = 2; rank 0 then stops it and the other follows."""
    os.environ.update(SK_RING_SLOTS="8", SK_STREAM_SLOTS="2", SK_STREAM_PAD="2")
    mesh = make_mesh(2, tp=2, device="cpu")
    resources = ResourceManager()
    eng = _engine(mesh=mesh, resources=resources)
    asyncio.run(eng.start())
    (entry,) = resources._entries.values()
    cached = dict(entry.value[1].named_parameters())
    local = dict(eng._params.named_parameters())
    q = next(name for name in cached if name.endswith(".q.w"))  # a column-parallel weight
    out = {"misses": resources.misses, "cached_split": sum(hasattr(t, "_tp") for t in cached.values()),
           "engine_split": sum(hasattr(t, "_tp") for t in local.values()),
           "cached_q": tuple(cached[q].shape), "engine_q": tuple(local[q].shape)}
    if dist.get_rank() == 0:
        asyncio.run(eng.stop())
    else:
        eng.follow()
    return out


def test_mesh_manager_keeps_the_whole_params():
    results = run_ranks(_mesh_rank, 2, device="cpu", timeout_s=240)
    for out in results:
        assert out["misses"] == 1
        assert out["cached_split"] == 0 and out["engine_split"] > 0
        assert out["cached_q"][1] == 2 * out["engine_q"][1] and out["cached_q"][0] == out["engine_q"][0], out
