# SPDX-License-Identifier: Apache-2.0
"""The port's dynamic engine (``engine/dynamic.py``, ``engine/distributor.py``)
on the CPU: the scenarios of ``tests/test_dynamic_engine.py`` (the JAX
package's) on the port's registry with ``device="cpu"``, each also run
through the JAX engine where it makes output; and live sessions with the
port's ``WhisperNode`` (segment finals, and ``live_captions.yml``'s
streaming partials and finals) whose Transcription lines equal the JAX
engine's on the same graph.

Tolerances: output files are compared byte for byte (gain and WAV are exact
f32 arithmetic); Transcription text, language and segment bounds exactly,
confidences within 1e-5 (f32 greedy decode on both sides, as in
``test_torch_whisper_node.py``).
"""

import asyncio
import io
import json
import os
import wave

import numpy as np
import pytest
import torch

import streamkit_tpu.core as jax_core
import streamkit_tpu.engine.dynamic as jax_dynamic
import streamkit_tpu.nodes as jax_nodes
import streamkit_tpu_torch.core as torch_core
import streamkit_tpu_torch.engine as torch_engine
import streamkit_tpu_torch.nodes as torch_nodes
from test_torch_whisper_node import COLLECT_KIND, collector_kind, hf_dir, speech_wav  # noqa: F401  (module fixture)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def registries():
    jreg = jax_core.NodeRegistry()
    jax_nodes.register_nodes(jreg)
    treg = torch_core.NodeRegistry()
    torch_nodes.register_nodes(treg, device="cpu")
    return {"jax": jreg, "torch": treg}


def start(pkg, registries, session_id):
    if pkg == "jax":
        return jax_dynamic.start_dynamic_engine(registries["jax"], jax_dynamic.DynamicEngineConfig(session_id=session_id))
    return torch_engine.start_dynamic_engine(registries["torch"],
                                             torch_engine.DynamicEngineConfig(session_id=session_id))


def wav_file(tmp_path, samples, rate=48000, name="in.wav"):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(samples * 32768, -32768, 32767).astype("<i2")).tobytes())
    p = tmp_path / name
    p.write_bytes(buf.getvalue())
    return str(p)


async def wait_stopped(handle, tries=400):
    for _ in range(tries):
        await asyncio.sleep(0.05)
        states = await handle.get_node_states()
        if states and all(s.kind.value == "stopped" for s in states.values()):
            return states
    raise AssertionError(f"stream did not drain: {await handle.get_node_states()}")


async def gain_session(handle, src_path, out_path, gain, chunk_size=8192):
    await handle.add_node("reader", "core::file_reader", {"path": src_path, "chunk_size": chunk_size})
    await handle.add_node("demux", "containers::wav::demuxer")
    await handle.add_node("gain", "audio::gain", {"gain": gain})
    await handle.add_node("mux", "containers::wav::muxer")
    await handle.add_node("writer", "core::file_writer", {"path": out_path})
    await handle.connect("reader", "out", "demux", "in")
    await handle.connect("demux", "out", "gain", "in")
    await handle.connect("gain", "out", "mux", "in")
    await handle.connect("mux", "out", "writer", "in")


def test_session_lifecycle_and_live_pipeline(registries, tmp_path):
    """AddNode/Connect → ready-gating Start → data flows → stats/pipeline
    queries → shutdown; the output file equals the JAX engine's."""
    rng = np.random.RandomState(0)
    src_path = wav_file(tmp_path, (0.25 + 0.05 * rng.randn(48000)).astype(np.float32))
    out = {}
    for pkg in ("jax", "torch"):
        out_path = str(tmp_path / f"out_{pkg}.wav")

        async def main(pkg=pkg, out_path=out_path):
            handle = start(pkg, registries, "s1")
            await gain_session(handle, src_path, out_path, 2.0)
            await wait_stopped(handle)
            pipeline = await handle.get_pipeline()
            stats = await handle.get_node_stats()
            await handle.shutdown_and_wait()
            return pipeline, stats

        pipeline, stats = asyncio.run(main())
        assert set(pipeline["nodes"]) == {"reader", "demux", "gain", "mux", "writer"}
        assert len(pipeline["connections"]) == 4
        out[pkg] = open(out_path, "rb").read()
    data = out["torch"]
    assert data[:4] == b"RIFF" and data == out["jax"]
    y = np.frombuffer(data[44:], dtype="<i2").astype(np.float32) / 32768.0
    assert len(y) > 40000
    np.testing.assert_allclose(y[:40000].mean(), 0.5, atol=2e-3)  # 0.25 × gain 2.0


def test_connect_type_mismatch_rejected(registries):
    async def main():
        handle = start("torch", registries, "s2")
        await handle.add_node("reader", "core::file_reader", {"path": "/dev/null"})
        await handle.add_node("gain", "audio::gain")
        with pytest.raises(torch_core.ValidationFailure, match="type mismatch"):
            await handle.connect("reader", "out", "gain", "in")  # Binary → RawAudio
        await handle.shutdown_and_wait()

    asyncio.run(main())


def test_tune_node_live_params(registries, tmp_path):
    """UpdateParams reaches a running node without restarting it."""
    src_path = wav_file(tmp_path, np.ones(96000, np.float32) * 0.1)
    out_path = str(tmp_path / "out.wav")

    async def main():
        handle = start("torch", registries, "s3")
        await gain_session(handle, src_path, out_path, 1.0, chunk_size=4096)
        await handle.tune_node("gain", torch_core.NodeControlMessage.update_params({"gain": 3.0}))
        pipeline = await handle.get_pipeline()
        assert pipeline["nodes"]["gain"]["params"]["gain"] == 3.0
        await wait_stopped(handle)
        await handle.shutdown_and_wait()

    asyncio.run(main())
    data = open(out_path, "rb").read()
    y = np.frombuffer(data[44:], dtype="<i2").astype(np.float32) / 32768.0
    # the tune raced the stream start; by the end gain must be 3.0
    assert abs(y[-1000:].mean() - 0.3) < 0.02


def test_subscribe_state_events(registries, tmp_path):
    src_path = wav_file(tmp_path, np.zeros(4800, np.float32))

    async def main():
        handle = start("torch", registries, "s4")
        state_sub = await handle.subscribe_state()
        await handle.add_node("reader", "core::file_reader", {"path": src_path})
        await handle.add_node("sink", "core::sink")
        await handle.connect("reader", "out", "sink", "in")
        seen = []
        for _ in range(200):
            try:
                upd = state_sub.try_recv()
                seen.append((upd.node_name, upd.state.kind.value))
            except Exception:
                await asyncio.sleep(0.02)
            if ("reader", "stopped") in seen:
                break
        await handle.shutdown_and_wait()
        return seen

    seen = asyncio.run(main())
    assert ("reader", "ready") in seen  # gated until Start
    assert ("reader", "running") in seen
    assert ("reader", "stopped") in seen


def test_best_effort_drops_under_stall():
    """BestEffort connection: the producer never stalls; drops are counted."""
    from streamkit_tpu_torch.engine.distributor import PinDistributor

    async def main():
        dist = PinDistributor("n", "out", capacity=4)
        slow = torch_core.Channel(1)
        dist.add_connection("slow:in", slow, torch_core.ConnectionMode.BEST_EFFORT)
        dist.start()
        for i in range(50):
            await dist.input.send(torch_core.Packet.new_text(f"p{i}"))
        await asyncio.sleep(0.05)
        # the consumer wakes up and drains: it gets the newest pending, not all 50
        got = []
        while True:
            try:
                got.append(slow.try_recv())
            except Exception:
                break
        dest = dist.destinations["slow:in"]
        assert dest.dropped > 0
        assert len(got) <= 3
        texts = [p.text for p in got]
        assert "p49" in texts[-1] or dest._pending is not None
        dist.stop()

    asyncio.run(main())


def test_remove_node_mid_stream(registries, tmp_path):
    src_path = wav_file(tmp_path, np.zeros(480000, np.float32))

    async def main():
        handle = start("torch", registries, "s5")
        await handle.add_node("reader", "core::file_reader", {"path": src_path, "chunk_size": 1024})
        await handle.add_node("pass", "core::passthrough")
        await handle.add_node("sink", "core::sink")
        await handle.connect("reader", "out", "pass", "in")
        await handle.connect("pass", "out", "sink", "in")
        await asyncio.sleep(0.2)
        await handle.remove_node("pass")
        pipeline = await handle.get_pipeline()
        assert "pass" not in pipeline["nodes"]
        assert pipeline["connections"] == []
        # the engine is still healthy: it can add a new node
        await handle.add_node("sink2", "core::sink")
        await handle.shutdown_and_wait()

    asyncio.run(main())


def _line_key(line):
    tr = line["Transcription"]
    return (tr["text"], tr["language"], [(s["text"], s["start_time_ms"], s["end_time_ms"]) for s in tr["segments"]])


def whisper_session(pkg, registries, wav, params, out_path, batched, collect=False):
    """A live session of ``pkg`` built with ``add_node``/``connect``: file →
    WAV demuxer → whisper (``params``) → (the Transcription collector) →
    JSON → file, run until every node stopped → (node states, batcher stats
    or None)."""

    async def main():
        batcher = None
        if batched:
            if pkg == "torch":
                batcher = torch_engine.DeviceBatcher(tick_ms=5.0, device="cpu")
            else:
                from streamkit_tpu.engine.batcher import DeviceBatcher

                batcher = DeviceBatcher(tick_ms=5.0)
            batcher.start()
        core = torch_core if pkg == "torch" else jax_core
        cfg_cls = torch_engine.DynamicEngineConfig if pkg == "torch" else jax_dynamic.DynamicEngineConfig
        start_fn = torch_engine.start_dynamic_engine if pkg == "torch" else jax_dynamic.start_dynamic_engine
        handle = start_fn(registries[pkg], cfg_cls(session_id="stt"), resources=core.ResourceManager(),
                          batcher=batcher)
        nodes = [("reader", "core::file_reader", {"path": str(wav)}), ("demux", "containers::wav::demuxer", None),
                 ("stt", "plugin::native::whisper", params), *([("collect", COLLECT_KIND, None)] if collect else []),
                 ("json", "core::json_serialize", {"newline_delimited": True}),
                 ("writer", "core::file_writer", {"path": out_path})]
        for name, kind, p in nodes:
            await handle.add_node(name, kind, p)
        for (a, _, _), (b, _, _) in zip(nodes, nodes[1:]):
            await handle.connect(a, "out", b, "in")
        states = await wait_stopped(handle, tries=1200)
        await handle.shutdown_and_wait()
        stats = None
        if batcher is not None:
            stats = batcher.stats()
            batcher.stop()
        return states, stats

    states, stats = asyncio.run(main())
    assert all(s.kind.value == "stopped" for s in states.values())
    with open(out_path) as f:
        return [json.loads(ln) for ln in f if ln.strip()], stats


@pytest.mark.parametrize("batched", [False, True])
def test_whisper_session_lines_equal_jax(registries, hf_dir, tmp_path, batched):  # noqa: F811
    """A live session file → WAV demuxer → whisper (one HF checkpoint, f32)
    → JSON → file, built with ``add_node``/``connect``: the port's dynamic
    engine and node write the JAX engine's Transcription lines (with a
    batcher: the ring decodes of both packages' ``DeviceBatcher``)."""
    wav = tmp_path / "speech.wav"
    wav.write_bytes(speech_wav(secs=3, speech_secs=1))
    params = {"model_path": hf_dir, "dtype": "float32", "max_tokens": 8, "language": "en"}
    lines = {pkg: whisper_session(pkg, registries, wav, params, str(tmp_path / f"out_{pkg}.jsonl"), batched)[0]
             for pkg in ("jax", "torch")}
    assert lines["torch"] and [_line_key(ln) for ln in lines["torch"]] == [_line_key(ln) for ln in lines["jax"]]
    for a, b in zip(lines["torch"], lines["jax"]):
        ca, cb = a["Transcription"]["segments"][0]["confidence"], b["Transcription"]["segments"][0]["confidence"]
        assert (ca is None) == (cb is None) and (ca is None or abs(ca - cb) <= 1e-5)


def test_live_captions_session_lines_equal_jax(registries, hf_dir, tmp_path, monkeypatch):  # noqa: F811
    """``live_captions.yml``'s whisper step (streaming partials, finals from
    the stream, 8-frame VAD blocks, its silence and segment limits) on one
    HF checkpoint at f32, in a dynamic session with both packages'
    ``DeviceBatcher`` (a 16 kHz WAV, so no resampler): the port writes the
    JAX engine's partial and final Transcriptions. ``partial_interval_ms``
    is 0 here: the YAML's 250 ms is a wall-clock cooldown between decodes,
    so which blocks decode would depend on the host's speed, not on the
    audio."""
    import yaml

    monkeypatch.setenv("SK_STREAM_SLOTS", "4")
    monkeypatch.setenv("SK_STREAM_GATHER_MS", "0")
    with open(os.path.join(REPO, "samples", "pipelines", "system", "live_captions.yml")) as f:
        yaml_params = next(s["params"] for s in yaml.safe_load(f)["steps"] if s["kind"] == "plugin::native::whisper")
    params = {k: v for k, v in yaml_params.items() if k != "model_size"}
    params.update(model_path=hf_dir, dtype="float32", max_tokens=8, partial_interval_ms=0)
    assert params["streaming_partials"] and params["final_from_stream"] and params["vad_block_frames"] == 8
    wav = tmp_path / "speech.wav"
    wav.write_bytes(speech_wav(secs=5, speech_secs=3))
    lines, seen = {}, {}
    for pkg in ("jax", "torch"):
        cls, seen[pkg] = collector_kind(pkg)
        registries[pkg].register(COLLECT_KIND, lambda p, cls=cls: cls(p))
        try:
            lines[pkg], stats = whisper_session(pkg, registries, wav, params, str(tmp_path / f"out_{pkg}.jsonl"),
                                                batched=True, collect=True)
        finally:
            registries[pkg].unregister(COLLECT_KIND)
        assert any(k.startswith("stream_step:") for k in stats["kinds"]), stats
    assert lines["torch"] and [_line_key(ln) for ln in lines["torch"]] == [_line_key(ln) for ln in lines["jax"]]
    assert len(seen["torch"]) == len(lines["torch"]) == len(seen["jax"])
    for (text, lang, final, segs), (text_j, lang_j, final_j, segs_j) in zip(seen["torch"], seen["jax"]):
        assert (text, lang, final) == (text_j, lang_j, final_j)
        assert [s[:2] for s in segs] == [s[:2] for s in segs_j]
        for s, sj in zip(segs, segs_j):
            assert (s[2] is None) == (sj[2] is None) and (sj[2] is None or abs(s[2] - sj[2]) <= 1e-5)
    finals = [i for i, t in enumerate(seen["torch"]) if t[2]]
    assert finals and finals[0] > 0  # partials stream before the first final
