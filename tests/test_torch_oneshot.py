# SPDX-License-Identifier: Apache-2.0
"""The port's oneshot engine, graph builder, pipeline compiler and host nodes
against the JAX package's: the same pipelines and request bodies through
both registries and both ``run_oneshot_pipeline`` give equal response bytes,
equal content types and the same refusals."""

import asyncio
import io
import json
import os
import wave

import numpy as np
import pytest
import yaml
import torch

import streamkit_tpu.api as jax_api
import streamkit_tpu.core as jax_core
import streamkit_tpu.engine as jax_engine
import streamkit_tpu.nodes as jax_nodes
import streamkit_tpu_torch.api as torch_api
import streamkit_tpu_torch.core as torch_core
import streamkit_tpu_torch.engine as torch_engine
import streamkit_tpu_torch.nodes as torch_nodes

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {
    "jax": (jax_api, jax_core, jax_engine, jax_nodes),
    "torch": (torch_api, torch_core, torch_engine, torch_nodes),
}


@pytest.fixture(scope="module")
def registries():
    out = {}
    for name, (_, core, _, nodes) in PACKAGES.items():
        reg = core.NodeRegistry()
        if name == "torch":
            nodes.register_nodes(reg, device="cpu")
        else:
            nodes.register_nodes(reg)
        out[name] = reg
    return out


def wav_bytes(rate=16000, channels=1, secs=0.25, sampwidth=2, seed=0) -> bytes:
    rng = np.random.RandomState(seed)
    x = (0.3 * rng.randn(int(rate * secs) * channels)).clip(-1, 1)
    if sampwidth == 1:
        raw = ((x * 127) + 128).astype(np.uint8).tobytes()
    elif sampwidth == 2:
        raw = (x * 32767).astype("<i2").tobytes()
    else:
        raw = (x * 2147483647).astype("<i4").tobytes()
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(sampwidth)
        w.setframerate(rate)
        w.writeframes(raw)
    return buf.getvalue()


def run(pkg: str, registries, doc: dict, body: bytes = b"", chunk: int = 4096, **kw):
    """Compile ``doc`` with ``pkg``'s compiler and run it through its
    registry and oneshot engine → (content type, response bytes)."""
    api, _, engine, _ = PACKAGES[pkg]
    pipeline = api.compile_pipeline_dict(doc)

    async def main():
        async def stream():
            for i in range(0, len(body), chunk):
                yield body[i : i + chunk]

        result = await engine.run_oneshot_pipeline(registries[pkg], pipeline, input_stream=stream(), **kw)
        return result.content_type, await result.read_all()

    return asyncio.run(main())


def both(registries, doc, body=b"", **kw):
    got = {pkg: run(pkg, registries, doc, body, **kw) for pkg in PACKAGES}
    return got["jax"], got["torch"]


def steps(*kinds_params) -> dict:
    return {"mode": "oneshot",
            "steps": [{"kind": k, "params": p} if p else {"kind": k} for k, p in kinds_params]}


@pytest.mark.parametrize(
    "rate,channels,sampwidth,frame,bits",
    [(16000, 1, 2, 960, 16), (48000, 2, 2, 480, 16), (22050, 1, 1, 960, 32), (8000, 2, 4, 333, 32)],
)
def test_wav_demux_mux_bytes_equal(registries, rate, channels, sampwidth, frame, bits):
    body = wav_bytes(rate, channels, sampwidth=sampwidth, seed=rate)
    doc = steps(("streamkit::http_input", None),
                ("containers::wav::demuxer", {"frame_samples_per_channel": frame}),
                ("containers::wav::muxer", {"bits": bits}),
                ("streamkit::http_output", None))
    (ct_j, out_j), (ct_t, out_t) = both(registries, doc, body, chunk=1000)
    assert ct_t == ct_j == "audio/wav"
    assert len(out_t) > 44 and out_t == out_j


@pytest.mark.parametrize("params", [{"newline_delimited": True}, {}, {"pretty": True}])
def test_json_serialize_lines_equal(registries, params):
    body = wav_bytes(secs=0.05, seed=3)
    doc = steps(("streamkit::http_input", None),
                ("containers::wav::demuxer", {"frame_samples_per_channel": 160}),
                ("core::json_serialize", params),
                ("streamkit::http_output", None))
    (ct_j, out_j), (ct_t, out_t) = both(registries, doc, body)
    assert ct_t == ct_j == "application/json"
    assert out_t and out_t == out_j


@pytest.mark.parametrize(
    "doc,kw",
    [
        # configured on the output node
        (steps(("streamkit::http_input", None), ("core::json_serialize", None),
               ("streamkit::http_output", {"content_type": "text/x-test"})), {}),
        # the upstream node's static type (the muxer)
        (steps(("streamkit::http_input", None), ("containers::wav::demuxer", None),
               ("containers::wav::muxer", None), ("streamkit::http_output", None)), {}),
        # the request's own type through a passthrough
        (steps(("streamkit::http_input", None), ("core::passthrough", None),
               ("streamkit::http_output", None)), {"input_content_type": "audio/x-raw"}),
        # nothing known: octet-stream
        (steps(("streamkit::http_input", None), ("core::passthrough", None),
               ("streamkit::http_output", None)), {}),
        # the caller's configured type wins over everything
        (steps(("streamkit::http_input", None), ("core::json_serialize", None),
               ("streamkit::http_output", None)), {"configured_content_type": "application/x-ndjson"}),
    ],
)
def test_negotiated_content_type_equal(registries, doc, kw):
    body = wav_bytes(secs=0.02)
    (ct_j, out_j), (ct_t, out_t) = both(registries, doc, body, **kw)
    assert ct_t == ct_j
    assert out_t == out_j


def _refusal(pkg, registries, doc):
    _, core, _, _ = PACKAGES[pkg]
    with pytest.raises(core.ValidationFailure) as e:
        run(pkg, registries, doc)
    return str(e.value)


@pytest.mark.parametrize(
    "doc",
    [
        # no http_output
        {"mode": "oneshot", "steps": [{"kind": "streamkit::http_input"}]},
        # binary into a 16 kHz raw-audio input
        steps(("streamkit::http_input", None), ("plugin::native::whisper", None), ("streamkit::http_output", None)),
        # raw audio into a binary input
        steps(("streamkit::http_input", None), ("containers::wav::demuxer", None),
              ("containers::wav::demuxer", None), ("streamkit::http_output", None)),
        # VAD events into the WAV muxer
        steps(("streamkit::http_input", None), ("containers::wav::demuxer", None), ("plugin::native::vad", None),
              ("containers::wav::muxer", None), ("streamkit::http_output", None)),
        # two http_outputs
        {"mode": "oneshot", "nodes": {
            "i": {"kind": "streamkit::http_input"},
            "a": {"kind": "streamkit::http_output", "needs": "i"},
            "b": {"kind": "streamkit::http_output", "needs": "i"}}},
    ],
    ids=["no-http-output", "binary-to-audio", "audio-to-binary", "events-to-muxer", "two-outputs"],
)
def test_refusals_are_the_same_validation_failures(registries, doc):
    assert _refusal("torch", registries, doc) == _refusal("jax", registries, doc)


def test_dynamic_mode_is_refused_by_both(registries):
    doc = dict(steps(("streamkit::http_input", None), ("streamkit::http_output", None)), mode="dynamic")
    assert _refusal("torch", registries, doc) == _refusal("jax", registries, doc)


SAMPLE_DIR = os.path.join(REPO, "samples", "pipelines", "system")
WAV_STT = steps(("streamkit::http_input", None), ("containers::wav::demuxer", None),
                ("plugin::native::whisper", {"model_size": "large-v3", "dtype": "bfloat16", "language": "auto"}),
                ("core::json_serialize", {"newline_delimited": True}), ("streamkit::http_output", None))


@pytest.mark.parametrize(
    "source", ["speech_to_text.yml", "live_captions.yml", "wav-stt"],
)
@pytest.mark.parametrize("optimize", [True, False])
def test_compile_pipeline_dict_equal(source, optimize):
    if source == "wav-stt":
        doc = dict(WAV_STT)
    else:
        with open(os.path.join(SAMPLE_DIR, source)) as f:
            doc = yaml.safe_load(f)
    doc["optimize"] = optimize
    got_j = jax_api.compile_pipeline_dict(dict(doc)).to_json()
    got_t = torch_api.compile_pipeline_dict(dict(doc)).to_json()
    assert got_t == got_j
    assert got_t["nodes"]


def test_compile_yaml_equal_on_the_stt_sample():
    with open(os.path.join(SAMPLE_DIR, "speech_to_text.yml")) as f:
        text = f.read()
    assert torch_api.compile_yaml(text).to_json() == jax_api.compile_yaml(text).to_json()


# -- the repo's own sample pipelines -------------------------------------------
from test_torch_whisper_node import hf_dir  # noqa: E402,F401  (module fixture)

MEDIA = os.path.join(REPO, "samples", "media")


def sample_doc(name: str, **step_params) -> dict:
    """A sample pipeline as written, with ``step_params[kind]`` merged into
    that step's params."""
    with open(os.path.join(SAMPLE_DIR, name)) as f:
        doc = yaml.safe_load(f)
    for step in doc["steps"]:
        if step["kind"] in step_params:
            step["params"] = dict(step.get("params") or {}, **step_params[step["kind"]])
    return doc


@pytest.mark.parametrize("fused", [True, False])
def test_speech_to_text_sample_lines_equal_jax(registries, hf_dir, fused):  # noqa: F811
    """``speech_to_text.yml`` (Ogg → Opus → resampler → Whisper → JSON) on
    ``speech_30s.ogg``, the whisper step pointed at one HF checkpoint at
    f32, all other steps as written: equal Transcription lines from both
    packages (text, language and bounds exactly; confidence within 1e-5).
    Fused: the resampler does no re-framing (``output_frame_size: 0``), so
    the compiler folds it into a 16 kHz Opus decode. Unfused: as written,
    ``audio::resampler`` (rubato, host) runs."""
    from streamkit_tpu_torch.nodes.codecs import opus_available

    if not opus_available():
        pytest.skip("libopus unavailable")
    steps = {"plugin::native::whisper": {"model_path": hf_dir, "dtype": "float32", "max_tokens": 8}}
    if fused:
        steps["audio::resampler"] = {"output_frame_size": 0}
    doc = sample_doc("speech_to_text.yml", **steps)
    kinds = [n.kind for n in torch_api.compile_pipeline_dict(dict(doc)).nodes.values()]
    assert ("audio::resampler" in kinds) != fused
    with open(os.path.join(MEDIA, "speech_30s.ogg"), "rb") as f:
        body = f.read()
    (ct_j, out_j), (ct_t, out_t) = both(registries, doc, body, chunk=8192)
    assert ct_t == ct_j == "application/json"
    lines_j = [json.loads(x)["Transcription"] for x in out_j.decode().splitlines() if x.strip()]
    lines_t = [json.loads(x)["Transcription"] for x in out_t.decode().splitlines() if x.strip()]
    assert lines_t and len(lines_t) == len(lines_j)
    for a, b in zip(lines_t, lines_j):
        assert (a["text"], a["language"]) == (b["text"], b["language"])
        for sa, sb in zip(a["segments"], b["segments"]):
            assert (sa["text"], sa["start_time_ms"], sa["end_time_ms"]) == (sb["text"], sb["start_time_ms"],
                                                                          sb["end_time_ms"])
            assert (sa["confidence"] is None) == (sb["confidence"] is None)
            assert sa["confidence"] is None or abs(sa["confidence"] - sb["confidence"]) <= 1e-5


def test_double_volume_sample_bytes_equal_jax(registries):
    """``double_volume.yml`` as written on ``tone.wav``: equal WAV bytes."""
    with open(os.path.join(MEDIA, "tone.wav"), "rb") as f:
        body = f.read()
    doc = sample_doc("double_volume.yml")
    (ct_j, out_j), (ct_t, out_t) = both(registries, doc, body)
    assert ct_t == ct_j == "audio/wav"
    assert len(out_t) > 44 and out_t == out_j


EXACT_RESAMPLE = steps(("streamkit::http_input", None), ("containers::wav::demuxer", None),
                       ("audio::resampler", {"target_sample_rate": 16000, "compat": "exact"}),
                       ("containers::wav::muxer", None), ("streamkit::http_output", None))


@pytest.mark.parametrize("rate,channels", [(48000, 1), (44100, 2)])
def test_resampler_slot_table_matches_host_path(registries, rate, channels):
    """The ``compat: exact`` resampler through the port's ``DeviceBatcher``
    (slot-table rows on the CPU) gives the host path's bytes and the JAX
    package's, and frees its slot when the stream ends."""
    from streamkit_tpu_torch.nodes.audio.filters import resampler_slot_table

    x = np.sin(2 * np.pi * 440 * np.arange(rate * channels) / (rate * channels)) * 0.5
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((x * 32767).astype("<i2").tobytes())
    body = buf.getvalue()
    plain = run("torch", registries, EXACT_RESAMPLE, body)

    b = torch_engine.DeviceBatcher(tick_ms=5.0, device="cpu")
    batched = run("torch", registries, EXACT_RESAMPLE, body, batcher=b)
    b.stop()
    assert batched == plain  # the same arithmetic and state logic → the same bytes
    assert batched == run("jax", registries, EXACT_RESAMPLE, body)
    assert b.stats()["kinds"][f"resample:{rate}:16000:960:{channels}"]["calls"] > 0
    table = resampler_slot_table(rate, 16000, 960, channels, "cpu")
    assert table.in_use == 0  # slot released at node completion


@pytest.mark.parametrize("target", [48000, 16000, 24000, 8000])
def test_resampler_frame_sizes_follow_the_target_rate(registries, target):
    """``output_frame_size`` is checked against the Opus frame sizes (2.5 to
    60 ms) at the target rate. At 48 kHz both packages accept and refuse the
    same sizes; below it the JAX package still checks the 48 kHz sizes, so
    it refuses ``live_captions.yml``'s 320 (20 ms at 16 kHz), which the port
    accepts."""
    def outcome(pkg, size):
        try:
            registries[pkg].create_node("audio::resampler", {"target_sample_rate": target, "output_frame_size": size})
        except Exception as e:  # noqa: BLE001 — compared by type name across the packages
            return type(e).__name__
        return "ok"

    per_rate = [target * q // 400 for q in (1, 2, 4, 8, 16, 24)]
    for size in sorted(set(per_rate + [0, 120, 320, 300, 961, 2880])):
        want = "ok" if size == 0 or size in per_rate else "ConfigurationError"
        assert outcome("torch", size) == want, size
        if target == 48000:
            assert outcome("jax", size) == want, size
    with open(os.path.join(SAMPLE_DIR, "live_captions.yml")) as f:
        params = next(s["params"] for s in yaml.safe_load(f)["steps"] if s["kind"] == "audio::resampler")
    if target == 16000:
        assert outcome("torch", params["output_frame_size"]) == "ok"
        assert outcome("jax", params["output_frame_size"]) == "ConfigurationError"


# -- the cascade samples: Whisper → NLLB (→ VITS) -------------------------------------
def run_with_batcher(pkg, registries, doc, body, batched):
    """One request through ``pkg``'s registry and oneshot engine, with a
    ``DeviceBatcher`` started inside the run when ``batched`` → (content
    type, response bytes, batcher kinds or None)."""
    api, _, engine, _ = PACKAGES[pkg]
    pipeline = api.compile_pipeline_dict(doc)

    async def main():
        batcher = None
        if batched:
            if pkg == "torch":
                batcher = engine.DeviceBatcher(tick_ms=5.0, device="cpu")
            else:
                from streamkit_tpu.engine.batcher import DeviceBatcher

                batcher = DeviceBatcher(tick_ms=5.0)
            batcher.start()

        async def stream():
            yield body

        result = await engine.run_oneshot_pipeline(registries[pkg], pipeline, input_stream=stream(), batcher=batcher)
        out = await result.read_all()
        kinds = None
        if batcher is not None:
            kinds = batcher.stats()["kinds"]
            batcher.stop()
        return result.content_type, out, kinds

    return asyncio.run(main())


def cascade_doc(name: str, hf_dir: str) -> dict:
    """A cascade sample as written, its whisper step pointed at one HF
    checkpoint at f32 (the random ``tiny`` of each package differs; NLLB
    and VITS without a checkpoint are the reference's own random models in
    both)."""
    return sample_doc(name, **{"plugin::native::whisper": {"model_path": hf_dir, "dtype": "float32",
                                                            "max_tokens": 8}})


@pytest.mark.parametrize("batched", [False, True], ids=["direct", "batcher"])
def test_speech_translate_sample_lines_equal_jax(registries, hf_dir, batched):  # noqa: F811
    """``speech_translate.yml`` (WAV → Whisper → NLLB → NDJSON): equal
    response bytes from both packages, with and without a batcher (then the
    translation runs as the batcher's ``nllb:`` kind)."""
    from test_torch_whisper_node import speech_wav

    doc = cascade_doc("speech_translate.yml", hf_dir)
    body = speech_wav(secs=3, speech_secs=1)
    ct_j, out_j, _ = run_with_batcher("jax", registries, doc, body, batched)
    ct_t, out_t, kinds = run_with_batcher("torch", registries, doc, body, batched)
    assert ct_t == ct_j == "application/json"
    lines = [json.loads(x) for x in out_t.decode().splitlines() if x.strip()]
    assert lines and all(set(x) == {"Text"} for x in lines)
    assert out_t == out_j
    if batched:
        assert any(k.startswith("nllb:") for k in kinds), kinds


@pytest.mark.parametrize("batched", [False, True], ids=["direct", "batcher"])
def test_voice_translate_sample_audio_equal_jax(registries, hf_dir, batched):  # noqa: F811
    """``voice_translate.yml`` (WAV → Whisper → NLLB → VITS at 24 kHz → WAV):
    the same header and length (so the same VITS durations) from both
    packages, every 16-bit sample within one step (f32 synthesis in two
    libraries, rounded to 16 bits), with and without a batcher (then NLLB
    and VITS run as the batcher's ``nllb:`` and ``tts_vits:`` kinds)."""
    from test_torch_whisper_node import speech_wav

    doc = cascade_doc("voice_translate.yml", hf_dir)
    body = speech_wav(secs=3, speech_secs=1)
    ct_j, out_j, _ = run_with_batcher("jax", registries, doc, body, batched)
    ct_t, out_t, kinds = run_with_batcher("torch", registries, doc, body, batched)
    assert ct_t == ct_j == "audio/wav"
    assert len(out_t) == len(out_j) > 44 + 24000 // 10 and out_t[:44] == out_j[:44]
    diff = np.abs(np.frombuffer(out_t[44:], "<i2").astype(np.int32) - np.frombuffer(out_j[44:], "<i2"))
    assert diff.max() <= 1
    if batched:
        assert any(k.startswith("nllb:") for k in kinds) and any(k.startswith("tts_vits:") for k in kinds), kinds
