# SPDX-License-Identifier: Apache-2.0
"""The port's WhisperNode and VadNode against the JAX package's, through each
package's registry and oneshot engine on the CPU.

One random-init HF Whisper (``n_audio_ctx`` 1500, d 64, 2 + 2 layers),
saved with ``save_pretrained``, feeds both nodes via ``model_path`` at f32.
The same WAV runs four routes: no batcher (``transcribe_window``), a batcher
(``vad_ring`` + ``whisper_ring``), ``language: auto`` (``whisper_detect``)
and the stream table (``stream_step``, stream finals, a decode every block).
Every route must give identical Transcription lines; confidences agree
within 1e-5 (f32 greedy on both sides, so the tokens are exact)."""

import asyncio
import importlib
import io
import json
import wave

import numpy as np
import pytest
import torch

import streamkit_tpu.api as jax_api
import streamkit_tpu.core as jax_core
import streamkit_tpu.engine as jax_engine
import streamkit_tpu.nodes as jax_nodes
import streamkit_tpu_torch.api as torch_api
import streamkit_tpu_torch.core as torch_core
import streamkit_tpu_torch.engine as torch_engine
import streamkit_tpu_torch.nodes as torch_nodes

torch.set_num_threads(2)

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


def _byte_encoder():
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A random-init HF Whisper checkpoint with a byte-level vocab: ids
    0..255 are the bytes (so the suppression sets are non-empty: symbols and
    the blank), 256..50256 decode to ``x<id>``."""
    import transformers

    hf_cfg = transformers.WhisperConfig(
        vocab_size=51865, num_mel_bins=80, encoder_layers=2, encoder_attention_heads=2,
        decoder_layers=2, decoder_attention_heads=2, d_model=64, max_source_positions=1500,
        max_target_positions=64, encoder_ffn_dim=256, decoder_ffn_dim=256,
    )
    torch.manual_seed(0)
    model = transformers.WhisperForConditionalGeneration(hf_cfg).eval()
    path = tmp_path_factory.mktemp("hf_whisper")
    model.save_pretrained(str(path))
    enc = _byte_encoder()
    vocab = {enc[b]: b for b in range(256)}
    vocab.update({f"x{i}": i for i in range(256, 50257)})
    with open(path / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    return str(path)


def speech_wav(rate=16000, secs=3, speech_secs=1) -> bytes:
    """1 s of silence, ``speech_secs`` of speech-like audio, trailing silence."""
    from streamkit_tpu_torch.utils.speechsynth import synth_speech_with_plan

    x = np.zeros(rate * secs, dtype=np.float32)
    utt, _ = synth_speech_with_plan(
        speech_secs + 0.1, rate, seed=9, pause_range=(0.01, 0.02),
        utt_range=(speech_secs, speech_secs + 0.05), lead_silence_s=0.0,
    )
    n = min(len(utt), rate * speech_secs)
    x[rate : rate + n] = utt[:n]
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((x * 32767).astype("<i2").tobytes())
    return buf.getvalue()


COLLECT_KIND = "test::transcripts"


def collector_kind(pkg):
    """A passthrough that records every Transcription it forwards as
    ``(text, language, is_final, [(start_ms, end_ms, confidence)])``: the
    JSON form carries no ``is_final``. It reports its states, as a dynamic
    session's nodes must."""
    base = PACKAGES[pkg][3].core_nodes.basic.PassthroughNode
    state = importlib.import_module(f"{PACKAGES[pkg][1].__name__}.state")
    seen = []

    class Collect(base):
        async def run(self, ctx):
            ctx.emit_state(state.NodeState.running())
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                tr = pkt.transcription
                if tr is not None:
                    seen.append((tr.text, tr.language, tr.is_final,
                                 [(s.start_time_ms, s.end_time_ms, s.confidence) for s in tr.segments]))
                await ctx.output.send("out", pkt)
            ctx.emit_state(state.NodeState.stopped(state.StopReason.INPUT_CLOSED))

    return Collect, seen


def stt_doc(whisper_params: dict, collect: bool = False) -> dict:
    return {"mode": "oneshot", "steps": [
        {"kind": "streamkit::http_input"},
        {"kind": "containers::wav::demuxer"},
        {"kind": "plugin::native::whisper", "params": whisper_params},
        *([{"kind": COLLECT_KIND}] if collect else []),
        {"kind": "core::json_serialize", "params": {"newline_delimited": True}},
        {"kind": "streamkit::http_output", "params": {"content_type": "application/json"}},
    ]}


def run_pipeline(pkg, registries, doc, body, *, batched=False, resources=None):
    """→ (response lines as dicts, batcher stats or None)."""
    api, core, engine, _ = PACKAGES[pkg]
    pipeline = api.compile_pipeline_dict(doc)
    resources = resources if resources is not None else core.ResourceManager()

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

        result = await engine.run_oneshot_pipeline(
            registries[pkg], pipeline, input_stream=stream(), resources=resources, batcher=batcher
        )
        out = (await result.read_all()).decode()
        stats = None
        if batcher is not None:
            stats = batcher.stats()
            batcher.stop()
        return out, stats

    out, stats = asyncio.run(main())
    return [json.loads(line) for line in out.splitlines() if line.strip()], stats


ROUTES = {
    "window": ({}, False, ()),
    "ring": ({}, True, ("vad_ring:", "whisper_ring:")),
    "auto": ({"language": "auto"}, True, ("vad_ring:", "whisper_detect:", "whisper_ring:")),
    # 3 s of speech: the segment stays open across several input batches,
    # so partials stream before the final
    "stream": ({"partial_transcripts": True, "partial_interval_ms": 0, "final_from_stream": True}, True,
               ("stream_step:",)),
}
SPEECH_SECS = {"stream": 3}


def _json_key(line):
    tr = line["Transcription"]
    return (tr["text"], tr["language"], [(s["text"], s["start_time_ms"], s["end_time_ms"]) for s in tr["segments"]])


@pytest.mark.parametrize("route", list(ROUTES))
def test_transcription_lines_equal_jax(registries, hf_dir, route, monkeypatch):
    extra, batched, kinds = ROUTES[route]
    # both packages' stream-table knobs: a 4-row table (the tag is this
    # module's checkpoint, so the table is this test's own) and no gather
    # wait for co-arriving sessions (there is one)
    monkeypatch.setenv("SK_STREAM_SLOTS", "4")
    monkeypatch.setenv("SK_STREAM_GATHER_MS", "0")
    params = dict(model_path=hf_dir, dtype="float32", max_tokens=8, **{"language": "en", **extra})
    speech = SPEECH_SECS.get(route, 1)
    body = speech_wav(secs=speech + 2, speech_secs=speech)
    got, seen = {}, {}
    for pkg in PACKAGES:
        cls, seen[pkg] = collector_kind(pkg)
        registries[pkg].register(COLLECT_KIND, lambda p, cls=cls: cls(p))
        try:
            got[pkg] = run_pipeline(pkg, registries, stt_doc(params, collect=True), body, batched=batched)
        finally:
            registries[pkg].unregister(COLLECT_KIND)
    (lines_j, stats_j), (lines_t, stats_t) = got["jax"], got["torch"]
    assert [_json_key(ln) for ln in lines_t] == [_json_key(ln) for ln in lines_j]
    seen_t, seen_j = seen["torch"], seen["jax"]
    assert len(seen_t) == len(lines_t) == len(seen_j)
    for (text, lang, final, segs), (text_j, lang_j, final_j, segs_j) in zip(seen_t, seen_j):
        assert (text, lang, final) == (text_j, lang_j, final_j)
        assert [s[:2] for s in segs] == [s[:2] for s in segs_j]
        for s, sj in zip(segs, segs_j):
            assert (s[2] is None) == (sj[2] is None)
            if sj[2] is not None:
                assert abs(s[2] - sj[2]) <= 1e-5
    finals = [t for t in seen_t if t[2]]
    assert finals, seen_t
    # text decodes through the checkpoint's vocab, never the numeric fallback
    assert all(t[0] and "<" not in t[0] for t in finals)
    start_ms, end_ms, conf = finals[0][3][0]
    assert start_ms <= 1100 and end_ms >= 800 + 1000 * speech
    if route in ("ring", "auto"):  # the ring decode reports a confidence
        assert conf is not None
    if route == "stream":  # partials stream before the final
        assert any(not t[2] for t in seen_t), seen_t
    if batched:
        for prefix in kinds:
            assert any(k.startswith(prefix) for k in stats_t["kinds"]), stats_t
        assert sorted(stats_t["kinds"]) == sorted(stats_j["kinds"])


def test_random_init_node_gives_equal_lines_on_two_runs(registries):
    """Random init draws from seed 0 on a CPU generator: two node instances
    (two resource caches) decode identically, as the card's node must."""
    from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS, WhisperConfig

    WHISPER_CONFIGS["node-test"] = WhisperConfig(n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
                                                 n_audio_layer=2, n_text_state=64, n_text_head=2, n_text_layer=2)
    try:
        doc = stt_doc({"model_size": "node-test", "max_tokens": 6})
        body = speech_wav()
        a, _ = run_pipeline("torch", registries, doc, body)
        b, _ = run_pipeline("torch", registries, doc, body)
    finally:
        WHISPER_CONFIGS.pop("node-test", None)
    assert a and a == b


def test_model_cache_shared_across_pipelines(registries, hf_dir):
    """Two pipelines share one model load; the cache key names the device."""
    resources = torch_core.ResourceManager()
    doc = stt_doc({"model_path": hf_dir, "dtype": "float32", "max_tokens": 4})
    body = speech_wav()
    run_pipeline("torch", registries, doc, body, resources=resources)
    run_pipeline("torch", registries, doc, body, resources=resources)
    assert resources.misses == 1 and resources.hits >= 1
    assert resources.stats()["entries"] == 1


def test_ml_nodes_need_a_device():
    """Pipelines name no device: ``register_nodes`` takes one, and without a
    card its default (``cuda``) raises instead of running on the CPU."""
    reg = torch_core.NodeRegistry()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_nodes.register_nodes(reg)
    from streamkit_tpu_torch.nodes.ml.marian_node import MarianTranslateNode
    from streamkit_tpu_torch.nodes.ml.translate_node import TranslateNode
    from streamkit_tpu_torch.nodes.ml.tts_node import TtsNode
    from streamkit_tpu_torch.nodes.ml.vad_node import VadNode
    from streamkit_tpu_torch.nodes.ml.whisper_node import WhisperNode

    for cls in (VadNode, WhisperNode, TranslateNode, MarianTranslateNode, TtsNode):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(None)
    torch_nodes.register_nodes(reg, device="cpu")
    for kind in ("plugin::native::whisper", "plugin::native::nllb", "plugin::native::helsinki",
                 "plugin::native::kokoro", "plugin::native::piper"):
        assert reg.create_node(kind).device == torch.device("cpu")


# -- registry -----------------------------------------------------------------
def _definitions(reg):
    return {d.kind: d for d in reg.definitions()}


PORT_KINDS = [
    "audio::gain", "audio::mixer", "audio::pacer", "audio::resampler", "containers::ogg::demuxer",
    "containers::ogg::muxer", "containers::wav::demuxer", "containers::wav::muxer", "core::file_reader",
    "core::file_writer", "core::json_serialize", "core::pacer", "core::passthrough", "core::sink",
    "core::telemetry_out", "core::telemetry_tap", "core::text_chunker", "plugin::native::helsinki",
    "plugin::native::kokoro", "plugin::native::matcha", "plugin::native::nllb", "plugin::native::piper",
    "plugin::native::sensevoice", "plugin::native::vad", "plugin::native::whisper", "streamkit::http_input",
    "streamkit::http_output",
]
OPUS_KINDS = ["audio::opus::decoder", "audio::opus::encoder"]  # where libopus loads


def test_port_registers_exactly_the_ported_kinds(registries):
    from streamkit_tpu_torch.nodes.codecs import opus_available

    want = sorted(PORT_KINDS + (OPUS_KINDS if opus_available() else []))
    assert registries["torch"].kinds() == want


# the JAX registry's kinds the port has not ported: host nodes only (the
# script node, the WebM muxer, the MP3 / FLAC decoders, HTTP and MoQ transport)
HOST_KINDS_TO_PORT = [
    "audio::flac::decoder", "audio::mp3::decoder", "containers::webm::muxer", "core::script",
    "transport::http::fetcher", "transport::moq::peer", "transport::moq::publisher", "transport::moq::subscriber",
]


def test_only_host_kinds_are_missing_from_the_port(registries):
    """Every device model of the JAX registry is registered by the port (27
    kinds, 29 where libopus loads); the JAX kinds still missing are the 8
    host kinds above (those the JAX package registers here: its codec kinds
    need their libraries, as the port's Opus kinds do)."""
    from streamkit_tpu_torch.nodes.codecs import opus_available

    jax_kinds, port_kinds = set(registries["jax"].kinds()), set(registries["torch"].kinds())
    assert len(port_kinds) == (29 if opus_available() else 27)
    assert port_kinds <= jax_kinds
    assert jax_kinds - port_kinds == set(HOST_KINDS_TO_PORT) & jax_kinds


@pytest.mark.parametrize("kind", PORT_KINDS + OPUS_KINDS)
def test_registered_kind_exists_in_jax_with_equal_pins(registries, kind):
    jd, td = _definitions(registries["jax"]), _definitions(registries["torch"])
    if kind in OPUS_KINDS and kind not in td:
        pytest.skip("libopus unavailable: the Opus kinds are not registered")
    assert kind in jd and kind in td
    assert td[kind].input_pins == jd[kind].input_pins
    assert td[kind].output_pins == jd[kind].output_pins
    assert td[kind].supports_dynamic_pins == jd[kind].supports_dynamic_pins
    assert td[kind].description == jd[kind].description


# -- VAD node ------------------------------------------------------------------
def two_utterance_wav(rate=16000) -> bytes:
    from streamkit_tpu_torch.utils.speechsynth import synth_speech_with_plan

    x = np.zeros(rate * 5, dtype=np.float32)
    for start, seed in ((0.6, 3), (2.8, 4)):
        utt, _ = synth_speech_with_plan(1.0, rate, seed=seed, pause_range=(0.01, 0.02), utt_range=(0.9, 0.95),
                                        lead_silence_s=0.0)
        i = int(start * rate)
        x[i : i + min(len(utt), rate)] = utt[:rate]
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((x * 32767).astype("<i2").tobytes())
    return buf.getvalue()


@pytest.mark.parametrize(
    "params,sink",
    [({}, ("core::json_serialize", {"newline_delimited": True})),
     ({"min_silence_duration_s": 0.4, "threshold": 0.4}, ("core::json_serialize", {"newline_delimited": True})),
     ({"output_mode": "filtered_audio"}, ("containers::wav::muxer", None))],
    ids=["events", "second-aliases", "filtered-audio"],
)
def test_vad_node_output_equal_jax(registries, params, sink):
    doc = {"mode": "oneshot", "steps": [
        {"kind": "streamkit::http_input"},
        {"kind": "containers::wav::demuxer", "params": {"frame_samples_per_channel": 480}},
        {"kind": "plugin::native::vad", "params": params},
        {"kind": sink[0], **({"params": sink[1]} if sink[1] else {})},
        {"kind": "streamkit::http_output"},
    ]}
    body = two_utterance_wav()
    out = {}
    for pkg, (api, _, engine, _) in PACKAGES.items():
        async def main(api=api, engine=engine, pkg=pkg):
            async def stream():
                yield body

            r = await engine.run_oneshot_pipeline(registries[pkg], api.compile_pipeline_dict(doc),
                                                  input_stream=stream())
            return await r.read_all()

        out[pkg] = asyncio.run(main())
    assert out["torch"] == out["jax"]
    if sink[0] == "core::json_serialize":
        events = [json.loads(ln) for ln in out["torch"].decode().splitlines() if ln]
        assert len(events) >= 1
        assert all(e["Custom"]["data"]["event"] == "segment" for e in events)
    else:
        assert len(out["torch"]) > 44 + 2 * 16000 // 2  # at least half a second of speech


def test_vad_unknown_output_mode():
    """The port refuses an unknown ``output_mode`` with a ConfigurationError;
    the reference's node names ConfigurationError without importing it, so
    it raises NameError there (ROADMAP §3)."""
    from streamkit_tpu.nodes.ml.vad_node import VadNode as JaxVad
    from streamkit_tpu_torch.nodes.ml.vad_node import VadNode

    with pytest.raises(torch_core.ConfigurationError, match="output_mode"):
        VadNode({"output_mode": "bogus"}, device="cpu")
    with pytest.raises(NameError):
        JaxVad({"output_mode": "bogus"})
