# SPDX-License-Identifier: Apache-2.0
"""The port's Kokoro TTS (``models/kokoro.py``, the ``kokoro`` backend of
``nodes/ml/tts_node.py``) against the JAX package's, on the CPU at f32.

The model is ``samples/kokoro-golden`` as a model dir: hidden 512, style
256, 2 voices, the pack's 32 tokens, random weights from ``PRNGKey(0)``
(drawn by both packages to the same bits). Durations (frames per token) are
equal exactly; audio agrees within 1e-5 (measured: 4.5e-7 at a 0.4 peak;
the two libraries order their sums differently); the node's 16-bit output
within one step.
"""

import asyncio
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamkit_tpu.models import kokoro as jk
from streamkit_tpu_torch.models import kokoro as tk

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "samples", "kokoro-golden")
ATOL = 1e-5
TEXTS = ["hello there, this is a test of kokoro.", "the quick brown fox", "a", "speech on the port!"]


@pytest.fixture(scope="module")
def models():
    """(jax cfg, params, tokens, voices), (the port's, on the CPU)."""
    return jk.load_kokoro_dir(GOLDEN), tk.load_kokoro_dir(GOLDEN, device="cpu")


def rows(cfg, tokens, voices, texts, speaker=0):
    """Bucketed token rows, masks and style rows of ``texts`` (one bucket)."""
    ids = [tokens.encode(t) for t in texts]
    tok, mask = zip(*(tk.kokoro_token_row(i, cfg) for i in ids))
    style = [voices[speaker][min(len(i), voices.shape[1] - 1)] for i in ids]
    return ids, np.stack(tok), np.stack(mask), np.stack(style).astype(np.float32)


def test_tokens_and_voices_parse_equal(models):
    (jcfg, _, jtok, jvoices), (tcfg, _, ttok, tvoices) = models
    assert jcfg == jk.KokoroConfig(**tcfg.__dict__) and tcfg.n_tokens == 32
    assert ttok.table == jtok.table and len(ttok.table) == 32
    for text in TEXTS + ["ab  cd", "zzz", ""]:
        assert ttok.encode(text) == jtok.encode(text)
    assert tvoices.shape == jvoices.shape == (2, tk.STYLE_ROWS, tk.STYLE_DIM)
    assert np.array_equal(tvoices, jvoices)


def test_voices_bin_refuses_a_partial_pack(tmp_path):
    np.zeros(1000, "<f4").tofile(tmp_path / "voices.bin")
    for mod in (jk, tk):
        with pytest.raises(ValueError, match="multiple"):
            mod.load_voices_bin(str(tmp_path / "voices.bin"))


def test_durations_equal_and_core_audio_within_tolerance(models):
    """Four sentences in one 64-token bucket: the duration ints equal the
    reference's (row by row through ``vmap``), and ``_kokoro_core``'s audio
    and F0 are within 1e-5 at the 512-frame bucket."""
    (jcfg, jp, jtok, jv), (tcfg, tp, _, _) = models
    ids, tok, mask, style = rows(tcfg, jtok, jv, TEXTS)
    want = np.asarray(jk.kokoro_durations_batch(jp, jcfg, jnp.asarray(tok), jnp.asarray(mask), jnp.asarray(style)))
    with torch.inference_mode():
        got = tk.kokoro_durations_batch(tp, tcfg, *map(torch.as_tensor, (tok, mask, style)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert all(want[r, len(i):].sum() == 0 and want[r, : len(i)].min() >= 1 for r, i in enumerate(ids))
    fr = [tk.kokoro_frames(want[r], len(i), 1.0) for r, i in enumerate(ids)]
    f_pad = max(len(f[0]) for f in fr)
    fi = np.stack([np.pad(f[0], (0, f_pad - len(f[0]))) for f in fr])
    fm = np.stack([np.pad(f[1], (0, f_pad - len(f[1]))) for f in fr])
    aj, f0j = jk.kokoro_core_batch(jp, jcfg, *map(jnp.asarray, (tok, mask, style, fi, fm)), f_pad)
    with torch.inference_mode():
        at, f0t = tk.kokoro_core_batch(tp, tcfg, *map(torch.as_tensor, (tok, mask, style, fi, fm)), f_pad)
    assert at.shape == aj.shape == (4, f_pad * tk.HOP + 480)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=ATOL)
    np.testing.assert_allclose(f0t.numpy(), np.asarray(f0j), atol=ATOL)


def test_batched_rows_equal_single_rows(models):
    """The batcher's contract: a row of a 4-row call equals the row alone
    (durations exactly, audio within 1e-5)."""
    (_, _, jtok, jv), (tcfg, tp, _, _) = models
    _, tok, mask, style = rows(tcfg, jtok, jv, TEXTS)
    fi = np.random.RandomState(0).randint(0, 20, (4, 64)).astype(np.int32)
    fm = np.ones((4, 64), np.float32)
    fm[2, 30:] = 0
    args = [torch.as_tensor(a) for a in (tok, mask, style, fi, fm)]
    with torch.inference_mode():
        dur = tk.kokoro_durations_batch(tp, tcfg, *args[:3])
        audio, _ = tk.kokoro_core_batch(tp, tcfg, *args, 64)
        for r in range(4):
            one = [a[r:r + 1] for a in args]
            assert torch.equal(tk.kokoro_durations_batch(tp, tcfg, *one[:3])[0], dur[r])
            np.testing.assert_allclose(tk.kokoro_core_batch(tp, tcfg, *one, 64)[0][0].numpy(), audio[r].numpy(),
                                       atol=ATOL)


@pytest.mark.parametrize("speed", [1.0, 1.3, 0.5])
def test_synthesize_matches_jax(models, speed):
    (jcfg, jp, jtok, jv), (tcfg, tp, _, tv) = models
    ids = jtok.encode(TEXTS[1])
    want = jk.kokoro_synthesize(jp, jcfg, ids, jv[1], speed=speed)
    got = tk.kokoro_synthesize(tp, tcfg, ids, tv[1], speed=speed)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert tk.kokoro_synthesize(tp, tcfg, [], tv[0]).shape == (0,)


def test_a_sentence_past_512_frames_is_cut_in_both(models):
    """The reference keeps the first 512 frames (2.56 s) of a longer
    sentence (``kokoro.py:326-333``, ``fi[:n] = frame_idx[:f_pad]`` with the
    frame bucket capped at 512); the port follows it. This sentence needs
    more than 512 frames and both give exactly 512 · 120 samples."""
    (jcfg, jp, jtok, jv), (tcfg, tp, _, tv) = models
    ids = jtok.encode(TEXTS[0])
    tok, mask = tk.kokoro_token_row(ids, tcfg)
    style = jv[0][len(ids)]
    dur = np.asarray(jk._predict_durations(jp, jcfg, jnp.asarray(tok), jnp.asarray(mask), jnp.asarray(style)))
    need = int(dur.sum())
    fi, fm, kept = tk.kokoro_frames(dur, len(ids), 1.0)
    assert need > 512 and kept == 512 == len(fi) and fm.sum() == 512
    want = jk.kokoro_synthesize(jp, jcfg, ids, jv[0])
    got = tk.kokoro_synthesize(tp, tcfg, ids, tv[0])
    assert want.shape == got.shape == (512 * tk.HOP,)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_weights_npz_override(models, tmp_path):
    """A ``weights.npz`` of '/'-joined keys loads over the random init in
    both packages (a key absent keeps its random value); a wrong shape is
    refused."""
    dst = tmp_path / "pack"
    shutil.copytree(GOLDEN, dst)
    rng = np.random.RandomState(3)
    conv = (rng.randn(5, 512, 512) * 0.01).astype(np.float32)
    np.savez(dst / "weights.npz", embed=np.ones((40, 512), np.float32), **{"text_convs/1/w": conv})
    jcfg, jp, jtok, jv = jk.load_kokoro_dir(str(dst))
    tcfg, tp, _, tv = tk.load_kokoro_dir(str(dst), device="cpu")
    assert tcfg.n_tokens == jcfg.n_tokens == 40
    assert float(tp["embed"].min()) == float(tp["embed"].max()) == 1.0
    assert np.array_equal(tp["text_convs"][1]["w"].numpy(), conv.transpose(2, 1, 0))
    assert torch.equal(tp["text_convs"][0]["w"], models[1][1]["text_convs"][0]["w"])
    ids = jtok.encode(TEXTS[3])
    np.testing.assert_allclose(tk.kokoro_synthesize(tp, tcfg, ids, tv[0]),
                               jk.kokoro_synthesize(jp, jcfg, ids, jv[0]), atol=ATOL)
    np.savez(dst / "weights.npz", **{"dec_convs/0/w": np.zeros((5, 512, 511), np.float32)})
    with pytest.raises(ValueError, match="weights.npz"):
        tk.load_kokoro_dir(str(dst), device="cpu")


# -- the node -------------------------------------------------------------------
SENTENCES = ["Hello there. A first", " chunk, then more!", " the quick brown fox"]


def run_node(pkg, params, texts, resources, batcher=None, n_sessions=1):
    """``n_sessions`` concurrent ``plugin::native::kokoro`` nodes made by
    ``pkg``'s registry, fed ``texts`` → each one's audio (float32) and
    sample rate."""
    import importlib

    core = importlib.import_module(f"{pkg}.core")
    nodes = importlib.import_module(f"{pkg}.nodes")
    reg = core.NodeRegistry()
    nodes.register_nodes(reg, device="cpu") if pkg.endswith("torch") else nodes.register_nodes(reg)

    async def main():
        outs = [None] * n_sessions
        if batcher is not None:
            batcher.start()

        async def one(i):
            node = reg.create_node("plugin::native::kokoro", params)
            in_ch, out_ch = core.Channel(16), core.Channel(8192)
            ctx = core.NodeContext(node_name=f"t{i}", inputs={"in": in_ch},
                                   output=core.OutputSender(f"t{i}", direct={"out": out_ch}),
                                   batcher=batcher, resources=resources[pkg])
            task = asyncio.ensure_future(node.run(ctx))
            for text in texts:
                await in_ch.send(core.Packet.new_text(text))
            in_ch.close()
            await task
            out_ch.close()
            chunks, rate = [], None
            while (pkt := await out_ch.recv_optional()) is not None:
                chunks.append(np.asarray(pkt.audio.samples, np.float32))
                rate = pkt.audio.format.sample_rate
            outs[i] = (np.concatenate(chunks), rate)

        try:
            await asyncio.gather(*(one(i) for i in range(n_sessions)))
        finally:
            if batcher is not None:
                batcher.stop()
        return outs

    return asyncio.run(main())


@pytest.fixture(scope="module")
def resources():
    """One model cache per package for the node tests (the model loads once)."""
    import streamkit_tpu.core as jcore
    import streamkit_tpu_torch.core as tcore

    return {"streamkit_tpu": jcore.ResourceManager(), "streamkit_tpu_torch": tcore.ResourceManager()}


@pytest.mark.parametrize("params", [{"model_dir": GOLDEN, "speaker_id": 1},
                                    {"model_dir": GOLDEN, "backend": "kokoro", "speed": 1.5}],
                         ids=["auto", "kokoro-speed"])
def test_kokoro_node_matches_jax_with_and_without_a_batcher(resources, params):
    """The node on the golden pack (``auto`` picks ``kokoro`` by
    ``voices.bin``): 24 kHz, the JAX node's samples count, audio within
    1e-5; through the port's ``DeviceBatcher`` two sessions share its
    ``kokoro_dur:`` / ``kokoro_core:`` kinds and give the JAX node's
    batched audio."""
    from streamkit_tpu.engine.batcher import DeviceBatcher as JaxBatcher
    from streamkit_tpu_torch.engine import DeviceBatcher
    from streamkit_tpu_torch.nodes.ml.tts_node import TtsNode

    assert TtsNode(params, device="cpu")._pick_backend() == "kokoro"
    (want, rate_j), = run_node("streamkit_tpu", params, SENTENCES, resources)
    (got, rate_t), = run_node("streamkit_tpu_torch", params, SENTENCES, resources)
    assert rate_t == rate_j == 24000 and got.shape == want.shape and len(got) > 24000
    np.testing.assert_allclose(got, want, atol=ATOL)
    (want_b, _), = run_node("streamkit_tpu", params, SENTENCES, resources, batcher=JaxBatcher(tick_ms=20.0))
    tb = DeviceBatcher(tick_ms=100.0, device="cpu")  # a tick wide enough that both sessions share it
    outs = run_node("streamkit_tpu_torch", params, SENTENCES, resources, batcher=tb, n_sessions=2)
    for got_b, _ in outs:
        assert got_b.shape == want_b.shape == want.shape
        np.testing.assert_allclose(got_b, want_b, atol=ATOL)
    kinds = tb.stats()["kinds"]
    tag = f"{GOLDEN}:{params.get('speaker_id', 0)}:{params.get('speed', 1.0)}"
    assert {k.rsplit(":", 1 if k.startswith("kokoro_dur") else 2)[0] for k in kinds} == {
        f"kokoro_dur:{tag}", f"kokoro_core:{tag}"}
    assert sum(v["items"] for v in kinds.values()) == 12 > sum(v["calls"] for v in kinds.values())


def test_kokoro_node_refuses_a_speaker_past_the_pack(resources):
    """``speaker_id`` 5 passes the reference's 0–102 check but the golden
    pack has 2 voices: both nodes fail when they load it."""
    import streamkit_tpu.core as jcore
    import streamkit_tpu_torch.core as tcore

    for pkg, err in (("streamkit_tpu", jcore.ConfigurationError), ("streamkit_tpu_torch", tcore.ConfigurationError)):
        with pytest.raises(err, match="out of range"):
            run_node(pkg, {"model_dir": GOLDEN, "speaker_id": 5}, ["hello."], resources)
    with pytest.raises(tcore.ConfigurationError, match="requires a model dir"):
        run_node("streamkit_tpu_torch", {"backend": "kokoro"}, ["hello."], resources)


def test_text_to_speech_sample_matches_jax(resources):
    """``samples/pipelines/system/text_to_speech.yml`` as written (text →
    chunker → kokoro → 48 kHz resampler → Opus → Ogg), its kokoro step given
    the golden pack: both packages' Ogg streams decode to PCM of one length,
    every 16-bit sample within one step."""
    from streamkit_tpu_torch.nodes.codecs import opus_available

    if not opus_available():
        pytest.skip("libopus unavailable: the sample's Opus encoder does not register")
    import yaml

    from streamkit_tpu_torch.nodes.codecs.opus import OpusDecoder
    from streamkit_tpu_torch.nodes.containers.ogg import OggPageReader
    from test_torch_oneshot import PACKAGES

    with open(os.path.join(REPO, "samples", "pipelines", "system", "text_to_speech.yml")) as f:
        doc = yaml.safe_load(f)
    for step in doc["steps"]:
        if step["kind"] == "plugin::native::kokoro":
            step["params"] = dict(step.get("params") or {}, model_dir=GOLDEN)
    body = b"Hello from the port. This is a second sentence."
    pcm = {}
    for pkg, name in (("jax", "streamkit_tpu"), ("torch", "streamkit_tpu_torch")):
        api, core, engine, nodes = PACKAGES[pkg]
        reg = core.NodeRegistry()
        nodes.register_nodes(reg, device="cpu") if pkg == "torch" else nodes.register_nodes(reg)

        async def main(reg=reg, api=api, engine=engine, name=name):
            async def stream():
                yield body

            res = await engine.run_oneshot_pipeline(reg, api.compile_pipeline_dict(doc), input_stream=stream(),
                                                    resources=resources[name])
            return res.content_type, await res.read_all()

        ctype, ogg = asyncio.run(main())
        assert ctype == "audio/ogg" and ogg[:4] == b"OggS"
        packets = [p for p, _ in OggPageReader().feed(ogg) if not p.startswith((b"OpusHead", b"OpusTags"))]
        dec = OpusDecoder(48000, 1)
        pcm[pkg] = np.concatenate([dec.decode(p) for p in packets])
    assert pcm["torch"].shape == pcm["jax"].shape and pcm["torch"].size > 48000
    diff = np.abs(pcm["torch"].astype(np.float64) - pcm["jax"].astype(np.float64)) * 32768
    assert diff.max() <= 1.0
