# SPDX-License-Identifier: Apache-2.0
"""The port's SenseVoice (``models/sensevoice.py``,
``nodes/ml/sensevoice_node.py``) against the JAX package's, on the CPU.

Both packages draw the same random init (numpy ``default_rng``). At f32 the
logits agree within 1e-4 (measured 2.1e-6 at a 4.0 peak) and the CTC ids are
equal; at bf16 the logits agree within 0.05 (measured 0.012: bf16's step is
0.03 at 4). The node's segments (times, language, text) equal the JAX
node's at f32, with and without a batcher.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamkit_tpu.models import sensevoice as js
from streamkit_tpu_torch.models import sensevoice as ts
from test_torch_tts import pairing_batcher

torch.set_num_threads(2)

SMALL = dict(vocab_size=300, d_model=64, heads=4, ffn_dim=128, layers=2, fsmn_kernel=5)  # the node's random model
# the published widths (d 512, 4 heads, ffn 2048, vocab 25055, 80 mels, LFR 7/6), cut to 2 layers
FULL_2 = dict(layers=2)


@pytest.mark.parametrize("t", [95, 42, 7, 6, 1])
def test_lfr_stack_exact(t):
    """Stacking 7 frames at a hop of 6, the tail padded with the last frame."""
    mel = np.random.RandomState(t).randn(2, t, 80).astype(np.float32)
    want = np.asarray(js.lfr_stack(jnp.asarray(mel), 7, 6))
    got = ts.lfr_stack(torch.as_tensor(mel), 7, 6).numpy()
    assert got.shape == want.shape == (2, (t + 5) // 6, 560) and np.array_equal(got, want)


def logits_pair(cfg_kw, jdt, tdt, t_lfr=16):
    jc, tc = js.SenseVoiceConfig(**cfg_kw), ts.SenseVoiceConfig(**cfg_kw)
    jp, tp = js.sensevoice_init_params(jc, 0, jdt), ts.sensevoice_init_params(tc, 0, tdt, device="cpu")
    rng = np.random.RandomState(0)
    mel = rng.randn(3, t_lfr * 6, 80).astype(np.float32)
    mask = np.ones((3, t_lfr), np.float32)
    mask[1, 10:] = 0
    mask[2, 3:] = 0
    lang, itn = np.asarray([2, 0, 5], np.int32), np.asarray([1, 0, 1], np.int32)
    want = np.asarray(js.sensevoice_logits(jp, jc, *map(jnp.asarray, (mel, mask, lang, itn))), np.float32)
    with torch.inference_mode():
        got = ts.sensevoice_logits(tp, tc, *map(torch.as_tensor, (mel, mask, lang, itn)))
    return got, want, mask


@pytest.mark.parametrize("cfg", [SMALL, FULL_2], ids=["node", "full-2"])
def test_logits_and_ctc_ids_match_jax_at_f32(cfg):
    got, want, mask = logits_pair(cfg, jnp.float32, torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 18, ts.SenseVoiceConfig(**cfg).vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    ids_j = js.ctc_greedy_decode(want[:, 2:], mask.astype(bool))
    assert ts.ctc_greedy_decode(got.numpy()[:, 2:], mask.astype(bool)) == ids_j
    assert ts.ctc_collapse(got[:, 2:].argmax(-1).numpy(), mask.astype(bool)) == ids_j
    assert [len(r) for r in ids_j] != [0, 0, 0]


@pytest.mark.parametrize("cfg", [SMALL, FULL_2], ids=["node", "full-2"])
def test_logits_match_jax_at_bf16(cfg):
    """The node's default dtype: bf16 weights and activations, f32 scores
    and CTC logits, within 0.05 of the JAX package's."""
    got, want, _ = logits_pair(cfg, jnp.bfloat16, torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=0.05)


def test_ctc_greedy_decode_collapses():
    logits = np.full((2, 6, 5), -1.0, np.float32)
    for b, seq in enumerate(([3, 3, 0, 3, 4, 4], [1, 2, 2, 0, 0, 1])):
        for t, k in enumerate(seq):
            logits[b, t, k] = 1.0
    mask = np.ones((2, 6), bool)
    mask[1, 4:] = False
    assert ts.ctc_greedy_decode(logits, mask) == js.ctc_greedy_decode(logits, mask) == [[3, 3, 4], [1, 2]]


# -- the node -------------------------------------------------------------------
def speech(seed=77, secs=3.0):
    from streamkit_tpu_torch.utils.speechsynth import synth_speech_with_plan

    audio, _ = synth_speech_with_plan(secs, 16000, seed=seed, pause_range=(0.8, 0.9), utt_range=(1.0, 1.2))
    return audio.astype(np.float32)


def run_node(pkg, params, audios, batcher=None):
    """One sensevoice node of ``pkg`` (through its registry) per entry of
    ``audios``, all at once, fed 20 ms frames → each one's Transcription
    segments as ``(text, language, start_ms, end_ms)``."""
    import importlib

    core = importlib.import_module(f"{pkg}.core")
    nodes = importlib.import_module(f"{pkg}.nodes")
    reg = core.NodeRegistry()
    nodes.register_nodes(reg, device="cpu") if pkg.endswith("torch") else nodes.register_nodes(reg)

    async def main():
        resources = core.ResourceManager()
        if batcher is not None:
            batcher.start()

        async def one(i, audio):
            node = reg.create_node("plugin::native::sensevoice", params)
            in_ch, out_ch = core.Channel(1024), core.Channel(64)
            ctx = core.NodeContext(node_name=f"sv{i}", inputs={"in": in_ch},
                                   output=core.OutputSender(f"sv{i}", direct={"out": out_ch}),
                                   batcher=batcher, resources=resources)
            task = asyncio.ensure_future(node.run(ctx))
            fmt = core.AudioFormat(16000, 1)
            for j in range(len(audio) // 320):
                await in_ch.send(core.Packet.new_audio(core.AudioFrame(audio[j * 320:(j + 1) * 320], fmt)))
            in_ch.close()
            await task
            out_ch.close()
            out = []
            while (pkt := await out_ch.recv_optional()) is not None:
                tr = pkt.transcription
                (seg,) = tr.segments
                out.append((tr.text, tr.language, seg.start_time_ms, seg.end_time_ms))
            return out

        try:
            return await asyncio.gather(*(one(i, a) for i, a in enumerate(audios)))
        finally:
            if batcher is not None:
                batcher.stop()

    return asyncio.run(main())


@pytest.mark.parametrize("params", [{"language": "en", "min_silence_duration_ms": 400, "dtype": "float32"},
                                    {"language": "yue", "use_itn": False, "dtype": "float32"}],
                         ids=["en", "yue-no-itn"])
def test_sensevoice_node_matches_jax_with_and_without_a_batcher(params):
    """Segments equal to the JAX node's (VAD-gated, the text the random
    model's raw CTC ids); through the port's ``DeviceBatcher`` two sessions
    share ``sensevoice:`` calls (each kind expects two submissions a call,
    ``pairing_batcher``) and give the JAX node's batched segments."""
    from streamkit_tpu.engine.batcher import DeviceBatcher as JaxBatcher
    from streamkit_tpu_torch.engine import DeviceBatcher

    audio = speech()
    (want,) = run_node("streamkit_tpu", params, [audio])
    (got,) = run_node("streamkit_tpu_torch", params, [audio])
    assert got == want and len(got) >= 1 and got[0][0]
    other = speech(seed=78)
    want_b = run_node("streamkit_tpu", params, [audio, other], batcher=JaxBatcher(tick_ms=20.0))
    tb = pairing_batcher(DeviceBatcher)
    got_b = run_node("streamkit_tpu_torch", params, [audio, other], batcher=tb)
    # a batched segment is zero-padded to its sample bucket, so its text may
    # differ from the unbatched one; its times may not
    assert got_b == want_b and [x[1:] for x in got_b[0]] == [x[1:] for x in want]
    kinds = tb.stats()["kinds"]
    lang = params["language"]
    assert kinds and all(k.startswith("sensevoice:") and f":{lang}:{int(params.get('use_itn', True))}:" in k
                         for k in kinds)
    assert sum(v["items"] for v in kinds.values()) == len(got_b[0]) + len(got_b[1])
    assert sum(v["calls"] for v in kinds.values()) < sum(v["items"] for v in kinds.values())


def write_npz(path, cfg_kw, **arrays):
    np.savez(path / "sensevoice.npz", config=np.asarray(cfg_kw, dtype=object), **arrays)


def test_sensevoice_npz_weights_are_applied(tmp_path):
    """A reference fault the port refuses: the JAX node reads ``config`` and
    ``pieces`` from ``sensevoice.npz`` and returns the random init, so a
    weight key in the file is ignored (``sensevoice_node.py:113-122``). The
    port applies it. A config-only file gives both packages one model: the
    same segments, their text joined from ``pieces``."""
    params = {"model_dir": str(tmp_path), "language": "en", "min_silence_duration_ms": 400, "dtype": "float32"}
    audio = speech()
    pieces = np.asarray(["<blank>"] + [f"▁w{i}" for i in range(299)], dtype=object)
    write_npz(tmp_path, SMALL, pieces=pieces)
    (want,) = run_node("streamkit_tpu", params, [audio])
    (got,) = run_node("streamkit_tpu_torch", params, [audio])
    assert got == want and want and all(t.startswith("w") for t, *_ in want)
    bias = np.zeros(300, np.float32)
    bias[7] = 1e4  # every frame's argmax is token 7: one id per segment
    write_npz(tmp_path, SMALL, pieces=pieces, **{"ctc/b": bias})
    (ignored,) = run_node("streamkit_tpu", params, [audio])
    (applied,) = run_node("streamkit_tpu_torch", params, [audio])
    assert ignored == want  # the reference drops the weight
    assert [t for t, *_ in applied] == ["w6"] * len(want)
    assert [s[1:] for s in applied] == [s[1:] for s in want]
    write_npz(tmp_path, SMALL, **{"layers/1/fsmn": np.zeros((4, 64), np.float32)})
    from streamkit_tpu_torch.nodes.ml.sensevoice_node import load_sensevoice_dir

    with pytest.raises(ValueError, match=r"sensevoice.npz\[layers/1/fsmn\]"):
        load_sensevoice_dir(str(tmp_path), device="cpu")


def test_sensevoice_node_refusals(tmp_path):
    import streamkit_tpu.core as jcore
    import streamkit_tpu_torch.core as tcore
    from streamkit_tpu.nodes.ml.sensevoice_node import SenseVoiceNode as JaxNode
    from streamkit_tpu_torch.nodes.ml.sensevoice_node import SenseVoiceNode

    with pytest.raises(tcore.ConfigurationError, match="unknown language"):
        SenseVoiceNode({"language": "fr"}, device="cpu")
    with pytest.raises(jcore.ConfigurationError, match="unknown language"):
        JaxNode({"language": "fr"})
    assert SenseVoiceNode(None, device="cpu").dtype == torch.bfloat16
    for pkg, err in (("streamkit_tpu", jcore.ConfigurationError), ("streamkit_tpu_torch", tcore.ConfigurationError)):
        with pytest.raises(err, match="no sensevoice.npz"):
            run_node(pkg, {"model_dir": str(tmp_path)}, [speech()])
