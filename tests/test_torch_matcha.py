# SPDX-License-Identifier: Apache-2.0
"""The port's Matcha-TTS (``models/matcha.py``, ``nodes/ml/matcha_node.py``)
against the JAX package's, on the CPU at f32.

Both packages draw the same random init (numpy ``default_rng``) and the same
ODE noise (``jax.random.normal``, reproduced by ``utils/jax_prng.py``). The
frame counts are equal exactly; encoder means and log-durations agree
within 1e-5, mels within 1e-4 (measured 3.6e-6 at a 5.7 peak after 10 Euler
steps), the node's audio within 1e-4.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamkit_tpu.models import matcha as jm
from streamkit_tpu_torch.models import matcha as tm

torch.set_num_threads(2)

NODE_CFG = dict(vocab_size=256, d_model=64, heads=2, enc_layers=2, ffn_dim=128, dec_channels=64, dec_layers=2)
# the published widths (d 192, 2 heads, ffn 768, 80 mels, decoder 256), cut to 2 layers each
FULL_2 = dict(enc_layers=2, dec_layers=2)


def pair(**kw):
    jc, tc = jm.MatchaConfig(**kw), tm.MatchaConfig(**kw)
    return (jc, jm.matcha_init_params(jc, 0)), (tc, tm.matcha_init_params(tc, 0, device="cpu"))


def batch(vocab, lengths=(32, 20, 7), t=32, seed=0):
    ids = np.random.RandomState(seed).randint(0, vocab, (len(lengths), t)).astype(np.int32)
    mask = np.zeros((len(lengths), t), np.float32)
    for r, n in enumerate(lengths):
        mask[r, :n] = 1
        ids[r, n:] = 0
    return ids, mask


@pytest.mark.parametrize("cfg", [NODE_CFG, FULL_2, dict(n_speakers=3)], ids=["node", "full-2", "published"])
def test_init_equals_jax(cfg):
    """Every leaf, convolution weights in PyTorch's layout (the reference's
    ``[k, in, out]`` → ``[out, in, k]``); at the published widths too."""
    jc, tc = jm.MatchaConfig(**cfg), tm.MatchaConfig(**cfg)
    want = jax.tree_util.tree_flatten_with_path(jm.matcha_init_params(jc, 3))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(tm.matcha_init_params(tc, 3, device="cpu"))[0])
    assert len(want) == len(got)
    for path, w in want:
        w = np.asarray(w)
        assert np.array_equal(w.transpose(2, 1, 0) if w.ndim == 3 else w, got[path].numpy()), path


@pytest.mark.parametrize("cfg", [NODE_CFG, FULL_2], ids=["node", "full-2"])
def test_encode_matches_jax_and_a_padded_row_equals_it_alone(cfg):
    """Means and log-durations of a masked batch within 1e-5 of the JAX
    package's; each row of the batch within 1e-5 of the row unpadded."""
    (jc, jp), (tc, tp) = pair(**cfg)
    ids, mask = batch(jc.vocab_size)
    mu_j, d_j = jm._encode(jp, jc, jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        mu_t, d_t = tm._encode(tp, tc, torch.as_tensor(ids), torch.as_tensor(mask))
        np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-5)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
        for r, n in enumerate((32, 20, 7)):
            mu1, d1 = tm._encode(tp, tc, torch.as_tensor(ids[r:r + 1, :n]))
            np.testing.assert_allclose(mu1[0].numpy(), mu_t[r, :n].numpy(), atol=1e-5)
            np.testing.assert_allclose(d1[0].numpy(), d_t[r, :n].numpy(), atol=1e-5)


@pytest.mark.parametrize("cfg,frames,kw", [
    (NODE_CFG, 256, dict(length_scale=1.1)),
    (NODE_CFG, 64, dict(noise_scale=0.3, seed=5, ode_steps=4)),
    (FULL_2, 128, dict(speaker_id=0)),
], ids=["node", "node-cut", "full-2"])
def test_synthesize_mel_matches_jax(cfg, frames, kw):
    """Mel within 1e-4 and ``n_frames`` equal (64 frames cut the longest
    row), and a row alone equal to its row of the batch (one noise pattern
    over the rows)."""
    (jc, jp), (tc, tp) = pair(**cfg)
    ids, mask = batch(jc.vocab_size, seed=1)
    mel_j, n_j = jm.matcha_synthesize_mel(jp, jc, jnp.asarray(ids), frames, mask=jnp.asarray(mask), **kw)
    with torch.inference_mode():
        mel_t, n_t = tm.matcha_synthesize_mel(tp, tc, torch.as_tensor(ids), frames, mask=torch.as_tensor(mask), **kw)
        one, n1 = tm.matcha_synthesize_mel(tp, tc, torch.as_tensor(ids[1:2]), frames,
                                           mask=torch.as_tensor(mask[1:2]), **kw)
    assert n_t.dtype == torch.int32 and np.array_equal(n_t.numpy(), np.asarray(n_j)) and int(n_t.min()) > 0
    assert mel_t.shape == (3, frames, 80)
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_j), atol=1e-4)
    assert int(n1[0]) == int(n_t[1])
    np.testing.assert_allclose(one[0].numpy(), mel_t[1].numpy(), atol=1e-5)


def test_matcha_params_from_numpy_takes_the_jax_tree():
    (jc, jp), (tc, tp) = pair(**NODE_CFG)
    got = tm.matcha_params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    assert torch.equal(got["dec_blocks"][1]["conv3"]["w"], tp["dec_blocks"][1]["conv3"]["w"])
    with pytest.raises(ValueError, match="config"):
        tm.matcha_params_from_numpy(jax.tree.map(np.asarray, jp), tm.MatchaConfig(**dict(NODE_CFG, enc_layers=3)))


# -- the node -------------------------------------------------------------------
TEXTS = ["Hello there, a first", " sentence. And", " a second one for the port."]


def run_node(pkg, params, texts, batcher=None, n_sessions=1):
    """``n_sessions`` concurrent matcha nodes of ``pkg`` (made through the
    package's registry) fed ``texts`` → each one's audio packets."""
    import importlib

    core = importlib.import_module(f"{pkg}.core")
    nodes = importlib.import_module(f"{pkg}.nodes")
    reg = core.NodeRegistry()
    nodes.register_nodes(reg, device="cpu") if pkg.endswith("torch") else nodes.register_nodes(reg)

    async def main():
        resources = core.ResourceManager()
        outs = [None] * n_sessions
        if batcher is not None:
            batcher.start()

        async def one(i):
            node = reg.create_node("plugin::native::matcha", params)
            in_ch, out_ch = core.Channel(16), core.Channel(1024)
            ctx = core.NodeContext(node_name=f"m{i}", inputs={"in": in_ch},
                                   output=core.OutputSender(f"m{i}", direct={"out": out_ch}),
                                   batcher=batcher, resources=resources)
            task = asyncio.ensure_future(node.run(ctx))
            for text in texts:
                await in_ch.send(core.Packet.new_text(text))
            in_ch.close()
            await task
            out_ch.close()
            outs[i] = []
            while (pkt := await out_ch.recv_optional()) is not None:
                outs[i].append((np.asarray(pkt.audio.samples, np.float32), pkt.audio.format.sample_rate))

        try:
            await asyncio.gather(*(one(i) for i in range(n_sessions)))
        finally:
            if batcher is not None:
                batcher.stop()
        return outs

    return asyncio.run(main())


def test_matcha_node_matches_jax_with_and_without_a_batcher():
    """``plugin::native::matcha`` through both registries (the reference's
    random model, its vocoder at ``HifiGanConfig()``): the same packets
    (one per 10-character chunk), 22.05 kHz, audio within 1e-4; through the
    port's ``DeviceBatcher`` two sessions share one ``matcha:`` call per
    bucket and give the JAX node's batched audio."""
    from streamkit_tpu.engine.batcher import DeviceBatcher as JaxBatcher
    from streamkit_tpu_torch.engine import DeviceBatcher

    params = {"speed": 1.25, "noise_scale": 0.5}
    (want,) = run_node("streamkit_tpu", params, TEXTS)
    (got,) = run_node("streamkit_tpu_torch", params, TEXTS)
    assert len(got) == len(want) == 3
    for (g, rg), (w, rw) in zip(got, want):
        assert rg == rw == 22050 and g.shape == w.shape and g.size > 0
        np.testing.assert_allclose(g, w, atol=1e-4)
    (want_b,) = run_node("streamkit_tpu", params, TEXTS, batcher=JaxBatcher(tick_ms=20.0))
    tb = DeviceBatcher(tick_ms=100.0, device="cpu")
    outs = run_node("streamkit_tpu_torch", params, TEXTS, batcher=tb, n_sessions=2)
    for got_b in outs:
        assert len(got_b) == len(want_b) == 3
        for (g, _), (w, _) in zip(got_b, want_b):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=1e-4)
    kinds = tb.stats()["kinds"]
    assert kinds and all(k.startswith("matcha:") and ":0:10:0.5:0.8:" in k for k in kinds), kinds
    assert sum(v["items"] for v in kinds.values()) == 6 > sum(v["calls"] for v in kinds.values())


def test_matcha_node_refusals_match_jax(tmp_path):
    """A speed outside [0.25, 4], and a model dir (no checkpoint conversion
    is provisioned), are refused by both packages."""
    import streamkit_tpu.core as jcore
    import streamkit_tpu_torch.core as tcore
    from streamkit_tpu.nodes.ml.matcha_node import MatchaTtsNode as JaxNode
    from streamkit_tpu_torch.nodes.ml.matcha_node import MatchaTtsNode

    with pytest.raises(tcore.ConfigurationError, match="speed"):
        MatchaTtsNode({"speed": 5.0}, device="cpu")
    with pytest.raises(jcore.ConfigurationError, match="speed"):
        JaxNode({"speed": 5.0})
    for pkg, err in (("streamkit_tpu", jcore.ConfigurationError), ("streamkit_tpu_torch", tcore.ConfigurationError)):
        with pytest.raises(err, match="checkpoint conversion"):
            run_node(pkg, {"model_dir": str(tmp_path)}, ["hello there, you."])
