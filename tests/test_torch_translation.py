# SPDX-License-Identifier: Apache-2.0
"""The port's translation stack against the JAX package's, on the CPU at f32.

The same numpy parameter tree (the reference's random init, some rows of
the tied embedding scaled so that rows stop at different steps) goes into
both packages; the same seeded source ids go through both. Encoder states
and logits agree within 1e-5 (f32; the two libraries order their sums
differently); greedy and beam tokens and lengths are equal exactly.
Covers ``models/{seq2seq,nllb,marian,sp_tokenizer}.py``,
``nodes/ml/_text_batching.py``, ``translate_node.py`` and ``marian_node.py``.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamkit_tpu.models import marian as jmarian
from streamkit_tpu.models import nllb as jnllb
from streamkit_tpu.models import sp_tokenizer as jsp
from streamkit_tpu_torch.models import marian as tmarian
from streamkit_tpu_torch.models import nllb as tnllb
from streamkit_tpu_torch.models import seq2seq as tseq
from streamkit_tpu_torch.models import sp_tokenizer as tsp

torch.set_num_threads(2)

ATOL = 1e-5
NLLB = dict(vocab_size=96, d_model=32, encoder_layers=2, decoder_layers=2, heads=2, ffn_dim=64, max_positions=64)
MARIAN = dict(vocab_size=64, d_model=32, encoder_layers=2, decoder_layers=2, heads=2, ffn_dim=64,
              max_positions=64, pad_token_id=63, eos_token_id=0, decoder_start_token_id=63)
# rows of the tied NLLB embedding scaled: none; EOS (rows stop at 5 or run
# to the cap); EOS more (every row stops early, so the loop ends early)
NLLB_TWEAKS = {"plain": {}, "mixed-eos": {2: 4.0}, "all-eos": {2: 6.0}}


def nllb_tree(tweak=None):
    tree = jax.tree.map(np.array, jnllb.nllb_init_params(jnllb.NllbConfig(**NLLB), 0))
    for row, k in (tweak or {}).items():
        tree["emb"][row] *= k
    return tree


def marian_tree(eos_bias: float = 4.0):
    """The reference init with every weight 10× and the embedding 200×, so
    decoding depends on the source; an EOS bias makes rows stop at
    different steps."""
    def scale(t):
        if isinstance(t, dict):
            return {k: (v * 10 if k == "w" else scale(v)) for k, v in t.items()}
        return [scale(v) for v in t] if isinstance(t, list) else t

    tree = scale(jax.tree.map(np.array, jmarian.marian_init_params(jmarian.MarianConfig(**MARIAN), 0)))
    tree["emb"] = tree["emb"] * 200
    tree["logits_bias"][0] = eos_bias
    return tree


def pair_nllb(tweak=None):
    tree = nllb_tree(tweak)
    cfg = jnllb.NllbConfig(**NLLB)
    return (cfg, jax.tree.map(jnp.asarray, tree)), (tnllb.NllbConfig(**NLLB),
                                                    tnllb.nllb_params_from_numpy(tree, tnllb.NllbConfig(**NLLB),
                                                                                 device="cpu"))


def pair_marian(eos_bias: float = 4.0):
    tree = marian_tree(eos_bias)
    cfg = jmarian.MarianConfig(**MARIAN)
    tcfg = tmarian.MarianConfig(**MARIAN)
    return (cfg, jax.tree.map(jnp.asarray, tree)), (tcfg, tmarian.marian_params_from_numpy(tree, tcfg, device="cpu"))


def nllb_src(seed=1, b=6, t=9, pad_from=None):
    src = np.random.RandomState(seed).randint(4, 96, size=(b, t)).astype(np.int32)
    if pad_from is not None:
        src[1, pad_from:] = 1
    return src


def marian_src(seed=1, b=6, t=9):
    return np.random.RandomState(seed).randint(2, 60, size=(b, t)).astype(np.int32)


def same(a, b):
    return np.asarray(a).tolist() == (b.tolist() if isinstance(b, torch.Tensor) else np.asarray(b).tolist())


# -- weights -------------------------------------------------------------------
@pytest.mark.parametrize("family", ["nllb", "marian"])
def test_seeded_init_equals_the_reference_init(family):
    """The port's random init draws the reference's numbers: every leaf
    equal bit for bit at f32 (so a node without a checkpoint is the same
    model in both packages); Marian's logits bias stays f32 under bf16."""
    if family == "nllb":
        cfg, ref = tnllb.NllbConfig(**NLLB), jnllb.nllb_init_params(jnllb.NllbConfig(**NLLB), 3)
        got = tnllb.nllb_init_params(cfg, 3, device="cpu")
        bf = tnllb.nllb_init_params(cfg, 3, torch.bfloat16, device="cpu")
    else:
        cfg, ref = tmarian.MarianConfig(**MARIAN), jmarian.marian_init_params(jmarian.MarianConfig(**MARIAN), 3)
        got = tmarian.marian_init_params(cfg, 3, device="cpu")
        bf = tmarian.marian_init_params(cfg, 3, torch.bfloat16, device="cpu")
        assert bf["logits_bias"].dtype == torch.float32
    flat_r, _ = jax.tree_util.tree_flatten(ref)
    flat_g, _ = jax.tree_util.tree_flatten(got)
    assert len(flat_r) == len(flat_g)
    for r, g in zip(flat_r, flat_g):
        assert np.array_equal(np.asarray(r), g.numpy())
    assert bf["emb"].dtype == torch.bfloat16


# -- NLLB ----------------------------------------------------------------------
def test_nllb_encode_and_logits_with_padding():
    (jc, jp), (tc, tp) = pair_nllb(NLLB_TWEAKS["mixed-eos"])
    src = nllb_src(pad_from=5)
    je, jb = jnllb.nllb_encode(jp, jc, jnp.asarray(src))
    te, tb = tnllb.nllb_encode(tp, tc, torch.as_tensor(src))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=ATOL)
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    dec = np.random.RandomState(2).randint(4, 96, size=(6, 5)).astype(np.int32)
    dec[:, 0] = jc.decoder_start_token_id
    dec[2, 3:] = jc.pad_token_id  # pads in the decoder rows move their positions
    jl = jnllb.nllb_decode_logits(jp, jc, jnp.asarray(dec), je, jb)
    tl = tnllb.nllb_decode_logits(tp, tc, torch.as_tensor(dec), te, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_nllb_cached_step_matches_jax():
    """Two cached steps (the forced prefix) then a third: logits within
    1e-5 and the written self K/V equal to the reference's cache."""
    (jc, jp), (tc, tp) = pair_nllb()
    src = nllb_src(pad_from=4)
    je, jb = jnllb.nllb_encode(jp, jc, jnp.asarray(src))
    te, tb = tnllb.nllb_encode(tp, tc, torch.as_tensor(src))
    jcache = jnllb._nllb_init_cache(jp, jc, je, 8)
    tcache = tnllb._nllb_init_cache(tp, tc, te, 8)
    for step, tok in enumerate([2, 5, 17]):
        jl, jcache = jnllb.nllb_decode_step(jp, jc, jnp.full((6,), tok, jnp.int32), jnp.int32(step), jcache, jb)
        tl, tcache = tnllb.nllb_decode_step(tp, tc, torch.full((6,), tok), step, tcache, tb)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for jl_, tl_ in zip(jcache, tcache):
        for a, b in zip(jl_, tl_):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)


@pytest.mark.parametrize("tweak", list(NLLB_TWEAKS))
def test_nllb_greedy_matches_jax(tweak):
    """Tokens and lengths equal: the forced prefix, pad after a row's EOS,
    the stop once every row is done, lengths as the non-pad count."""
    (jc, jp), (tc, tp) = pair_nllb(NLLB_TWEAKS[tweak])
    src = nllb_src(pad_from=6)
    jt, jl = jnllb.nllb_greedy_cached(jp, jc, jnp.asarray(src), 5, max_tokens=12)
    tt, tl = tnllb.nllb_greedy_cached(tp, tc, torch.as_tensor(src), 5, max_tokens=12)
    assert same(jt, tt) and same(jl, tl)
    assert tt.dtype == tl.dtype == torch.int32
    if tweak == "mixed-eos":
        assert len(set(tl.tolist())) > 1  # rows stopped at different steps
    # per-row target languages ride one batch
    langs = np.array([5, 7, 5, 9, 5, 7], np.int32)
    jt, _ = jnllb.nllb_greedy_cached(jp, jc, jnp.asarray(src), jnp.asarray(langs), max_tokens=12)
    tt, _ = tnllb.nllb_greedy_cached(tp, tc, torch.as_tensor(src), torch.as_tensor(langs), max_tokens=12)
    assert same(jt, tt)


@pytest.mark.parametrize("beam", [1, 4])
@pytest.mark.parametrize("tweak", ["plain", "mixed-eos"])
def test_nllb_beam_matches_jax(beam, tweak):
    (jc, jp), (tc, tp) = pair_nllb(NLLB_TWEAKS[tweak])
    src = nllb_src(pad_from=6)
    jt, jl = jnllb.nllb_beam_translate(jp, jc, jnp.asarray(src), 5, max_tokens=10, beam=beam)
    tt, tl = tnllb.nllb_beam_translate(tp, tc, torch.as_tensor(src), 5, max_tokens=10, beam=beam)
    assert same(jt, tt) and same(jl, tl)
    if beam == 1:  # beam 1 is the greedy decode
        g, _ = tnllb.nllb_greedy_cached(tp, tc, torch.as_tensor(src), 5, max_tokens=10)
        assert torch.equal(g, tt)


def test_nllb_cached_matches_eager_and_padded_batch_matches_unpadded():
    (_, _), (tc, tp) = pair_nllb(NLLB_TWEAKS["mixed-eos"])
    src = nllb_src()
    eager = tnllb.nllb_greedy_translate(tp, tc, torch.as_tensor(src), 5, max_tokens=10)
    toks, _ = tnllb.nllb_greedy_cached(tp, tc, torch.as_tensor(src), 5, max_tokens=10)
    for r in range(src.shape[0]):
        pred = [int(t) for t in eager[r, 2:] if t != tc.pad_token_id][:10]
        assert [t for t in toks[r].tolist() if t != tc.pad_token_id] == pred
    # pad-to-bucket + batch must not change a row's decode
    rng = np.random.RandomState(2)
    rows = [rng.randint(4, 96, size=n).astype(np.int32) for n in (6, 11)]
    batch = np.full((2, 16), tc.pad_token_id, np.int32)
    for i, ids in enumerate(rows):
        batch[i, : len(ids)] = ids
    toks_b, _ = tnllb.nllb_greedy_cached(tp, tc, torch.as_tensor(batch), torch.tensor([5, 7]), max_tokens=8)
    for i, (ids, lang) in enumerate(zip(rows, (5, 7))):
        one = np.full((1, 16), tc.pad_token_id, np.int32)
        one[0, : len(ids)] = ids
        toks_1, _ = tnllb.nllb_greedy_cached(tp, tc, torch.as_tensor(one), torch.tensor([lang]), max_tokens=8)
        assert torch.equal(toks_1[0], toks_b[i])


def test_nllb_real_pad_token_before_eos_follows_the_reference():
    """A fault of the reference, kept for parity: ``lengths`` counts the
    non-pad tokens, so a real token equal to ``pad_token_id`` emitted before
    EOS is left out of it (and the node's strip drops it from the text).
    With the pad row of the tied embedding scaled 4×, rows emit pad as a
    real token: both packages report the same tokens and the same short
    lengths."""
    (jc, jp), (tc, tp) = pair_nllb({1: 4.0})
    src = nllb_src()
    jt, jl = jnllb.nllb_greedy_cached(jp, jc, jnp.asarray(src), 5, max_tokens=12)
    tt, tl = tnllb.nllb_greedy_cached(tp, tc, torch.as_tensor(src), 5, max_tokens=12)
    assert same(jt, tt) and same(jl, tl)
    row = tt[0].tolist()
    assert tc.eos_token_id not in row and tc.pad_token_id in row  # no EOS: every token is real
    assert int(tl[0]) < len(row)


def test_nllb_hf_converter_matches_jax():
    """One random HF M2M100 (transformers) converted by both packages: equal
    trees, and logits with a padded source within 1e-5."""
    import transformers

    hf_cfg = transformers.M2M100Config(vocab_size=128, d_model=32, encoder_layers=2, decoder_layers=2,
                                       encoder_attention_heads=2, decoder_attention_heads=2, encoder_ffn_dim=64,
                                       decoder_ffn_dim=64, max_position_embeddings=64)
    torch.manual_seed(0)
    model = transformers.M2M100ForConditionalGeneration(hf_cfg).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    jc, tc = jnllb.nllb_config_from_hf(hf_cfg), tnllb.nllb_config_from_hf(hf_cfg)
    jp, tp = jnllb.nllb_params_from_hf(sd, jc), tnllb.nllb_params_from_hf(sd, tc, device="cpu")
    for r, g in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(tp)):
        assert np.array_equal(np.asarray(r), g.numpy())
    src = np.random.RandomState(0).randint(4, 128, size=(2, 10)).astype(np.int32)
    src[1, 7:] = tc.pad_token_id
    dec = np.full((2, 4), 9, np.int32)
    dec[:, 0] = tc.decoder_start_token_id
    je, jb = jnllb.nllb_encode(jp, jc, jnp.asarray(src))
    te, tb = tnllb.nllb_encode(tp, tc, torch.as_tensor(src))
    np.testing.assert_allclose(tnllb.nllb_decode_logits(tp, tc, torch.as_tensor(dec), te, tb).numpy(),
                               np.asarray(jnllb.nllb_decode_logits(jp, jc, jnp.asarray(dec), je, jb)), atol=ATOL)


# -- Marian --------------------------------------------------------------------
def test_marian_encode_and_logits_with_padding():
    (jc, jp), (tc, tp) = pair_marian()
    src = marian_src()
    src[0, 6:] = jc.pad_token_id
    je, jb = jmarian.marian_encode(jp, jc, jnp.asarray(src))
    te, tb = tmarian.marian_encode(tp, tc, torch.as_tensor(src))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-4)  # post-LN at 200× embeddings
    dec = marian_src(seed=3, t=5)
    dec[:, 0] = jc.decoder_start_token_id
    jl = jmarian.marian_decode_logits(jp, jc, jnp.asarray(dec), je, jb)
    tl = tmarian.marian_decode_logits(tp, tc, torch.as_tensor(dec), te, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


def test_marian_cached_step_matches_jax():
    (jc, jp), (tc, tp) = pair_marian()
    src = marian_src()
    je, jb = jmarian.marian_encode(jp, jc, jnp.asarray(src))
    te, tb = tmarian.marian_encode(tp, tc, torch.as_tensor(src))
    jcache = jmarian._marian_init_cache(jp, jc, je, 6)
    tcache = tmarian._marian_init_cache(tp, tc, te, 6)
    for step, tok in enumerate([63, 7, 30]):
        jl, jcache = jmarian.marian_decode_step(jp, jc, jnp.full((6,), tok, jnp.int32), jnp.int32(step), jcache, jb)
        tl, tcache = tmarian.marian_decode_step(tp, tc, torch.full((6,), tok), step, tcache, tb)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("eos_bias", [0.0, 4.0, 6.0])
def test_marian_greedy_matches_jax(eos_bias):
    (jc, jp), (tc, tp) = pair_marian(eos_bias)
    src = marian_src()
    jt, jl = jmarian.marian_greedy_cached(jp, jc, jnp.asarray(src), max_tokens=12)
    tt, tl = tmarian.marian_greedy_cached(tp, tc, torch.as_tensor(src), max_tokens=12)
    assert same(jt, tt) and same(jl, tl)
    eager = tmarian.marian_greedy_translate(tp, tc, torch.as_tensor(src), max_len=12)
    for r in range(src.shape[0]):
        pred = [int(t) for t in eager[r, 1:] if t != tc.pad_token_id][:12]
        assert [t for t in tt[r].tolist() if t != tc.pad_token_id] == pred


@pytest.mark.parametrize("beam", [1, 4])
@pytest.mark.parametrize("eos_bias", [0.0, 4.0])
def test_marian_beam_matches_jax(beam, eos_bias):
    (jc, jp), (tc, tp) = pair_marian(eos_bias)
    src = marian_src()
    jt, jl = jmarian.marian_beam_translate(jp, jc, jnp.asarray(src), max_tokens=10, beam=beam)
    tt, tl = tmarian.marian_beam_translate(tp, tc, torch.as_tensor(src), max_tokens=10, beam=beam)
    assert same(jt, tt) and same(jl, tl)


def test_marian_hf_converter_matches_jax():
    import transformers

    hf_cfg = transformers.MarianConfig(
        vocab_size=101, d_model=32, encoder_layers=2, decoder_layers=2, encoder_attention_heads=4,
        decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64, max_position_embeddings=64,
        pad_token_id=100, eos_token_id=0, decoder_start_token_id=100, activation_function="swish",
        scale_embedding=True, forced_eos_token_id=None, share_encoder_decoder_embeddings=True,
        tie_word_embeddings=True,
    )
    torch.manual_seed(0)
    model = transformers.MarianMTModel(hf_cfg).eval()
    with torch.no_grad():
        model.final_logits_bias.normal_(0, 0.5)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    jc, tc = jmarian.marian_config_from_hf(hf_cfg), tmarian.marian_config_from_hf(hf_cfg)
    jp, tp = jmarian.marian_params_from_hf(sd, jc), tmarian.marian_params_from_hf(sd, tc, device="cpu")
    for r, g in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(tp)):
        assert np.array_equal(np.asarray(r), g.numpy())
    src = np.random.RandomState(0).randint(1, 99, size=(2, 9)).astype(np.int32)
    src[:, -1] = 0
    jt, _ = jmarian.marian_greedy_cached(jp, jc, jnp.asarray(src), max_tokens=8)
    tt, _ = tmarian.marian_greedy_cached(tp, tc, torch.as_tensor(src), max_tokens=8)
    assert same(jt, tt)


# -- beam search pieces --------------------------------------------------------
def test_top_k_breaks_ties_as_jax():
    """Ties (finished beams carry rows of equal scores) break toward the lower
    index, as ``jax.lax.top_k`` does."""
    x = np.array([[0.0, -1e30, 0.0, 1.0, -1e30, 1.0, 1.0, -1e30]], np.float32)
    for k in (1, 3, 5, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tseq.top_k(torch.as_tensor(x), k)
        assert same(ji, ti) and same(jv, tv)


# -- tokenizer (a copy of the reference's) --------------------------------------
def test_sp_tokenizer_copy_matches(tmp_path):
    pieces = [("<unk>", 0.0, 2), ("</s>", 0.0, 3), ("<pad>", 0.0, 3)] + [
        (p, -float(i), 1) for i, p in enumerate(["▁hello", "▁world", "▁he", "llo", "▁", "h", "e", "l", "o", "w", "r",
                                                  "d", "▁wor", "ld"])]
    path = str(tmp_path / "m.spm")
    tsp.write_model(path, pieces, unk_id=0, eos_id=1, pad_id=2)
    jm, tm = jsp.SentencePieceModel.load(path), tsp.SentencePieceModel.load(path)
    for text in ["hello world", "  hello   there world ", "held", "wold rod"]:
        assert tm.encode(text) == jm.encode(text)
        assert tm.decode(tm.encode(text)) == jm.decode(jm.encode(text))
    assert (tm.unk_id, tm.eos_id, tm.pad_id, tm.vocab_size) == (jm.unk_id, jm.eos_id, jm.pad_id, jm.vocab_size)


# -- BucketedGreedy --------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 15, 16, 17, 40, 64, 100, 300])
def test_bucketed_greedy_buckets_and_kind_names(n):
    """Pow-2 source buckets (at least 16, clamped to the position table) and
    the batcher kind ``{kind_tag}:{bucket}`` of the reference."""
    from streamkit_tpu.nodes.ml._text_batching import BucketedGreedy as JB
    from streamkit_tpu_torch.engine import DeviceBatcher
    from streamkit_tpu_torch.nodes.ml._text_batching import BucketedGreedy as TB

    calls = []

    def decode(src, tgt):
        calls.append(tuple(src.shape))
        return torch.zeros((src.shape[0], 4), dtype=torch.int32), torch.full((src.shape[0],), 2, dtype=torch.int32)

    ids = list(range(4, 4 + n))
    jb = JB("tag", 256, 1, lambda s, t: (s[:, :4], s[:, 0]))
    tb = TB("tag", 256, 1, decode, device="cpu")
    jt, jpad = jb._bucketed(ids)
    tt, tpad = tb._bucketed(ids)
    assert jt == tt and np.array_equal(jpad, tpad)
    assert tb.max_batch == jb.max_batch == 16

    async def main():
        batcher = DeviceBatcher(device="cpu")
        out = await asyncio.gather(*(tb.run_batched(batcher, ids, np.int32(3)) for _ in range(3)))
        kinds = list(batcher.stats()["kinds"])
        batcher.stop()
        return out, kinds

    out, kinds = asyncio.run(main())
    assert kinds == [f"tag:{tt}"]
    assert all(n_ == 2 for _, n_ in out)
    assert tb.run_single(ids, np.int32(3))[1] == 2
    assert calls[0][1] == tt and calls[-1] == (1, tt)


# -- the nodes -------------------------------------------------------------------
TEXTS = ["the same sentence for every concurrent session", "hola", "a third, longer line of text to translate "
         "which needs a bigger bucket than the others do"]


def run_node(pkg, kind, params, texts, batcher=None, n_sessions=1, device="cpu"):
    """``n_sessions`` concurrent nodes of ``kind``, each fed ``texts`` → the
    Text packets each emits."""
    import importlib

    core = importlib.import_module(f"{pkg}.core")
    mod, cls = {"plugin::native::nllb": ("translate_node", "TranslateNode"),
                "plugin::native::helsinki": ("marian_node", "MarianTranslateNode")}[kind]
    node_cls = getattr(importlib.import_module(f"{pkg}.nodes.ml.{mod}"), cls)

    async def main():
        resources = core.ResourceManager()
        outs = [None] * n_sessions

        async def one(i):
            node = node_cls(params, device=device) if pkg.endswith("torch") else node_cls(params)
            in_ch, out_ch = core.Channel(16), core.Channel(64)
            ctx = core.NodeContext(node_name=f"tr{i}", inputs={"in": in_ch},
                                   output=core.OutputSender(f"tr{i}", direct={"out": out_ch}),
                                   batcher=batcher, resources=resources)
            task = asyncio.ensure_future(node.run(ctx))
            for text in texts:
                await in_ch.send(core.Packet.new_text(text))
            in_ch.close()
            await task
            out_ch.close()
            got = []
            while (pkt := await out_ch.recv_optional()) is not None:
                got.append(pkt.text)
            outs[i] = got

        await asyncio.gather(*(one(i) for i in range(n_sessions)))
        return outs

    return asyncio.run(main())


@pytest.mark.parametrize("kind", ["plugin::native::nllb", "plugin::native::helsinki"])
@pytest.mark.parametrize("beam", [1, 4])
def test_translate_node_lines_equal_jax(kind, beam):
    """Without a checkpoint both packages' nodes run the reference's own tiny
    random model and byte tokenizer: equal Text lines, without a batcher and
    through the port's ``DeviceBatcher`` (3 concurrent sessions, one call
    per bucket)."""
    from streamkit_tpu_torch.engine import DeviceBatcher

    params = {"beam_size": beam, "max_tokens": 16}
    want = run_node("streamkit_tpu", kind, params, TEXTS)[0]
    assert len(want) == len(TEXTS)
    assert run_node("streamkit_tpu_torch", kind, params, TEXTS)[0] == want
    batcher = DeviceBatcher(tick_ms=100.0, device="cpu")  # a tick wide enough that the sessions share it
    outs = run_node("streamkit_tpu_torch", kind, params, TEXTS, batcher=batcher, n_sessions=3)
    batcher.stop()
    assert outs == [want] * 3
    tag = "nllb" if kind.endswith("nllb") else "marian"
    kinds = batcher.stats()["kinds"]
    assert sorted(k.rsplit(":", 1)[1] for k in kinds) == ["128", "16", "64"]
    assert all(k.startswith(f"{tag}:") and f":16:b{beam}:" in k for k in kinds)
    assert sum(v["items"] for v in kinds.values()) == 9 and sum(v["calls"] for v in kinds.values()) < 9


def test_translate_node_refusals():
    from streamkit_tpu_torch.core import ConfigurationError
    from streamkit_tpu_torch.nodes.ml.marian_node import MarianTranslateNode
    from streamkit_tpu_torch.nodes.ml.translate_node import TranslateNode

    for cls in (TranslateNode, MarianTranslateNode):
        with pytest.raises(ConfigurationError, match="beam_size"):
            cls({"beam_size": 9}, device="cpu")
        node = cls({"target_language": "fra_Latn", "max_length": 7, "model_dir": "/nonexistent"}, device="cpu")
        assert node.max_tokens == 7 and node.model_path == "/nonexistent"
    assert TranslateNode({"target_language": "fra_Latn"}, device="cpu").target_lang == "fra_Latn"


@pytest.fixture(scope="module")
def marian_dir(tmp_path_factory):
    """A random transformers MarianMTModel saved with ``save_pretrained``,
    with a ``source.spm`` written by ``write_model`` (no target.spm: the
    source vocabulary decodes too)."""
    import transformers

    pieces = [("</s>", 0.0, 3), ("<unk>", 0.0, 2)] + [
        (p, -float(i % 7), 1) for i, p in enumerate(["▁", "a", "b", "c", "d", "e", "h", "l", "o", "r", "w", "▁he",
                                                      "llo", "▁wor", "ld", "▁a", "▁the"])]
    pieces += [(f"x{i}", -9.0, 1) for i in range(100 - len(pieces) - 1)] + [("<pad>", 0.0, 3)]
    hf_cfg = transformers.MarianConfig(
        vocab_size=len(pieces), d_model=32, encoder_layers=2, decoder_layers=2, encoder_attention_heads=4,
        decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64, max_position_embeddings=64,
        pad_token_id=len(pieces) - 1, eos_token_id=0, decoder_start_token_id=len(pieces) - 1,
        activation_function="swish", forced_eos_token_id=None,
    )
    torch.manual_seed(1)
    model = transformers.MarianMTModel(hf_cfg).eval()
    with torch.no_grad():
        model.model.shared.weight.mul_(20.0)
    path = tmp_path_factory.mktemp("hf_marian")
    model.save_pretrained(str(path))
    tsp.write_model(str(path / "source.spm"), pieces, unk_id=1, eos_id=0, pad_id=len(pieces) - 1)
    return str(path)


def test_marian_model_path_route_equals_jax(marian_dir):
    """The ``model_path`` route: transformers loads the checkpoint inside
    ``build``, ``source.spm`` tokenizes through the port's copy of the
    SentencePiece reader; equal lines in both packages."""
    params = {"model_path": marian_dir, "max_tokens": 12}
    texts = ["hello world", "the world", "a bad cold hello"]
    want = run_node("streamkit_tpu", "plugin::native::helsinki", params, texts)[0]
    got = run_node("streamkit_tpu_torch", "plugin::native::helsinki", params, texts)[0]
    assert got == want and len(got) == 3


@pytest.mark.parametrize("family", ["nllb", "marian"])
def test_decode_step_past_the_position_table_raises(family):
    """The reference's ``dynamic_index_in_dim`` / ``dynamic_update_slice``
    clamp a step past the cache or the position table (the row repeats its
    last position); the port raises instead. ``max_tokens`` 70 against a
    table of 64 positions."""
    if family == "nllb":
        (_, _), (tc, tp) = pair_nllb()
        call = lambda: tnllb.nllb_greedy_cached(tp, tc, torch.as_tensor(nllb_src()), 5, max_tokens=70)  # noqa: E731
    else:
        (_, _), (tc, tp) = pair_marian(0.0)
        call = lambda: tmarian.marian_greedy_cached(tp, tc, torch.as_tensor(marian_src()), max_tokens=70)  # noqa: E731
    with pytest.raises(ValueError, match="outside the cache"):
        call()
