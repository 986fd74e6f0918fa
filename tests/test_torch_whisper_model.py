# SPDX-License-Identifier: Apache-2.0
"""Port parity: Whisper encoder/decoder against the JAX package on the CPU.

The config has head_dim 64 and a 256-frame audio context, so the encoder
takes the flash-attention gate (on the CPU the wrapper runs its plain
version). Both packages compute with the same weights: the JAX package's
``init_params`` tree, carried over with ``params_from_numpy``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamkit_tpu.models.whisper import model as jmodel
from streamkit_tpu.models.whisper.config import WhisperConfig as JConfig
from streamkit_tpu_torch.models.whisper import model as tmodel
from streamkit_tpu_torch.models.whisper.config import WhisperConfig
from streamkit_tpu_torch.models.whisper.load import (
    config_from_hf,
    params_from_hf_state_dict,
    params_from_numpy,
)

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

DIMS = dict(
    n_mels=80, n_audio_ctx=256, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
    n_vocab=51865, n_text_ctx=32, n_text_state=128, n_text_head=2, n_text_layer=2,
)
CFG, JCFG = WhisperConfig(**DIMS), JConfig(**DIMS)


@pytest.fixture(scope="module")
def pair():
    jp = jmodel.init_params(JCFG, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    return jp, tp


def _mel(seed, b=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 2 * CFG.n_audio_ctx, CFG.n_mels) * 0.5).astype(np.float32)


def test_param_tree_names_follow_jax_paths(pair):
    jp, tp = pair
    names = dict(tp.named_parameters())
    assert "enc.layers.1.attn.q.w" in names and "dec.layers.0.xattn.k.w" in names
    assert "dec.layers.0.xattn.k.b" not in names  # k projections carry no bias
    np.testing.assert_array_equal(names["enc.layers.1.attn.q.w"].numpy(), np.asarray(jp["enc"]["layers"][1]["attn"]["q"]["w"]))
    assert len(names) == len(jax.tree.leaves(jp))


def test_init_params_on_device_shapes():
    g = torch.Generator().manual_seed(3)
    tp = tmodel.init_params(CFG, g, torch.bfloat16, device="cpu")
    jp = jmodel.init_params(JCFG, jax.random.PRNGKey(0))
    shapes = {k: tuple(v.shape) for k, v in tp.named_parameters()}
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        assert shapes[key] == leaf.shape, key
    assert all(v.dtype == torch.bfloat16 for v in tp.parameters())


def test_encode_matches_jax_f32(pair):
    """f32, atol 2e-4 (two layers of f32 matmuls in another order)."""
    jp, tp = pair
    mel = _mel(0)
    want = np.asarray(jmodel.encode(jp, JCFG, jnp.asarray(mel)))
    got = tmodel.encode(tp, CFG, torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_encode_matches_jax_bf16(pair):
    """bf16 weights and activations on both sides. Each side rounds every op
    to bf16 in its own order, so the outputs (layer-normed, |x| up to 3.4)
    differ by a few bf16 ulps (0.0156 at |x| >= 2). Readings over six inputs:
    max-abs gap 0.031-0.047, mean-abs gap 2.6e-3, and the port's error
    against the f32 encode 0.83-1.09x the reference's own bf16 error (mean
    0.98-0.99x). Limits: max gap 0.08, mean gap 5e-3, port error at most
    1.5x (max) and 1.1x (mean) the reference's."""
    jp, _ = pair
    jpb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tpb = params_from_numpy(jax.tree.map(np.asarray, jp), CFG, torch.bfloat16, device="cpu")
    mel = _mel(1)
    exact = np.asarray(jmodel.encode(jp, JCFG, jnp.asarray(mel)))
    want = np.asarray(jmodel.encode(jpb, JCFG, jnp.asarray(mel, jnp.bfloat16)).astype(jnp.float32))
    got = tmodel.encode(tpb, CFG, torch.from_numpy(mel).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=0.08, rtol=0)
    assert np.abs(got - want).mean() <= 5e-3
    err_port, err_ref = np.abs(got - exact), np.abs(want - exact)
    assert err_port.max() <= 1.5 * err_ref.max()
    assert err_port.mean() <= 1.1 * err_ref.mean()


def test_decode_logits_and_steps_match_jax(pair):
    """Teacher-forced logits and incremental decode steps, atol 2e-3."""
    jp, tp = pair
    mel = _mel(2)
    states_j = jmodel.encode(jp, JCFG, jnp.asarray(mel))
    states_t = torch.from_numpy(np.array(states_j))
    toks = np.asarray([[CFG.token_sot, CFG.token_language(0), CFG.token_transcribe, 440, 1001]] * 2, np.int32)
    toks[1, 3] = 77
    want = np.asarray(jmodel.decode_logits(jp, JCFG, jnp.asarray(toks), states_j))
    got = tmodel.decode_logits(tp, CFG, torch.from_numpy(toks).long(), states_t).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)

    for int8 in (False, True):
        cj = jmodel.init_kv_cache(jp, JCFG, states_j, max_len=8, cross_kv_int8=int8)
        ct = tmodel.init_kv_cache(tp, CFG, states_t, max_len=8, cross_kv_int8=int8)
        for i in range(toks.shape[1]):
            lj, cj = jmodel.decode_step(jp, JCFG, jnp.asarray(toks[:, i]), cj)
            lt, ct = tmodel.decode_step(tp, CFG, torch.from_numpy(toks[:, i]), ct)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-3, rtol=0)
        assert ct.pos == int(cj.pos) == toks.shape[1]
        np.testing.assert_allclose(ct.k.numpy(), np.asarray(cj.k), atol=2e-4, rtol=0)
        if not int8:
            # incremental logits equal the teacher-forced ones (last position)
            np.testing.assert_allclose(lt.numpy(), got[:, -1], atol=2e-3, rtol=0)


def test_int8_cross_cache_bit_exact(pair):
    """int8 cross K/V and their scales equal the JAX package's at f32
    (round half to even on both sides)."""
    jp, tp = pair
    states = np.array(jmodel.encode(jp, JCFG, jnp.asarray(_mel(3))))
    cj = jmodel.init_kv_cache(jp, JCFG, jnp.asarray(states), cross_kv_int8=True)
    ct = tmodel.init_kv_cache(tp, CFG, torch.from_numpy(states), cross_kv_int8=True)
    assert ct.cross_quantized and ct.xk.dtype == torch.int8
    np.testing.assert_array_equal(ct.xk.numpy(), np.asarray(cj.xk))
    np.testing.assert_array_equal(ct.xv.numpy(), np.asarray(cj.xv))
    np.testing.assert_array_equal(ct.xk_scale.numpy(), np.asarray(cj.xk_scale))
    np.testing.assert_array_equal(ct.xv_scale.numpy(), np.asarray(cj.xv_scale))
    # round half to even on exact halves
    q, scale = tmodel._quantize_tmaj(torch.tensor([[127.0], [0.5], [1.5], [2.5]]))  # [hd=4, T=1]
    assert scale.tolist() == [[1.0]] and q.flatten().tolist() == [127, 0, 2, 2]


def test_out_of_range_tokens_raise(pair):
    """The reference clamps out-of-range embedding indices; the port refuses
    them."""
    _, tp = pair
    small = WhisperConfig(**{**DIMS, "n_vocab": 256})
    with pytest.raises(ValueError, match="vocabulary"):
        tmodel._check_tokens(small, small.token_sot)
    states = torch.zeros(1, CFG.n_audio_ctx, CFG.n_audio_state)
    cache = tmodel.init_kv_cache(tp, CFG, states, max_len=2)
    _, cache = tmodel.decode_step(tp, CFG, torch.tensor([1]), cache)
    _, cache = tmodel.decode_step(tp, CFG, torch.tensor([1]), cache)
    with pytest.raises(ValueError, match="beyond the cache"):
        tmodel.decode_step(tp, CFG, torch.tensor([1]), cache)


def test_hf_state_dict_conversion_matches_hf_encoder():
    """``params_from_hf_state_dict`` against a random-init transformers model
    (encoder atol 1e-4, as the JAX package's own HF parity test)."""
    transformers = pytest.importorskip("transformers")
    from streamkit_tpu.models.whisper.load import params_from_hf_state_dict as jconv

    hf_cfg = transformers.WhisperConfig(
        vocab_size=CFG.n_vocab, num_mel_bins=CFG.n_mels,
        encoder_layers=CFG.n_audio_layer, encoder_attention_heads=CFG.n_audio_head,
        decoder_layers=CFG.n_text_layer, decoder_attention_heads=CFG.n_text_head,
        d_model=CFG.n_audio_state, max_source_positions=CFG.n_audio_ctx,
        max_target_positions=CFG.n_text_ctx,
        encoder_ffn_dim=4 * CFG.n_audio_state, decoder_ffn_dim=4 * CFG.n_text_state,
    )
    torch.manual_seed(0)
    model = transformers.WhisperForConditionalGeneration(hf_cfg).eval()
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    cfg = config_from_hf(hf_cfg)
    assert cfg == CFG
    tp = params_from_hf_state_dict(sd, cfg, device="cpu")
    jp = jconv(sd, JCFG)
    for (path, leaf) in jax.tree_util.tree_flatten_with_path(jp)[0]:
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        np.testing.assert_array_equal(dict(tp.named_parameters())[key].numpy(), np.asarray(leaf))
    mel = _mel(4)
    with torch.no_grad():
        want = model.model.encoder(torch.from_numpy(mel.transpose(0, 2, 1))).last_hidden_state.numpy()
    got = tmodel.encode(tp, cfg, torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
