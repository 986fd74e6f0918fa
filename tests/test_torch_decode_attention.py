# SPDX-License-Identifier: Apache-2.0
"""Kernel K4 (the decode continuation's cross-attention over the int8 cross
caches): the port's plain version against the JAX package's expression
(``streaming._scores_rows``, the horizon's mask, softmax,
``streaming._attend_rows``), the wrapper's CPU routing and its refusals. The
CUDA kernel itself is held against the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamkit_tpu.models.whisper import streaming as js
from streamkit_tpu_torch.ops import decode_attention as tda

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

# random int8 V makes the attend a near-cancellation sum: the tolerance is
# set by the term scale (127 * max scale), as in tests/test_torch_stream_attention.py
TERM = 127 * 0.02


def _case(B=5, H=3, hd=64, T=96, seed=0):
    rng = np.random.default_rng(seed)
    i8 = lambda *s: rng.integers(-127, 128, s).astype(np.int8)  # noqa: E731
    sc = lambda *s: rng.uniform(0.001, 0.02, s).astype(np.float32)  # noqa: E731
    return dict(qs=rng.standard_normal((B, H, 1, hd)).astype(np.float32) * 0.3,
                k8=i8(B, H, hd, T), ks=sc(B, H, T), v8=i8(B, H, hd, T), vs=sc(B, H, T))


def _jax(kw, ep, dtype):
    """The JAX decode step's expression for one layer (``_decode_core``)."""
    T = kw["k8"].shape[-1]
    op = float(kw["qs"].shape[-1] ** -0.25)
    xmask = jnp.where(jnp.arange(T, dtype=jnp.int32)[None, :] < jnp.maximum(jnp.asarray(ep, jnp.int32), 1)[:, None],
                      0.0, -jnp.inf).astype(jnp.float32)[:, None, None, :]
    xs = js._scores_rows(jnp.asarray(kw["qs"]).astype(dtype), (jnp.asarray(kw["k8"]), jnp.asarray(kw["ks"])), op,
                         dtype)
    xp = jax.nn.softmax(xs + xmask, axis=-1)
    return np.asarray(js._attend_rows(xp, (jnp.asarray(kw["v8"]), jnp.asarray(kw["vs"])), dtype))


def _torch(kw, ep, dtype=torch.float32, fn=tda.decode_cross_attention):
    args = {k: torch.from_numpy(v) for k, v in kw.items()}
    args["qs"] = args["qs"].to(dtype)
    op = float(kw["qs"].shape[-1] ** -0.25)
    return fn(**args, ep=torch.tensor(ep, dtype=torch.int32), op_scale=op).numpy()


EPS = lambda T: [0, 1, 7, T - 1, T]  # noqa: E731  the horizons: none yet, one column, a few, all but one, all


@pytest.mark.parametrize("hd, T", [(64, 96), (32, 40), (128, 300)])
def test_plain_version_matches_jax_expression_f32(hd, T):
    """f32, atol 1e-5: the same expression (matmul order aside), at every
    horizon from none to the whole table."""
    kw = _case(hd=hd, T=T, seed=hd + T)
    np.testing.assert_allclose(_torch(kw, EPS(T)), _jax(kw, EPS(T), jnp.float32), atol=1e-5, rtol=0)


@pytest.mark.parametrize("hd, T", [(64, 96), (32, 512)])
def test_plain_version_matches_jax_expression_bf16(hd, T):
    """bf16 queries: both round k8*op (op rounded to bf16 first) and p*scale
    to bf16 at the same places. Limit: 2e-3 of the term scale, K3's."""
    kw = _case(hd=hd, T=T, seed=3 + T)
    got = _torch(kw, EPS(T), torch.bfloat16)
    np.testing.assert_allclose(got, _jax(kw, EPS(T), jnp.bfloat16), atol=2e-3 * TERM, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_columns_past_the_horizon_are_not_seen(dtype):
    """Columns at or above max(ep, 1) change nothing, bit for bit: neither
    their codes nor their scales."""
    T = 64
    kw = _case(T=T, seed=11)
    ep = EPS(T)
    base = _torch(kw, ep, dtype)
    junk = {k: v.copy() for k, v in kw.items()}
    for b, e in enumerate(ep):
        lo = max(e, 1)
        junk["k8"][b, ..., lo:] = 99
        junk["v8"][b, ..., lo:] = -99
        junk["ks"][b, :, lo:] = 7.0
        junk["vs"][b, :, lo:] = 7.0
    np.testing.assert_array_equal(base, _torch(junk, ep, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ep_zero_attends_column_zero_as_ep_one(dtype):
    """A row not yet encoded (ep = 0, or below) sees column 0 alone, as
    ep = 1: the softmax stays finite."""
    kw = _case(B=1, seed=5)
    one = _torch(kw, [1], dtype)
    assert np.isfinite(one).all()
    np.testing.assert_array_equal(_torch(kw, [0], dtype), one)
    np.testing.assert_array_equal(_torch(kw, [-3], dtype), one)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_routes_cpu_tensors_to_plain_version(dtype):
    kw = _case(B=3, H=2, T=48, seed=2)
    ep = [0, 17, 48]
    before = tda.decode_cross_attention.launches
    out = _torch(kw, ep, dtype)
    assert tda.decode_cross_attention.launches == before
    assert out.shape == (3, 2, 1, 64) and out.dtype == np.float32
    np.testing.assert_array_equal(out, _torch(kw, ep, dtype, fn=tda.decode_cross_attention_reference))


def _args(**over):
    kw = {k: torch.from_numpy(v) for k, v in _case(B=2, H=2, hd=64, T=32).items()}
    kw["ep"] = torch.tensor([3, 32], dtype=torch.int32)
    kw.update(over)
    return kw


def _bad_cases():
    ok = _args()
    return [
        ("qs float16", dict(qs=ok["qs"].half()), "float32 or bfloat16"),
        ("qs two rows", dict(qs=ok["qs"].expand(2, 2, 2, 64).contiguous()), r"\[B, H, 1, hd\]"),
        ("k8 uint8", dict(k8=ok["k8"].to(torch.uint8)), "k8 must be"),
        ("v8 short", dict(v8=ok["v8"][..., :31].contiguous()), "v8 must be"),
        ("ks float64", dict(ks=ok["ks"].double()), "ks must be"),
        ("vs one head", dict(vs=ok["vs"][:, :1].contiguous()), "vs must be"),
        ("ep int64", dict(ep=ok["ep"].long()), "ep must be"),
        ("ep three rows", dict(ep=torch.tensor([1, 2, 3], dtype=torch.int32)), "ep must be"),
        ("k8 transposed", dict(k8=ok["k8"].transpose(-1, -2).contiguous().transpose(-1, -2)), "contiguous"),
        ("hd 80", dict(qs=torch.zeros(2, 2, 1, 80), k8=torch.zeros(2, 2, 80, 32, dtype=torch.int8),
                       v8=torch.zeros(2, 2, 80, 32, dtype=torch.int8)), "unsupported shape"),
        ("T past shared memory", dict(k8=torch.zeros(2, 2, 64, 7263, dtype=torch.int8),
                                      v8=torch.zeros(2, 2, 64, 7263, dtype=torch.int8),
                                      ks=torch.zeros(2, 2, 7263), vs=torch.zeros(2, 2, 7263)), "unsupported shape"),
        ("cpu tensors", {}, "CUDA"),
    ]


@pytest.mark.parametrize("label, over, match", _bad_cases(), ids=[c[0] for c in _bad_cases()])
def test_wrapper_refuses_what_the_kernel_does_not_take(label, over, match):
    with pytest.raises(ValueError, match=match):
        tda._check(**_args(**over))


def test_supports_states_the_kernels_own_limits():
    assert tda.supports(64, 512) and tda.supports(32, 1) and tda.supports(128, 1500) and tda.supports(64, 7262)
    assert not tda.supports(80, 512)  # head dims 32, 64, 128
    assert not tda.supports(64, 7263)  # the 8 warps' partial scores no longer fit in shared memory
    assert not tda.supports(64, 0)
    assert tda._smem_bytes(7262) <= 232_448 < tda._smem_bytes(7263)
