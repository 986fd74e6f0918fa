# SPDX-License-Identifier: Apache-2.0
"""K1's backward: the port's plain backward (``attention_backward_reference``,
the oracle of ``csrc/flash_attention_bwd.cu``), its autograd Function on the
CPU and autograd through its CPU route, against the backward of the library
flash kernel that the JAX package's ``_lib_flash`` calls, run in TPU
interpret mode with the backward blocks named here. Also the reference's own
fault: ``_lib_flash`` names no backward blocks, so it cannot be
differentiated. The CUDA kernels are held against the plain version on the
card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import BlockSizes, SegmentIds
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as lib_flash

from streamkit_tpu.ops import attention as jattn
from streamkit_tpu_torch.ops import attention as tattn

BLOCK = 128
# every block of the forward and of both backward kernels (dK/dV, dQ)
BLOCKS = BlockSizes(
    block_q=BLOCK, block_k_major=BLOCK, block_k=BLOCK, block_b=1,
    block_q_major_dkv=BLOCK, block_k_major_dkv=BLOCK, block_k_dkv=BLOCK, block_q_dkv=BLOCK,
    block_k_major_dq=BLOCK, block_k_dq=BLOCK, block_q_dq=BLOCK,
)


def _inputs(seed, b, h, tq, tk, d, dtype=np.float32):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, tq, d).astype(dtype)
    k, v = (rng.randn(b, h, tk, d).astype(dtype) for _ in range(2))
    do = rng.randn(b, h, tq, d).astype(dtype)
    return q, k, v, do


def _library_vjp(q, k, v, do, scale):
    """The library kernel's forward and backward in interpret mode, padded
    to the blocks as ``_lib_flash`` pads: query rows with zeros (sliced off,
    so their dO is 0), key columns masked by ``SegmentIds``."""
    b, _, tq, _ = q.shape
    tk = k.shape[2]
    tq_p, tk_p = -(-tq // BLOCK) * BLOCK, -(-tk // BLOCK) * BLOCK

    def f(q, k, v):
        qp = jnp.pad(q, ((0, 0), (0, 0), (0, tq_p - tq), (0, 0)))
        kp = jnp.pad(k, ((0, 0), (0, 0), (0, tk_p - tk), (0, 0)))
        vp = jnp.pad(v, ((0, 0), (0, 0), (0, tk_p - tk), (0, 0)))
        seg = None
        if tk_p != tk:
            kv_ids = (jnp.arange(tk_p) >= tk).astype(jnp.float32)
            seg = SegmentIds(q=jnp.zeros((b, tq_p), jnp.float32), kv=jnp.broadcast_to(kv_ids, (b, tk_p)))
        out = lib_flash(qp, kp, vp, segment_ids=seg, sm_scale=scale * scale, block_sizes=BLOCKS)
        return out[:, :, :tq]

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        grads = vjp(jnp.asarray(do))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize(
    "b,h,tq,tk", [(1, 2, 256, 384), (2, 1, 200, 300)], ids=["256x384", "200x300-padded"]
)
def test_backward_matches_library_kernel_interpret(b, h, tq, tk):
    """f32, atol 1e-5 on every gradient: the library's dK/dV and dQ kernels
    (interpret mode) against (1) the port's plain backward fed the plain
    forward's output and row statistic, (2) its autograd Function on the
    CPU, (3) autograd through ``flash_attention``'s CPU route."""
    d = 64
    scale = d ** -0.25
    q, k, v, do = _inputs(tq + tk, b, h, tq, tk, d)
    want_out, want = _library_vjp(q, k, v, do, scale)

    tq_, tk_, tv_, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = tattn.attention_lse_reference(tq_, tk_, tv_, scale)
    np.testing.assert_allclose(out.numpy(), want_out, atol=1e-5, rtol=0)
    plain = tattn.attention_backward_reference(tq_, tk_, tv_, out, tdo, lse, scale)

    def autograd(fn):
        leaves = [x.clone().requires_grad_() for x in (tq_, tk_, tv_)]
        fn(*leaves, scale).backward(tdo)
        return [x.grad for x in leaves]

    for got in (plain, autograd(tattn.FlashAttention.apply), autograd(tattn.flash_attention)):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)
    assert max(np.abs(w).max() for w in want) > 0.1  # the gradients are not vanishingly small


def test_row_statistic_rebuilds_the_probabilities():
    """The forward's row statistic is log2 of the row sum of 2^(s²·log2e·QKᵀ):
    2^(s²·log2e·QKᵀ − lse) is the softmax, to f32 rounding (atol 1e-6)."""
    q, k, v, _ = _inputs(0, 1, 2, 70, 90, 64)
    scale = 64 ** -0.25
    tq_, tk_ = torch.from_numpy(q), torch.from_numpy(k)
    _, lse = tattn.attention_lse_reference(tq_, tk_, torch.from_numpy(v), scale)
    assert lse.shape == (1, 2, 70) and lse.dtype == torch.float32
    p = torch.exp2(torch.matmul(tq_, tk_.transpose(-1, -2)) * (scale * scale * math.log2(math.e)) - lse[..., None])
    want = torch.softmax(torch.matmul(tq_ * scale, (tk_ * scale).transpose(-1, -2)), -1)
    np.testing.assert_allclose(p.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_backward_matches_jax_vjp_of_reference_at_bf16():
    """bf16 inputs: the port's plain backward (f32 inside, P and dS rounded
    to bf16 where the tensor-core kernels round them, bf16 out) against
    ``jax.vjp`` of the JAX package's ``attention_reference`` at bf16 (which
    rounds the probabilities and every product to bf16). Limit: 2% of each
    gradient's largest magnitude, three bf16 ulps there (JAX's bf16 vjp
    itself is up to 1% off the f32 gradients on these inputs); both stay
    within it of the f32 gradients too."""
    d = 64
    scale = d ** -0.25
    q, k, v, do = _inputs(7, 1, 2, 256, 300, d)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    out, vjp = jax.vjp(lambda q, k, v: jattn.attention_reference(q, k, v, scale), *jb[:3])
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jb[3])]
    want32 = [np.asarray(g) for g in jax.vjp(lambda q, k, v: jattn.attention_reference(q, k, v, scale),
                                             *(x.astype(jnp.float32) for x in jb[:3]))[1](jb[3].astype(jnp.float32))]

    tb = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in jb]
    o, lse = tattn.attention_lse_reference(*tb[:3], scale)
    got = tattn.attention_backward_reference(*tb[:3], o, tb[3], lse, scale)
    for g, w, w32 in zip(got, want, want32):
        assert g.dtype == torch.bfloat16
        tol = 0.02 * np.abs(w32).max()
        np.testing.assert_allclose(g.float().numpy(), w, atol=tol, rtol=0)
        np.testing.assert_allclose(g.float().numpy(), w32, atol=tol, rtol=0)


def test_reference_lib_flash_cannot_be_differentiated():
    """The reference's fault: ``_lib_flash`` builds ``BlockSizes`` with the
    forward blocks only, so its backward raises (``make_train_step`` on a
    TPU, for every config whose attention takes the flash gate). The port
    refuses it: its backward kernels run (tests above, on the card)."""
    q, k, v, do = _inputs(1, 1, 2, 256, 256, 64)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q, k, v: jattn._lib_flash(q, k, v, 64 ** -0.25),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        with pytest.raises(ValueError, match="not all backward blocks are"):
            vjp(jnp.asarray(do))


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors each wrapper is its plain version: the forward with
    the row statistic, the dQ and dK/dV kernels' halves, their composition;
    no launch is counted."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3, 2, 1, 64, 80, 64))
    scale = 64 ** -0.25
    counts = (tattn.flash_attention.launches, tattn.flash_attention_backward_dq.launches,
              tattn.flash_attention_backward_dkv.launches)
    o, lse = tattn.flash_attention_lse(q, k, v, scale)
    want_o, want_lse = tattn.attention_lse_reference(q, k, v, scale)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    dq, delta = tattn.flash_attention_backward_dq(q, k, v, o, do, lse, scale)
    dk, dv = tattn.flash_attention_backward_dkv(q, k, v, do, lse, delta, scale)
    torch.testing.assert_close(delta, (do * o).sum(-1), atol=1e-5, rtol=0)
    for g, w in zip((dq, dk, dv), tattn.flash_attention_backward(q, k, v, o, do, lse, scale)):
        assert torch.equal(g, w)
    assert counts == (tattn.flash_attention.launches, tattn.flash_attention_backward_dq.launches,
                      tattn.flash_attention_backward_dkv.launches)
