# SPDX-License-Identifier: Apache-2.0
"""Kernel K3 (streaming-encoder attention over int8 history): the port's
plain version against the JAX package's Pallas kernel in interpret mode and
its plain reference, and the wrapper's CPU routing. The CUDA kernel itself
is held against the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamkit_tpu.ops import stream_attention as jsa
from streamkit_tpu_torch.ops import stream_attention as tsa


def _case(B=4, H=4, c=16, hd=64, T=256, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    i8 = lambda *s: rng.integers(-127, 128, s).astype(np.int8)  # noqa: E731
    sc = lambda *s: rng.uniform(0.001, 0.02, s).astype(np.float32)  # noqa: E731
    return dict(
        qs=mk(B, H, c, hd) * 0.3,
        k8=i8(B, H, hd, T), ks=sc(B, H, T),
        v8=i8(B, H, hd, T), vs=sc(B, H, T),
        ck8=i8(B, H, hd, c), cks=sc(B, H, c),
        cv8=i8(B, H, hd, c), cvs=sc(B, H, c),
    )


def _jax(kw, pos, dtype=jnp.float32, kernel=True):
    args = {k: jnp.asarray(v) for k, v in kw.items()}
    args["qs"] = args["qs"].astype(dtype)
    p = jnp.asarray(pos, jnp.int32)
    op = float(kw["qs"].shape[-1] ** -0.25)
    if kernel:
        return np.asarray(jsa.history_attention(**args, pos=p, op_scale=op, interpret=True))
    return np.asarray(jsa.history_attention_reference(**args, pos=p, op_scale=op))


def _torch(kw, pos, dtype=torch.float32):
    args = {k: torch.from_numpy(v) for k, v in kw.items()}
    args["qs"] = args["qs"].to(dtype)
    op = float(kw["qs"].shape[-1] ** -0.25)
    return tsa.history_attention(**args, pos=torch.tensor(pos, dtype=torch.int32), op_scale=op).numpy()


# random int8 V makes the attend a near-cancellation sum: the tolerance is
# set by the TERM scale (127 * max scale), as in tests/test_stream_attention.py
TERM = 127 * 0.02


@pytest.mark.parametrize("pos", [[0, 8, 64, 256], [16, 16, 16, 16]])
def test_plain_version_matches_jax_kernel_interpret(pos):
    kw = _case()
    np.testing.assert_allclose(_torch(kw, pos), _jax(kw, pos), atol=2e-3 * TERM, rtol=0)


@pytest.mark.parametrize("pos", [[0, 8, 64, 256], [16, 16, 16, 16], [5, 0, 200, 131]])
def test_plain_version_matches_jax_reference_f32(pos):
    """f32, atol 1e-5: the same formulation (matmul order aside)."""
    kw = _case(seed=2)
    np.testing.assert_allclose(_torch(kw, pos), _jax(kw, pos, kernel=False), atol=1e-5, rtol=0)


@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("c", [8, 24, 32])
def test_plain_version_matches_jax_kernel_at_tile_edges(c, hd):
    """The bf16 kernel's tiles: 16-row query tiles (c = 8 and 24 pad the
    last one), 128-column history tiles (histories of 0, 127, 128 and 129
    columns) and both extreme head dims. The JAX kernel needs T % 128 = 0:
    T = 256. Limit: 2e-3 of the term scale, as above."""
    kw = _case(B=4, H=2, c=c, hd=hd, T=256, seed=c + hd)
    pos = [0, 127, 128, 129]
    np.testing.assert_allclose(_torch(kw, pos), _jax(kw, pos), atol=2e-3 * TERM, rtol=0)


@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("T", [136, 300])
def test_plain_version_matches_jax_reference_off_tile(T, hd):
    """T that is no multiple of 128 (the JAX kernel refuses it; the CUDA
    kernel copies 16- or 4-byte pieces): the port equals the reference
    formulation at f32, atol 1e-5, with histories on both sides of a tile."""
    kw = _case(B=4, H=2, c=16, hd=hd, T=T, seed=T + hd)
    pos = [T, 128, 129, 0]
    np.testing.assert_allclose(_torch(kw, pos), _jax(kw, pos, kernel=False), atol=1e-5, rtol=0)


def test_plain_version_matches_jax_reference_bf16():
    """bf16 queries: both round k8*op (op rounded to bf16 first) and p*scale
    to bf16 at the same places. Limit: 2e-3 of the term scale, the kernel
    test's tolerance; the measured gap is below 1e-5 of it."""
    kw = _case(seed=3)
    pos = [0, 40, 128, 256]
    got = _torch(kw, pos, torch.bfloat16)
    want = _jax(kw, pos, jnp.bfloat16, kernel=False)
    np.testing.assert_allclose(got, want, atol=2e-3 * TERM, rtol=0)


@pytest.mark.parametrize("T", [200, 512])
def test_plain_version_any_T(T):
    """T that is no multiple of 128 (the kernel takes it; the TPU gate did
    not): the port equals the reference formulation at f32."""
    kw = _case(B=2, H=3, c=8, T=T, seed=T)
    pos = [T - 8, 17]
    np.testing.assert_allclose(_torch(kw, pos), _jax(kw, pos, kernel=False), atol=1e-5, rtol=0)


def test_fresh_rows_ignore_history():
    """pos = 0 rows attend only to candidates: history contents must not leak."""
    kw = _case(seed=1)
    base = _torch(kw, [0, 0, 0, 0])
    kw2 = dict(kw, k8=np.full_like(kw["k8"], 99), v8=np.full_like(kw["v8"], -99))
    np.testing.assert_array_equal(base, _torch(kw2, [0, 0, 0, 0]))


def test_wrapper_routes_cpu_tensors_to_plain_version():
    kw = {k: torch.from_numpy(v) for k, v in _case(B=1, H=2, T=64).items()}
    before = tsa.history_attention.launches
    out = tsa.history_attention(**kw, pos=torch.tensor([9]), op_scale=0.35)
    assert tsa.history_attention.launches == before
    assert out.shape == (1, 2, 16, 64) and out.dtype == torch.float32
    with pytest.raises(ValueError, match="CUDA"):
        tsa._check(pos=torch.tensor([9], dtype=torch.int32), **kw)


@pytest.mark.parametrize(
    "hd, T, c, dtype, ok",
    [
        (64, 2560, 16, torch.bfloat16, True),  # the 16 rows' scores fill shared memory
        (64, 2688, 16, torch.bfloat16, False),
        (128, 2304, 16, torch.bfloat16, True),
        (64, 2688, 16, torch.float32, True),  # the f32 kernel keeps 8 rows a block
    ],
)
def test_supports_follows_each_kernels_shared_memory(hd, T, c, dtype, ok):
    assert tsa.supports(20, hd, T, c, dtype) is ok
    assert (tsa._smem_bytes(hd, T, c, dtype) <= 232_448) is ok


def test_supports_states_the_kernels_own_limits():
    assert tsa.supports(20, 64, 512, 16) and tsa.supports(20, 64, 64, 16) and tsa.supports(20, 64, 1500, 64)
    assert not tsa.supports(20, 64, 512, 12)  # whole 8-row chunks only
    assert not tsa.supports(20, 80, 512, 16)  # head dims 32, 64, 128
    assert not tsa.supports(20, 64, 8000, 16)  # scores no longer fit in shared memory
