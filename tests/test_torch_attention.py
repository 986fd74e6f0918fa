# SPDX-License-Identifier: Apache-2.0
"""Kernel K1 (encoder flash attention): the port's plain version against the
JAX package's Pallas kernel in interpret mode and its plain reference, and
the wrapper's CPU routing. The CUDA kernel itself is held against the plain
version on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamkit_tpu.ops import attention as jattn
from streamkit_tpu_torch.ops import attention as tattn


def _qkv(seed, b, h, t, d, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, t, d).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("t", [256, 300, 520])
def test_reference_matches_jax_flash_interpret(t):
    """f32, atol 1e-5: the Pallas kernel (interpret mode) and the port's
    plain version compute the same softmax attention."""
    q, k, v = _qkv(t, 1, 2, t, 64)
    scale = 64 ** -0.25
    want_kernel = np.asarray(
        jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, interpret=True)
    )
    want_ref = np.asarray(jattn.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    got = tattn.attention_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", [129, 383, 1500])
def test_reference_matches_jax_at_tile_edges(t, d):
    """f32, atol 1e-5, at the edges of the kernel's 128-row Q and K/V tiles
    (one row past a tile, one short of three, the encoder's 1500) for both
    head dims it takes: the Pallas kernel (interpret mode), JAX's plain
    reference and the port's plain version agree."""
    q, k, v = _qkv(t + d, 1, 1, t, d)
    scale = d ** -0.25
    want_kernel = np.asarray(
        jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, interpret=True)
    )
    want_ref = np.asarray(jattn.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    got = tattn.attention_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=1e-5, rtol=0)


def test_reference_bf16_matches_jax():
    """bf16, atol 1e-2: both round q*s, k*s and the probabilities to bf16
    (outputs here are ≲ 1 in magnitude; one bf16 ulp is 2^-8 relative)."""
    q, k, v = _qkv(7, 2, 3, 300, 64)
    scale = 64 ** -0.25
    want = np.asarray(
        jattn.attention_reference(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), scale
        ).astype(jnp.float32)
    )
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = tattn.attention_reference(tq, tk, tv, scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=0)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 2, 256, 64))
    before = tattn.flash_attention.launches
    out = tattn.flash_attention(q, k, v, 0.5)
    assert tattn.flash_attention.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(out, tattn.attention_reference(q, k, v, 0.5), atol=0, rtol=0)


def test_kernel_checks_reject_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 2, 256, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tattn._check(q, k, v)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No nvcc → the build raises (never a silent fallback)."""
    from streamkit_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(tattn.SOURCE)



def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize(
    "make, dims, strides",
    [
        # the encoder's head-split view of [B, T, H*d] projections: no copy
        (lambda: _bf16(2, 300, 3 * 64).reshape(2, 300, 3, 64).transpose(1, 2), (64, 300, 3, 2), (57600, 64, 192)),
        (lambda: _bf16(2, 3, 300, 64), (64, 300, 3, 2), (57600, 19200, 64)),
        # size-1 batch and head dims: their strides become the tensor's extent
        (lambda: _bf16(1, 1, 129, 128), (128, 129, 1, 1), (16512, 16512, 128)),
    ],
)
def test_tma_geometry_describes_views_in_place(make, dims, strides):
    """The bf16 kernel's tensor maps: dims innermost first, element strides
    of (B, H, T) as the launch passes them."""
    assert tattn.tma_geometry(make()) == (dims, strides)


@pytest.mark.parametrize(
    "make, match",
    [
        (lambda: _bf16(1, 2, 64, 256).transpose(-1, -2), "unit head_dim stride"),
        (lambda: _bf16(2 * 256 * 64 + 1)[1:].view(1, 2, 256, 64), "16-byte aligned"),
        # time stride 132 elements = 264 bytes
        (lambda: _bf16(1, 256, 132)[..., :128].reshape(1, 256, 2, 64).transpose(1, 2), "multiples of 16 bytes"),
        # a broadcast batch: stride 0
        (lambda: _bf16(1, 2, 256, 64).expand(3, 2, 256, 64), "multiples of 16 bytes"),
    ],
)
def test_tma_geometry_refuses_what_tma_cannot_take(make, match):
    with pytest.raises(ValueError, match=match):
        tattn.tma_geometry(make())
