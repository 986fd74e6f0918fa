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

