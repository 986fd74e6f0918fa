# SPDX-License-Identifier: Apache-2.0
"""The port's hand-written CUDA kernels against their plain versions, on an
NVIDIA card. Skips without one. This file imports no JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from streamkit_tpu_torch.ops import attention as tattn


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape", [(1, 20, 1500, 64), (4, 20, 400, 64), (2, 3, 300, 64), (3, 1, 37, 64), (1, 2, 257, 128)]
)
def test_flash_attention_matches_plain(dtype, shape):
    """Kernel vs the plain version run in f32 (f32 atol 1e-4; bf16 within
    twice the plain version's own bf16 error on the same inputs), reading
    head-split views of [B, T, H*d] projections."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, h, t, d = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (
        torch.randn(b, t, h * d, device="cuda", generator=g).to(dtype).reshape(b, t, h, d).transpose(1, 2)
        for _ in range(3)
    )
    before = tattn.flash_attention.launches
    out = tattn.flash_attention(q, k, v, d ** -0.25)
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    ref = tattn.attention_reference(q.float(), k.float(), v.float(), d ** -0.25)
    if dtype == torch.float32:
        tol = 1e-4
    else:
        tol = 2 * (tattn.attention_reference(q, k, v, d ** -0.25).float() - ref).abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol


@pytest.mark.cuda
def test_flash_attention_rejects_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.zeros(1, 2, 256, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tattn.flash_attention(q, q, q, 0.5)
    q = torch.zeros(1, 2, 256, 96, device="cuda")
    with pytest.raises(ValueError, match="unsupported shape"):
        tattn.flash_attention(q, q, q, 0.5)
    q = torch.zeros(1, 2, 64, 256, device="cuda").transpose(-1, -2)
    with pytest.raises(ValueError, match="unit head_dim stride"):
        tattn.flash_attention(q, q, q, 0.5)
