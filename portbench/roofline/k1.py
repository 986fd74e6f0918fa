# SPDX-License-Identifier: Apache-2.0
"""K1, the encoder's flash attention (``ops/attention.py``,
``csrc/flash_attention.cu``): softmax(q kᵀ / sqrt(d)) v over ``[B, H, T,
d]`` bf16 operands, no mask."""

KERNEL = r"flash_fwd"


def flops(B: int, H: int, T: int, d: int) -> int:
    """q kᵀ and p v: two products of 2·T·T·d per head."""
    return 4 * B * H * T * T * d


def nbytes(B: int, H: int, T: int, d: int, esize: int = 2) -> int:
    """q, k and v read once, the output written once."""
    return 4 * B * H * T * d * esize
