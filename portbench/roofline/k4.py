# SPDX-License-Identifier: Apache-2.0
"""K4, the decode continuation's cross-attention (``ops/decode_attention.py``,
``csrc/decode_attention.cu``): per batch row and head one query row attends
to the row's int8 cross K and V (``[hd, T]``, per-column f32 scales) below
its encoder horizon, ``min(max(ep, 1), T)`` columns. One launch per decoder
layer and decode step."""

KERNEL = r"decode_cross_attention_kernel"


def columns(horizons, T: int) -> int:
    """The visible columns of all rows: ``min(max(ep, 1), T)`` a row."""
    return sum(min(max(int(ep), 1), T) for ep in horizons)


def flops(H: int, hd: int, horizons, T: int) -> int:
    """q·k and p·v over each row's visible columns: 4·hd a column and head."""
    return 4 * H * hd * columns(horizons, T)


def nbytes(H: int, hd: int, horizons, T: int, q_esize: int = 2) -> int:
    """The queries and horizons read, the f32 output written, and each
    visible column's int8 K and V with their two f32 scales read once:
    2·H·hd + 8·H bytes a column."""
    B = len(horizons)
    return B * H * hd * q_esize + B * H * hd * 4 + 4 * B + H * columns(horizons, T) * (2 * hd + 8)
