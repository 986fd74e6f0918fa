# SPDX-License-Identifier: Apache-2.0
"""K3, the streaming encoder's history attention (``ops/stream_attention.py``,
``csrc/stream_attention.cu``): ``c`` queries per row attend to the row's
int8 history below ``pos[b]`` (per-column f32 scales) and to the call's
``c`` int8 candidates, block-causally. One launch per encoder layer."""

KERNEL = r"history_attention"


def flops(H: int, c: int, hd: int, positions) -> int:
    """q kᵀ and p v over each row's history and candidates."""
    B = len(positions)
    return 4 * H * c * hd * (sum(int(p) for p in positions) + B * c)


def nbytes(H: int, c: int, hd: int, positions, q_esize: int = 2) -> int:
    """bf16 queries and pos read, f32 output written, each row's valid
    history (int8 K and V with their f32 scales) and the candidates read."""
    B = len(positions)
    hist = sum(int(p) for p in positions)
    return (B * H * c * hd * q_esize + B * H * c * hd * 4 + 4 * B
            + H * hist * (2 * hd + 8) + B * H * c * (2 * hd + 8))
