# SPDX-License-Identifier: Apache-2.0
"""PCM sample conversions for the int16 ring wire.

Port of ``streamkit_tpu/ops/dsp.py`` ``s16le_to_f32`` / ``f32_to_s16le``.
Gain, mix and channel conversion come with the DSP slice.
"""

from __future__ import annotations

import torch

__all__ = ["s16le_to_f32", "f32_to_s16le"]


def s16le_to_f32(samples: torch.Tensor) -> torch.Tensor:
    """int16 PCM → float32 in [-1, 1): x / 32768."""
    return samples.to(torch.float32) * (1.0 / 32768.0)


def f32_to_s16le(samples: torch.Tensor) -> torch.Tensor:
    """float32 → int16 PCM with clamp + round-half-away-from-zero (Rust
    ``f32::round``, the reference's conversion convention)."""
    x = torch.clamp(samples * 32768.0, -32768.0, 32767.0)
    rounded = torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))
    return rounded.to(torch.int16)
