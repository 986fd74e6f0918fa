# SPDX-License-Identifier: Apache-2.0
"""Elementwise and mixing DSP: gain, mix, channel and sample-format convert.

Port of ``streamkit_tpu/ops/dsp.py``. These are the device counterparts of
the reference's CPU loops:

* gain — f32 multiply (``nodes/src/audio/filters/gain.rs:188``)
* mix  — f32 sequential accumulation with channel up/down-mix
  (``nodes/src/audio/filters/mixer.rs:1027-1090``): mono→stereo duplicates,
  stereo→mono averages ``(L+R)*0.5``, generic cyclic mapping; **no clamping**.
* convert — s16le↔f32 PCM conversion.

Plain tensor functions, f32 throughout, each op its own eager kernel (no
fused multiply-add), computed where their inputs live. All take a leading
batch dimension, so the batcher can stack many sessions into one call.
Accumulation is left to right in input order, the reference's f32
summation order, so every function here is bit-identical to the JAX
package's and to the same arithmetic in numpy.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["apply_gain", "mix_frames", "convert_channels", "s16le_to_f32", "f32_to_s16le"]


def apply_gain(samples: torch.Tensor, gain) -> torch.Tensor:
    """Multiply samples by a scalar gain (f32, no clamp). ``gain`` is rounded
    to f32 first, as the reference's ``jnp.asarray(gain, float32)``."""
    return samples * torch.as_tensor(gain, dtype=samples.dtype, device=samples.device)


def convert_channels(samples: torch.Tensor, src_channels: int, dst_channels: int) -> torch.Tensor:
    """Channel up/down-mix on interleaved PCM ``[..., frames*src_channels]``.

    Matches reference ``mixer.rs:1047-1078``: mono→stereo duplicate,
    stereo→mono ``(L+R)*0.5``, generic cyclic channel mapping."""
    if src_channels == dst_channels:
        return samples
    *lead, n = samples.shape
    frames = n // src_channels
    x = samples.reshape(*lead, frames, src_channels)
    if src_channels == 1 and dst_channels == 2:
        y = x.repeat_interleave(2, dim=-1)
    elif src_channels == 2 and dst_channels == 1:
        y = (x[..., 0:1] + x[..., 1:2]) * 0.5
    else:
        idx = torch.arange(dst_channels, device=samples.device) % src_channels
        y = x[..., idx]
    return y.reshape(*lead, frames * dst_channels)


def mix_frames(
    inputs: Sequence[torch.Tensor], src_channels: Sequence[int], dst_channels: int, out_samples: int
) -> torch.Tensor:
    """Mix N interleaved inputs into one f32 buffer of ``out_samples``.

    ``inputs``: tensors ``[..., n_i]`` on one device; ``src_channels``: the
    channel count of each. Inputs shorter than the output (after channel
    conversion) are zero-padded, longer ones cut (the reference mixes the
    ``min`` length into a zeroed buffer). Left-to-right accumulation keeps the
    f32 summation order."""
    first = inputs[0]
    acc = torch.zeros(first.shape[:-1] + (out_samples,), dtype=torch.float32, device=first.device)
    for x, ch in zip(inputs, src_channels):
        y = convert_channels(x, ch, dst_channels)
        n = y.shape[-1]
        if n < out_samples:
            y = torch.nn.functional.pad(y, (0, out_samples - n))
        elif n > out_samples:
            y = y[..., :out_samples]
        acc = acc + y
    return acc


def s16le_to_f32(samples: torch.Tensor) -> torch.Tensor:
    """int16 PCM → float32 in [-1, 1): x / 32768."""
    return samples.to(torch.float32) * (1.0 / 32768.0)


def f32_to_s16le(samples: torch.Tensor) -> torch.Tensor:
    """float32 → int16 PCM with clamp + round-half-away-from-zero (Rust
    ``f32::round``, the reference's conversion convention)."""
    x = torch.clamp(samples * 32768.0, -32768.0, 32767.0)
    rounded = torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))
    return rounded.to(torch.int16)
