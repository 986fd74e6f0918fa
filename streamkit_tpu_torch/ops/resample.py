# SPDX-License-Identifier: Apache-2.0
"""Streaming linear-interpolation resampler (fixed input chunk).

Port of ``streamkit_tpu/ops/resample.py``: the counterpart of the
reference's rubato ``FastFixedIn`` with ``PolynomialDegree::Linear``
(``nodes/src/audio/filters/resampler.rs:232-244``):

* fixed ``chunk_frames`` input per call (default 960 = 20 ms @ 48 kHz),
* per-output-sample linear interpolation ``s0 + (s1 - s0) * frac`` in f32,
* one history frame carried between chunks for boundary continuity.

Two deliberate improvements over the reference:

* **Exact rational phase.** Source position is tracked as an integer
  numerator modulo the output rate (reduced by gcd), so there is *zero*
  phase drift over unbounded stream length — rubato's f64 accumulator
  drifts a few samples per hour at irrational ratios.
* **Fixed shapes.** Output length per chunk varies by ±1 with phase; the
  device function emits a fixed ``max_out`` output plus a valid count, so a
  batch of sessions stacks into one call.

:func:`resample_chunk` is plain torch on the device that holds its inputs,
batched over a leading dimension: per-session state is ``(phase_num int32,
history [channels] f32)`` rows in a slot table (``engine/slots.py``). The
interpolation is two eager ops, a multiply and then an add, so the product
is rounded before the add exactly as in :class:`LinearResampler` (numpy) and
in the reference's rustc build; ``torch.lerp`` (which switches form at
``w >= 0.5``) and ``addcmul`` would each give other bits. The host classes
below are numpy, copied from the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "LinearResampler",
    "RubatoResampler",
    "max_output_frames",
    "resample_chunk",
]


def max_output_frames(chunk_frames: int, src_rate: int, dst_rate: int) -> int:
    """Static upper bound on output frames per chunk."""
    return int(math.floor(chunk_frames * dst_rate / src_rate)) + 2


def resample_chunk(
    history: torch.Tensor,  # [..., channels] last input frame of previous chunk
    chunk: torch.Tensor,  # [..., frames, channels] deinterleaved input
    phase_num: torch.Tensor,  # [...] int32, source position numerator (units: 1/dst_num src samples)
    src_num: int,  # reduced source rate (src_rate / gcd)
    dst_num: int,  # reduced destination rate (dst_rate / gcd)
    max_out: int,
) -> tuple:
    """Resample one fixed-size chunk.

    Source timeline: index 0 is ``history``, 1..frames are ``chunk``. Output
    k is taken at exact source position ``(phase_num + k*src_num) / dst_num``;
    valid while it needs no sample beyond the chunk.

    Returns ``(out [..., max_out, channels], n_valid [...],
    new_phase_num [...], new_history [..., channels])``.
    """
    frames = chunk.shape[-2]
    src = torch.cat([history.unsqueeze(-2), chunk], dim=-2)  # frames+1 samples
    k = torch.arange(max_out, dtype=torch.int32, device=chunk.device)
    pos_num = phase_num.unsqueeze(-1) + k * src_num  # [..., max_out] int32, >= 0
    # floor division and modulo agree with C truncation on these
    # non-negative values
    idx0 = torch.div(pos_num, dst_num, rounding_mode="floor")
    frac = torch.remainder(pos_num, dst_num).to(torch.float32) * torch.tensor(
        1.0 / dst_num, dtype=torch.float32, device=chunk.device
    )
    valid = idx0 < frames  # lerp needs src[idx0+1] <= src[frames]
    idx0c = idx0.clamp(0, frames - 1).long().unsqueeze(-1)
    s0 = torch.take_along_dim(src, idx0c, dim=-2)
    s1 = torch.take_along_dim(src, idx0c + 1, dim=-2)
    # f32 lerp, reference interp_lin form: the product is rounded (its own
    # kernel) before the add (another kernel)
    delta = (s1 - s0) * frac.unsqueeze(-1)
    out = s0 + delta
    out = torch.where(valid.unsqueeze(-1), out, torch.zeros((), dtype=out.dtype, device=out.device))
    n_valid = valid.sum(-1, dtype=torch.int32)
    new_phase_num = phase_num + n_valid * src_num - frames * dst_num
    new_history = chunk[..., -1, :]
    return out, n_valid, new_phase_num, new_history


@dataclass
class LinearResampler:
    """Host-side stateful wrapper for single-stream use (nodes/tests).

    **Pure numpy — zero device dispatches.** This is the ``backend: "host"``
    path of ``audio::resampler``: live 20 ms streams at high session counts
    must never pay a per-chunk device round trip. The math is the exact same
    gather+lerp as :func:`resample_chunk`, which the device slot-table path
    runs, with the product rounded before the add on both sides, so the two
    backends stay byte-identical.

    The dynamic engine calls :func:`resample_chunk` directly with batched
    per-session state rows instead.
    """

    src_rate: int
    dst_rate: int
    chunk_frames: int
    channels: int

    def __post_init__(self) -> None:
        g = math.gcd(self.src_rate, self.dst_rate)
        self.src_num = self.src_rate // g
        self.dst_num = self.dst_rate // g
        # int32 overflow guard: phase_num + max_out*src_num must fit in int32
        self.max_out = max_output_frames(self.chunk_frames, self.src_rate, self.dst_rate)
        if (self.dst_num + self.max_out * self.src_num) >= 2**31:
            raise ValueError("sample-rate ratio too extreme for int32 phase tracking")
        # first output at source position 1.0 (= first real sample; index 0 is history)
        self._phase_num = self.dst_num
        self._history = np.zeros((self.channels,), dtype=np.float32)

    def process(self, chunk_interleaved: np.ndarray) -> np.ndarray:
        """Resample any whole number of interleaved frames; returns the valid
        interleaved output samples. Host-resident: numpy only.

        Unlike the fixed-shape device kernel, the host path is
        length-agnostic: the exact rational phase makes the output invariant
        to chunk boundaries, so callers may coalesce many 20 ms chunks into
        one call (the per-call numpy overhead dominated ingress at high
        session counts)."""
        frames = chunk_interleaved.shape[0] // self.channels
        if frames <= 0:
            return np.zeros(0, dtype=np.float32)
        chunk = np.asarray(chunk_interleaved, dtype=np.float32).reshape(frames, self.channels)
        src = np.concatenate([self._history[None, :], chunk], axis=0)  # frames+1 samples
        phase = self._phase_num
        # output k valid while idx0 = (phase + k*src_num) // dst_num < frames
        n = max(0, (frames * self.dst_num - 1 - phase) // self.src_num + 1)
        k = np.arange(n, dtype=np.int64)
        pos_num = phase + k * self.src_num
        idx0 = pos_num // self.dst_num
        frac = (pos_num % self.dst_num).astype(np.float32) * np.float32(1.0 / self.dst_num)
        s0 = src[idx0]
        s1 = src[idx0 + 1]
        out = s0 + (s1 - s0) * frac[:, None]  # f32 lerp — reference interp_lin form
        self._phase_num = phase + n * self.src_num - frames * self.dst_num
        self._history = chunk[-1].copy()
        return np.ascontiguousarray(out, dtype=np.float32).reshape(-1)


# ---------------------------------------------------------------------------
# rubato-compat mode (bit-exact reference parity)
# ---------------------------------------------------------------------------
_PLM = 8  # rubato POLYNOMIAL_LEN_MAX: history depth and loop bound use the
# septic maximum regardless of the active polynomial degree


@dataclass
class RubatoResampler:
    """Bit-exact reimplementation of rubato 0.16 ``FastFixedIn`` with
    ``PolynomialDegree::Linear`` at a fixed ratio — the reference resampler's
    exact configuration (``nodes/src/audio/filters/resampler.rs:231-244``).

    This is the ``compat: "rubato"`` mode of ``audio::resampler``: where
    :class:`LinearResampler` tracks phase as an exact rational (zero drift,
    the slot-table spec), this class reproduces rubato's **f64 ratio
    accumulator** — ``idx += 1/ratio`` per output sample, carried across
    chunks as ``last_index = idx - chunk_frames`` — so non-integer-ratio PCM
    (48 k→44.1 k, 44.1 k→16 k, …) is bit-identical to the reference,
    including the accumulator's sub-sample drift pattern (held bit for bit
    against the JAX package's copy and its golden fixtures).

    Host numpy on purpose: the accumulator is inherently sequential f64
    state; the vectorized form below reproduces the scalar sequence exactly
    (``np.add.accumulate`` is a strict left-to-right f64 fold) while staying
    one numpy call per chunk. Live-stream serving uses the host backend
    anyway (a per-chunk device dispatch costs more than the math).

    Unlike :class:`LinearResampler`, input buffers internally to whole
    ``chunk_frames`` (rubato is fixed-chunk-in); :meth:`process` accepts any
    length and emits what completed chunks produce. :meth:`flush` mirrors
    the reference's EOF remainder path (``resampler.rs:558-570``): the
    leftover frames run through a FRESH resampler sized to the remainder.
    """

    src_rate: int
    dst_rate: int
    chunk_frames: int
    channels: int

    def __post_init__(self) -> None:
        # rubato: resample_ratio = out/in (f64); t_ratio = 1.0/ratio
        self._t_ratio = np.float64(1.0) / (
            np.float64(self.dst_rate) / np.float64(self.src_rate)
        )
        self._last_index = -np.float64(_PLM) / 2.0
        self._hist = np.zeros((2 * _PLM, self.channels), np.float32)
        self._pend = np.zeros((0, self.channels), np.float32)
        self._end_idx = np.float64(self.chunk_frames - (_PLM + 1))

    def _run_chunk(self, chunk: np.ndarray, end_idx: np.float64) -> np.ndarray:
        """One fixed chunk through the accumulator; updates carry state."""
        frames = chunk.shape[0]
        buf = np.concatenate([self._hist, chunk], axis=0)
        # f64 accumulation identical to the scalar loop: acc[j] = a_j where
        # a_0 = last_index, a_j = a_{j-1} + t (strict sequential fold)
        n_max = int(np.ceil((end_idx - self._last_index) / self._t_ratio)) + 2
        n_max = max(n_max, 1)
        arr = np.full(n_max + 1, self._t_ratio, np.float64)
        arr[0] = self._last_index
        acc = np.add.accumulate(arr)
        # the loop emits j while a_{j-1} < end_idx (increment BEFORE emit)
        n = int(np.searchsorted(acc, end_idx, side="left"))
        idxs = acc[1 : n + 1]
        self._last_index = np.float64(
            (idxs[-1] if n else self._last_index) - np.float64(frames)
        )
        self._hist = buf[frames : frames + 2 * _PLM]
        if n == 0:
            return np.zeros((0, self.channels), np.float32)
        fl = np.floor(idxs)
        start = fl.astype(np.int64) + 2 * _PLM
        frac = (idxs - fl).astype(np.float32)[:, None]
        p0 = buf[start]
        p1 = buf[start + 1]
        # f32 lerp, product rounded before the add (rustc interp_lin)
        return p0 + frac * (p1 - p0)

    def process(self, chunk_interleaved: np.ndarray) -> np.ndarray:
        """Buffer input; resample every completed ``chunk_frames`` chunk.
        Returns interleaved f32 output samples."""
        x = np.asarray(chunk_interleaved, np.float32).reshape(-1, self.channels)
        self._pend = np.concatenate([self._pend, x], axis=0)
        outs = []
        while self._pend.shape[0] >= self.chunk_frames:
            chunk, self._pend = (
                self._pend[: self.chunk_frames],
                self._pend[self.chunk_frames :],
            )
            outs.append(self._run_chunk(chunk, self._end_idx))
        if not outs:
            return np.zeros(0, np.float32)
        return np.ascontiguousarray(np.concatenate(outs, axis=0)).reshape(-1)

    def flush(self) -> np.ndarray:
        """EOF: the reference runs leftover frames through a FRESH
        ``FastFixedIn`` sized to the remainder (``resampler.rs:558-570``) —
        fresh zero history, fresh ``last_index``."""
        rem = self._pend
        self._pend = np.zeros((0, self.channels), np.float32)
        if rem.shape[0] == 0:
            return np.zeros(0, np.float32)
        fresh = RubatoResampler(
            self.src_rate, self.dst_rate, rem.shape[0], self.channels
        )
        out = fresh._run_chunk(rem, fresh._end_idx)
        return np.ascontiguousarray(out).reshape(-1)
