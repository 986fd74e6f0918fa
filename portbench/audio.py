# SPDX-License-Identifier: Apache-2.0
"""The benchmark's audio: seeded synthetic speech at 16 kHz, int16.

A run synthesises a library of utterances whose durations are fixed by the
traffic mix (the seed draws their sound, not their length), then lays them
out with the mix's fixed cycle of pauses: every seed gives the same amount
of speech and silence, in another order. A noise floor, drawn from the
seed, lies under everything, so no two streams share a sample run and no
stretch is digital silence.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from speechsynth import _synth_utterance

SR = 16_000


def library(seed: int, durations: Sequence[float]) -> List[np.ndarray]:
    """One float32 utterance per duration, faded at both ends."""
    rng = np.random.default_rng([seed, 1])
    out = []
    for dur in durations:
        n = int(round(dur * SR))
        u = _synth_utterance(n / SR, SR, rng)[:n]
        edge = min(int(0.02 * SR), n // 2)
        w = np.ones(n, np.float32)
        w[:edge] = np.linspace(0, 1, edge, dtype=np.float32)
        w[-edge:] = np.linspace(1, 0, edge, dtype=np.float32)
        out.append(u * w)
    return out


def compose(lib: List[np.ndarray], order: Sequence[int], pauses: Sequence[float], lead_s: float,
            total_s: float, noise_dbfs: float, rng: np.random.Generator) -> np.ndarray:
    """``lead_s`` of noise, then the utterances in ``order`` (cycled) with the
    pauses in turn, cut to ``total_s``; int16."""
    n = int(round(total_s * SR))
    x = np.zeros(n, np.float32)
    pos, i = int(round(lead_s * SR)), 0
    while pos < n:
        u = lib[order[i % len(order)]]
        m = min(u.size, n - pos)
        x[pos : pos + m] = u[:m]
        pos += u.size + int(round(pauses[i % len(pauses)] * SR))
        i += 1
    x += np.float32(10.0 ** (noise_dbfs / 20.0)) * rng.standard_normal(n, dtype=np.float32)
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


def as_float(pcm: np.ndarray) -> np.ndarray:
    """The int16 samples as float32 in [-1, 1), exactly (the wire the program
    quantizes back to int16 gives the same samples)."""
    return pcm.astype(np.float32) / 32768.0
