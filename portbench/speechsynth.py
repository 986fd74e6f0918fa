# SPDX-License-Identifier: Apache-2.0
"""Offline speech-like audio synthesizer for fixtures and VAD calibration.

A numpy/scipy copy of ``streamkit_tpu/utils/speechsynth.py`` (the port
imports nothing of the JAX package); the same seed gives the same audio.

The reference ships licensed recorded speech fixtures
(``samples/audio/system/speech_10m.opus`` etc.) used by its load tests and
VAD. This environment is zero-egress, so we synthesize speech-*like* audio
instead: a source-filter formant synthesizer (glottal pulse train + noise
excitation through 3 formant resonators with prosody, syllable rhythm, and
sentence pauses). The output has realistic speech statistics — harmonic
voiced segments around 80–300 Hz f0, formant structure, 3–6 Hz syllable
energy modulation, silence gaps — which is what VAD segmentation and
loadtest media paths actually exercise.

Everything is deterministic given a seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

__all__ = [
    "SpeechPlan",
    "synth_speech",
    "synth_speech_with_plan",
    "synth_music",
]


# Vowel formant targets (F1, F2, F3) in Hz — classic Peterson-Barney values.
_VOWELS = [
    (730, 1090, 2440),  # /a/
    (270, 2290, 3010),  # /i/
    (300, 870, 2240),   # /u/
    (530, 1840, 2480),  # /e/
    (570, 840, 2410),   # /o/
    (660, 1720, 2410),  # /ae/
]


def _resonator_coeffs(freq: float, bw: float, sr: float) -> Tuple[float, float, float]:
    """Two-pole resonator (Klatt-style formant filter) coefficients."""
    r = float(np.exp(-np.pi * bw / sr))
    theta = 2.0 * np.pi * freq / sr
    b1 = 2.0 * r * np.cos(theta)
    b2 = -r * r
    a0 = 1.0 - b1 - b2
    return a0, b1, b2


def _apply_resonator(x: np.ndarray, freq: float, bw: float, sr: float) -> np.ndarray:
    a0, b1, b2 = _resonator_coeffs(freq, bw, sr)
    from scipy.signal import lfilter

    return lfilter([a0], [1.0, -b1, -b2], x).astype(np.float32)


def _glottal_source(n: int, f0: np.ndarray, sr: float, rng: np.random.Generator) -> np.ndarray:
    """Pulse-train-ish source: integrated sawtooth with jitter/shimmer."""
    jitter = 1.0 + 0.01 * rng.standard_normal(n).astype(np.float32)
    phase = np.cumsum(f0 * jitter) / sr
    saw = 2.0 * (phase % 1.0) - 1.0
    # soften to approximate a glottal flow derivative
    out = saw - np.roll(saw, 1)
    out[0] = 0.0
    shimmer = 1.0 + 0.05 * rng.standard_normal(n).astype(np.float32)
    return (out * shimmer).astype(np.float32)


@dataclass
class SpeechPlan:
    """Ground-truth activity plan: list of (start_s, end_s, kind) where kind
    is "speech" or "silence". Used by VAD segmentation tests."""

    segments: List[Tuple[float, float, str]]
    sample_rate: int

    def speech_mask(self, frame_s: float) -> np.ndarray:
        """Per-frame boolean speech mask at the given frame size."""
        total = self.segments[-1][1] if self.segments else 0.0
        n = int(round(total / frame_s))
        mask = np.zeros(n, dtype=bool)
        for s, e, kind in self.segments:
            if kind != "speech":
                continue
            i0, i1 = int(round(s / frame_s)), int(round(e / frame_s))
            mask[i0:i1] = True
        return mask


def _synth_utterance(dur_s: float, sr: int, rng: np.random.Generator) -> np.ndarray:
    """One utterance: a run of syllables (voiced vowels + fricative onsets)."""
    n = int(dur_s * sr)
    t = np.arange(n, dtype=np.float32) / sr
    # prosody: declining f0 contour with per-syllable wiggle
    f0_base = float(rng.uniform(95.0, 220.0))
    syll_rate = float(rng.uniform(3.0, 5.5))  # syllables/sec
    f0 = f0_base * (1.0 - 0.15 * t / max(dur_s, 0.3)) * (
        1.0 + 0.06 * np.sin(2 * np.pi * syll_rate * t + rng.uniform(0, 6.28))
    )
    voiced = _glottal_source(n, f0.astype(np.float32), sr, rng)

    # syllable amplitude envelope (raised cosine bumps)
    env = 0.5 - 0.5 * np.cos(2 * np.pi * syll_rate * t + rng.uniform(0, 6.28))
    env = (env.astype(np.float32) ** 1.5) * 0.9 + 0.1

    # time-varying formants: glide between 2-4 vowels across the utterance
    n_v = int(rng.integers(2, 5))
    targets = [
        _VOWELS[int(rng.integers(0, len(_VOWELS)))] for _ in range(n_v)
    ]
    out = np.zeros(n, dtype=np.float32)
    seg = max(1, n // n_v)
    for i in range(n_v):
        lo, hi = i * seg, min(n, (i + 1) * seg) if i < n_v - 1 else n
        if hi <= lo:
            continue
        chunk = voiced[lo:hi]
        f1, f2, f3 = targets[i]
        y = (
            _apply_resonator(chunk, f1, 90.0, sr)
            + 0.6 * _apply_resonator(chunk, f2, 110.0, sr)
            + 0.25 * _apply_resonator(chunk, f3, 170.0, sr)
        )
        out[lo:hi] = y

    # sprinkle fricative-like noise bursts at syllable boundaries
    n_fric = int(dur_s * syll_rate * 0.4)
    for _ in range(n_fric):
        pos = int(rng.integers(0, max(1, n - sr // 20)))
        ln = int(rng.uniform(0.03, 0.08) * sr)
        noise = rng.standard_normal(ln).astype(np.float32)
        noise = _apply_resonator(noise, float(rng.uniform(2500, 6000)), 1500.0, sr)
        w = np.hanning(ln).astype(np.float32)
        out[pos : pos + ln] += 0.35 * noise[: n - pos] * w[: n - pos]

    out *= env
    peak = float(np.max(np.abs(out)) or 1.0)
    return (out / peak * 0.5).astype(np.float32)


def synth_speech_with_plan(
    duration_s: float,
    sample_rate: int = 16000,
    seed: int = 0,
    pause_range: Tuple[float, float] = (0.35, 0.9),
    utt_range: Tuple[float, float] = (0.8, 3.5),
    lead_silence_s: float = 0.4,
) -> Tuple[np.ndarray, SpeechPlan]:
    """Synthesize speech-like audio and return (float32 mono audio, plan)."""
    rng = np.random.default_rng(seed)
    sr = sample_rate
    total = int(duration_s * sr)
    audio = np.zeros(total, dtype=np.float32)
    segments: List[Tuple[float, float, str]] = []
    pos = int(lead_silence_s * sr)
    if pos > 0:
        segments.append((0.0, pos / sr, "silence"))
    while pos < total:
        dur = float(rng.uniform(*utt_range))
        n = min(int(dur * sr), total - pos)
        if n > sr // 10:
            utt = _synth_utterance(n / sr, sr, rng)
            if len(utt) < n:
                utt = np.pad(utt, (0, n - len(utt)))
            utt = utt[:n]
            # fade edges to avoid clicks
            edge = min(int(0.02 * sr), n // 2)
            w = np.ones(n, dtype=np.float32)
            w[:edge] = np.linspace(0, 1, edge, dtype=np.float32)
            w[-edge:] = np.linspace(1, 0, edge, dtype=np.float32)
            audio[pos : pos + n] = utt * w
            segments.append((pos / sr, (pos + n) / sr, "speech"))
        pos += n
        gap = int(float(rng.uniform(*pause_range)) * sr)
        gap = min(gap, total - pos)
        if gap > 0:
            segments.append((pos / sr, (pos + gap) / sr, "silence"))
            pos += gap
    return audio, SpeechPlan(segments=segments, sample_rate=sr)


def synth_speech(duration_s: float, sample_rate: int = 16000, seed: int = 0) -> np.ndarray:
    audio, _ = synth_speech_with_plan(duration_s, sample_rate, seed)
    return audio


def synth_music(duration_s: float, sample_rate: int = 48000, seed: int = 0) -> np.ndarray:
    """Arpeggiated chord synth — a music-like fixture (steady energy, no
    speech rhythm) for codec/mixer paths and VAD negative tests."""
    rng = np.random.default_rng(seed)
    sr = sample_rate
    n = int(duration_s * sr)
    t = np.arange(n, dtype=np.float32) / sr
    out = np.zeros(n, dtype=np.float32)
    chords = [[220.0, 277.2, 329.6], [196.0, 246.9, 293.7], [174.6, 220.0, 261.6]]
    beat = 0.25  # seconds per arpeggio note
    idx = (t / beat).astype(np.int64)
    for k in range(int(np.ceil(duration_s / beat))):
        chord = chords[(k // 8) % len(chords)]
        f = chord[k % 3] * (2.0 if k % 7 == 0 else 1.0)
        sel = idx == k
        tt = t[sel] - k * beat
        env = np.exp(-tt * 6.0).astype(np.float32)
        out[sel] += env * (
            0.5 * np.sin(2 * np.pi * f * tt)
            + 0.25 * np.sin(2 * np.pi * 2 * f * tt)
            + 0.12 * np.sin(2 * np.pi * 3 * f * tt + rng.uniform(0, 3))
        ).astype(np.float32)
    peak = float(np.max(np.abs(out)) or 1.0)
    return (out / peak * 0.4).astype(np.float32)
