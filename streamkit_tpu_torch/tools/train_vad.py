# SPDX-License-Identifier: Apache-2.0
"""Train the bundled learned VAD on synthesized + real speech.

Port of ``tools/train_vad.py``. The formant synthesizer
(:mod:`streamkit_tpu_torch.utils.speechsynth`) gives speech-like positives
with exact frame labels; negatives are silence, white and pink noise, AM
noise, tones and synth music; speech under noise keeps its speech label.
Where the OpenSpeech sample (``SK_VAD_REAL_SPEECH``, default the reference
checkout's ``samples/audio/system/speech_10m.opus``) decodes, real-speech
clips pseudo-labelled by the weight-free spectral scorer join in: frames
over 0.8 are speech, under 0.2 nonspeech, the rest left out of the loss.
Every clip gets a gain and a random EQ tilt.

The same seeds draw the same clips as the reference. The parameters are
leaf tensors on ``device`` (``cuda`` unless the caller passes
``device="cpu"``); autograd through :func:`..models.silero_vad.apply`
gives the gradient, and ``torch.optim.Adam(lr=3e-4)`` the update optax's
``adam(3e-4)`` makes. The data, the spectral teacher included, is made on
the host, so a run on the card and one on the CPU train on the same
labels.

    python -m streamkit_tpu_torch.tools.train_vad [--device cpu] [--out PATH]

``SK_VAD_STEPS`` sets the steps (1200). Without ``--out`` it overwrites the
port's bundled ``streamkit_tpu_torch/models/weights/vad_synth.npz``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import silero_vad as sv
from ..utils.speechsynth import synth_music, synth_speech_with_plan

__all__ = ["make_dataset", "loss_fn", "init_training", "to_device", "train_step", "train", "main", "BUNDLED_WEIGHTS"]

FRAME = sv.FRAME
SR = 16000
CLIP_FRAMES = 48  # ~1.5 s clips (48 x 32 ms)
CLIP = CLIP_FRAMES * FRAME
LR = 3e-4
BATCH = 64
VAL_CLIPS, VAL_SEED = 128, 999_999
TEACHER_BLOCK = 256  # frames per spectral-teacher call
BUNDLED_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "models", "weights", "vad_synth.npz"
)


def _pink(rng, n):
    white = rng.standard_normal(n + 1024).astype(np.float32)
    # crude 1/f shaping via cumulative smoothing
    k = np.exp(-np.arange(256) / 64.0).astype(np.float32)
    pink = np.convolve(white, k, mode="same")[:n]
    return pink / (np.abs(pink).max() + 1e-6)


_REAL_SAMPLE = os.environ.get(
    "SK_VAD_REAL_SPEECH",
    "/root/reference/samples/audio/system/speech_10m.opus",
)
_REAL = None  # (frames [N, FRAME] f32, probs [N] spectral) or () if absent


def _load_real():
    """Decode the real-speech sample at 16 kHz and pseudo-label every frame
    with the spectral scorer, on the CPU, in blocks of 256 frames."""
    global _REAL
    if _REAL is not None:
        return _REAL
    try:
        from ..ops.vad import _spectral_frame_probs, _spectral_init_state
        from ..utils.realspeech import load_opus_16k

        a16 = load_opus_16k(_REAL_SAMPLE)
        if a16 is None:
            raise FileNotFoundError(_REAL_SAMPLE)
        nf = len(a16) // FRAME
        frames = a16[: nf * FRAME].reshape(nf, FRAME)
        st = _spectral_init_state((), torch.device("cpu"))
        probs = []
        with torch.no_grad():
            for i in range(0, nf, TEACHER_BLOCK):
                p, st = _spectral_frame_probs(st, torch.from_numpy(frames[i : i + TEACHER_BLOCK]))
                probs.append(p.numpy())
        probs = np.concatenate(probs)
        _REAL = (frames, probs)
        print(
            f"# real-speech teacher: {nf} frames from {_REAL_SAMPLE} "
            f"(speech {(probs > 0.8).mean():.0%}, nonspeech {(probs < 0.2).mean():.0%}, "
            f"masked {((probs >= 0.2) & (probs <= 0.8)).mean():.0%})",
            flush=True,
        )
    except Exception as e:  # noqa: BLE001 — train synthetic-only without it
        print(f"# real-speech fixture unavailable ({e}); synthetic-only", flush=True)
        _REAL = ()
    return _REAL


def _augment(rng, audio):
    """Gain + first-order EQ tilt, matching real capture-level diversity."""
    gain = float(rng.uniform(0.05, 1.4))
    audio = audio * gain
    if rng.integers(0, 2):  # one-pole tilt (dark or bright)
        a = float(rng.uniform(-0.6, 0.6))
        out = np.empty_like(audio)
        # y[t] = x[t] + a*x[t-1] — cheap spectral tilt
        out[0] = audio[0]
        out[1:] = audio[1:] + a * audio[:-1]
        audio = out
    return np.clip(audio, -1.0, 1.0)


def make_dataset(n_clips: int, seed: int):
    """Returns (audio [N, CLIP], labels [N, CLIP_FRAMES], weight [N, CLIP_FRAMES])."""
    rng = np.random.default_rng(seed)
    real = _load_real()
    xs, ys, ws = [], [], []
    for i in range(n_clips):
        # 14 slots: 0-2 real speech, 3-7 synth speech (6-7 noisy), 8-9
        # stationary noise, 10 AM noise, 11 tones, 12 music, 13 near-silence;
        # real clips must not crowd out synth speech
        kind = rng.integers(0, 14)
        if len(real) and kind < 3:  # real speech, spectral-pseudo-labelled
            frames, probs = real
            j = int(rng.integers(0, len(frames) - CLIP_FRAMES))
            audio = _augment(rng, frames[j : j + CLIP_FRAMES].reshape(-1).copy())
            p = probs[j : j + CLIP_FRAMES]
            label = (p > 0.8).astype(np.float32)
            weight = ((p > 0.8) | (p < 0.2)).astype(np.float32)
            if rng.integers(0, 3) == 0:  # noise under real speech
                audio = audio + rng.standard_normal(CLIP).astype(np.float32) * float(
                    rng.uniform(0.002, 0.03)
                )
            xs.append(audio[:CLIP])
            ys.append(label)
            ws.append(weight)
            continue
        if kind < 8:  # synth speech (possibly noisy)
            audio, plan = synth_speech_with_plan(
                CLIP / SR + 0.2, SR, seed=seed * 7919 + i, lead_silence_s=float(rng.uniform(0, 0.5))
            )
            audio = audio[:CLIP]
            label = plan.speech_mask(FRAME / SR)[:CLIP_FRAMES].astype(np.float32)
            if len(label) < CLIP_FRAMES:
                label = np.pad(label, (0, CLIP_FRAMES - len(label)))
            gain = float(rng.uniform(0.2, 1.5))
            audio = audio * gain
            if kind >= 6:  # add noise under the speech
                snr = float(rng.uniform(0.02, 0.15))
                noise = rng.standard_normal(CLIP).astype(np.float32) * snr * gain
                audio = audio + noise
        elif kind < 10:  # stationary noise (white or pink), wide level range
            level = float(rng.uniform(0.005, 0.5))
            audio = (
                rng.standard_normal(CLIP).astype(np.float32)
                if kind == 8
                else _pink(rng, CLIP)
            ) * level
            label = np.zeros(CLIP_FRAMES, np.float32)
        elif kind == 10:  # amplitude-modulated noise — hard negative
            t = np.arange(CLIP) / SR
            env = 0.5 + 0.5 * np.sin(2 * np.pi * float(rng.uniform(2.0, 6.0)) * t)
            audio = (rng.standard_normal(CLIP) * env * float(rng.uniform(0.05, 0.3))).astype(
                np.float32
            )
            label = np.zeros(CLIP_FRAMES, np.float32)
        elif kind == 11:  # pure tone(s) — structured but not speech-modulated
            t = np.arange(CLIP) / SR
            f = float(rng.uniform(100, 2000))
            audio = (0.3 * np.sin(2 * np.pi * f * t)).astype(np.float32)
            label = np.zeros(CLIP_FRAMES, np.float32)
        elif kind == 12:  # music
            audio = synth_music(CLIP / SR + 0.1, SR, seed=seed * 104729 + i)[:CLIP]
            label = np.zeros(CLIP_FRAMES, np.float32)
        else:  # near-silence
            audio = rng.standard_normal(CLIP).astype(np.float32) * 0.002
            label = np.zeros(CLIP_FRAMES, np.float32)
        if len(audio) < CLIP:
            audio = np.pad(audio, (0, CLIP - len(audio)))
        xs.append(audio[:CLIP])
        ys.append(label)
        ws.append(np.ones(CLIP_FRAMES, np.float32))
    return np.stack(xs), np.stack(ys), np.stack(ws)


def loss_fn(params: Dict[str, torch.Tensor], audio, labels, weight):
    """Weighted BCE over the clips' frames and the weighted frame accuracy
    at 0.5 → (loss, acc), scalar tensors on the params' device."""
    frames = audio.reshape(audio.shape[0], CLIP_FRAMES, FRAME)
    state = sv.init_state((audio.shape[0],), audio.device)
    probs, _ = sv.apply(params, state, frames)
    eps = 1e-6
    bce = -(labels * torch.log(probs + eps) + (1 - labels) * torch.log(1 - probs + eps))
    wsum = torch.clamp(weight.sum(), min=1.0)
    acc = (((probs > 0.5) == (labels > 0.5)) * weight).sum() / wsum
    return (bce * weight).sum() / wsum, acc


def init_training(device=None, seed: int = 0, params: Optional[dict] = None):
    """(params, optimizer): ``init_params(seed)`` (or ``params``, numpy) as
    leaf tensors on ``device`` and Adam at 3e-4 over them."""
    dev = resolve_device(device)
    src = sv.init_params(seed) if params is None else params
    leaves = {k: torch.tensor(np.asarray(v, np.float32), device=dev, requires_grad=True) for k, v in src.items()}
    return leaves, torch.optim.Adam(leaves.values(), lr=LR, betas=(0.9, 0.999), eps=1e-8)


def to_device(batch, device: torch.device):
    """A numpy ``(audio, labels, weight)`` batch as tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in batch)


def train_step(params, opt, audio, labels, weight):
    """One Adam step on one batch of tensors → (loss, acc) before the step."""
    opt.zero_grad(set_to_none=True)
    loss, acc = loss_fn(params, audio, labels, weight)
    loss.backward()
    opt.step()
    return loss.detach(), acc


def train(n_steps: int, device=None):
    """``n_steps`` Adam steps from ``init_params(0)``, step ``it`` on
    ``make_dataset(64, seed=it)``, validated every 50 steps and at the last
    on the 128 clips of seed 999 999 → (params, val acc)."""
    dev = resolve_device(device)
    params, opt = init_training(dev)
    val = to_device(make_dataset(VAL_CLIPS, seed=VAL_SEED), dev)
    vacc = None
    for it in range(n_steps):
        loss, acc = train_step(params, opt, *to_device(make_dataset(BATCH, seed=it), dev))
        if it % 50 == 0 or it == n_steps - 1:
            with torch.no_grad():
                vloss, vacc = loss_fn(params, *val)
            print(f"step {it}: loss {loss.item():.4f} acc {acc.item():.3f} | "
                  f"val loss {vloss.item():.4f} acc {vacc.item():.3f}", flush=True)
    if vacc is None:  # no step taken
        with torch.no_grad():
            vacc = loss_fn(params, *val)[1]
    return params, vacc.item()


def main(argv=None, out: Optional[str] = None) -> str:
    """Train for ``SK_VAD_STEPS`` (1200) steps and write the weights to
    ``out`` (default: the port's bundled ``vad_synth.npz``) → the path."""
    ap = argparse.ArgumentParser(prog="python -m streamkit_tpu_torch.tools.train_vad")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="weights file (default: the bundled vad_synth.npz)")
    args = ap.parse_args(argv if argv is not None else [])
    out = os.path.abspath(out or args.out or BUNDLED_WEIGHTS)
    t0 = time.monotonic()
    params, vacc = train(int(os.environ.get("SK_VAD_STEPS", 1200)), device=args.device)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    sv.save_params(params, out)
    print(f"saved {os.path.normpath(out)} (val acc {vacc:.3f}, {time.monotonic() - t0:.1f} s)")
    return out


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
