# SPDX-License-Identifier: Apache-2.0
"""Voice-activity detection: per-frame speech probability on the device.

Port of ``streamkit_tpu/ops/vad.py``. Two backends behind one contract
(512-sample frames → one probability per frame, carried per-session state,
batched over sessions):

* **learned** (default when weights are present): the Silero-class LSTM in
  :mod:`streamkit_tpu_torch.models.silero_vad`; weights from
  ``SK_VAD_WEIGHTS`` or the bundled ``models/weights/vad_synth.npz``.
* **spectral** (when no weights file exists; force with
  ``SK_VAD_BACKEND=spectral``): band-limited speech energy over an adaptive
  noise floor, weighted by spectral structure, with attack/decay smoothing.

The backend is resolved once, at first use: slot tables keep state rows
whose structure must not change afterwards.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "VadState",
    "vad_init_state",
    "vad_frame_probs",
    "vad_backend",
    "load_vad_weights",
    "VAD_FRAME",
    "VAD_CONTEXT",
]

VAD_FRAME = 512  # 32 ms @ 16 kHz
VAD_CONTEXT = 64  # samples of left context
_SR = 16_000


class VadState(NamedTuple):
    noise_floor: torch.Tensor  # [...] EMA of noise energy (log domain)
    context: torch.Tensor  # [..., VAD_CONTEXT] previous samples
    prob_ema: torch.Tensor  # [...] smoothed probability


def _spectral_init_state(batch_shape, device) -> VadState:
    return VadState(
        noise_floor=torch.full(batch_shape, -6.0, device=device),
        context=torch.zeros(batch_shape + (VAD_CONTEXT,), device=device),
        prob_ema=torch.zeros(batch_shape, device=device),
    )


@functools.lru_cache(maxsize=8)
def _band_bases(device: torch.device):
    """Windowed DFT bases restricted to the speech band (200–4000 Hz)."""
    n = VAD_FRAME + VAD_CONTEXT
    freqs = np.fft.rfftfreq(n, d=1.0 / _SR)
    keep = (freqs >= 200.0) & (freqs <= 4000.0)
    k = np.arange(n)[:, None]
    f = np.nonzero(keep)[0][None, :]
    ang = -2.0 * np.pi * k * f / n
    w = np.hanning(n)[:, None]
    cos_b = (np.cos(ang) * w).astype(np.float32)
    sin_b = (np.sin(ang) * w).astype(np.float32)
    return torch.from_numpy(cos_b).to(device), torch.from_numpy(sin_b).to(device)


def _spectral_frame_probs(state: VadState, frames: torch.Tensor) -> tuple:
    """``frames [..., n_frames, VAD_FRAME]`` f32 → ``(probs [..., n_frames],
    new_state)``: speech-band SNR over an adaptive noise floor, weighted by
    spectral structure; fast attack, slow release."""
    cos_b, sin_b = _band_bases(frames.device)
    st = state
    probs = []
    for n in range(frames.shape[-2]):
        x = torch.cat([st.context, frames[..., n, :]], dim=-1)  # [..., 576]
        re = torch.matmul(x, cos_b)
        im = torch.matmul(x, sin_b)
        power = re * re + im * im  # [..., n_band]
        band_energy = power.mean(dim=-1)
        log_e = torch.log(band_energy + 1e-10)
        # spectral flatness: geometric over arithmetic mean
        flatness = torch.exp(torch.log(power + 1e-10).mean(dim=-1)) / (band_energy + 1e-10)
        structure = 1.0 - torch.clamp(flatness * 4.0, 0.0, 1.0)
        # adaptive noise floor: fast decay toward quiet, slow rise
        alpha = torch.where(log_e < st.noise_floor, 0.3, 0.005)
        new_floor = st.noise_floor + alpha * (log_e - st.noise_floor)
        snr = log_e - new_floor
        raw = torch.sigmoid(2.0 * (snr - 1.5)) * (0.5 + 0.5 * structure)
        beta = torch.where(raw > st.prob_ema, 0.7, 0.3)
        prob = st.prob_ema + beta * (raw - st.prob_ema)
        st = VadState(new_floor, x[..., -VAD_CONTEXT:], prob)
        probs.append(prob)
    return torch.stack(probs, dim=-1), st


# ---------------------------------------------------------------------------
# backend dispatch

_BACKEND = None  # "learned" | "spectral", frozen at first use
_LEARNED_PARAMS = None  # numpy weights of the learned backend
_LEARNED_ON = {}  # device → tensor copies of _LEARNED_PARAMS


def _bundled_weights_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "models",
        "weights",
        "vad_synth.npz",
    )


def load_vad_weights(path: str) -> None:
    """Install learned-VAD weights (must happen before any state is created)."""
    global _BACKEND, _LEARNED_PARAMS
    from ..models import silero_vad as sv

    _LEARNED_PARAMS = sv.load_params(path)  # raises on schema mismatch
    _LEARNED_ON.clear()
    _BACKEND = "learned"


def _ensure_backend() -> str:
    global _BACKEND
    if _BACKEND is not None:
        return _BACKEND
    forced = os.environ.get("SK_VAD_BACKEND", "").lower()
    if forced == "spectral":
        _BACKEND = "spectral"
        return _BACKEND
    path = os.environ.get("SK_VAD_WEIGHTS") or _bundled_weights_path()
    if os.path.exists(path):
        try:
            load_vad_weights(path)
            return _BACKEND
        except (ValueError, OSError):
            if os.environ.get("SK_VAD_WEIGHTS"):
                raise  # an explicitly requested weights file must load
    _BACKEND = "spectral"
    return _BACKEND


def vad_backend() -> str:
    """Resolved backend name ("learned" or "spectral")."""
    return _ensure_backend()


def vad_init_state(batch_shape=(), device=None):
    """Initial state rows ``batch_shape`` on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    if _ensure_backend() == "learned":
        from ..models import silero_vad as sv

        return sv.init_state(tuple(batch_shape), dev)
    return _spectral_init_state(tuple(batch_shape), dev)


def _learned_params(device: torch.device):
    params = _LEARNED_ON.get(device)
    if params is None:
        params = {k: torch.from_numpy(v).to(device) for k, v in _LEARNED_PARAMS.items()}
        _LEARNED_ON[device] = params
    return params


def vad_frame_probs(state, frames: torch.Tensor) -> tuple:
    """Score VAD frames: ``[..., n_frames, VAD_FRAME]`` f32 @16 kHz →
    ``(probs [..., n_frames], new_state)`` with the resolved backend."""
    if _ensure_backend() == "learned":
        from ..models import silero_vad as sv

        return sv.apply(_learned_params(frames.device), state, frames)
    return _spectral_frame_probs(state, frames)
