# SPDX-License-Identifier: Apache-2.0
"""Silero-class learned VAD in PyTorch.

Port of ``streamkit_tpu/models/silero_vad.py``: 512-sample frames @16 kHz,
64 samples of carried context, LSTM(128) state, one speech probability per
frame. Windowed STFT features → per-frame MLP encoder → LSTM carried across
the frame's four STFT offsets → sigmoid head. The reference's ``lax.scan``
over frames is a Python loop; batch dimensions ride through.

Weights: any npz matching :data:`PARAM_SHAPES` (the bundled
``weights/vad_synth.npz`` is a copy of the reference's).
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "LearnedVadState",
    "PARAM_SHAPES",
    "init_params",
    "init_state",
    "apply",
    "load_params",
]

FRAME = 512
CONTEXT = 64
N_FFT = 256
N_BINS = N_FFT // 2 + 1
# STFT frame offsets inside the 576-sample (context+frame) window
_OFFSETS = (0, 128, 256, 320)
ENC_DIM = 64
HIDDEN = 128


class LearnedVadState(NamedTuple):
    h: torch.Tensor  # [..., HIDDEN]
    c: torch.Tensor  # [..., HIDDEN]
    context: torch.Tensor  # [..., CONTEXT]


PARAM_SHAPES: Dict[str, Tuple[int, ...]] = {
    "enc_w": (N_BINS, ENC_DIM),
    "enc_b": (ENC_DIM,),
    "lstm_wx": (ENC_DIM, 4 * HIDDEN),
    "lstm_wh": (HIDDEN, 4 * HIDDEN),
    "lstm_b": (4 * HIDDEN,),
    "head_w1": (HIDDEN, ENC_DIM),
    "head_b1": (ENC_DIM,),
    "head_w2": (ENC_DIM, 1),
    "head_b2": (1,),
}


def init_params(seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape in PARAM_SHAPES.items():
        if name.endswith("_b"):
            params[name] = np.zeros(shape, np.float32)
        else:
            params[name] = (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
    params["lstm_b"][HIDDEN : 2 * HIDDEN] = 1.0  # forget-gate bias
    return params


def init_state(batch_shape=(), device=None) -> LearnedVadState:
    dev = resolve_device(device)
    return LearnedVadState(
        h=torch.zeros(batch_shape + (HIDDEN,), device=dev),
        c=torch.zeros(batch_shape + (HIDDEN,), device=dev),
        context=torch.zeros(batch_shape + (CONTEXT,), device=dev),
    )


@functools.lru_cache(maxsize=8)
def _stft_bases(device: torch.device):
    """Windowed DFT bases ``[N_FFT, N_BINS]`` (cos, sin) on ``device``."""
    k = np.arange(N_FFT)[:, None]
    f = np.arange(N_BINS)[None, :]
    ang = -2.0 * np.pi * k * f / N_FFT
    w = np.hanning(N_FFT)[:, None]
    cos_b = (np.cos(ang) * w).astype(np.float32)
    sin_b = (np.sin(ang) * w).astype(np.float32)
    return torch.from_numpy(cos_b).to(device), torch.from_numpy(sin_b).to(device)


def _features(x: torch.Tensor) -> torch.Tensor:
    """``[..., 576]`` window → ``[..., len(_OFFSETS), N_BINS]`` log-magnitudes."""
    cos_b, sin_b = _stft_bases(x.device)
    frames = torch.stack([x[..., o : o + N_FFT] for o in _OFFSETS], dim=-2)
    re = torch.matmul(frames, cos_b)
    im = torch.matmul(frames, sin_b)
    return torch.log1p(torch.sqrt(re * re + im * im) * 32.0)


def _lstm_cell(params, x, h, c):
    gates = x @ params["lstm_wx"] + h @ params["lstm_wh"] + params["lstm_b"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def apply(
    params: Dict[str, torch.Tensor], state: LearnedVadState, frames: torch.Tensor
) -> Tuple[torch.Tensor, LearnedVadState]:
    """Score frames: ``[..., n_frames, FRAME]`` → (probs ``[..., n_frames]``,
    new state). ``params`` are tensors on the frames' device."""
    probs = []
    st = state
    for n in range(frames.shape[-2]):
        x = torch.cat([st.context, frames[..., n, :]], dim=-1)  # [..., 576]
        enc = torch.relu(_features(x) @ params["enc_w"] + params["enc_b"])  # [..., T, E]
        h, c = st.h, st.c
        for t in range(len(_OFFSETS)):
            h, c = _lstm_cell(params, enc[..., t, :], h, c)
        z = torch.relu(h @ params["head_w1"] + params["head_b1"])
        logit = (z @ params["head_w2"] + params["head_b2"])[..., 0]
        probs.append(torch.sigmoid(logit))
        st = LearnedVadState(h, c, x[..., -CONTEXT:])
    return torch.stack(probs, dim=-1), st


def load_params(path: str) -> Dict[str, np.ndarray]:
    data = np.load(path)
    params = {}
    for name, shape in PARAM_SHAPES.items():
        if name not in data:
            raise ValueError(f"VAD weights file missing parameter {name!r}")
        arr = np.asarray(data[name], np.float32)
        if arr.shape != shape:
            raise ValueError(f"VAD weight {name}: expected {shape}, got {arr.shape}")
        params[name] = arr
    return params
