# SPDX-License-Identifier: Apache-2.0
"""Whisper-compatible log-mel spectrogram frontend.

Port of ``streamkit_tpu/ops/mel.py``: 16 kHz, n_fft=400, hop=160, periodic
Hann window, 80 (or 128) slaney-norm mel bands, ``log10(clip(.,1e-10))``
then dynamic-range compression ``max(log, max-8); (log+4)/4``. The DFT is
two real matmuls against precomputed cos/sin bases, in full float32 (the
reference runs them at ``Precision.HIGHEST``). Batched: ``[batch, samples]``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import strict_fp32

__all__ = ["mel_filterbank", "log_mel_spectrogram", "N_FFT", "HOP_LENGTH", "SAMPLE_RATE"]

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(n_mels: int = 80, sample_rate: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank ``[n_mels, n_fft//2+1]``
    (equivalent to ``librosa.filters.mel`` defaults, as Whisper ships)."""
    fft_freqs = np.fft.rfftfreq(n_fft, d=1.0 / sample_rate)
    mel_min, mel_max = _hz_to_mel(np.array(0.0)), _hz_to_mel(np.array(sample_rate / 2))
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_bases(n_fft: int, device: torch.device):
    """Windowed DFT bases ``[n_fft, n_fft//2+1]`` (cos, sin) on ``device``."""
    k = np.arange(n_fft)[:, None]
    f = np.arange(n_fft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * k * f / n_fft
    window = np.hanning(n_fft + 1)[:-1]  # periodic Hann, matches torch.hann_window
    cos_b = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_b = (np.sin(ang) * window[:, None]).astype(np.float32)
    return torch.from_numpy(cos_b).to(device), torch.from_numpy(sin_b).to(device)


@functools.lru_cache(maxsize=8)
def _mel_mat(n_mels: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(n_mels).T.copy()).to(device)  # [n_freq, n_mels]


def frame_signal(x: torch.Tensor, n_frames: int, offset: int = 0) -> torch.Tensor:
    """``[..., samples]`` → overlapping ``[..., n_frames, N_FFT]`` frames
    (hop ``HOP_LENGTH``, frame j starting at ``offset + j·160``): a 400-sample
    window spans 3 consecutive 160-sample rows, so frames = concat of 3
    shifted row views, trimmed."""
    rows = n_frames + 2
    need = offset + rows * HOP_LENGTH
    pad = need - x.shape[-1]
    if pad > 0:  # tail rows only feed the sliced-off overhang
        x = F.pad(x, (0, pad))
    y = x[..., offset : offset + rows * HOP_LENGTH]
    y = y.reshape(*x.shape[:-1], rows, HOP_LENGTH)
    w = torch.cat([y[..., :-2, :], y[..., 1:-1, :], y[..., 2:, :]], dim=-1)  # [..., n_frames, 480]
    return w[..., :N_FFT]


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """``[..., samples] f32 @16kHz → [..., n_frames, n_mels]`` log-mel.

    Whisper's recipe: reflect-pad n_fft//2 each side, drop the final frame,
    windowed matmul-DFT, power spectrum, mel projection, log10 and
    dynamic-range compression (clamp at the row's max − 8)."""
    if audio.is_cuda:
        strict_fp32()
    audio = audio.to(torch.float32)
    pad = N_FFT // 2
    lead = audio.shape[:-1]
    x = F.pad(audio.reshape(-1, 1, audio.shape[-1]), (pad, pad), mode="reflect")
    x = x.reshape(*lead, x.shape[-1])
    n = x.shape[-1]
    n_frames = 1 + (n - N_FFT) // HOP_LENGTH
    frames = frame_signal(x, n_frames)  # [..., n_frames, n_fft]
    cos_b, sin_b = _dft_bases(N_FFT, audio.device)
    re = torch.matmul(frames, cos_b)
    im = torch.matmul(frames, sin_b)
    power = re * re + im * im  # [..., n_frames, n_freq]
    power = power[..., :-1, :]  # whisper drops the last frame
    mel = torch.matmul(power, _mel_mat(n_mels, audio.device))
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    peak = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    return (log_spec + 4.0) / 4.0
