# SPDX-License-Identifier: Apache-2.0
"""Plain voice-activity detection and segmentation: the yardstick for the
program's VAD probabilities and its speech segments.

The detector is the Silero-class network the program serves (512-sample
frames with 64 samples of carried context; log-magnitude STFT features at
four offsets, a ReLU encoder, an LSTM of 128 carried across frames, a
two-layer sigmoid head), computed in float32 from the weights file beside
this module (``vad_weights.npz``), which the benchmark hands to the program
too. The segmenter follows the program's documented rules: a segment opens
on the first frame at or above the threshold, two frames of pre-roll before
it; it closes after ``min_silence_ms`` of frames below the threshold or at
the longest segment.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from .whisper import fp8_round

FRAME = 512
CONTEXT = 64
N_FFT = 256
OFFSETS = (0, 128, 256, 320)
HIDDEN = 128
WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vad_weights.npz")


def load_weights(device, precision: str = "f32") -> Dict[str, torch.Tensor]:
    with np.load(WEIGHTS) as data:
        w = {k: torch.from_numpy(np.asarray(data[k], np.float32)).to(device) for k in data.files}
    if precision == "fp8":
        w = {k: (fp8_round(v, per_row=False) if v.ndim == 2 else v) for k, v in w.items()}
    return w


def frame_probs(audio: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """``audio [B, n·512]`` float32 in [-1, 1) (each row from its session's
    first sample) → speech probabilities ``[B, n]``, state from zeros."""
    dev = audio.device
    w = load_weights(dev, precision)
    act = (lambda x: fp8_round(x, per_row=True)) if precision == "fp8" else (lambda x: x)
    b, n = audio.shape[0], audio.shape[1] // FRAME
    window = torch.from_numpy(np.hanning(N_FFT).astype(np.float32)).to(dev)
    frames = audio[:, : n * FRAME].reshape(b, n, FRAME).float()
    ctx = torch.cat([torch.zeros((b, 1, CONTEXT), device=dev), frames[:, :-1, -CONTEXT:]], dim=1)
    x = torch.cat([ctx, frames], dim=-1)  # [B, n, 576]: every frame's window at once
    stft = torch.stack([x[..., o : o + N_FFT] for o in OFFSETS], dim=-2) * window
    spec = torch.fft.rfft(stft.double(), dim=-1)
    feat = torch.log1p(torch.sqrt(spec.real ** 2 + spec.imag ** 2) * 32.0).float()  # [B, n, 4, 129]
    enc = torch.relu(act(feat) @ w["enc_w"] + w["enc_b"])
    h = torch.zeros((b, HIDDEN), device=dev)
    c = torch.zeros((b, HIDDEN), device=dev)
    out = []
    xin = act(enc) @ w["lstm_wx"]  # [B, n, 4, 4H]: the input half of every gate at once
    for i in range(n):
        for t in range(len(OFFSETS)):
            gates = xin[:, i, t] + act(h) @ w["lstm_wh"] + w["lstm_b"]
            gi, gf, gg, go = torch.chunk(gates, 4, dim=-1)
            c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h = torch.sigmoid(go) * torch.tanh(c)
        out.append(h)
    hs = torch.stack(out, dim=1)
    z = torch.relu(act(hs) @ w["head_w1"] + w["head_b1"])
    return torch.sigmoid((act(z) @ w["head_w2"] + w["head_b2"])[..., 0])


def segments(probs: np.ndarray, threshold: float = 0.5, min_silence_ms: float = 700.0,
             max_segment_secs: float = 30.0, pre_roll: int = 2, flush: bool = False) -> List[Tuple[int, int]]:
    """Speech segments ``(start_frame, end_frame)`` of one session's frame
    probabilities, in order. An open segment at the end is kept only with
    ``flush`` (the stream ended there)."""
    min_silence = int(min_silence_ms / 1000.0 * 16000 / FRAME)
    max_frames = int(max_segment_secs * 16000 / FRAME)
    out, start, frames_in, silence, quiet = [], None, 0, 0, 0
    for i, p in enumerate(np.asarray(probs, np.float64), start=1):
        if start is None:
            if p >= threshold:
                frames_in = min(quiet, pre_roll) + 1
                start, silence = i - frames_in, 0
            else:
                quiet += 1
            continue
        frames_in += 1
        silence = silence + 1 if p < threshold else 0
        if silence >= min_silence or frames_in >= max_frames:
            out.append((start, i))
            start, quiet = None, 0
    if flush and start is not None:
        out.append((start, len(probs)))
    return out
