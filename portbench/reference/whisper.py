# SPDX-License-Identifier: Apache-2.0
"""Plain Whisper in float32 PyTorch: the yardstick the benchmark holds the
port's outputs against.

Written from the published architecture (openai/whisper ``model.py``): a
log-mel frontend, two GELU convolutions, sinusoidal positions, pre-norm
encoder and decoder blocks with biased q / v / o and an unbiased k, and
logits against the token embedding. It imports nothing of the program and
takes only the weight tensors the benchmark drew, which it reads as float32.

Three entry points, one per way the program serves:

* :func:`encode_full` + :func:`decode_logits`: the full-window encoder over
  a 30 s window and the teacher-forced decoder (exact finals);
* :class:`StreamEncoder`: the chunk-causal streaming encoder the live path
  runs (16 mel frames, 8 positions a chunk; a chunk's queries see every
  committed position and the call's chunks up to their own; the log-mel
  floor is the call's own maximum), and :func:`decode_logits` with one
  cross-attention horizon per query (the continuation decoder).

``precision="fp8"`` rounds every matmul and convolution operand to
float8 e4m3 (weights per tensor, activations per row): the control that a
sound program has to beat.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160
CHUNK_POS = 8
CHUNK_SAMPLES = 2 * CHUNK_POS * HOP  # 2560
LEFT_CTX = 560
RIGHT_CTX = 200
E4M3_MAX = 448.0


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------
def fp8_round(x: torch.Tensor, per_row: bool) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a scale per row (or per tensor),
    returned in float32."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True) if per_row else x.abs().amax()
    scale = torch.clamp(amax, min=1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Weights:
    """The benchmark's weight tree (nested dicts and lists of tensors, the
    program's leaf names) as float32, rounded once for the control."""

    def __init__(self, tree, precision: str = "f32", device=None):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision f32 or fp8, got {precision}")
        self.precision = precision

        def conv(x, name):
            if isinstance(x, dict):
                return {k: conv(v, k) for k, v in x.items()}
            if isinstance(x, list):
                return [conv(v, name) for v in x]
            t = x.detach().to(device=device or x.device, dtype=torch.float32)
            # matrices and convolution kernels are operands of products
            if precision == "fp8" and name in ("w", "tok_emb"):
                t = fp8_round(t, per_row=False)
            return t

        self.tree = conv(tree, "")

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x, per_row=True) if self.precision == "fp8" else x

    def dense(self, x, p):
        y = self.act(x) @ p["w"]
        return y + p["b"] if "b" in p else y

    def matmul(self, a, b):
        """An activation-by-activation product (attention)."""
        if self.precision == "fp8":
            return fp8_round(a, True) @ fp8_round(b.transpose(-1, -2), True).transpose(-1, -2)
        return a @ b


def layer_norm(x, p):
    return F.layer_norm(x, (x.shape[-1],), p["g"], p["b"], eps=1e-5)


def _mlp(w: Weights, x, layer):
    return w.dense(F.gelu(w.dense(x, layer["mlp1"])), layer["mlp2"])


def _heads(x, n_head):
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _merge(x):
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def attention(w: Weights, q, k, v, n_head, mask=None):
    """Scaled dot-product attention, ``mask`` added to the scores."""
    qh, kh, vh = _heads(q, n_head), _heads(k, n_head), _heads(v, n_head)
    scores = w.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(qh.shape[-1])
    if mask is not None:
        scores = scores + mask
    return _merge(w.matmul(torch.softmax(scores, dim=-1), vh))


def conv1d(w: Weights, x, p, stride: int, padding: int):
    """``x [B, t, c_in]``, weight ``[k, c_in, c_out]`` → ``[B, t', c_out]``."""
    kern = p["w"].permute(2, 1, 0)
    y = F.conv1d(w.act(x).transpose(1, 2), kern, stride=stride, padding=padding)
    return y.transpose(1, 2) + p["b"]


def sinusoids(length: int, channels: int) -> torch.Tensor:
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float()


# ---------------------------------------------------------------------------
# log-mel
# ---------------------------------------------------------------------------
def mel_filters(n_mels: int) -> np.ndarray:
    """librosa's slaney-scale, slaney-normalised filterbank ``[n_mels,
    201]`` (what openai/whisper ships in ``mel_filters.npz``)."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
        return np.where(f >= 1000.0, log, lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), m * (200.0 / 3))

    freqs = np.linspace(0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    hz = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    out = np.zeros((n_mels, freqs.size))
    for i in range(n_mels):
        lo, c, hi = hz[i], hz[i + 1], hz[i + 2]
        rise = (freqs - lo) / (c - lo)
        fall = (hi - freqs) / (hi - c)
        out[i] = np.maximum(0.0, np.minimum(rise, fall)) * 2.0 / (hi - lo)
    return out.astype(np.float32)


def _power(frames_src: torch.Tensor, n_frames: int, offset: int) -> torch.Tensor:
    """Power spectra of ``n_frames`` periodic-Hann frames starting at
    ``offset + 160·j`` of ``frames_src [B, samples]`` → ``[B, n_frames, 201]``."""
    need = offset + (n_frames - 1) * HOP + N_FFT
    if frames_src.shape[-1] < need:
        frames_src = F.pad(frames_src, (0, need - frames_src.shape[-1]))
    frames = frames_src[:, offset:].unfold(-1, N_FFT, HOP)[:, :n_frames]
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=frames.device)
    spec = torch.fft.rfft(frames.double() * window, dim=-1)
    return (spec.real ** 2 + spec.imag ** 2).float()


def _log_mel(power: torch.Tensor, n_mels: int) -> torch.Tensor:
    mel = power @ torch.from_numpy(mel_filters(n_mels)).to(power.device).T
    log = torch.log10(torch.clamp(mel, min=1e-10))
    log = torch.maximum(log, log.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (log + 4.0) / 4.0


def log_mel_window(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """Whisper's frontend over a window: ``[B, samples]`` →
    ``[B, samples // 160, n_mels]`` (reflect padding, last frame dropped)."""
    x = F.pad(audio.float()[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    n_frames = audio.shape[-1] // HOP
    return _log_mel(_power(x, n_frames, 0), n_mels)


# ---------------------------------------------------------------------------
# full-window encoder and teacher-forced decoder
# ---------------------------------------------------------------------------
def encode_full(w: Weights, mel: torch.Tensor, n_head: int) -> torch.Tensor:
    """``mel [B, 2·T, n_mels]`` → audio states ``[B, T, d]``."""
    e = w.tree["enc"]
    x = F.gelu(conv1d(w, mel, e["conv1"], 1, 1))
    x = F.gelu(conv1d(w, x, e["conv2"], 2, 1))
    x = x + e["pos"][: x.shape[1]]
    for layer in e["layers"]:
        h = layer_norm(x, layer["ln1"])
        a = layer["attn"]
        x = x + w.dense(attention(w, w.dense(h, a["q"]), w.dense(h, a["k"]), w.dense(h, a["v"]), n_head), a["o"])
        x = x + _mlp(w, layer_norm(x, layer["ln2"]), layer)
    return layer_norm(x, e["ln_post"])


def decode_logits(w: Weights, tokens: torch.Tensor, xk: List[torch.Tensor], xv: List[torch.Tensor], n_head: int,
                  horizon: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced decoder → float32 logits ``[B, t, vocab]``.

    ``xk`` / ``xv``: per layer, the cross keys and values ``[B, T, d]``
    (:func:`cross_kv`). ``horizon [B, t]``: query ``j`` sees the cross
    positions below ``horizon[b, j]`` (None: all of them)."""
    d = w.tree["dec"]
    t = tokens.shape[1]
    x = d["tok_emb"][tokens.long()] + d["pos_emb"][:t]
    causal = torch.triu(torch.full((t, t), float("-inf"), device=x.device), diagonal=1)
    xmask = None
    if horizon is not None:
        cols = torch.arange(xk[0].shape[1], device=x.device)
        xmask = torch.where(cols[None, None, :] < horizon[:, :, None], 0.0, float("-inf"))[:, None]
    for li, layer in enumerate(d["layers"]):
        h = layer_norm(x, layer["ln1"])
        a = layer["attn"]
        x = x + w.dense(attention(w, w.dense(h, a["q"]), w.dense(h, a["k"]), w.dense(h, a["v"]), n_head, causal),
                        a["o"])
        hx = layer_norm(x, layer["ln_x"])
        xa = layer["xattn"]
        x = x + w.dense(attention(w, w.dense(hx, xa["q"]), xk[li], xv[li], n_head, xmask), xa["o"])
        x = x + _mlp(w, layer_norm(x, layer["ln2"]), layer)
    h = w.act(layer_norm(x, d["ln"]))
    return h @ d["tok_emb"].T


def cross_kv(w: Weights, states: torch.Tensor):
    """Per decoder layer, the cross-attention keys and values of ``states``."""
    layers = w.tree["dec"]["layers"]
    return ([w.dense(states, l["xattn"]["k"]) for l in layers], [w.dense(states, l["xattn"]["v"]) for l in layers])


# ---------------------------------------------------------------------------
# the chunk-causal streaming encoder
# ---------------------------------------------------------------------------
class StreamEncoder:
    """One segment's chunk-causal encoder, committed call by call.

    :meth:`call` takes the audio one encoder call gathers (``LEFT_CTX``
    samples before the first chunk, ``n_chunks`` chunks, ``RIGHT_CTX``
    after), encodes the chunks against the committed history and commits the
    first ``commit`` of them; :meth:`states` returns every committed
    position's encoder output."""

    def __init__(self, w: Weights, n_head: int, n_ctx: int):
        self.w, self.n_head, self.n_ctx = w, n_head, n_ctx
        n_layer = len(w.tree["enc"]["layers"])
        self.hk: List[Optional[torch.Tensor]] = [None] * n_layer
        self.hv: List[Optional[torch.Tensor]] = [None] * n_layer
        self.out: List[torch.Tensor] = []
        self.pos = 0

    def call(self, gathered: torch.Tensor, n_chunks: int, commit: int) -> None:
        w, e = self.w, self.w.tree["enc"]
        n_mels = e["conv1"]["w"].shape[1]
        n_pos = CHUNK_POS * n_chunks
        mel = _log_mel(_power(gathered.float()[None], 16 * n_chunks + 3, 40), n_mels)
        x = F.gelu(conv1d(w, mel, e["conv1"], 1, 0))
        x = F.gelu(conv1d(w, x, e["conv2"], 2, 0))  # [1, n_pos, d]
        p = torch.clamp(self.pos + torch.arange(n_pos, device=x.device), max=self.n_ctx - 1)
        x = x + e["pos"][p]
        j = torch.arange(n_pos, device=x.device)
        block = torch.where(j[None, :] < ((j // CHUNK_POS + 1) * CHUNK_POS)[:, None], 0.0, float("-inf"))
        keep = CHUNK_POS * commit
        for li, layer in enumerate(e["layers"]):
            h = layer_norm(x, layer["ln1"])
            a = layer["attn"]
            q, k, v = w.dense(h, a["q"]), w.dense(h, a["k"]), w.dense(h, a["v"])
            if self.hk[li] is None:
                kk, vv, mask = k, v, block
            else:
                hist = self.hk[li].shape[1]
                kk = torch.cat([self.hk[li], k], dim=1)
                vv = torch.cat([self.hv[li], v], dim=1)
                mask = torch.cat([torch.zeros((n_pos, hist), device=x.device), block], dim=1)
            if keep:
                self.hk[li] = k[:, :keep] if self.hk[li] is None else torch.cat([self.hk[li], k[:, :keep]], 1)
                self.hv[li] = v[:, :keep] if self.hv[li] is None else torch.cat([self.hv[li], v[:, :keep]], 1)
            x = x + w.dense(attention(w, q, kk, vv, self.n_head, mask), a["o"])
            x = x + _mlp(w, layer_norm(x, layer["ln2"]), layer)
        if keep:
            self.out.append(layer_norm(x, e["ln_post"])[:, :keep])
            self.pos += keep

    def states(self) -> torch.Tensor:
        return torch.cat(self.out, dim=1)
