# SPDX-License-Identifier: Apache-2.0
"""Kokoro TTS, a StyleTTS2-class stack (not the VITS backend), in PyTorch.

Port of ``streamkit_tpu/models/kokoro.py``. Parity target:
``plugins/native/kokoro`` (sherpa-onnx OfflineTts). The model dir holds
``voices.bin`` (raw f32 voice-style packs, ``[n_speakers, 510, 256]``),
``tokens.txt`` (``<token> <id>`` lines) and, once a converted checkpoint is
provisioned, ``weights.npz`` ('/'-joined keys of the parameter tree).

The model: a phoneme text encoder (three convolutions and a BiLSTM), a
style-conditioned prosody predictor (BiLSTM; duration classes, F0, energy),
and an ISTFTNet-style decoder whose magnitude and phase frames an inverse
STFT with Hann overlap-add turns into 24 kHz audio. Without ``weights.npz``
the weights are the reference's random init, drawn with
:mod:`streamkit_tpu_torch.utils.jax_prng` from ``PRNGKey(0)``: the same
numbers as the JAX package's.

Every function takes a batch ``[B, ...]`` where the reference maps one row
(its ``*_batch`` functions ``vmap`` it). Convolution weights are kept in
PyTorch's ``[out, in, k]`` layout; the reference's are ``[k, in, out]``.
The LSTMs scan the whole padded bucket, pads (token 0) included, as the
reference's ``lax.scan`` does, with gates in the order ``i, f, g, o``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..utils import jax_prng
from . import override_leaves
from .tts import conv_tree_to_torch

__all__ = [
    "KokoroConfig",
    "KokoroTokens",
    "load_voices_bin",
    "load_kokoro_dir",
    "kokoro_init_params",
    "kokoro_init_numpy",
    "kokoro_params_from_numpy",
    "kokoro_synthesize",
    "kokoro_durations_batch",
    "kokoro_core_batch",
    "kokoro_bucket",
    "kokoro_frames",
    "kokoro_finish",
    "kokoro_token_row",
    "HOP",
    "SAMPLE_RATE",
    "STYLE_DIM",
    "STYLE_ROWS",
    "TOKEN_BUCKETS",
]

STYLE_DIM = 256  # kokoro style vector width
STYLE_ROWS = 510  # style rows per voice, indexed by phoneme length
SAMPLE_RATE = 24_000

# iSTFT head (ISTFTNet-style): 20 ms frames at 24 kHz, 4x hop overlap
N_FFT = 480
HOP = 120
FRAME_BUCKETS = (64, 128, 256, 512)
TOKEN_BUCKETS = (64, 128, 256, 512)


@dataclass(frozen=True)
class KokoroConfig:
    n_tokens: int = 178  # kokoro v1.1 tokens.txt size
    hidden: int = 512
    style_dim: int = STYLE_DIM
    n_text_convs: int = 3
    sample_rate: int = SAMPLE_RATE
    max_dur: int = 24  # max frames one phoneme can expand to


class KokoroTokens:
    """``tokens.txt`` table: ``<token> <id>`` per line (sherpa format)."""

    def __init__(self, table: Dict[str, int]) -> None:
        self.table = table
        self._keys = sorted(table, key=len, reverse=True)  # longest-first

    @classmethod
    def load(cls, path: str) -> "KokoroTokens":
        table: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                # the token may be a space: "<tok> <id>" splits once from the right
                tok, _, idx = line.rpartition(" ")
                if tok == "":
                    tok = " "
                table[tok] = int(idx)
        return cls(table)

    @property
    def n_tokens(self) -> int:
        return max(self.table.values()) + 1

    def encode(self, text: str) -> List[int]:
        """Longest-match tokenization (the character-level G2P fallback;
        unknown characters are skipped, sherpa's OOV rule)."""
        ids: List[int] = []
        i = 0
        low = text.lower()
        while i < len(low):
            for k in self._keys:
                if low.startswith(k, i):
                    ids.append(self.table[k])
                    i += len(k)
                    break
            else:
                i += 1
        return ids


def load_voices_bin(path: str, style_rows: int = STYLE_ROWS, style_dim: int = STYLE_DIM) -> np.ndarray:
    """``voices.bin`` → ``[n_speakers, style_rows, style_dim]`` f32 (a raw
    little-endian concatenation of per-voice ``[510, 1, 256]`` packs)."""
    raw = np.fromfile(path, dtype="<f4")
    per_voice = style_rows * style_dim
    if raw.size == 0 or raw.size % per_voice != 0:
        raise ValueError(
            f"voices.bin size {raw.size} is not a multiple of one voice pack "
            f"({style_rows}x{style_dim})"
        )
    return raw.reshape(-1, style_rows, style_dim)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _normal(key, shape, scale: float) -> np.ndarray:
    return jax_prng.normal(key, shape) * np.float32(scale)


def _dense_init(key, n_in, n_out):
    return {"w": _normal(key, (n_in, n_out), n_in**-0.5), "b": np.zeros((n_out,), np.float32)}


def _conv_init(key, k, n_in, n_out):
    return {"w": _normal(key, (k, n_in, n_out), (k * n_in) ** -0.5), "b": np.zeros((n_out,), np.float32)}


def _lstm_init(key, n_in, n_h):
    k1, k2 = jax_prng.split(key)
    return {
        "wx": _normal(k1, (n_in, 4 * n_h), n_in**-0.5),
        "wh": _normal(k2, (n_h, 4 * n_h), n_h**-0.5),
        "b": np.zeros((4 * n_h,), np.float32),
    }


def kokoro_init_numpy(cfg: KokoroConfig, key=None) -> Dict:
    """The reference's random tree in its layout (numpy f32), drawn from
    ``key`` (default ``PRNGKey(0)``) down the reference's key tree."""
    keys = jax_prng.split(jax_prng.PRNGKey(0) if key is None else key, 24)
    h, s = cfg.hidden, cfg.style_dim
    return {
        "embed": _normal(keys[0], (cfg.n_tokens, h), 0.02),
        "text_convs": [_conv_init(keys[1 + i], 5, h, h) for i in range(cfg.n_text_convs)],
        "text_lstm_f": _lstm_init(keys[5], h, h // 2),
        "text_lstm_b": _lstm_init(keys[6], h, h // 2),
        # prosody predictor: style-conditioned duration / F0 / energy
        "pred_in": _dense_init(keys[7], h + s, h),
        "pred_lstm_f": _lstm_init(keys[8], h, h // 2),
        "pred_lstm_b": _lstm_init(keys[9], h, h // 2),
        "dur_out": _dense_init(keys[10], h, cfg.max_dur),
        "f0_out": _dense_init(keys[11], h, 1),
        "energy_out": _dense_init(keys[12], h, 1),
        # decoder (ISTFTNet-style): frame convs + mag/phase heads
        "dec_in": _dense_init(keys[13], h + s + 2, h),  # +F0 +energy
        "dec_convs": [_conv_init(keys[14 + i], 5, h, h) for i in range(4)],
        "mag_out": _dense_init(keys[18], h, N_FFT // 2 + 1),
        "phase_out": _dense_init(keys[19], h, N_FFT // 2 + 1),
    }


def kokoro_params_from_numpy(tree, cfg: KokoroConfig, dtype=torch.float32, device=None) -> Dict:
    """The reference's Kokoro tree (numpy, its layout) → the port's on
    ``device`` (default ``cuda``): convolution weights ``[k, in, out]`` become
    ``[out, in, k]``; dense and LSTM weights keep ``[in, out]``."""
    if len(tree["text_convs"]) != cfg.n_text_convs or tree["embed"].shape[1] != cfg.hidden:
        raise ValueError("parameter tree does not match the config")
    return conv_tree_to_torch(tree, dtype, device)


def kokoro_init_params(cfg: KokoroConfig, key=None, dtype=torch.float32, device=None) -> Dict:
    """The reference's random init (``PRNGKey(0)`` unless ``key`` is given),
    drawn on the host and moved to ``device`` (default ``cuda``)."""
    device = resolve_device(device)  # before the draw: no card, no work
    return kokoro_params_from_numpy(kokoro_init_numpy(cfg, key), cfg, dtype, device)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------
def _bilstm(pf: Dict, pb: Dict, xs: torch.Tensor) -> torch.Tensor:
    """Forward and backward LSTMs over ``xs [B, T, in]`` → ``[B, T, 2h]``.

    Both directions step together (one batched product per step); the input
    products of every step are computed first, and each step adds them to
    ``h @ wh`` and the bias in the reference's order."""
    b, t, _ = xs.shape
    n_h = pf["wh"].shape[0]
    xw = torch.stack([xs @ pf["wx"], (xs @ pb["wx"]).flip(1)])  # [2, B, T, 4h]; backward reversed
    wh = torch.stack([pf["wh"], pb["wh"]])  # [2, h, 4h]
    bias = torch.stack([pf["b"], pb["b"]])[:, None]  # [2, 1, 4h]
    h = xs.new_zeros(2, b, n_h)
    c = xs.new_zeros(2, b, n_h)
    out = []
    for i in range(t):
        gates = xw[:, :, i] + torch.bmm(h, wh) + bias
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h = torch.sigmoid(go) * torch.tanh(c)
        out.append(h)
    hs = torch.stack(out, dim=2)  # [2, B, T, h]
    return torch.cat([hs[0], hs[1].flip(1)], dim=-1)


def _conv1d_same(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """``x [B, T, C]`` → 'SAME' convolution (odd k) → ``[B, T, C_out]``."""
    k = p["w"].shape[-1]
    return F.conv1d(x.transpose(1, 2), p["w"], padding=k // 2).transpose(1, 2) + p["b"]


def _dense(x: torch.Tensor, p: Dict) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def _text_encode(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]  # [B, T, H]
    for conv in params["text_convs"]:
        x = torch.relu(_conv1d_same(x, conv))
    return _bilstm(params["text_lstm_f"], params["text_lstm_b"], x)


def _prosody(params: Dict, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    sty = style[:, None, :].expand(-1, x.shape[1], -1)
    hp = torch.relu(_dense(torch.cat([x, sty], dim=-1), params["pred_in"]))
    return _bilstm(params["pred_lstm_f"], params["pred_lstm_b"], hp)


def _predict_durations(params: Dict, cfg: KokoroConfig, tokens: torch.Tensor, t_mask: torch.Tensor,
                       style: torch.Tensor) -> torch.Tensor:
    """Per-phoneme frame counts ``[B, T]`` int32: argmax over the
    duration-class head plus one (the first index on ties), zero at pads."""
    hp = _prosody(params, _text_encode(params, tokens), style)
    dur = torch.argmax(_dense(hp, params["dur_out"]), dim=-1) + 1
    return (dur * t_mask).to(torch.int32)


def _hann(device) -> torch.Tensor:
    """``jnp.hanning(480)``: the symmetric window."""
    return torch.hann_window(N_FFT, periodic=False, dtype=torch.float32, device=device)


def _overlap_add(frames: torch.Tensor, n_frames: int) -> torch.Tensor:
    """``frames [B, F, N_FFT]`` summed at hops of ``HOP`` → ``[B, F·HOP + N_FFT]``."""
    b = frames.shape[0]
    out = F.fold(frames.transpose(1, 2), output_size=(1, (n_frames - 1) * HOP + N_FFT),
                 kernel_size=(1, N_FFT), stride=(1, HOP))
    return F.pad(out.reshape(b, -1), (0, HOP))


def _kokoro_core(params: Dict, cfg: KokoroConfig, tokens: torch.Tensor, t_mask: torch.Tensor,
                 style: torch.Tensor, frame_idx: torch.Tensor, f_mask: torch.Tensor, n_frames: int):
    """Frame-expanded synthesis of ``B`` rows: text states gathered per
    ``frame_idx [B, n_frames]`` (durations came from
    :func:`_predict_durations`), decoded to magnitude and phase frames and
    inverted → (audio ``[B, n_frames·HOP + N_FFT]`` f32, F0 ``[B, T]``)."""
    x = _text_encode(params, tokens) * t_mask[..., None]
    hp = _prosody(params, x, style)
    # jax.nn.softplus has no linear branch above 20, F.softplus does: the
    # difference there is below float32's resolution
    f0 = F.softplus(_dense(hp, params["f0_out"]))  # [B, T, 1]
    energy = torch.sigmoid(_dense(hp, params["energy_out"]))

    # length-regulate: gather per-frame phoneme states + prosody
    idx = frame_idx.long()[..., None]
    frames = torch.gather(x, 1, idx.expand(-1, -1, x.shape[-1]))  # [B, F, H]
    f0_f = torch.gather(f0, 1, idx)
    en_f = torch.gather(energy, 1, idx)
    sty_f = style[:, None, :].expand(-1, n_frames, -1)
    d = torch.relu(_dense(torch.cat([frames, sty_f, f0_f, en_f], dim=-1), params["dec_in"]))
    for conv in params["dec_convs"]:
        d = d + torch.relu(_conv1d_same(d, conv))
    d = d * f_mask[..., None]

    mag = torch.exp(torch.clamp(_dense(d, params["mag_out"]), -8, 4))
    phase = _dense(d, params["phase_out"])
    spec = torch.polar(mag.float(), phase.float())  # [B, F, N_FFT/2+1]

    # inverse STFT with Hann overlap-add
    win = _hann(d.device)
    frames_t = torch.fft.irfft(spec, n=N_FFT, dim=-1) * win * f_mask[..., None]
    audio = _overlap_add(frames_t, n_frames)
    norm = _overlap_add((win * win).expand(1, n_frames, N_FFT), n_frames)
    return audio / torch.clamp(norm, min=1e-3), f0[..., 0]


def kokoro_bucket(n: int, buckets=FRAME_BUCKETS) -> int:
    """The bucket of ``n`` (frame buckets by default; token buckets pass
    :data:`TOKEN_BUCKETS`); past the largest, the largest."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def kokoro_frames(dur: np.ndarray, t: int, speed: float):
    """Host side of the frame expansion: durations of the ``t`` tokens
    scaled by ``1 / speed`` (at least one frame each) → (``frame_idx``
    ``[f_pad]`` int32, ``f_mask`` ``[f_pad]`` f32, frames kept). A sentence
    longer than the largest frame bucket (512) keeps its first 512 frames,
    as the reference does."""
    dur = np.maximum(1, np.round(np.asarray(dur)[:t] / max(speed, 1e-3))).astype(np.int64)
    frame_idx = np.repeat(np.arange(t, dtype=np.int32), dur)
    n = len(frame_idx)
    f_pad = kokoro_bucket(n)
    fi = np.zeros(f_pad, np.int32)
    fi[:n] = frame_idx[:f_pad]
    f_mask = np.zeros(f_pad, np.float32)
    kept = min(n, f_pad)
    f_mask[:kept] = 1.0
    return fi, f_mask, kept


def kokoro_token_row(ids: List[int], cfg: KokoroConfig):
    """Token ids → (bucketed ``tokens`` int32, ``t_mask`` f32)."""
    t = len(ids)
    t_pad = kokoro_bucket(t, TOKEN_BUCKETS)
    tok = np.zeros(t_pad, np.int32)
    tok[:t] = np.asarray(ids, np.int32) % cfg.n_tokens
    t_mask = np.zeros(t_pad, np.float32)
    t_mask[:t] = 1.0
    return tok, t_mask


def kokoro_synthesize(params: Dict, cfg: KokoroConfig, tokens: List[int], style_pack: np.ndarray,
                      speed: float = 1.0) -> np.ndarray:
    """One sentence → 24 kHz f32 audio on the parameters' device. The style
    row is picked by phoneme length (the voicepack contract); ``speed``
    scales durations; the audio is scaled to a 0.7 peak where it exceeds 1."""
    if not tokens:
        return np.zeros(0, np.float32)
    t = len(tokens)
    dev = params["embed"].device
    tok, t_mask = kokoro_token_row(tokens, cfg)
    style = np.asarray(style_pack[min(t, style_pack.shape[0] - 1)], np.float32)
    row = [torch.as_tensor(a[None], device=dev) for a in (tok, t_mask, style)]
    with torch.inference_mode():
        dur = _predict_durations(params, cfg, *row)[0].cpu().numpy()
        fi, f_mask, kept = kokoro_frames(dur, t, speed)
        audio, _ = _kokoro_core(params, cfg, *row, torch.as_tensor(fi[None], device=dev),
                                torch.as_tensor(f_mask[None], device=dev), len(fi))
    return kokoro_finish(audio[0].cpu().numpy(), kept)


def kokoro_finish(audio: np.ndarray, kept: int) -> np.ndarray:
    """The kept frames' audio, scaled to a 0.7 peak where it exceeds 1."""
    out = np.asarray(audio)[: kept * HOP]
    peak = np.abs(out).max() or 1.0
    return (out / max(peak, 1.0) * 0.7).astype(np.float32)


# the reference's batched entry points (``vmap`` of one row): the port's
# functions take a batch already, and row ``i`` equals the row alone
kokoro_durations_batch = _predict_durations
kokoro_core_batch = _kokoro_core


# ---------------------------------------------------------------------------
# model-dir loader (reference contract)
# ---------------------------------------------------------------------------
def load_kokoro_dir(model_dir: str, dtype=torch.float32, device=None):
    """Load a kokoro model dir → (cfg, params on ``device``, tokens, voices).

    ``weights.npz`` (a converted checkpoint) is used where present, its keys
    over the random init and shape-checked; otherwise the parameters are
    the reference's random init. Voices and tokens are always the dir's."""
    device = resolve_device(device)
    tokens_path = os.path.join(model_dir, "tokens.txt")
    voices_path = os.path.join(model_dir, "voices.bin")
    for p in (tokens_path, voices_path):
        if not os.path.exists(p):
            raise FileNotFoundError(f"kokoro model dir missing {os.path.basename(p)}: {model_dir}")
    tokens = KokoroTokens.load(tokens_path)
    voices = load_voices_bin(voices_path)
    cfg = KokoroConfig(n_tokens=max(tokens.n_tokens, 1))
    npz = os.path.join(model_dir, "weights.npz")
    if os.path.exists(npz):
        flat = dict(np.load(npz))
        if "embed" in flat:
            # the checkpoint is authoritative for the token-table size
            # (tokens.txt may cover a subset of the trained vocabulary)
            cfg = KokoroConfig(n_tokens=max(cfg.n_tokens, flat["embed"].shape[0]))
        tree = override_leaves(kokoro_init_numpy(cfg), flat, "weights.npz")
    else:
        tree = kokoro_init_numpy(cfg)
    return cfg, kokoro_params_from_numpy(tree, cfg, dtype, device), tokens, voices

