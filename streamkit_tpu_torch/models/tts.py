# SPDX-License-Identifier: Apache-2.0
"""TTS stack: non-autoregressive acoustic model + HiFi-GAN vocoder, PyTorch.

Port of ``streamkit_tpu/models/tts.py``:

* :func:`hifigan_generate` — HiFi-GAN generator (the vocoder of the
  FastSpeech backend). :func:`hifigan_params_from_hf` converts HF
  ``SpeechT5HifiGan`` state dicts.
* :class:`AcousticConfig` / :func:`acoustic_generate` — FastSpeech-style
  text→mel: byte embeddings → transformer encoder → duration-expanded
  frames → decoder → mel, one device call per sentence.

Convolution weights are kept in PyTorch's layout (``[out, in/groups, k]``,
transposed convolutions ``[in, out, k]``); the reference keeps
``[k, in, out]`` (``[k, out, in]`` for its ``transpose_kernel``
convolutions), and :func:`conv_tree_to_torch` permutes them on the way in.
The vocoder runs channels-first; the acoustic model channels-last, as the
reference does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import params_to_torch

__all__ = [
    "HifiGanConfig",
    "hifigan_init_params",
    "hifigan_params_from_numpy",
    "hifigan_generate",
    "hifigan_params_from_hf",
    "AcousticConfig",
    "acoustic_init_params",
    "acoustic_params_from_numpy",
    "acoustic_generate",
    "conv_tree_to_torch",
]


def conv_tree_to_torch(tree, dtype, device, keep_f32=()):
    """A parameter tree in the reference's layout (numpy) → tensors on
    ``device``: every 3-d weight ``[k, a, b]`` becomes ``[b, a, k]``, which is
    PyTorch's ``[out, in, k]`` for a convolution and ``[in, out, k]`` for a
    transposed one (the reference stores those as ``[k, out, in]``)."""

    def permute(x):
        if isinstance(x, dict):
            return {k: permute(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [permute(v) for v in x]
        if hasattr(x, "__array__") and np.ndim(x) == 3:
            return np.ascontiguousarray(np.asarray(x, np.float32).transpose(2, 1, 0))
        return x

    return params_to_torch(permute(tree), dtype, resolve_device(device), keep_f32)


# ---------------------------------------------------------------------------
# HiFi-GAN generator (HF SpeechT5HifiGan-compatible)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class HifiGanConfig:
    model_in_dim: int = 80
    upsample_initial_channel: int = 512
    upsample_rates: tuple = (4, 4, 4, 4)
    upsample_kernel_sizes: tuple = (8, 8, 8, 8)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    leaky_relu_slope: float = 0.1
    normalize_before: bool = True  # HF applies mean/scale normalization


def _conv_init(rng, k, c_in, c_out):
    s = 1.0 / math.sqrt(k * c_in)
    return rng.uniform(-s, s, (k, c_in, c_out)).astype(np.float32)


def _hifigan_numpy(cfg: HifiGanConfig, seed: int) -> Dict:
    """The reference's random tree (its layout), drawn in its order."""
    rng = np.random.default_rng(seed)

    def conv(k, c_in, c_out):
        return {"w": _conv_init(rng, k, c_in, c_out), "b": np.zeros((c_out,), np.float32)}

    params: Dict = {
        "mean": np.zeros((cfg.model_in_dim,), np.float32),
        "scale": np.ones((cfg.model_in_dim,), np.float32),
        "conv_pre": conv(7, cfg.model_in_dim, cfg.upsample_initial_channel),
        "ups": [],
        "resblocks": [],
    }
    ch = cfg.upsample_initial_channel
    for r, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        # transposed-convolution kernels are [k, out, in] there; bias is [out]
        params["ups"].append({"w": _conv_init(rng, k, ch // 2, ch), "b": np.zeros((ch // 2,), np.float32)})
        ch //= 2
        for k_res, dilations in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            block = {"convs1": [], "convs2": []}
            for _ in dilations:
                block["convs1"].append(conv(k_res, ch, ch))
                block["convs2"].append(conv(k_res, ch, ch))
            params["resblocks"].append(block)
    params["conv_post"] = conv(7, ch, 1)
    return params


def hifigan_init_params(cfg: HifiGanConfig, seed: int = 0, dtype=torch.float32, device=None) -> Dict:
    """The reference's random vocoder (its numpy draws), made on the host
    and moved to ``device`` (default ``cuda``)."""
    return hifigan_params_from_numpy(_hifigan_numpy(cfg, seed), cfg, dtype, device)


def hifigan_params_from_numpy(tree, cfg: HifiGanConfig, dtype=torch.float32, device=None) -> Dict:
    """The reference's vocoder tree (numpy arrays) → the port's."""
    params = conv_tree_to_torch(tree, dtype, device)
    if len(params["ups"]) != len(cfg.upsample_rates):
        raise ValueError("parameter tree does not match the config's upsample layers")
    return params


def _conv(x, p, dilation: int = 1):
    """Channels-first 'same' convolution: x [b, c, t]."""
    k = p["w"].shape[-1]
    return F.conv1d(x, p["w"], p.get("b"), padding=(k - 1) * dilation // 2, dilation=dilation)


def _conv_transpose(x, p, stride: int):
    """HF ConvTranspose1d with padding (k - stride) // 2, channels-first."""
    k = p["w"].shape[-1]
    return F.conv_transpose1d(x, p["w"], p["b"], stride=stride, padding=(k - stride) // 2)


def hifigan_generate(params: Dict, cfg: HifiGanConfig, mel: torch.Tensor) -> torch.Tensor:
    """``mel [b, frames, n_mels]`` → waveform ``[b, frames * prod(rates)]``."""
    slope = cfg.leaky_relu_slope
    x = mel
    if cfg.normalize_before:
        x = (x - params["mean"]) / params["scale"]
    x = _conv(x.transpose(1, 2), params["conv_pre"])
    n_kernels = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        x = _conv_transpose(F.leaky_relu(x, slope), params["ups"][i], cfg.upsample_rates[i])
        acc = None
        for j in range(n_kernels):
            block = params["resblocks"][i * n_kernels + j]
            h = x
            for c1, c2, d in zip(block["convs1"], block["convs2"], cfg.resblock_dilation_sizes[j]):
                y = _conv(F.leaky_relu(h, slope), c1, dilation=d)
                y = _conv(F.leaky_relu(y, slope), c2)
                h = h + y
            acc = h if acc is None else acc + h
        x = acc / n_kernels
    x = _conv(F.leaky_relu(x, slope), params["conv_post"])
    return torch.tanh(x)[:, 0]


def hifigan_params_from_hf(sd: Dict[str, np.ndarray], cfg: HifiGanConfig, dtype=torch.float32,
                           device=None) -> Dict:
    """An HF SpeechT5HifiGan state dict (PyTorch's convolution layouts) →
    the port's parameters on ``device`` (default ``cuda``)."""

    def conv(prefix):
        return {"w": np.asarray(sd[f"{prefix}.weight"], np.float32),
                "b": np.asarray(sd[f"{prefix}.bias"], np.float32)}

    tree: Dict = {
        "mean": np.asarray(sd.get("mean", np.zeros(cfg.model_in_dim)), np.float32),
        "scale": np.asarray(sd.get("scale", np.ones(cfg.model_in_dim)), np.float32),
        "conv_pre": conv("conv_pre"),
        "ups": [conv(f"upsampler.{i}") for i in range(len(cfg.upsample_rates))],
        "resblocks": [],
    }
    for i in range(len(cfg.upsample_rates) * len(cfg.resblock_kernel_sizes)):
        tree["resblocks"].append({
            "convs1": [conv(f"resblocks.{i}.convs1.{j}") for j in range(len(cfg.resblock_dilation_sizes[0]))],
            "convs2": [conv(f"resblocks.{i}.convs2.{j}") for j in range(len(cfg.resblock_dilation_sizes[0]))],
        })
    tree["conv_post"] = conv("conv_post")
    return params_to_torch(tree, dtype, resolve_device(device))


# ---------------------------------------------------------------------------
# FastSpeech-style acoustic model (text → mel)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class AcousticConfig:
    vocab_size: int = 256  # byte-level text input
    d_model: int = 256
    heads: int = 4
    enc_layers: int = 4
    dec_layers: int = 4
    n_mels: int = 80
    max_text: int = 512
    max_frames: int = 2048
    frames_per_token: int = 8  # fallback duration when predictor untrained


def _acoustic_numpy(cfg: AcousticConfig, seed: int) -> Dict:
    """The reference's random tree, drawn in its order."""
    rng = np.random.default_rng(seed)

    def lin(d_in, d_out):
        s = 1.0 / math.sqrt(d_in)
        return {"w": rng.uniform(-s, s, (d_in, d_out)).astype(np.float32), "b": np.zeros((d_out,), np.float32)}

    def ln(d):
        return {"g": np.ones((d,), np.float32), "b": np.zeros((d,), np.float32)}

    def layer(d):
        return {
            "ln1": ln(d),
            "q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
            "ln2": ln(d),
            "fc1": lin(d, 4 * d), "fc2": lin(4 * d, d),
        }

    d = cfg.d_model
    pos = np.zeros((max(cfg.max_text, cfg.max_frames), d), np.float32)
    p = np.arange(pos.shape[0])[:, None]
    i = np.arange(d // 2)[None, :]
    angles = p / np.power(10000, 2 * i / d)
    pos[:, 0::2] = np.sin(angles)
    pos[:, 1::2] = np.cos(angles)
    return {
        "emb": rng.normal(0, 0.02, (cfg.vocab_size, d)).astype(np.float32),
        "pos": pos,
        "enc": [layer(d) for _ in range(cfg.enc_layers)],
        "dur": lin(d, 1),
        "dec": [layer(d) for _ in range(cfg.dec_layers)],
        "out_ln": ln(d),
        "mel_out": lin(d, cfg.n_mels),
    }


def acoustic_init_params(cfg: AcousticConfig, seed: int = 0, dtype=torch.float32, device=None) -> Dict:
    """The reference's random acoustic model (its numpy draws), made on the
    host and moved to ``device`` (default ``cuda``)."""
    return acoustic_params_from_numpy(_acoustic_numpy(cfg, seed), cfg, dtype, device)


def acoustic_params_from_numpy(tree, cfg: AcousticConfig, dtype=torch.float32, device=None) -> Dict:
    """The reference's acoustic tree (numpy arrays) → the port's."""
    params = params_to_torch(tree, dtype, resolve_device(device))
    if len(params["enc"]) != cfg.enc_layers or len(params["dec"]) != cfg.dec_layers:
        raise ValueError("parameter tree does not match the config's layer counts")
    return params


def _ln_(x, p):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + 1e-5) * p["g"] + p["b"]).to(x.dtype)


def _dense_(x, p):
    return torch.matmul(x, p["w"]) + p["b"]


def _block(x, layer, heads, mask=None):
    h = _ln_(x, layer["ln1"])
    *lead, t, d = h.shape
    hd = d // heads

    def split(v):
        return v.reshape(*lead, t, heads, hd).transpose(-3, -2)

    q, k, v = split(_dense_(h, layer["q"])), split(_dense_(h, layer["k"])), split(_dense_(h, layer["v"]))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    a = torch.matmul(probs, v)
    a = a.transpose(-3, -2).reshape(*lead, t, d)
    x = x + _dense_(a, layer["o"])
    h = _ln_(x, layer["ln2"])
    return x + _dense_(F.gelu(_dense_(h, layer["fc1"]), approximate="tanh"), layer["fc2"])


def acoustic_generate(params: Dict, cfg: AcousticConfig, tokens: torch.Tensor, n_frames: int) -> torch.Tensor:
    """``tokens [b, t]`` → mel ``[b, n_frames, n_mels]``.

    Durations: predicted per token (softplus), normalized to fill exactly
    ``n_frames``; each frame takes the first token whose end boundary is
    not below the frame's centre (a sum of comparisons, as the reference
    counts it)."""
    tokens = tokens.long()
    b, t = tokens.shape
    x = params["emb"][tokens] + params["pos"][:t].to(params["emb"].dtype)
    for layer in params["enc"]:
        x = _block(x, layer, cfg.heads)
    dur = F.softplus(_dense_(x, params["dur"])[..., 0]) + 1e-3  # [b, t]
    cum = torch.cumsum(dur, dim=-1)
    total = cum[:, -1:]
    boundaries = cum / total * n_frames  # token end-frames in [0, n_frames]
    frame_idx = torch.arange(n_frames, dtype=torch.float32, device=x.device)[None, :] + 0.5
    tok_for_frame = (boundaries[:, None, :] < frame_idx[:, :, None]).sum(dim=-1)
    tok_for_frame = tok_for_frame.clamp(0, t - 1)
    frames = torch.gather(x, 1, tok_for_frame[..., None].expand(b, n_frames, x.shape[-1]))
    y = frames + params["pos"][:n_frames].to(frames.dtype)
    for layer in params["dec"]:
        y = _block(y, layer, cfg.heads)
    return _dense_(_ln_(y, params["out_ln"]), params["mel_out"])
