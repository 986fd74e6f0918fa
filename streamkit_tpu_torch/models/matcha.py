# SPDX-License-Identifier: Apache-2.0
"""Matcha-TTS-class flow-matching acoustic model in PyTorch.

Port of ``streamkit_tpu/models/matcha.py``. Parity target: the reference's
matcha plugin (``plugins/native/matcha/``, Matcha-TTS through sherpa-onnx):
text encoder and duration predictor → length-regulated means → a
conditional flow-matching decoder solved with a fixed-step Euler ODE → mel,
then a vocoder (HiFi-GAN, :mod:`streamkit_tpu_torch.models.tts`).

Config semantics follow the reference (``matcha/src/config.rs``):
``length_scale`` scales durations, ``noise_scale`` scales the initial ODE
noise, ``speaker_id`` selects a speaker embedding. The random init is the
reference's numpy draw and the ODE noise its ``jax.random.normal`` draw
(:mod:`streamkit_tpu_torch.utils.jax_prng`), so a model without a checkpoint
synthesizes the reference's mel. Convolution weights are kept as PyTorch's
``[out, in, k]`` (the reference's ``[k, in, out]``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..utils import jax_prng
from .tts import conv_tree_to_torch

__all__ = ["MatchaConfig", "matcha_init_params", "matcha_params_from_numpy", "matcha_synthesize_mel"]


@dataclass(frozen=True)
class MatchaConfig:
    vocab_size: int = 178  # phoneme inventory
    d_model: int = 192
    heads: int = 2
    enc_layers: int = 6
    ffn_dim: int = 768
    n_mels: int = 80
    dec_channels: int = 256
    dec_layers: int = 4
    n_speakers: int = 1
    spk_dim: int = 64
    ode_steps: int = 10  # fixed Euler steps (sherpa default ~5-10)


def _matcha_numpy(cfg: MatchaConfig, seed: int) -> Dict:
    """The reference's random tree in its layout, drawn in its order."""
    rng = np.random.default_rng(seed)

    def lin(d_in, d_out):
        return {"w": (rng.standard_normal((d_in, d_out)) / math.sqrt(d_in)).astype(np.float32),
                "b": np.zeros((d_out,), np.float32)}

    def ln(d):
        return {"g": np.ones((d,), np.float32), "b": np.zeros((d,), np.float32)}

    def conv(c_in, c_out, k):
        return {"w": (rng.standard_normal((k, c_in, c_out)) / math.sqrt(k * c_in)).astype(np.float32),
                "b": np.zeros((c_out,), np.float32)}

    d = cfg.d_model

    def enc_layer():
        return {"ln1": ln(d), "qkv": lin(d, 3 * d), "out": lin(d, d), "ln2": ln(d),
                "conv1": conv(d, cfg.ffn_dim, 3), "conv2": conv(cfg.ffn_dim, d, 3)}

    c = cfg.dec_channels
    cond_dim = cfg.n_mels + cfg.spk_dim + c  # mu + speaker + time embedding

    def dec_block():
        return {"conv1": conv(cfg.n_mels + cond_dim, c, 5), "conv2": conv(c, c, 5), "conv3": conv(c, cfg.n_mels, 5),
                "gn1": ln(c), "gn2": ln(c)}

    return {
        "emb": (rng.standard_normal((cfg.vocab_size, d)) * 0.02).astype(np.float32),
        "enc_layers": [enc_layer() for _ in range(cfg.enc_layers)],
        "enc_ln": ln(d),
        "mu_proj": lin(d, cfg.n_mels),
        "dur_conv": conv(d, d, 3),
        "dur_ln": ln(d),
        "dur_proj": lin(d, 1),
        "spk_emb": (rng.standard_normal((cfg.n_speakers, cfg.spk_dim)) * 0.1).astype(np.float32),
        "time_mlp1": lin(c, c),
        "time_mlp2": lin(c, c),
        "dec_blocks": [dec_block() for _ in range(cfg.dec_layers)],
    }


def matcha_params_from_numpy(tree, cfg: MatchaConfig, dtype=torch.float32, device=None) -> Dict:
    """The reference's Matcha tree (numpy, its layout) → the port's on
    ``device`` (default ``cuda``)."""
    if len(tree["enc_layers"]) != cfg.enc_layers or len(tree["dec_blocks"]) != cfg.dec_layers:
        raise ValueError("parameter tree does not match the config")
    return conv_tree_to_torch(tree, dtype, device)


def matcha_init_params(cfg: MatchaConfig, seed: int = 0, dtype=torch.float32, device=None) -> Dict:
    """The reference's random init (numpy ``default_rng(seed)``), drawn on
    the host and moved to ``device`` (default ``cuda``)."""
    device = resolve_device(device)  # before the draw: no card, no work
    return matcha_params_from_numpy(_matcha_numpy(cfg, seed), cfg, dtype, device)


def _ln(x, p):
    """Layer norm with the population variance, in the reference's order."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + 1e-5) * p["g"] + p["b"]


def _dense(x, p):
    return x @ p["w"] + p["b"]


def _conv1d(x, p):
    """``x [b, t, c_in]`` → 'SAME' convolution (odd k) → ``[b, t, c_out]``."""
    k = p["w"].shape[-1]
    return F.conv1d(x.transpose(1, 2), p["w"], padding=k // 2).transpose(1, 2) + p["b"]


def _encode(params: Dict, cfg: MatchaConfig, tokens: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phoneme tokens ``[b, t]`` → (mu per token ``[b, t, n_mels]``,
    log-durations ``[b, t]``).

    ``mask [b, t]`` (1 = token, 0 = pad) keeps pad keys out of attention and
    zeroes pad activations wherever a convolution reads them, so a padded
    batch equals each row alone."""
    x = params["emb"][tokens.long()] * math.sqrt(cfg.d_model)
    b, t, d = x.shape
    hd = d // cfg.heads
    m = None if mask is None else mask.to(x.dtype)[..., None]
    attn_bias = None
    if mask is not None:
        x = x * m
        attn_bias = ((1.0 - mask.float()) * -1e9)[:, None, None, :]

    def heads(z):
        return z.reshape(b, t, cfg.heads, hd).transpose(1, 2)

    for layer in params["enc_layers"]:
        h = _ln(x, layer["ln1"])
        q, k, v = _dense(h, layer["qkv"]).chunk(3, dim=-1)
        scores = torch.matmul(heads(q).float(), heads(k).float().transpose(-1, -2))
        if attn_bias is not None:
            scores = scores + attn_bias  # the bias before the scaling, as the reference adds it
        w = torch.softmax(scores / math.sqrt(hd), dim=-1).to(v.dtype)
        att = torch.matmul(w, heads(v))
        x = x + _dense(att.transpose(1, 2).reshape(b, t, d), layer["out"])
        h = _ln(x, layer["ln2"])
        if m is not None:
            h = h * m  # layer norm's bias makes pads nonzero: the convolutions must see zeros
        h = F.gelu(_conv1d(h, layer["conv1"]), approximate="tanh")
        if m is not None:
            h = h * m  # conv1 spills into pad positions; conv2 must not read it
        x = x + _conv1d(h, layer["conv2"])
        if m is not None:
            x = x * m
    x = _ln(x, params["enc_ln"])
    if m is not None:
        x = x * m  # zeros at pads before the mu / duration heads
    mu = _dense(x, params["mu_proj"])
    dur = _dense(_ln(torch.relu(_conv1d(x, params["dur_conv"])), params["dur_ln"]), params["dur_proj"])
    return mu, dur[..., 0]


def _length_regulate(mu: torch.Tensor, durations: torch.Tensor, max_frames: int) -> torch.Tensor:
    """Expand token means by integer durations into ``[b, max_frames, n_mels]``."""
    ends = torch.cumsum(durations, dim=1)  # [b, t]
    starts = ends - durations
    frames = torch.arange(max_frames, device=mu.device)[None, :, None]
    sel = (frames >= starts[:, None, :]) & (frames < ends[:, None, :])  # [b, F, t]
    return torch.bmm(sel.to(mu.dtype), mu)


def _time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _velocity(params: Dict, cfg: MatchaConfig, x, mu_frames, spk, t_scalar) -> torch.Tensor:
    """The flow's vector field v(x_t, t | mu, spk): stacked conv blocks."""
    b, f, _ = x.shape
    temb = _time_embedding(torch.full((b,), float(t_scalar), dtype=torch.float32, device=x.device),
                           cfg.dec_channels)
    temb = _dense(F.silu(_dense(temb, params["time_mlp1"])), params["time_mlp2"])
    cond = torch.cat([mu_frames, spk[:, None, :].expand(b, f, cfg.spk_dim),
                      temb[:, None, :].expand(b, f, cfg.dec_channels)], dim=-1)
    v = x
    for blk in params["dec_blocks"]:
        h = torch.cat([v, cond], dim=-1)
        h = F.silu(_ln(_conv1d(h, blk["conv1"]), blk["gn1"]))
        h = F.silu(_ln(_conv1d(h, blk["conv2"]), blk["gn2"]))
        v = v + _conv1d(h, blk["conv3"])
    return v - x  # residual parametrization of the field


def matcha_synthesize_mel(params: Dict, cfg: MatchaConfig, tokens: torch.Tensor, max_frames: int,
                          mask: Optional[torch.Tensor] = None, speaker_id: int = 0, noise_scale: float = 0.667,
                          length_scale: float = 1.0, ode_steps: int = 0,
                          seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``tokens [b, t]`` → (mel ``[b, max_frames, n_mels]``, n_frames ``[b]``
    int32), on the parameters' device.

    Deterministic given ``seed``: one noise pattern (``jax.random.normal``
    of ``PRNGKey(seed)``) broadcast over the rows, so a row synthesizes the
    same whatever shares its call. ``length_scale`` > 1 slows speech."""
    steps = ode_steps or cfg.ode_steps
    dev = params["emb"].device
    mu, log_dur = _encode(params, cfg, tokens, mask)
    durations = torch.clamp(torch.round(torch.exp(log_dur) * length_scale), min=1).to(torch.int32)
    if mask is not None:
        durations = durations * mask.to(torch.int32)  # pads emit no frames
    n_frames = torch.clamp(durations.sum(dim=1, dtype=torch.int32), max=max_frames)
    mu_frames = _length_regulate(mu, durations, max_frames)
    spk = params["spk_emb"][torch.full((tokens.shape[0],), speaker_id, dtype=torch.long, device=dev)]

    noise = torch.from_numpy(jax_prng.normal(jax_prng.PRNGKey(seed), (1, max_frames, cfg.n_mels)))
    x = mu_frames + noise_scale * noise.to(dev, mu_frames.dtype)
    dt = np.float32(1.0 / steps)
    for i in range(steps):
        x = x + float(dt) * _velocity(params, cfg, x, mu_frames, spk, np.float32(i) * dt)
    keep = torch.arange(max_frames, device=dev)[None, :] < n_frames[:, None]
    return x * keep[..., None], n_frames
