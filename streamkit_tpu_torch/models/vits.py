# SPDX-License-Identifier: Apache-2.0
"""VITS text-to-speech (piper/MMS-class) in PyTorch.

Port of ``streamkit_tpu/models/vits.py`` (everything but Kokoro): the text
encoder (relative-position transformer), the deterministic and stochastic
duration predictors (rational-quadratic spline flows), the residual-coupling
prior flow and the VITS HiFi-GAN decoder. Numerics follow HF
``modeling_vits.py``; ``vits_params_from_hf`` converts a ``VitsModel`` state
dict, fusing torch weight-norm parametrizations.

Activations are channels-last ``[batch, time, channels]`` as in the
reference, except in the decoder, which runs channels-first. Convolution
weights are kept in PyTorch's layout (``[out, in/groups, k]``; the
upsampling convolutions ``[in, out, k]``).

Durations are computed in f32 whatever the parameters' dtype, in the
reference's order of operations (``ceil(exp(log_dur) * mask / rate)``): one
ulp there can move a whole frame.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import params_to_torch
from .tts import conv_tree_to_torch

__all__ = [
    "VitsConfig",
    "VitsCharTokenizer",
    "vits_params_from_hf",
    "vits_params_from_numpy",
    "vits_config_from_hf",
    "vits_init_params",
    "load_vits",
    "synthesize",
    "text_encoder",
    "predict_durations",
    "durations",
    "flow_reverse",
    "vits_decode",
]


@dataclass
class VitsConfig:
    vocab_size: int = 38
    hidden_size: int = 192
    num_hidden_layers: int = 6
    num_attention_heads: int = 2
    window_size: int = 4
    use_bias: bool = True
    ffn_dim: int = 768
    ffn_kernel_size: int = 3
    flow_size: int = 192
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    leaky_relu_slope: float = 0.1
    prior_encoder_num_flows: int = 4
    prior_encoder_num_wavenet_layers: int = 4
    wavenet_kernel_size: int = 5
    wavenet_dilation_rate: int = 1
    duration_predictor_kernel_size: int = 3
    duration_predictor_filter_channels: int = 256
    duration_predictor_flow_bins: int = 10
    duration_predictor_tail_bound: float = 5.0
    duration_predictor_num_flows: int = 4
    depth_separable_channels: int = 2
    depth_separable_num_layers: int = 3
    use_stochastic_duration_prediction: bool = True
    speaking_rate: float = 1.0
    noise_scale: float = 0.667
    noise_scale_duration: float = 0.8
    layer_norm_eps: float = 1e-5
    hidden_act: str = "relu"
    sampling_rate: int = 16000

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def hop(self) -> int:
        return int(np.prod(self.upsample_rates))


def vits_config_from_hf(hf) -> VitsConfig:
    """Map a ``transformers.VitsConfig`` onto ours."""
    return VitsConfig(
        vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size,
        num_hidden_layers=hf.num_hidden_layers,
        num_attention_heads=hf.num_attention_heads,
        window_size=hf.window_size,
        use_bias=hf.use_bias,
        ffn_dim=hf.ffn_dim,
        ffn_kernel_size=hf.ffn_kernel_size,
        flow_size=hf.flow_size,
        upsample_rates=tuple(hf.upsample_rates),
        upsample_kernel_sizes=tuple(hf.upsample_kernel_sizes),
        upsample_initial_channel=hf.upsample_initial_channel,
        resblock_kernel_sizes=tuple(hf.resblock_kernel_sizes),
        resblock_dilation_sizes=tuple(tuple(d) for d in hf.resblock_dilation_sizes),
        leaky_relu_slope=hf.leaky_relu_slope,
        prior_encoder_num_flows=hf.prior_encoder_num_flows,
        prior_encoder_num_wavenet_layers=hf.prior_encoder_num_wavenet_layers,
        wavenet_kernel_size=hf.wavenet_kernel_size,
        wavenet_dilation_rate=hf.wavenet_dilation_rate,
        duration_predictor_kernel_size=hf.duration_predictor_kernel_size,
        duration_predictor_filter_channels=hf.duration_predictor_filter_channels,
        duration_predictor_flow_bins=hf.duration_predictor_flow_bins,
        duration_predictor_tail_bound=hf.duration_predictor_tail_bound,
        duration_predictor_num_flows=hf.duration_predictor_num_flows,
        depth_separable_channels=hf.depth_separable_channels,
        depth_separable_num_layers=hf.depth_separable_num_layers,
        use_stochastic_duration_prediction=hf.use_stochastic_duration_prediction,
        speaking_rate=hf.speaking_rate,
        noise_scale=hf.noise_scale,
        noise_scale_duration=hf.noise_scale_duration,
        layer_norm_eps=hf.layer_norm_eps,
        hidden_act=hf.hidden_act if isinstance(hf.hidden_act, str) else "relu",
        sampling_rate=hf.sampling_rate,
    )


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------
def _conv1d(x, p, *, dilation: int = 1, pad: Optional[Tuple[int, int]] = None, groups: int = 1):
    """Channels-last convolution: x [b, t, c_in], weight [c_out, c_in/groups,
    k], with torch's 'same' padding unless ``pad`` is given."""
    k = p["w"].shape[-1]
    if pad is None:
        s = (k * dilation - dilation) // 2
        pad = (s, s)
    y = F.conv1d(F.pad(x.transpose(1, 2), pad), p["w"], p.get("b"), dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def _layer_norm(x, p, eps: float):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * p["w"] + p["b"]


def _act(name: str):
    return {
        "relu": torch.relu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
        "silu": F.silu,
    }.get(name, torch.relu)


# ---------------------------------------------------------------------------
# text encoder: relative-position attention (modeling_vits.py:842-1005)
# ---------------------------------------------------------------------------
def _get_relative_embeddings(emb, length: int, window: int):
    """emb [2w+1, d] → [2*length-1, d] (pad or slice to the sequence)."""
    pad = max(length - (window + 1), 0)
    if pad > 0:
        emb = F.pad(emb, (0, 0, pad, pad))
    start = max((window + 1) - length, 0)
    return emb[start:start + 2 * length - 1]


def _relative_to_absolute(x):
    """[bh, t, 2t-1] → [bh, t, t] (skewing trick)."""
    bh, t, _ = x.shape
    x = F.pad(x, (0, 1))
    x = x.reshape(bh, t * 2 * t)
    x = F.pad(x, (0, t - 1))
    x = x.reshape(bh, t + 1, 2 * t - 1)
    return x[:, :t, t - 1:]


def _absolute_to_relative(x):
    """[bh, t, t] → [bh, t, 2t-1]."""
    bh, t, _ = x.shape
    x = F.pad(x, (0, t - 1))
    x = x.reshape(bh, t * (2 * t - 1))
    x = F.pad(x, (t, 0))
    return x.reshape(bh, t, 2 * t)[:, :, 1:]


def _attention(x, p, cfg: VitsConfig, attn_bias=None):
    b, t, _ = x.shape
    h, d = cfg.num_attention_heads, cfg.head_dim
    scale = d ** -0.5

    def proj(name):
        y = x @ p[name]["w"]
        if "b" in p[name]:
            y = y + p[name]["b"]
        return y.reshape(b, t, h, d).transpose(1, 2).reshape(b * h, t, d)

    q = proj("q") * scale
    k = proj("k")
    v = proj("v")
    logits = q @ k.transpose(1, 2)
    if cfg.window_size:
        rel_k = _get_relative_embeddings(p["emb_rel_k"], t, cfg.window_size)
        logits = logits + _relative_to_absolute(q @ rel_k.T)
    if attn_bias is not None:
        logits = (logits.reshape(b, h, t, t) + attn_bias).reshape(b * h, t, t)
    probs = torch.softmax(logits, dim=-1)
    out = probs @ v
    if cfg.window_size:
        rel_v = _get_relative_embeddings(p["emb_rel_v"], t, cfg.window_size)
        out = out + _absolute_to_relative(probs) @ rel_v
    out = out.reshape(b, h, t, d).transpose(1, 2).reshape(b, t, h * d)
    y = out @ p["out"]["w"]
    if "b" in p["out"]:
        y = y + p["out"]["b"]
    return y


def _feed_forward(x, mask, p, cfg: VitsConfig):
    k = cfg.ffn_kernel_size
    pad = ((k - 1) // 2, k // 2) if k > 1 else (0, 0)
    y = _conv1d(x * mask, p["conv1"], pad=pad)
    y = _act(cfg.hidden_act)(y)
    y = _conv1d(y * mask, p["conv2"], pad=pad)
    return y * mask


def text_encoder(params, cfg: VitsConfig, input_ids, mask=None):
    """``input_ids [b, t]`` → (hidden [b,t,h], prior_means, prior_log_var).

    mask: optional [b, t] float (1 = token, 0 = pad). Ids past the vocabulary
    take its last row, as the reference's clamping gather does."""
    p = params["text_encoder"]
    ids = input_ids.long().clamp(0, p["emb"].shape[0] - 1)
    x = p["emb"][ids] * math.sqrt(cfg.hidden_size)
    if mask is None:
        mask = torch.ones(ids.shape, dtype=x.dtype, device=x.device)
    m = mask[..., None]
    attn_bias = (1.0 - mask[:, None, None, :]) * torch.finfo(x.dtype).min
    x = x * m
    for layer in p["layers"]:
        res = x
        x = _attention(x, layer["attn"], cfg, attn_bias)
        x = _layer_norm(res + x, layer["ln1"], cfg.layer_norm_eps)
        res = x
        x = _feed_forward(x, m, layer["ffn"], cfg)
        x = _layer_norm(res + x, layer["ln2"], cfg.layer_norm_eps)
    x = x * m
    stats = _conv1d(x, p["project"], pad=(0, 0)) * m
    means, log_var = torch.split(stats, stats.shape[-1] // 2, dim=-1)
    return x, means, log_var


# ---------------------------------------------------------------------------
# WaveNet + residual coupling flow (modeling_vits.py:303-372, 552-595)
# ---------------------------------------------------------------------------
def _wavenet(x, mask, p, cfg: VitsConfig):
    """Gated dilated conv stack; x [b, t, hidden]."""
    out = torch.zeros_like(x)
    n = cfg.hidden_size
    for i, layer in enumerate(p["layers"]):
        dilation = cfg.wavenet_dilation_rate ** i
        h = _conv1d(x, layer["in"], dilation=dilation)
        acts = torch.tanh(h[..., :n]) * torch.sigmoid(h[..., n:])
        rs = _conv1d(acts, layer["res_skip"], pad=(0, 0))
        if i < len(p["layers"]) - 1:
            x = (x + rs[..., :n]) * mask
            out = out + rs[..., n:]
        else:
            out = out + rs
    return out * mask


def _coupling_layer_reverse(z, mask, p, cfg: VitsConfig):
    half = cfg.flow_size // 2
    first, second = z[..., :half], z[..., half:]
    h = _conv1d(first, p["pre"], pad=(0, 0)) * mask
    h = _wavenet(h, mask, p["wavenet"], cfg)
    mean = _conv1d(h, p["post"], pad=(0, 0)) * mask
    return torch.cat([first, (second - mean) * mask], dim=-1)


def flow_reverse(params, cfg: VitsConfig, z, mask):
    """Prior flow in reverse (inference): z [b, t, flow] → latents."""
    for p in reversed(params["flow"]):
        z = torch.flip(z, dims=(-1,))
        z = _coupling_layer_reverse(z, mask, p, cfg)
    return z


# ---------------------------------------------------------------------------
# duration predictors (modeling_vits.py:598-839)
# ---------------------------------------------------------------------------
def _duration_predictor(x, mask, p, cfg: VitsConfig):
    y = _conv1d(x * mask, p["conv1"])
    y = torch.relu(y)
    y = _layer_norm(y, p["norm1"], cfg.layer_norm_eps)
    y = _conv1d(y * mask, p["conv2"])
    y = torch.relu(y)
    y = _layer_norm(y, p["norm2"], cfg.layer_norm_eps)
    return _conv1d(y * mask, p["proj"], pad=(0, 0)) * mask


def _dds_conv(x, mask, p, cfg: VitsConfig, cond=None):
    """Dilated depth-separable conv stack (gelu/LN), x [b, t, hidden]."""
    if cond is not None:
        x = x + cond
    k = cfg.duration_predictor_kernel_size
    for i, layer in enumerate(p["layers"]):
        h = _conv1d(x * mask, layer["dw"], dilation=k ** i, groups=cfg.hidden_size)
        h = _layer_norm(h, layer["norm1"], cfg.layer_norm_eps)
        h = F.gelu(h)
        h = _conv1d(h, layer["pw"], pad=(0, 0))
        h = _layer_norm(h, layer["norm2"], cfg.layer_norm_eps)
        h = F.gelu(h)
        x = x + h
    return x * mask


def _rq_spline_reverse(inputs, uw, uh, ud, cfg: VitsConfig):
    """Unconstrained rational-quadratic spline, reverse direction only
    (modeling_vits.py:93-300). The bin of each input is a sum of
    comparisons against the bin edges, as the reference counts it, so that
    a value on an edge falls in the same bin."""
    tail = cfg.duration_predictor_tail_bound
    min_bin_w = 1e-3
    min_bin_h = 1e-3
    min_deriv = 1e-3
    num_bins = uw.shape[-1]

    inside = (inputs >= -tail) & (inputs <= tail)
    x = inputs.clamp(-tail, tail)

    constant = float(np.log(np.exp(1 - min_deriv) - 1))
    ud = F.pad(ud, (1, 1), value=constant)

    def edges(u, min_bin):
        w = torch.softmax(u, dim=-1)
        w = min_bin + (1 - min_bin * num_bins) * w
        cum = F.pad(torch.cumsum(w, dim=-1), (1, 0))
        cum = 2 * tail * cum - tail
        cum[..., 0] = -tail
        cum[..., -1] = tail
        return cum, cum[..., 1:] - cum[..., :-1]

    cumw, widths = edges(uw, min_bin_w)
    derivs = min_deriv + F.softplus(ud)
    cumh, heights = edges(uh, min_bin_h)

    locations = cumh.clone()
    locations[..., -1] += 1e-6  # reverse: bins over heights
    bin_idx = (x[..., None] >= locations).sum(dim=-1) - 1
    bin_idx = bin_idx.clamp(0, num_bins - 1)[..., None]

    def take(a):
        return torch.gather(a, -1, bin_idx)[..., 0]

    in_cumw = take(cumw)
    in_w = take(widths)
    in_cumh = take(cumh)
    delta = heights / widths
    in_delta = take(delta)
    in_d = take(derivs)
    in_d1 = take(derivs[..., 1:])
    in_h = take(heights)

    inter1 = in_d + in_d1 - 2 * in_delta
    inter2 = x - in_cumh
    inter3 = inter2 * inter1
    a = in_h * (in_delta - in_d) + inter3
    b = in_h * in_d - inter3
    c = -in_delta * inter2
    disc = b * b - 4 * a * c
    root = (2 * c) / (-b - torch.sqrt(disc.clamp(min=0.0)))
    out = root * in_w + in_cumw
    return torch.where(inside, out, inputs)


def _conv_flow_reverse(z, mask, p, cfg: VitsConfig, cond):
    half = cfg.depth_separable_channels // 2
    first, second = z[..., :half], z[..., half:]
    h = _conv1d(first, p["pre"], pad=(0, 0))
    h = _dds_conv(h, mask, p["dds"], cfg, cond)
    h = _conv1d(h, p["proj"], pad=(0, 0)) * mask

    b, t, _ = first.shape
    nb = cfg.duration_predictor_flow_bins
    # torch reshapes (b, c, 3nb-1, t) channel-first; channels-last equivalent
    h = h.reshape(b, t, half, 3 * nb - 1)
    scale = math.sqrt(cfg.hidden_size)
    uw = h[..., :nb] / scale
    uh = h[..., nb:2 * nb] / scale
    ud = h[..., 2 * nb:]
    out = _rq_spline_reverse(second, uw, uh, ud, cfg)
    return torch.cat([first, out * mask], dim=-1)


def _stochastic_duration_reverse(x, mask, p, cfg: VitsConfig, noise):
    """Reverse (inference) pass of the stochastic duration predictor."""
    h = _conv1d(x, p["conv_pre"], pad=(0, 0))
    h = _dds_conv(h, mask, p["dds"], cfg)
    h = _conv1d(h, p["conv_proj"], pad=(0, 0)) * mask

    z = noise  # [b, t, 2]
    # flows reversed, dropping the "useless" first ConvFlow
    # (modeling_vits.py:790-791)
    flows: List = list(reversed(p["flows"]))
    flows = flows[:-2] + [flows[-1]]
    for fp in flows:
        z = torch.flip(z, dims=(-1,))
        if fp["kind"] == "affine":
            z = (z - fp["translate"]) * torch.exp(-fp["log_scale"]) * mask
        else:
            z = _conv_flow_reverse(z, mask, fp, cfg, cond=h)
    return z[..., :1]  # log_duration


def predict_durations(params, cfg: VitsConfig, hidden, mask, dur_noise=None):
    """hidden [b,t,h], mask [b,t,1] → log_duration [b,t,1]."""
    p = params["duration_predictor"]
    if cfg.use_stochastic_duration_prediction:
        if dur_noise is None:
            dur_noise = hidden.new_zeros(hidden.shape[:2] + (2,))
        return _stochastic_duration_reverse(hidden, mask, p, cfg, dur_noise)
    return _duration_predictor(hidden, mask, p, cfg)


def durations(log_dur, mask, rate: float):
    """Frames per token: ``ceil(exp(log_dur) * mask / rate)`` in f32, in the
    reference's order of operations."""
    return torch.ceil(torch.exp(log_dur.float()) * mask.float() / rate)


# ---------------------------------------------------------------------------
# HiFi-GAN decoder (VITS variant: flow_size in, no conv_post bias)
# ---------------------------------------------------------------------------
def _conv_cf(x, p, dilation: int = 1, pad: Optional[int] = None):
    """Channels-first 'same' convolution: x [b, c, t]."""
    k = p["w"].shape[-1]
    return F.conv1d(x, p["w"], p.get("b"), padding=(k * dilation - dilation) // 2 if pad is None else pad,
                    dilation=dilation)


def vits_decode(params, cfg: VitsConfig, latents):
    """latents [b, frames, flow] → waveform [b, frames * hop]."""
    p = params["decoder"]
    slope = cfg.leaky_relu_slope
    x = _conv_cf(latents.transpose(1, 2), p["pre"], pad=3)
    nk = len(cfg.resblock_kernel_sizes)
    for i, up in enumerate(p["ups"]):
        x = F.leaky_relu(x, slope)
        k = up["w"].shape[-1]
        stride = cfg.upsample_rates[i]
        x = F.conv_transpose1d(x, up["w"], up["b"], stride=stride, padding=(k - stride) // 2)
        acc = None
        for j in range(nk):
            rb = p["resblocks"][i * nk + j]
            y = x
            for c1, c2, d in zip(rb["convs1"], rb["convs2"], cfg.resblock_dilation_sizes[j]):
                res = y
                y = F.leaky_relu(y, slope)
                y = _conv_cf(y, c1, dilation=d)
                y = F.leaky_relu(y, slope)
                y = _conv_cf(y, c2)
                y = y + res
            acc = y if acc is None else acc + y
        x = acc / nk
    x = F.leaky_relu(x, 0.01)  # torch F.leaky_relu default slope
    x = _conv_cf(x, p["post"], pad=3)
    return torch.tanh(x)[:, 0]


# ---------------------------------------------------------------------------
# end-to-end synthesis
# ---------------------------------------------------------------------------
def _expand_by_duration(durations, means, log_vars, in_mask, max_frames: int):
    """Monotonic length regulation as one matmul: attn [b, frames, t] with
    attn[b, j, i] = 1 iff frame j belongs to token i; then the stats expand
    by ``attn @ stats`` (modeling_vits.py:1373-1385, with a fixed
    ``max_frames``)."""
    d = durations[..., 0] * in_mask[..., 0]
    cum = torch.cumsum(d, dim=-1)  # [b, t]
    total = cum[:, -1:].clamp(min=1.0)
    frames = torch.arange(max_frames, dtype=d.dtype, device=d.device)[None, :, None]  # [1, f, 1]
    below = (frames < cum[:, None, :]).to(d.dtype)  # [b, f, t]
    started = (frames >= (cum - d)[:, None, :]).to(d.dtype)
    out_mask = (frames[..., 0] < total).to(d.dtype)[..., None]  # [b, f, 1]
    attn = (below * started * out_mask * in_mask[:, None, :, 0]).to(means.dtype)
    return attn @ means, attn @ log_vars, out_mask.to(means.dtype), total[..., 0]


def synthesize(
    params,
    cfg: VitsConfig,
    input_ids,
    *,
    mask=None,
    max_frames: Optional[int] = None,
    speaking_rate: Optional[float] = None,
    noise_scale: Optional[float] = None,
    noise: Optional[torch.Tensor] = None,
    dur_noise: Optional[torch.Tensor] = None,
):
    """Full VITS inference: token ids → waveform.

    Returns ``(waveform [b, max_frames*hop], n_valid_samples [b] int32)``.
    ``max_frames`` fixes the output length; frames beyond the predicted
    length are masked to silence. ``noise``/``dur_noise`` default to zeros
    (deterministic synthesis); pass gaussian samples scaled by the config
    noise levels for the stochastic behaviour.
    """
    hidden, means, log_vars = text_encoder(params, cfg, input_ids, mask)
    m = (torch.ones(input_ids.shape, dtype=hidden.dtype, device=hidden.device) if mask is None
         else mask.to(hidden.dtype))[..., None]

    log_dur = predict_durations(params, cfg, hidden, m, dur_noise)
    rate = cfg.speaking_rate if speaking_rate is None else speaking_rate
    duration = durations(log_dur, m, rate)

    if max_frames is None:
        # eager convenience: tight bound from the actual prediction
        per_sample = duration.sum(dim=(1, 2))
        max_frames = int(per_sample.clamp(min=1.0).max())

    means_e, log_vars_e, out_mask, total = _expand_by_duration(duration, means, log_vars, m.float(), max_frames)
    ns = cfg.noise_scale if noise_scale is None else noise_scale
    z_p = means_e if noise is None else means_e + noise * torch.exp(log_vars_e) * ns
    z_p = z_p * out_mask
    latents = flow_reverse(params, cfg, z_p, out_mask) * out_mask
    wave = vits_decode(params, cfg, latents)
    return wave, (total * cfg.hop).to(torch.int32)


# ---------------------------------------------------------------------------
# weights: the reference's tree, HF conversion and random init
# ---------------------------------------------------------------------------
def vits_params_from_numpy(tree, cfg: VitsConfig, dtype=torch.float32, device=None) -> Dict:
    """The reference's VITS tree (numpy arrays, its convolution layouts) →
    the port's, on ``device`` (default ``cuda``)."""
    params = conv_tree_to_torch(tree, dtype, device)
    if len(params["text_encoder"]["layers"]) != cfg.num_hidden_layers or len(params["flow"]) != (
            cfg.prior_encoder_num_flows):
        raise ValueError("parameter tree does not match the config's layer counts")
    return params


def _fuse_weight_norm(sd: Dict[str, np.ndarray], prefix: str) -> np.ndarray:
    """torch weight_norm: w = g * v / ||v|| (norm over in+k dims per out)."""
    g = np.asarray(sd[f"{prefix}.parametrizations.weight.original0"], np.float32)
    v = np.asarray(sd[f"{prefix}.parametrizations.weight.original1"], np.float32)
    norm = np.sqrt(np.sum(v * v, axis=(1, 2), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def vits_params_from_hf(sd: Dict[str, np.ndarray], cfg: VitsConfig, dtype=torch.float32, device=None) -> Dict:
    """Convert a HF ``VitsModel`` state dict (the training-only posterior
    encoder is skipped). HF stores convolutions in PyTorch's layouts, which
    are the port's."""

    def t(name):
        return np.asarray(sd[name], np.float32)

    def conv(prefix, bias=True, weight_norm=False):
        out = {"w": _fuse_weight_norm(sd, prefix) if weight_norm else t(f"{prefix}.weight")}
        if bias and f"{prefix}.bias" in sd:
            out["b"] = t(f"{prefix}.bias")
        return out

    def lin(prefix):
        out = {"w": t(f"{prefix}.weight").T}
        if f"{prefix}.bias" in sd:
            out["b"] = t(f"{prefix}.bias")
        return out

    def ln(prefix):
        return {"w": t(f"{prefix}.weight"), "b": t(f"{prefix}.bias")}

    def enc_layer(i):
        pre = f"text_encoder.encoder.layers.{i}"
        return {
            "attn": {
                "q": lin(f"{pre}.attention.q_proj"),
                "k": lin(f"{pre}.attention.k_proj"),
                "v": lin(f"{pre}.attention.v_proj"),
                "out": lin(f"{pre}.attention.out_proj"),
                "emb_rel_k": t(f"{pre}.attention.emb_rel_k")[0],
                "emb_rel_v": t(f"{pre}.attention.emb_rel_v")[0],
            },
            "ln1": ln(f"{pre}.layer_norm"),
            "ffn": {"conv1": conv(f"{pre}.feed_forward.conv_1"), "conv2": conv(f"{pre}.feed_forward.conv_2")},
            "ln2": ln(f"{pre}.final_layer_norm"),
        }

    def wavenet(prefix, num_layers):
        return {"layers": [
            {"in": conv(f"{prefix}.in_layers.{i}", weight_norm=True),
             "res_skip": conv(f"{prefix}.res_skip_layers.{i}", weight_norm=True)}
            for i in range(num_layers)
        ]}

    def dds(prefix):
        return {"layers": [
            {"dw": conv(f"{prefix}.convs_dilated.{i}"), "pw": conv(f"{prefix}.convs_pointwise.{i}"),
             "norm1": ln(f"{prefix}.norms_1.{i}"), "norm2": ln(f"{prefix}.norms_2.{i}")}
            for i in range(cfg.depth_separable_num_layers)
        ]}

    nk = len(cfg.resblock_kernel_sizes)
    tree: Dict = {
        "text_encoder": {
            "emb": t("text_encoder.embed_tokens.weight"),
            "layers": [enc_layer(i) for i in range(cfg.num_hidden_layers)],
            "project": conv("text_encoder.project"),
        },
        "flow": [
            {"pre": conv(f"flow.flows.{i}.conv_pre"),
             "wavenet": wavenet(f"flow.flows.{i}.wavenet", cfg.prior_encoder_num_wavenet_layers),
             "post": conv(f"flow.flows.{i}.conv_post")}
            for i in range(cfg.prior_encoder_num_flows)
        ],
        "decoder": {
            "pre": conv("decoder.conv_pre"),
            # ConvTranspose1d weights are [in, out, k] in the state dict
            "ups": [conv(f"decoder.upsampler.{i}") for i in range(len(cfg.upsample_rates))],
            "resblocks": [
                {"convs1": [conv(f"decoder.resblocks.{r}.convs1.{j}")
                            for j in range(len(cfg.resblock_dilation_sizes[r % nk]))],
                 "convs2": [conv(f"decoder.resblocks.{r}.convs2.{j}")
                            for j in range(len(cfg.resblock_dilation_sizes[r % nk]))]}
                for r in range(len(cfg.upsample_rates) * nk)
            ],
            "post": conv("decoder.conv_post", bias=False),
        },
    }
    if cfg.use_stochastic_duration_prediction:
        flows = [{"kind": "affine", "translate": t("duration_predictor.flows.0.translate")[:, 0],
                  "log_scale": t("duration_predictor.flows.0.log_scale")[:, 0]}]
        for i in range(1, cfg.duration_predictor_num_flows + 1):
            pre = f"duration_predictor.flows.{i}"
            flows.append({"kind": "conv", "pre": conv(f"{pre}.conv_pre"), "dds": dds(f"{pre}.conv_dds"),
                          "proj": conv(f"{pre}.conv_proj")})
        tree["duration_predictor"] = {
            "conv_pre": conv("duration_predictor.conv_pre"),
            "conv_proj": conv("duration_predictor.conv_proj"),
            "dds": dds("duration_predictor.conv_dds"),
            "flows": flows,
        }
    else:
        tree["duration_predictor"] = {
            "conv1": conv("duration_predictor.conv_1"),
            "conv2": conv("duration_predictor.conv_2"),
            "norm1": ln("duration_predictor.norm_1"),
            "norm2": ln("duration_predictor.norm_2"),
            "proj": conv("duration_predictor.proj"),
        }
    return params_to_torch(tree, dtype, resolve_device(device))


def _init_numpy(cfg: VitsConfig, seed: int) -> Dict:
    """The reference's random tree (its layouts), drawn in its order from
    its generator."""
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=0.02):
        return rng.randn(*shape).astype(np.float32) * np.float32(scale)

    def conv(k, c_in, c_out, bias=True, groups=1):
        p = {"w": arr(k, c_in // groups, c_out, scale=1.0 / math.sqrt(k * c_in))}
        if bias:
            p["b"] = np.zeros((c_out,), np.float32)
        return p

    def lin(d_in, d_out):
        return {"w": arr(d_in, d_out), "b": np.zeros((d_out,), np.float32)}

    def ln(d):
        return {"w": np.ones((d,), np.float32), "b": np.zeros((d,), np.float32)}

    h = cfg.hidden_size
    w2 = 2 * cfg.window_size + 1

    def enc_layer():
        return {
            "attn": {
                "q": lin(h, h), "k": lin(h, h), "v": lin(h, h), "out": lin(h, h),
                "emb_rel_k": arr(w2, cfg.head_dim, scale=cfg.head_dim ** -0.5),
                "emb_rel_v": arr(w2, cfg.head_dim, scale=cfg.head_dim ** -0.5),
            },
            "ln1": ln(h),
            "ffn": {"conv1": conv(cfg.ffn_kernel_size, h, cfg.ffn_dim), "conv2": conv(cfg.ffn_kernel_size, cfg.ffn_dim, h)},
            "ln2": ln(h),
        }

    def wavenet(num_layers):
        return {"layers": [
            {"in": conv(cfg.wavenet_kernel_size, h, 2 * h), "res_skip": conv(1, h, 2 * h if i < num_layers - 1 else h)}
            for i in range(num_layers)
        ]}

    def dds():
        return {"layers": [
            {"dw": conv(cfg.duration_predictor_kernel_size, h, h, groups=h), "pw": conv(1, h, h),
             "norm1": ln(h), "norm2": ln(h)}
            for _ in range(cfg.depth_separable_num_layers)
        ]}

    half = cfg.flow_size // 2
    c0 = cfg.upsample_initial_channel
    params: Dict = {
        "text_encoder": {
            "emb": arr(cfg.vocab_size, h),
            "layers": [enc_layer() for _ in range(cfg.num_hidden_layers)],
            "project": conv(1, h, cfg.flow_size * 2),
        },
        "flow": [
            {"pre": conv(1, half, h), "wavenet": wavenet(cfg.prior_encoder_num_wavenet_layers), "post": conv(1, h, half)}
            for _ in range(cfg.prior_encoder_num_flows)
        ],
        "decoder": {
            "pre": conv(7, cfg.flow_size, c0),
            "ups": [conv(cfg.upsample_kernel_sizes[i], c0 // (2 ** (i + 1)), c0 // (2 ** i))
                    for i in range(len(cfg.upsample_rates))],
            "resblocks": [],
            "post": conv(7, c0 // (2 ** len(cfg.upsample_rates)), 1, bias=False),
        },
    }
    # the reference then redraws the upsampling kernels as [k, out, in]
    for i, up in enumerate(params["decoder"]["ups"]):
        c_in, c_out, k = c0 // (2 ** i), c0 // (2 ** (i + 1)), cfg.upsample_kernel_sizes[i]
        up["w"] = arr(k, c_out, c_in, scale=1.0 / math.sqrt(k * c_in))
        up["b"] = np.zeros((c_out,), np.float32)
    for i in range(len(cfg.upsample_rates)):
        ch = c0 // (2 ** (i + 1))
        for j, k in enumerate(cfg.resblock_kernel_sizes):
            dil = cfg.resblock_dilation_sizes[j]
            params["decoder"]["resblocks"].append(
                {"convs1": [conv(k, ch, ch) for _ in dil], "convs2": [conv(k, ch, ch) for _ in dil]}
            )
    if cfg.use_stochastic_duration_prediction:
        dsc = cfg.depth_separable_channels
        flows: List = [{"kind": "affine", "translate": np.zeros((dsc,), np.float32),
                        "log_scale": np.zeros((dsc,), np.float32)}]
        for _ in range(cfg.duration_predictor_num_flows):
            flows.append({"kind": "conv", "pre": conv(1, dsc // 2, h), "dds": dds(),
                          "proj": conv(1, h, dsc // 2 * (cfg.duration_predictor_flow_bins * 3 - 1))})
        params["duration_predictor"] = {"conv_pre": conv(1, h, h), "conv_proj": conv(1, h, h), "dds": dds(),
                                        "flows": flows}
    else:
        fc = cfg.duration_predictor_filter_channels
        params["duration_predictor"] = {
            "conv1": conv(cfg.duration_predictor_kernel_size, h, fc),
            "conv2": conv(cfg.duration_predictor_kernel_size, fc, fc),
            "norm1": ln(fc),
            "norm2": ln(fc),
            "proj": conv(1, fc, 1),
        }
    return params


def vits_init_params(cfg: VitsConfig, seed: int = 0, dtype=torch.float32, device=None) -> Dict:
    """The random weights of a config without a checkpoint: the reference's
    numpy draws (equal to its ``vits_init_params`` at f32), made on the host
    and moved to ``device`` (default ``cuda``)."""
    return vits_params_from_numpy(_init_numpy(cfg, seed), cfg, dtype, device)


# ---------------------------------------------------------------------------
# tokenizer + checkpoint loading (HF VitsTokenizer-compatible, char level)
# ---------------------------------------------------------------------------
class VitsCharTokenizer:
    """Character tokenizer matching HF ``VitsTokenizer`` (non-phonemized
    path): lowercase, drop chars outside the vocab, intersperse the
    blank/pad id between characters."""

    def __init__(self, vocab: Dict[str, int], add_blank: bool = True, pad_id: int = 0) -> None:
        self.vocab = vocab
        self.add_blank = add_blank
        self.pad_id = pad_id

    def encode(self, text: str) -> np.ndarray:
        ids = [self.vocab[c] for c in text.lower() if c in self.vocab]
        if self.add_blank:
            out = [self.pad_id] * (len(ids) * 2 + 1)
            out[1::2] = ids
            ids = out
        return np.asarray(ids or [self.pad_id], np.int32)


def load_vits(model_dir: str, dtype=torch.float32, device=None):
    """Load an HF VitsModel checkpoint dir (config.json + model.safetensors /
    pytorch_model.bin + vocab.json) → ``(cfg, params, tokenizer)`` on
    ``device`` (default ``cuda``)."""
    import json
    import os

    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        raw = json.load(f)
    fields = VitsConfig.__dataclass_fields__
    cfg = VitsConfig(**{
        k: (tuple(tuple(x) if isinstance(x, list) else x for x in v) if isinstance(v, list) else v)
        for k, v in raw.items() if k in fields
    })
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st_path):
        from safetensors.numpy import load_file

        sd = load_file(st_path)
    else:
        blob = torch.load(os.path.join(model_dir, "pytorch_model.bin"), map_location="cpu", weights_only=True)
        sd = {k: v.numpy() for k, v in blob.items()}
    params = vits_params_from_hf(sd, cfg, dtype, device)
    tok = None
    vocab_path = os.path.join(model_dir, "vocab.json")
    if os.path.exists(vocab_path):
        with open(vocab_path, encoding="utf-8") as f:
            tok = VitsCharTokenizer(json.load(f))
    return cfg, params, tok
