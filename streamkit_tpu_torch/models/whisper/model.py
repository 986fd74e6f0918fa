# SPDX-License-Identifier: Apache-2.0
"""Whisper encoder/decoder in PyTorch.

Port of ``streamkit_tpu/models/whisper/model.py``. The arithmetic follows
the reference step by step:

* parameters live in :class:`Params` modules whose leaf names follow the
  reference's dict paths (``enc.layers.3.attn.q.w``); weights keep its
  ``[d_in, d_out]`` layout, so carrying a parameter tree across is a copy,
* matmuls that the reference runs with ``preferred_element_type=f32`` and
  keeps in f32 (attention scores, logits) are computed in f32 here; the
  others round to the activation dtype as the reference does,
* encoder self-attention goes through the hand-written flash kernel on CUDA
  whenever the reference's gate holds (no mask, 4-d, T ≥ 256, hd % 64 == 0),
* the decoder's KV cache is updated **in place** (the reference's
  ``dynamic_update_slice`` is functional); see :func:`decode_step`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...device import resolve_device, strict_fp32
from ...ops.attention import flash_attention
from .config import WhisperConfig

__all__ = [
    "Params",
    "build_params",
    "init_params",
    "seeded_params",
    "encode",
    "decode_logits",
    "init_kv_cache",
    "decode_step",
    "sinusoids",
    "KVCache",
]


class Params(nn.Module):
    """A node of the parameter tree. ``p["w"]`` reads a child as the
    reference's dict pytree does; lists are ``nn.ModuleList``s."""

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def build_params(tree) -> Params:
    """Nested dict/list of tensors → :class:`Params` (no grad)."""

    def node(x):
        if isinstance(x, dict):
            m = Params()
            for k, v in x.items():
                child = node(v)
                if isinstance(child, torch.Tensor):
                    m.register_parameter(k, nn.Parameter(child, requires_grad=False))
                else:
                    m.add_module(k, child)
            return m
        if isinstance(x, list):
            return nn.ModuleList([node(v) for v in x])
        return x

    return node(tree)


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------
def _param_spec(cfg: WhisperConfig):
    """Leaf-spec tree with HF-compatible structure: each leaf is
    ``(kind, shape, arg)`` — ``uniform`` (±arg), ``uniform_r``, ``normal``
    (std arg), ``zeros``, ``ones``, ``sinusoid``."""

    def linear(d_in, d_out, bias=True):
        p = {"w": ("uniform", (d_in, d_out), 1.0 / math.sqrt(d_in))}
        if bias:
            p["b"] = ("zeros", (d_out,), None)
        return p

    def ln(d):
        return {"g": ("ones", (d,), None), "b": ("zeros", (d,), None)}

    def attn_block(d):
        return {
            "q": linear(d, d),
            "k": linear(d, d, bias=False),
            "v": linear(d, d),
            "o": linear(d, d),
        }

    def enc_layer(d):
        return {
            "ln1": ln(d),
            "attn": attn_block(d),
            "ln2": ln(d),
            "mlp1": linear(d, 4 * d),
            "mlp2": linear(4 * d, d),
        }

    def dec_layer(d):
        return {
            "ln1": ln(d),
            "attn": attn_block(d),
            "ln_x": ln(d),
            "xattn": attn_block(d),
            "ln2": ln(d),
            "mlp1": linear(d, 4 * d),
            "mlp2": linear(4 * d, d),
        }

    da, dt = cfg.n_audio_state, cfg.n_text_state
    return {
        "enc": {
            "conv1": {
                "w": ("uniform_r", (3, cfg.n_mels, da), 1.0 / math.sqrt(cfg.n_mels * 3)),
                "b": ("zeros", (da,), None),
            },
            "conv2": {
                "w": ("uniform_r", (3, da, da), 1.0 / math.sqrt(da * 3)),
                "b": ("zeros", (da,), None),
            },
            "pos": ("sinusoid", (cfg.n_audio_ctx, da), None),
            "layers": [enc_layer(da) for _ in range(cfg.n_audio_layer)],
            "ln_post": ln(da),
        },
        "dec": {
            "tok_emb": ("normal", (cfg.n_vocab, dt), 0.02),
            "pos_emb": ("normal", (cfg.n_text_ctx, dt), 0.02),
            "layers": [dec_layer(dt) for _ in range(cfg.n_text_layer)],
            "ln": ln(dt),
        },
    }


def _spec_map(spec, fn):
    if isinstance(spec, dict):
        return {k: _spec_map(v, fn) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_spec_map(v, fn) for v in spec]
    return fn(spec)


def init_params(
    cfg: WhisperConfig,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Params:
    """Random parameters drawn on ``device`` (default ``cuda``) from
    ``generator`` (seed 0 when omitted). Same distributions as the reference;
    the values differ (use ``load.params_from_numpy`` to carry a reference
    tree across)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def materialize(leaf):
        kind, shape, arg = leaf
        if kind in ("uniform", "uniform_r"):
            a = torch.empty(shape, device=dev).uniform_(-arg, arg, generator=generator)
        elif kind == "normal":
            a = torch.empty(shape, device=dev).normal_(0.0, arg, generator=generator)
        elif kind == "zeros":
            a = torch.zeros(shape, device=dev)
        elif kind == "ones":
            a = torch.ones(shape, device=dev)
        else:  # sinusoid
            a = torch.from_numpy(sinusoids(*shape)).to(dev)
        return a.to(dtype)

    return build_params(_spec_map(_param_spec(cfg), materialize))


def seeded_params(cfg: WhisperConfig, dtype: torch.dtype = torch.float32, device=None) -> Params:
    """The random weights of a config without a checkpoint: drawn on the CPU
    from seed 0 and then moved to ``device`` (default ``cuda``). Every entry
    point (the whisper node, the serving engine) draws through this, so one
    config gives one model on every device, as the reference's one
    ``PRNGKey(0)`` does."""
    dev = resolve_device(device)
    return init_params(cfg, torch.Generator().manual_seed(0), dtype, device="cpu").to(dev)


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder positions."""
    log_timescale_increment = math.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
def _layernorm(x, p):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + 1e-5)
    return (y * p["g"].float() + p["b"].float()).to(x.dtype)


def _dense(x, p):
    y = torch.matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def _split_heads(x, n_head):
    *lead, t, d = x.shape
    return x.reshape(*lead, t, n_head, d // n_head).transpose(-3, -2)  # [..., h, t, hd]


def _merge_heads(x):
    *lead, h, t, hd = x.shape
    return x.transpose(-3, -2).reshape(*lead, t, h * hd)


def _attention(q, k, v, n_head, mask=None):
    """Scaled dot-product attention. q,k,v: ``[..., t, d]``.

    Non-causal full-sequence attention (the encoder) goes through the flash
    kernel on CUDA; masked and short cases use plain attention."""
    hd = q.shape[-1] // n_head
    scale = hd ** -0.25
    qh = _split_heads(q, n_head)
    kh = _split_heads(k, n_head)
    vh = _split_heads(v, n_head)
    if mask is None and qh.ndim == 4 and qh.shape[-2] >= 256 and hd % 64 == 0:
        return _merge_heads(flash_attention(qh, kh, vh, scale))
    scores = torch.matmul((qh * scale).float(), (kh * scale).transpose(-1, -2).float())
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _merge_heads(torch.matmul(probs, vh))


def _mlp(x, layer):
    # tanh-gelu for bf16 activations (its error sits below bf16 rounding),
    # exact gelu for f32, as the reference
    approx = "tanh" if x.dtype == torch.bfloat16 else "none"
    return _dense(F.gelu(_dense(x, layer["mlp1"]), approximate=approx), layer["mlp2"])


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------
def _conv1d(x, w, b, stride: int):
    """x: ``[batch, t, c_in]``; w: ``[k, c_in, c_out]`` (the reference's NWC
    layout) → ``[batch, t', c_out]`` via ``F.conv1d`` over NCW."""
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=stride, padding=1)
    return y.transpose(1, 2) + b


def encode(params: Params, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """``mel [batch, n_frames, n_mels]`` → audio states ``[batch, n_audio_ctx, d]``.

    ``n_frames`` must be ``2 * n_audio_ctx`` or shorter (shorter windows use
    the prefix of the position table)."""
    if mel.is_cuda:
        strict_fp32()
    e = params["enc"]
    x = F.gelu(_conv1d(mel, e["conv1"]["w"], e["conv1"]["b"], 1))
    x = F.gelu(_conv1d(x, e["conv2"]["w"], e["conv2"]["b"], 2))
    x = x + e["pos"][: x.shape[-2]].to(x.dtype)
    for layer in e["layers"]:
        h = _layernorm(x, layer["ln1"])
        attn = _attention(
            _dense(h, layer["attn"]["q"]),
            _dense(h, layer["attn"]["k"]),
            _dense(h, layer["attn"]["v"]),
            cfg.n_audio_head,
        )
        x = x + _dense(attn, layer["attn"]["o"])
        x = x + _mlp(_layernorm(x, layer["ln2"]), layer)
    return _layernorm(x, e["ln_post"])


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------
def _check_tokens(cfg: WhisperConfig, *ids: int) -> None:
    """The reference clamps out-of-range embedding indices; the port refuses
    them (an out-of-range CUDA gather is a device-side fault)."""
    bad = [i for i in ids if not 0 <= i < cfg.n_vocab]
    if bad:
        raise ValueError(f"token ids {bad} outside the vocabulary ({cfg.n_vocab})")


def decode_logits(
    params: Params,
    cfg: WhisperConfig,
    tokens: torch.Tensor,  # [batch, t]
    audio_states: torch.Tensor,  # [batch, n_audio_ctx, d]
) -> torch.Tensor:
    """Full-sequence (teacher-forced) decoder → f32 logits ``[batch, t, vocab]``."""
    if audio_states.is_cuda:
        strict_fp32()
    d = params["dec"]
    t = tokens.shape[-1]
    if t > cfg.n_text_ctx:
        raise ValueError(f"{t} tokens exceed n_text_ctx={cfg.n_text_ctx}")
    x = d["tok_emb"][tokens] + d["pos_emb"][:t]
    causal = torch.triu(
        torch.full((t, t), float("-inf"), dtype=torch.float32, device=x.device), diagonal=1
    )
    for layer in d["layers"]:
        h = _layernorm(x, layer["ln1"])
        attn = _attention(
            _dense(h, layer["attn"]["q"]),
            _dense(h, layer["attn"]["k"]),
            _dense(h, layer["attn"]["v"]),
            cfg.n_text_head,
            mask=causal,
        )
        x = x + _dense(attn, layer["attn"]["o"])
        hx = _layernorm(x, layer["ln_x"])
        xattn = _attention(
            _dense(hx, layer["xattn"]["q"]),
            _dense(audio_states, layer["xattn"]["k"]),
            _dense(audio_states, layer["xattn"]["v"]),
            cfg.n_text_head,
        )
        x = x + _dense(xattn, layer["xattn"]["o"])
        x = x + _mlp(_layernorm(x, layer["ln2"]), layer)
    x = _layernorm(x, d["ln"])
    return torch.matmul(x.float(), d["tok_emb"].float().T)


class KVCache(NamedTuple):
    """Decoder caches in **T-major layout** ``[..., head_dim, T]``.

    ``k``/``v`` are written **in place** by :func:`decode_step` (one column
    per step); a cache belongs to one decode loop. ``pos`` is the next write
    position (a host int: the loop runs in Python)."""

    k: torch.Tensor  # [layers, batch, heads, head_dim, max_len]
    v: torch.Tensor
    xk: torch.Tensor  # [layers, batch, heads, head_dim, n_audio_ctx] (dtype or int8)
    xv: torch.Tensor
    pos: int
    # per-token dequant scales when xk/xv are int8 ([L, B, H, 1, n_audio_ctx]
    # f32); zero-size tensors when the cross cache is full precision
    xk_scale: torch.Tensor
    xv_scale: torch.Tensor

    @property
    def cross_quantized(self) -> bool:
        return self.xk_scale.numel() > 0


def _quantize_tmaj(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 over the head_dim axis of ``[..., hd, T]``
    (round half to even, as ``jnp.round``)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def init_kv_cache(
    params: Params,
    cfg: WhisperConfig,
    audio_states: torch.Tensor,
    max_len: Optional[int] = None,
    cross_kv_int8: bool = False,
) -> KVCache:
    """Preallocate the self-attention cache and precompute cross-attention
    K/V once (``cross_kv_int8``: per-token int8 with f32 scales)."""
    batch = audio_states.shape[0]
    max_len = max_len or cfg.n_text_ctx
    hd = cfg.n_text_state // cfg.n_text_head
    dtype = audio_states.dtype
    layers = params["dec"]["layers"]
    xk = torch.stack(
        [_split_heads(_dense(audio_states, l["xattn"]["k"]), cfg.n_text_head).transpose(-1, -2)
         for l in layers]
    )
    xv = torch.stack(
        [_split_heads(_dense(audio_states, l["xattn"]["v"]), cfg.n_text_head).transpose(-1, -2)
         for l in layers]
    )
    empty = torch.zeros((0,), dtype=torch.float32, device=audio_states.device)
    xk_scale = xv_scale = empty
    if cross_kv_int8:
        xk, xk_scale = _quantize_tmaj(xk)
        xv, xv_scale = _quantize_tmaj(xv)
    shape = (cfg.n_text_layer, batch, cfg.n_text_head, hd, max_len)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=audio_states.device),
        v=torch.zeros(shape, dtype=dtype, device=audio_states.device),
        xk=xk,
        xv=xv,
        pos=0,
        xk_scale=xk_scale,
        xv_scale=xv_scale,
    )


def _tmaj_attend(q, k_t, v_t, dtype, k_scale=None, v_scale=None):
    """q ``[b,h,1,hd]``; k_t/v_t T-major ``[b,h,hd,T]`` → ``[b,1,h*hd]``.

    With ``k_scale``/``v_scale`` the caches are per-token int8: scores take
    the K scales in f32 and the V scales fold into the probabilities. The
    f32 scores materialise an f32 copy of the keys per call (eager)."""
    scores = torch.matmul(q.float(), k_t.float())  # [b,h,1,T]
    if k_scale is not None:
        scores = scores * k_scale
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale
        v_t = v_t.to(dtype)
    probs = probs.to(dtype)
    out = torch.matmul(probs, v_t.transpose(-1, -2))  # bhqt,bhdt->bhqd
    return _merge_heads(out)


def decode_step(
    params: Params,
    cfg: WhisperConfig,
    tokens: torch.Tensor,  # [batch] current token ids
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """One incremental decode step → (f32 logits ``[batch, vocab]``, cache).

    Writes column ``cache.pos`` of ``cache.k``/``cache.v`` **in place** and
    returns the cache with ``pos + 1``. Attention reads the ``pos + 1``
    written columns (the reference masks the rest to -inf, which adds exact
    zeros)."""
    if tokens.is_cuda:
        strict_fp32()
    d = params["dec"]
    pos = cache.pos
    max_len = cache.k.shape[-1]
    if pos >= max_len or pos >= cfg.n_text_ctx:
        raise ValueError(f"decode position {pos} beyond the cache ({max_len}) or n_text_ctx")
    x = d["tok_emb"][tokens][:, None, :] + d["pos_emb"][pos : pos + 1]
    dtype = x.dtype
    hd = cfg.n_text_state // cfg.n_text_head
    scale = hd ** -0.25
    for i, layer in enumerate(d["layers"]):
        h = _layernorm(x, layer["ln1"])
        q = _split_heads(_dense(h, layer["attn"]["q"]), cfg.n_text_head)  # [b, h, 1, hd]
        k1 = _split_heads(_dense(h, layer["attn"]["k"]), cfg.n_text_head)
        v1 = _split_heads(_dense(h, layer["attn"]["v"]), cfg.n_text_head)
        cache.k[i, :, :, :, pos] = k1[:, :, 0, :]
        cache.v[i, :, :, :, pos] = v1[:, :, 0, :]
        attn = _tmaj_attend(
            q * scale, cache.k[i, ..., : pos + 1] * scale, cache.v[i, ..., : pos + 1], dtype
        )
        x = x + _dense(attn, layer["attn"]["o"])
        hx = _layernorm(x, layer["ln_x"])
        qx = _split_heads(_dense(hx, layer["xattn"]["q"]), cfg.n_text_head)
        if cache.cross_quantized:
            # int8 K can't absorb the d**-0.25: fold both scales into q
            xattn = _tmaj_attend(
                qx * (scale * scale), cache.xk[i], cache.xv[i], dtype,
                k_scale=cache.xk_scale[i], v_scale=cache.xv_scale[i],
            )
        else:
            xattn = _tmaj_attend(qx * scale, cache.xk[i] * scale, cache.xv[i], dtype)
        x = x + _dense(xattn, layer["xattn"]["o"])
        x = x + _mlp(_layernorm(x, layer["ln2"]), layer)
    x = _layernorm(x, d["ln"])
    logits = torch.matmul(x[:, 0].float(), d["tok_emb"].float().T)
    return logits, cache._replace(pos=pos + 1)
