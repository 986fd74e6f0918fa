# SPDX-License-Identifier: Apache-2.0
"""SenseVoice-small-class non-autoregressive ASR in PyTorch.

Port of ``streamkit_tpu/models/sensevoice.py``. Parity target: the
reference's sensevoice plugin (``plugins/native/sensevoice/``, sherpa-onnx
SenseVoice-small): low-frame-rate stacked log-mel features and
language / ITN prefix embeddings → a SAN-M encoder (self-attention plus an
FSMN memory over the value stream) → CTC logits. One forward pass per
segment, no decode loop.

The random init is the reference's numpy draw. Matmuls follow the
reference's output types: products feeding the softmax and the CTC head are
taken in float32 from operands rounded to the model dtype; the others stay
in the model dtype.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from ..device import resolve_device
from . import params_to_torch

__all__ = [
    "SenseVoiceConfig",
    "sensevoice_init_params",
    "sensevoice_init_numpy",
    "sensevoice_params_from_numpy",
    "sensevoice_logits",
    "ctc_greedy_decode",
    "ctc_collapse",
    "lfr_stack",
    "LANGUAGES",
]

# language ids in SenseVoice order (reference config.rs: auto/zh/en/ja/ko/yue)
LANGUAGES = {"auto": 0, "zh": 1, "en": 2, "ja": 3, "ko": 4, "yue": 5}


@dataclass(frozen=True)
class SenseVoiceConfig:
    vocab_size: int = 25055  # SenseVoice-small vocab
    n_mels: int = 80
    lfr_m: int = 7  # frames stacked
    lfr_n: int = 6  # hop in frames
    d_model: int = 512
    heads: int = 4
    ffn_dim: int = 2048
    layers: int = 50
    fsmn_kernel: int = 11
    n_languages: int = 6
    blank_id: int = 0

    @property
    def input_dim(self) -> int:
        return self.n_mels * self.lfr_m


def lfr_stack(mel: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Low-frame-rate stacking: ``[..., T, n_mels]`` → ``[..., ceil(T/n),
    n_mels·m]`` (stack m frames, hop n; frames past the end repeat the last)."""
    t = mel.shape[-2]
    t_out = (t + n - 1) // n
    idx = torch.arange(t_out, device=mel.device)[:, None] * n + torch.arange(m, device=mel.device)[None, :]
    stacked = torch.index_select(mel, -2, idx.clamp(max=t - 1).reshape(-1))
    return stacked.reshape(*mel.shape[:-2], t_out, m * mel.shape[-1])


def sensevoice_init_numpy(cfg: SenseVoiceConfig, seed: int = 0) -> Dict:
    """The reference's random tree (numpy f32), drawn in its order."""
    rng = np.random.default_rng(seed)

    def lin(d_in, d_out):
        return {"w": (rng.standard_normal((d_in, d_out)) / math.sqrt(d_in)).astype(np.float32),
                "b": np.zeros((d_out,), np.float32)}

    def ln(d):
        return {"g": np.ones((d,), np.float32), "b": np.zeros((d,), np.float32)}

    d = cfg.d_model

    def layer():
        return {
            "ln1": ln(d),
            "qkv": lin(d, 3 * d),
            "out": lin(d, d),
            # FSMN memory: depthwise conv over the value stream, [k, d]
            "fsmn": (rng.standard_normal((cfg.fsmn_kernel, d)) / math.sqrt(cfg.fsmn_kernel)).astype(np.float32),
            "ln2": ln(d),
            "fc1": lin(d, cfg.ffn_dim),
            "fc2": lin(cfg.ffn_dim, d),
        }

    return {
        "in_proj": lin(cfg.input_dim, d),
        "lang_emb": (rng.standard_normal((cfg.n_languages, d)) * 0.02).astype(np.float32),
        "itn_emb": (rng.standard_normal((2, d)) * 0.02).astype(np.float32),
        "layers": [layer() for _ in range(cfg.layers)],
        "out_ln": ln(d),
        "ctc": lin(d, cfg.vocab_size),
    }


def sensevoice_params_from_numpy(tree, cfg: SenseVoiceConfig, dtype=torch.float32, device=None) -> Dict:
    """A SenseVoice tree (numpy, the reference's layout) → the port's on
    ``device`` (default ``cuda``)."""
    if len(tree["layers"]) != cfg.layers or tree["ctc"]["w"].shape != (cfg.d_model, cfg.vocab_size):
        raise ValueError("parameter tree does not match the config")
    return params_to_torch(tree, dtype, resolve_device(device))


def sensevoice_init_params(cfg: SenseVoiceConfig, seed: int = 0, dtype=torch.float32, device=None) -> Dict:
    """The reference's random init (numpy ``default_rng(seed)``), drawn on
    the host and moved to ``device`` (default ``cuda``)."""
    device = resolve_device(device)  # before the draw: no card, no work
    return sensevoice_params_from_numpy(sensevoice_init_numpy(cfg, seed), cfg, dtype, device)


def _ln(x, p):
    """Layer norm with the population variance, in the reference's order."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + 1e-5) * p["g"] + p["b"]


def _dense(x, p):
    return x @ p["w"] + p["b"]


def _fsmn(v: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise centred memory convolution over time, ``v [b, t, d]``, as
    the reference sums it: k shifted scalings, added in order."""
    k = kernel.shape[0]
    pad = k // 2
    t = v.shape[1]
    vp = torch.nn.functional.pad(v, (0, 0, pad, k - 1 - pad))
    out = torch.zeros_like(v)
    for i in range(k):
        out = out + vp[:, i:i + t, :] * kernel[i]
    return out


def sensevoice_logits(params: Dict, cfg: SenseVoiceConfig, mel: torch.Tensor, mask: torch.Tensor,
                      language_id: torch.Tensor, use_itn: torch.Tensor) -> torch.Tensor:
    """``mel [b, T, n_mels]``, ``mask [b, T_lfr]`` (1 = valid) → CTC logits
    ``[b, 2 + T_lfr, vocab]`` f32 (prefix: language and ITN embeddings)."""
    x = lfr_stack(mel, cfg.lfr_m, cfg.lfr_n)
    x = _dense(x.to(params["in_proj"]["w"].dtype), params["in_proj"])
    b = x.shape[0]
    lang = params["lang_emb"][language_id.long()][:, None, :]
    itn = params["itn_emb"][use_itn.long()][:, None, :]
    x = torch.cat([lang, itn, x], dim=1)
    mask_full = torch.cat([torch.ones(b, 2, dtype=mask.dtype, device=mask.device), mask], dim=1)
    bias = torch.where(mask_full == 0, -math.inf, 0.0).float()[:, None, None, :]
    keep = mask_full[..., None].to(x.dtype)

    t = x.shape[1]
    hd = cfg.d_model // cfg.heads

    def heads(z):
        return z.reshape(b, t, cfg.heads, hd).transpose(1, 2)

    for layer in params["layers"]:
        h = _ln(x, layer["ln1"])
        q, k, v = _dense(h, layer["qkv"]).chunk(3, dim=-1)
        scores = torch.matmul(heads(q).float(), heads(k).float().transpose(-1, -2))
        w = torch.softmax(scores / math.sqrt(hd) + bias, dim=-1).to(v.dtype)
        att = torch.matmul(w, heads(v)).transpose(1, 2).reshape(b, t, cfg.d_model)
        # SAN-M: attention output + FSMN memory over the masked value stream
        mem = _fsmn(v * keep, layer["fsmn"])
        x = x + _dense(att + mem, layer["out"])
        h = _ln(x, layer["ln2"])
        x = x + _dense(torch.relu(_dense(h, layer["fc1"])), layer["fc2"])

    x = _ln(x, params["out_ln"])
    return torch.matmul(x.float(), params["ctc"]["w"].float()) + params["ctc"]["b"].float()


def ctc_collapse(ids: np.ndarray, mask: np.ndarray, blank_id: int = 0) -> List[List[int]]:
    """Framewise ids ``[b, t]`` → collapse repeats → drop blanks, each row up
    to its first invalid frame (``mask [b, t]``)."""
    out: List[List[int]] = []
    for b in range(ids.shape[0]):
        seq: List[int] = []
        prev = -1
        for t in range(ids.shape[1]):
            if not mask[b, t]:
                break
            tok = int(ids[b, t])
            if tok != blank_id and tok != prev:
                seq.append(tok)
            prev = tok
        out.append(seq)
    return out


def ctc_greedy_decode(logits: np.ndarray, mask: np.ndarray, blank_id: int = 0) -> List[List[int]]:
    """Framewise argmax → collapse repeats → drop blanks. ``logits [b, t, v]``,
    ``mask [b, t]`` over the same axis (prefix positions already excluded)."""
    return ctc_collapse(np.argmax(logits, axis=-1), mask, blank_id)
