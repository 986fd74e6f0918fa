# SPDX-License-Identifier: Apache-2.0
"""Marian NMT (Helsinki-NLP opus-mt) in PyTorch.

Port of ``streamkit_tpu/models/marian.py``. Marian differs from the
NLLB/M2M100 stack in :mod:`streamkit_tpu_torch.models.nllb`:

* post-layer-norm residual blocks (NLLB is pre-norm), computed in the
  activations' dtype
* sinusoidal positions starting at 0 with HF Marian's frequencies, no
  padding offset
* SiLU ("swish") FFN activation (NLLB uses ReLU)
* a trained ``final_logits_bias`` (kept in f32 whatever the dtype) added to
  the output projection
* decoder_start_token_id = pad, and an optional ``sqrt(d)`` embedding scale
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.tensor_parallel import embed_rows, project_vocab, tp_matmul
from . import params_to_torch
from .seq2seq import beam_decode, init_decoder_cache

__all__ = [
    "MarianConfig",
    "marian_init_params",
    "marian_params_from_numpy",
    "marian_encode",
    "marian_decode_logits",
    "marian_greedy_translate",
    "marian_greedy_cached",
    "marian_beam_translate",
    "marian_decode_step",
    "marian_config_from_hf",
    "marian_params_from_hf",
]


@dataclass(frozen=True)
class MarianConfig:
    vocab_size: int = 65001  # opus-mt default (last id = pad)
    d_model: int = 512
    encoder_layers: int = 6
    decoder_layers: int = 6
    heads: int = 8
    ffn_dim: int = 2048
    max_positions: int = 512
    pad_token_id: int = 65000
    eos_token_id: int = 0
    decoder_start_token_id: int = 65000  # = pad (Marian convention)
    scale_embedding: bool = True  # opus-mt checkpoints scale by sqrt(d)


def _sinusoidal_marian(n_pos: int, dim: int) -> np.ndarray:
    """Marian's position table: [sin block | cos block], position 0-based,
    no zeroed padding row, frequency 10000^(-2k/dim)."""
    half = dim // 2
    freqs = np.power(10000.0, -2.0 * np.arange(half, dtype=np.float64) / dim)
    pos = np.arange(n_pos, dtype=np.float64)[:, None] * freqs[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((n_pos, 1))], axis=1)
    return table.astype(np.float32)


def _init_numpy(cfg: MarianConfig, seed: int) -> Dict:
    """The reference's random tree, drawn in its order from its generator."""
    rng = np.random.default_rng(seed)

    def lin(d_in, d_out):
        return {"w": (rng.standard_normal((d_in, d_out)) * 0.02).astype(np.float32),
                "b": np.zeros((d_out,), np.float32)}

    def ln(d):
        return {"g": np.ones((d,), np.float32), "b": np.zeros((d,), np.float32)}

    def attn(d):
        return {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d)}

    d = cfg.d_model

    def enc_layer():
        return {"attn": attn(d), "ln1": ln(d), "fc1": lin(d, cfg.ffn_dim), "fc2": lin(cfg.ffn_dim, d), "ln2": ln(d)}

    def dec_layer():
        return {
            "attn": attn(d),
            "ln1": ln(d),
            "xattn": attn(d),
            "ln_x": ln(d),
            "fc1": lin(d, cfg.ffn_dim),
            "fc2": lin(cfg.ffn_dim, d),
            "ln2": ln(d),
        }

    return {
        "emb": (rng.standard_normal((cfg.vocab_size, d)) * 0.02).astype(np.float32),
        "pos": _sinusoidal_marian(cfg.max_positions, d),
        "logits_bias": np.zeros((cfg.vocab_size,), np.float32),
        "enc_layers": [enc_layer() for _ in range(cfg.encoder_layers)],
        "dec_layers": [dec_layer() for _ in range(cfg.decoder_layers)],
    }


def marian_init_params(cfg: MarianConfig, seed: int = 0, dtype=torch.float32, device=None) -> Dict:
    """The random weights of a config without a checkpoint: the reference's
    numpy draws, made on the host and then moved to ``device`` (default
    ``cuda``), so every device gets the same weights."""
    return marian_params_from_numpy(_init_numpy(cfg, seed), cfg, dtype, device)


def marian_params_from_numpy(tree, cfg: MarianConfig, dtype=torch.float32, device=None) -> Dict:
    """The reference's parameter tree (numpy arrays) → the port's, on
    ``device`` (default ``cuda``); ``logits_bias`` stays f32, as there."""
    params = params_to_torch(tree, dtype, resolve_device(device), keep_f32=("logits_bias",))
    if len(params["enc_layers"]) != cfg.encoder_layers or len(params["dec_layers"]) != cfg.decoder_layers:
        raise ValueError("parameter tree does not match the config's layer counts")
    return params


def _ln(x, p):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + 1e-5) * p["g"] + p["b"]


def _dense(x, p):
    return tp_matmul(x, p["w"]) + p["b"]


def _attn(q, k, v, hd: int, bias=None):
    """Attention over heads of ``hd``; the head count follows ``q``'s width
    (this rank's heads under tensor parallelism)."""
    b, tq, d = q.shape
    tk = k.shape[1]
    n_head = d // hd

    def heads(x, t):
        return x.reshape(b, t, n_head, hd).transpose(1, 2)

    qh, kh, vh = heads(q, tq), heads(k, tk), heads(v, tk)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(hd)
    if bias is not None:
        scores = scores + bias
    w = torch.softmax(scores, dim=-1).to(vh.dtype)
    return torch.matmul(w, vh).transpose(1, 2).reshape(b, tq, d)


def _scale(params, cfg: MarianConfig):
    emb = params["emb"]
    return torch.tensor(math.sqrt(cfg.d_model) if cfg.scale_embedding else 1.0, dtype=emb.dtype, device=emb.device)


def marian_encode(params, cfg: MarianConfig, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``tokens [b, t]`` → (hidden states, cross-attention bias)."""
    tokens = tokens.long()
    t = tokens.shape[-1]
    x = embed_rows(params["emb"], tokens) * _scale(params, cfg)
    x = x + params["pos"][:t].to(x.dtype)[None, :, :]
    pad_bias = torch.zeros(tokens.shape, dtype=torch.float32, device=tokens.device)
    bias = pad_bias.masked_fill(tokens == cfg.pad_token_id, float("-inf"))[:, None, None, :]
    for layer in params["enc_layers"]:
        a = _attn(_dense(x, layer["attn"]["q"]), _dense(x, layer["attn"]["k"]), _dense(x, layer["attn"]["v"]),
                  cfg.d_model // cfg.heads, bias)
        x = _ln(x + _dense(a, layer["attn"]["o"]), layer["ln1"])  # post-LN
        h = _dense(torch.nn.functional.silu(_dense(x, layer["fc1"])), layer["fc2"])
        x = _ln(x + h, layer["ln2"])
    return x, bias


def _logits(params, x):
    # logits_bias follows emb's vocab split
    return project_vocab(x, params["emb"],
                         lambda x, e: torch.matmul(x, e.T.to(x.dtype)).float() + params["logits_bias"])


def marian_decode_logits(params, cfg: MarianConfig, dec_tokens, enc_states, enc_bias) -> torch.Tensor:
    """Teacher-forced decoder pass → logits [b, t, vocab]."""
    dec_tokens = dec_tokens.long()
    t = dec_tokens.shape[-1]
    x = embed_rows(params["emb"], dec_tokens) * _scale(params, cfg)
    x = x + params["pos"][:t].to(x.dtype)[None, :, :]
    causal = torch.triu(torch.full((t, t), float("-inf"), device=x.device), diagonal=1)
    for layer in params["dec_layers"]:
        a = _attn(_dense(x, layer["attn"]["q"]), _dense(x, layer["attn"]["k"]), _dense(x, layer["attn"]["v"]),
                  cfg.d_model // cfg.heads, causal)
        x = _ln(x + _dense(a, layer["attn"]["o"]), layer["ln1"])
        a = _attn(_dense(x, layer["xattn"]["q"]), _dense(enc_states, layer["xattn"]["k"]),
                  _dense(enc_states, layer["xattn"]["v"]), cfg.d_model // cfg.heads, enc_bias)
        x = _ln(x + _dense(a, layer["xattn"]["o"]), layer["ln_x"])
        h = _dense(torch.nn.functional.silu(_dense(x, layer["fc1"])), layer["fc2"])
        x = _ln(x + h, layer["ln2"])
    return _logits(params, x)


def _marian_init_cache(params, cfg: MarianConfig, enc_states, max_t: int):
    return init_decoder_cache(params["dec_layers"], enc_states, max_t, _dense)


def marian_decode_step(params, cfg: MarianConfig, tok, step: int, cache, enc_bias):
    """One cached decoder step: ``tok [b]`` at position ``step`` →
    (logits [b, vocab], cache); the step's self K/V are written in place."""
    max_t = cache[0][0].shape[1]
    if not 0 <= step < min(max_t, params["pos"].shape[0]):
        raise ValueError(f"decode step {step} is outside the cache ({max_t}) or the position table")
    emb = params["emb"]
    x = (embed_rows(emb, tok.long()) * _scale(params, cfg) + params["pos"][step].to(emb.dtype))[:, None, :]
    self_mask = torch.zeros(max_t, device=x.device)
    self_mask[step + 1:] = float("-inf")
    for layer, (sk, sv, ck, cv) in zip(params["dec_layers"], cache):
        sk[:, step] = _dense(x, layer["attn"]["k"])[:, 0]
        sv[:, step] = _dense(x, layer["attn"]["v"])[:, 0]
        a = _attn(_dense(x, layer["attn"]["q"]), sk, sv, cfg.d_model // cfg.heads, self_mask)
        x = _ln(x + _dense(a, layer["attn"]["o"]), layer["ln1"])
        a = _attn(_dense(x, layer["xattn"]["q"]), ck, cv, cfg.d_model // cfg.heads, enc_bias)
        x = _ln(x + _dense(a, layer["xattn"]["o"]), layer["ln_x"])
        h = _dense(torch.nn.functional.silu(_dense(x, layer["fc1"])), layer["fc2"])
        x = _ln(x + h, layer["ln2"])
    return _logits(params, x[:, 0]), cache


def marian_greedy_cached(params, cfg: MarianConfig, src_tokens: torch.Tensor,
                         max_tokens: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode: encode once, then cached single-token steps from the
    decoder start; a row that has emitted EOS gets ``pad`` from then on, and
    the loop stops when every row is done or at ``max_tokens``. Returns
    (tokens [b, max_tokens], predictions only, int32; lengths [b], the
    non-pad tokens, EOS included)."""
    enc_states, enc_bias = marian_encode(params, cfg, src_tokens)
    b = src_tokens.shape[0]
    dev = enc_states.device
    cache = _marian_init_cache(params, cfg, enc_states, max_tokens + 1)
    pad, eos = cfg.pad_token_id, cfg.eos_token_id
    tok = torch.full((b,), cfg.decoder_start_token_id, dtype=torch.long, device=dev)
    tokens = torch.full((b, max_tokens), pad, dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    i = 0
    while i < max_tokens and not bool(done.all()):
        logits, cache = marian_decode_step(params, cfg, tok, i, cache, enc_bias)
        tok = torch.where(done, pad, torch.argmax(logits, dim=-1))
        tokens[:, i] = tok
        done = done | (tok == eos)
        i += 1
    lengths = (tokens != pad).sum(dim=1)
    return tokens.to(torch.int32), lengths.to(torch.int32)


def marian_greedy_translate(params, cfg: MarianConfig, src_tokens: torch.Tensor, max_len: int = 64) -> np.ndarray:
    """Greedy decode by teacher-forced re-scoring per step (the parity oracle
    of the cached decode). Returns the decoder rows (start token included)
    as numpy."""
    enc_states, enc_bias = marian_encode(params, cfg, src_tokens)
    dev = enc_states.device
    b = src_tokens.shape[0]
    dec = np.full((b, 1), cfg.decoder_start_token_id, np.int32)
    finished = np.zeros(b, bool)
    for _ in range(max_len):
        logits = marian_decode_logits(params, cfg, torch.as_tensor(dec, device=dev), enc_states, enc_bias)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy().astype(np.int32)
        nxt = np.where(finished, cfg.pad_token_id, nxt)
        dec = np.concatenate([dec, nxt[:, None]], axis=1)
        finished |= nxt == cfg.eos_token_id
        if finished.all():
            break
    return dec


def marian_beam_translate(params, cfg: MarianConfig, src_tokens: torch.Tensor, max_tokens: int = 64,
                          beam: int = 4, length_penalty: float = 1.0):
    """Beam-search decode (reference helsinki/CTranslate2 ``beam_size``).
    Returns (tokens [b, max_tokens] best hypothesis, lengths [b])."""
    enc_states, enc_bias = marian_encode(params, cfg, src_tokens)
    b = src_tokens.shape[0]
    cache = _marian_init_cache(params, cfg, enc_states, max_tokens + 1)
    start = torch.full((b,), cfg.decoder_start_token_id, dtype=torch.long, device=enc_states.device)
    logits, cache = marian_decode_step(params, cfg, start, 0, cache, enc_bias)
    cache = [tuple(x.repeat_interleave(beam, dim=0) for x in layer) for layer in cache]
    enc_bias_x = enc_bias.repeat_interleave(beam, dim=0)

    def step(tok, i, c):
        return marian_decode_step(params, cfg, tok, i, c, enc_bias_x)

    tokens, lengths, _ = beam_decode(step, cache, logits, b, beam, max_tokens, cfg.eos_token_id,
                                     cfg.pad_token_id, start_step=1, length_penalty=length_penalty)
    return tokens, lengths


def marian_config_from_hf(hf) -> MarianConfig:
    return MarianConfig(
        vocab_size=hf.vocab_size,
        d_model=hf.d_model,
        encoder_layers=hf.encoder_layers,
        decoder_layers=hf.decoder_layers,
        heads=hf.encoder_attention_heads,
        ffn_dim=hf.encoder_ffn_dim,
        max_positions=hf.max_position_embeddings,
        pad_token_id=hf.pad_token_id,
        eos_token_id=hf.eos_token_id,
        decoder_start_token_id=hf.decoder_start_token_id,
        scale_embedding=bool(getattr(hf, "scale_embedding", True)),
    )


def marian_params_from_hf(sd: Dict[str, np.ndarray], cfg: MarianConfig, dtype=torch.float32, device=None) -> Dict:
    """A ``MarianMTModel.state_dict()`` (numpy arrays) → the port's
    parameters on ``device`` (default ``cuda``)."""

    def t(name):
        return np.asarray(sd[name], np.float32)

    def lin(prefix):
        return {"w": t(f"{prefix}.weight").T, "b": t(f"{prefix}.bias")}

    def ln(prefix):
        return {"g": t(f"{prefix}.weight"), "b": t(f"{prefix}.bias")}

    def attn(prefix):
        return {
            "q": lin(f"{prefix}.q_proj"),
            "k": lin(f"{prefix}.k_proj"),
            "v": lin(f"{prefix}.v_proj"),
            "o": lin(f"{prefix}.out_proj"),
        }

    def enc_layer(i):
        p = f"model.encoder.layers.{i}"
        return {
            "attn": attn(f"{p}.self_attn"),
            "ln1": ln(f"{p}.self_attn_layer_norm"),
            "fc1": lin(f"{p}.fc1"),
            "fc2": lin(f"{p}.fc2"),
            "ln2": ln(f"{p}.final_layer_norm"),
        }

    def dec_layer(i):
        p = f"model.decoder.layers.{i}"
        return {
            "attn": attn(f"{p}.self_attn"),
            "ln1": ln(f"{p}.self_attn_layer_norm"),
            "xattn": attn(f"{p}.encoder_attn"),
            "ln_x": ln(f"{p}.encoder_attn_layer_norm"),
            "fc1": lin(f"{p}.fc1"),
            "fc2": lin(f"{p}.fc2"),
            "ln2": ln(f"{p}.final_layer_norm"),
        }

    key = "model.encoder.embed_positions.weight"
    tree = {
        "emb": t("model.shared.weight"),
        "pos": t(key) if key in sd else _sinusoidal_marian(cfg.max_positions, cfg.d_model),
        "logits_bias": t("final_logits_bias").reshape(-1),
        "enc_layers": [enc_layer(i) for i in range(cfg.encoder_layers)],
        "dec_layers": [dec_layer(i) for i in range(cfg.decoder_layers)],
    }
    return marian_params_from_numpy(tree, cfg, dtype, device)
