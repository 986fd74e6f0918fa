# SPDX-License-Identifier: Apache-2.0
"""NLLB-200 / M2M100-family translation model in PyTorch.

Port of ``streamkit_tpu/models/nllb.py``: the encoder-decoder transformer
(M2M100 architecture, which NLLB-200 shares), the cached greedy decode and
beam search, and the HF converter. Parameters are a nested dict of tensors
in the reference's layout (linear weights ``[d_in, d_out]``).

Architecture notes (matching HF M2M100):
* token embeddings scaled by ``sqrt(d_model)``; positions are *sinusoidal*
  with M2M100's table layout (sin block then cos block) and offset 2,
* pre-norm residual blocks + final layernorm in both stacks,
* k/v/q/out projections all biased; lm head ties to the shared embedding.

Matmuls run in the parameters' dtype (bf16 GEMMs accumulate in f32 and round
their output, as the reference's ``preferred_element_type=f32`` followed by a
cast does); attention scores and softmax are f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import params_to_torch
from .seq2seq import beam_decode, init_decoder_cache

__all__ = [
    "NllbConfig",
    "nllb_init_params",
    "nllb_params_from_numpy",
    "nllb_encode",
    "nllb_decode_logits",
    "nllb_config_from_hf",
    "nllb_params_from_hf",
    "nllb_greedy_translate",
    "nllb_beam_translate",
    "nllb_greedy_cached",
    "nllb_decode_step",
]


@dataclass(frozen=True)
class NllbConfig:
    vocab_size: int = 128112  # NLLB-200
    d_model: int = 1024
    encoder_layers: int = 12
    decoder_layers: int = 12
    heads: int = 16
    ffn_dim: int = 4096
    max_positions: int = 1024
    pad_token_id: int = 1
    eos_token_id: int = 2
    decoder_start_token_id: int = 2


def _sinusoidal_table(n_pos: int, dim: int, padding_idx: int = 1) -> np.ndarray:
    """M2M100's sinusoidal layout: [sin block | cos block], padding row zeroed."""
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    freqs = np.exp(np.arange(half, dtype=np.float64) * -emb)
    pos = np.arange(n_pos, dtype=np.float64)[:, None] * freqs[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((n_pos, 1))], axis=1)
    table[padding_idx] = 0.0
    return table.astype(np.float32)


def _init_numpy(cfg: NllbConfig, seed: int) -> Dict:
    """The reference's random tree, drawn in its order from its generator."""
    rng = np.random.default_rng(seed)

    def lin(d_in, d_out):
        s = 1.0 / math.sqrt(d_in)
        return {"w": rng.uniform(-s, s, (d_in, d_out)).astype(np.float32), "b": np.zeros((d_out,), np.float32)}

    def ln(d):
        return {"g": np.ones((d,), np.float32), "b": np.zeros((d,), np.float32)}

    def attn(d):
        return {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d)}

    def enc_layer(d):
        return {"ln1": ln(d), "attn": attn(d), "ln2": ln(d), "fc1": lin(d, cfg.ffn_dim), "fc2": lin(cfg.ffn_dim, d)}

    def dec_layer(d):
        return {
            "ln1": ln(d), "attn": attn(d),
            "ln_x": ln(d), "xattn": attn(d),
            "ln2": ln(d), "fc1": lin(d, cfg.ffn_dim), "fc2": lin(cfg.ffn_dim, d),
        }

    d = cfg.d_model
    return {
        "emb": rng.normal(0, 0.02, (cfg.vocab_size, d)).astype(np.float32),
        "pos": _sinusoidal_table(cfg.max_positions + 2, d, cfg.pad_token_id),
        "enc_layers": [enc_layer(d) for _ in range(cfg.encoder_layers)],
        "enc_ln": ln(d),
        "dec_layers": [dec_layer(d) for _ in range(cfg.decoder_layers)],
        "dec_ln": ln(d),
    }


def nllb_init_params(cfg: NllbConfig, seed: int = 0, dtype=torch.float32, device=None) -> Dict:
    """The random weights of a config without a checkpoint: the reference's
    numpy draws (so equal to its ``nllb_init_params`` at f32), made on the
    host and then moved to ``device`` (default ``cuda``), so a node and a
    direct caller get the same weights on every device."""
    return nllb_params_from_numpy(_init_numpy(cfg, seed), cfg, dtype, device)


def nllb_params_from_numpy(tree, cfg: NllbConfig, dtype=torch.float32, device=None) -> Dict:
    """The reference's parameter tree (numpy arrays) → the port's, on
    ``device`` (default ``cuda``) in ``dtype``."""
    params = params_to_torch(tree, dtype, resolve_device(device))
    if len(params["enc_layers"]) != cfg.encoder_layers or len(params["dec_layers"]) != cfg.decoder_layers:
        raise ValueError("parameter tree does not match the config's layer counts")
    return params


def _ln(x, p):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + 1e-5) * p["g"].float() + p["b"].float()).to(x.dtype)


def _dense(x, p):
    return torch.matmul(x, p["w"]) + p["b"]


def _heads(x, n):
    *lead, t, d = x.shape
    return x.reshape(*lead, t, n, d // n).transpose(-3, -2)


def _unheads(x):
    *lead, h, t, hd = x.shape
    return x.transpose(-3, -2).reshape(*lead, t, h * hd)


def _attn(q, k, v, n_head, mask=None):
    hd = q.shape[-1] // n_head
    qh = _heads(q, n_head) * torch.tensor(hd ** -0.5, dtype=q.dtype, device=q.device)  # M2M100 scales q only
    kh, vh = _heads(k, n_head), _heads(v, n_head)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _unheads(torch.matmul(probs, vh))


def _positions_for(tokens: torch.Tensor, pad_id: int, offset: int = 0) -> torch.Tensor:
    """M2M100 position ids: cumsum over non-pad + pad_id (pads stay at pad_id)."""
    mask = (tokens != pad_id).long()
    return (torch.cumsum(mask, dim=-1) + offset) * mask + pad_id


def _embed(params, cfg: NllbConfig, tokens, pos_ids):
    emb = params["emb"]
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=emb.dtype, device=emb.device)
    return emb[tokens] * scale + params["pos"][pos_ids].to(emb.dtype)


def nllb_encode(params, cfg: NllbConfig, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``tokens [b, t]`` → (hidden states, attention bias for cross-attn)."""
    tokens = tokens.long()
    x = _embed(params, cfg, tokens, _positions_for(tokens, cfg.pad_token_id))
    pad_bias = torch.zeros(tokens.shape, dtype=torch.float32, device=tokens.device)
    pad_bias = pad_bias.masked_fill(tokens == cfg.pad_token_id, float("-inf"))
    bias = pad_bias[:, None, None, :]  # [b, 1, 1, t]
    for layer in params["enc_layers"]:
        h = _ln(x, layer["ln1"])
        a = _attn(_dense(h, layer["attn"]["q"]), _dense(h, layer["attn"]["k"]), _dense(h, layer["attn"]["v"]),
                  cfg.heads, bias)
        x = x + _dense(a, layer["attn"]["o"])
        h = _ln(x, layer["ln2"])
        x = x + _dense(torch.relu(_dense(h, layer["fc1"])), layer["fc2"])
    return _ln(x, params["enc_ln"]), bias


def _logits(params, x):
    return torch.matmul(x, params["emb"].T.to(x.dtype)).float()


def nllb_decode_logits(params, cfg: NllbConfig, dec_tokens, enc_states, enc_bias) -> torch.Tensor:
    """Teacher-forced decoder pass → logits [b, t, vocab]."""
    dec_tokens = dec_tokens.long()
    t = dec_tokens.shape[-1]
    x = _embed(params, cfg, dec_tokens, _positions_for(dec_tokens, cfg.pad_token_id))
    causal = torch.triu(torch.full((t, t), float("-inf"), device=x.device), diagonal=1)
    for layer in params["dec_layers"]:
        h = _ln(x, layer["ln1"])
        a = _attn(_dense(h, layer["attn"]["q"]), _dense(h, layer["attn"]["k"]), _dense(h, layer["attn"]["v"]),
                  cfg.heads, causal)
        x = x + _dense(a, layer["attn"]["o"])
        h = _ln(x, layer["ln_x"])
        a = _attn(_dense(h, layer["xattn"]["q"]), _dense(enc_states, layer["xattn"]["k"]),
                  _dense(enc_states, layer["xattn"]["v"]), cfg.heads, enc_bias)
        x = x + _dense(a, layer["xattn"]["o"])
        h = _ln(x, layer["ln2"])
        x = x + _dense(torch.relu(_dense(h, layer["fc1"])), layer["fc2"])
    return _logits(params, _ln(x, params["dec_ln"]))


def _nllb_init_cache(params, cfg: NllbConfig, enc_states, max_t: int):
    return init_decoder_cache(params["dec_layers"], enc_states, cfg.d_model, max_t, _dense)


def nllb_decode_step(params, cfg: NllbConfig, tok, step: int, cache, enc_bias):
    """One cached decoder step at sequence position ``step`` (0-based).

    M2M100 position ids are cumsum-over-non-pad + pad_id; incremental rows
    never feed pad before finishing, so position = pad_id + step + 1 (rows
    diverge only after eos, where outputs are discarded). The self K/V of
    ``step`` are written into the cache in place."""
    pos_id = cfg.pad_token_id + step + 1
    max_t = cache[0][0].shape[1]
    if not 0 <= step < max_t or pos_id >= params["pos"].shape[0]:
        raise ValueError(f"decode step {step} is outside the cache ({max_t}) or the position table")
    emb = params["emb"]
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=emb.dtype, device=emb.device)
    x = (emb[tok.long()] * scale + params["pos"][pos_id].to(emb.dtype))[:, None, :]
    self_mask = torch.zeros(max_t, device=x.device)
    self_mask[step + 1:] = float("-inf")
    for layer, (sk, sv, ck, cv) in zip(params["dec_layers"], cache):
        h = _ln(x, layer["ln1"])
        sk[:, step] = _dense(h, layer["attn"]["k"])[:, 0]
        sv[:, step] = _dense(h, layer["attn"]["v"])[:, 0]
        a = _attn(_dense(h, layer["attn"]["q"]), sk, sv, cfg.heads, self_mask)
        x = x + _dense(a, layer["attn"]["o"])
        h = _ln(x, layer["ln_x"])
        a = _attn(_dense(h, layer["xattn"]["q"]), ck, cv, cfg.heads, enc_bias)
        x = x + _dense(a, layer["xattn"]["o"])
        h = _ln(x, layer["ln2"])
        x = x + _dense(torch.relu(_dense(h, layer["fc1"])), layer["fc2"])
    return _logits(params, _ln(x, params["dec_ln"])[:, 0]), cache


def _prefix(params, cfg: NllbConfig, src_tokens, target_lang_token, max_tokens: int):
    """Encode, then feed the forced prefix ``[decoder_start, target_lang]``
    → (logits for the first generated token, cache, encoder bias)."""
    enc_states, enc_bias = nllb_encode(params, cfg, src_tokens)
    b = src_tokens.shape[0]
    dev = enc_states.device
    cache = _nllb_init_cache(params, cfg, enc_states, max_tokens + 2)
    start = torch.full((b,), cfg.decoder_start_token_id, dtype=torch.long, device=dev)
    lang = torch.as_tensor(target_lang_token, device=dev).long().expand(b)
    _, cache = nllb_decode_step(params, cfg, start, 0, cache, enc_bias)
    logits, cache = nllb_decode_step(params, cfg, lang, 1, cache, enc_bias)
    return logits, cache, enc_bias


def nllb_greedy_cached(params, cfg: NllbConfig, src_tokens: torch.Tensor, target_lang_token,
                       max_tokens: int = 128):
    """Greedy decode: encode once, then cached single-token steps. The NLLB
    forced prefix ``[decoder_start, target_lang]`` is fed first; a row that
    has emitted EOS gets ``pad`` from then on, and the loop stops when every
    row is done or at ``max_tokens``. Returns (tokens [b, max_tokens],
    predictions only, int32; lengths [b], the non-pad tokens, EOS included)."""
    logits, cache, enc_bias = _prefix(params, cfg, src_tokens, target_lang_token, max_tokens)
    b = logits.shape[0]
    pad, eos = cfg.pad_token_id, cfg.eos_token_id
    tok = torch.argmax(logits, dim=-1)
    tokens = torch.full((b, max_tokens), pad, dtype=torch.long, device=logits.device)
    tokens[:, 0] = tok
    done = tok == eos
    i = 1
    while i < max_tokens and not bool(done.all()):
        logits, cache = nllb_decode_step(params, cfg, tok, i + 1, cache, enc_bias)
        tok = torch.where(done, pad, torch.argmax(logits, dim=-1))
        tokens[:, i] = tok
        done = done | (tok == eos)
        i += 1
    lengths = (tokens != pad).sum(dim=1)
    return tokens.to(torch.int32), lengths.to(torch.int32)


def nllb_greedy_translate(params, cfg: NllbConfig, src_tokens, target_lang_token: int,
                          max_tokens: int = 128) -> np.ndarray:
    """Greedy translation by teacher-forced re-decoding of the whole prefix
    each step (the parity oracle of the cached decode). NLLB convention:
    the decoder starts with ``[eos, target_lang]``. ``src_tokens`` is a
    tensor; returns the decoder rows (prefix included) as numpy."""
    enc_states, enc_bias = nllb_encode(params, cfg, src_tokens)
    dev = enc_states.device
    batch = src_tokens.shape[0]
    dec = np.full((batch, 1), cfg.decoder_start_token_id, np.int32)
    dec = np.concatenate([dec, np.full((batch, 1), target_lang_token, np.int32)], axis=1)
    done = np.zeros(batch, bool)
    for _ in range(max_tokens):
        logits = nllb_decode_logits(params, cfg, torch.as_tensor(dec, device=dev), enc_states, enc_bias)
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy().astype(np.int32)
        nxt = np.where(done, cfg.pad_token_id, nxt)
        done |= nxt == cfg.eos_token_id
        dec = np.concatenate([dec, nxt[:, None]], axis=1)
        if done.all():
            break
    return dec


def nllb_beam_translate(params, cfg: NllbConfig, src_tokens: torch.Tensor, target_lang_token,
                        max_tokens: int = 128, beam: int = 4, length_penalty: float = 1.0):
    """Beam-search decode (reference nllb/CTranslate2 ``beam_size``).
    Returns (tokens [b, max_tokens] best hypothesis, lengths [b])."""
    logits, cache, enc_bias = _prefix(params, cfg, src_tokens, target_lang_token, max_tokens)
    b = logits.shape[0]
    cache = [tuple(x.repeat_interleave(beam, dim=0) for x in layer) for layer in cache]
    enc_bias_x = enc_bias.repeat_interleave(beam, dim=0)

    def step(tok, i, c):
        return nllb_decode_step(params, cfg, tok, i, c, enc_bias_x)

    tokens, lengths, _ = beam_decode(step, cache, logits, b, beam, max_tokens, cfg.eos_token_id,
                                     cfg.pad_token_id, start_step=2, length_penalty=length_penalty)
    return tokens, lengths


# ---------------------------------------------------------------------------
# HF conversion
# ---------------------------------------------------------------------------
def nllb_config_from_hf(hf) -> NllbConfig:
    return NllbConfig(
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
    )


def nllb_params_from_hf(sd: Dict[str, np.ndarray], cfg: NllbConfig, dtype=torch.float32, device=None) -> Dict:
    """An HF ``M2M100ForConditionalGeneration`` state dict (numpy arrays) →
    the port's parameters on ``device`` (default ``cuda``)."""

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
            "ln1": ln(f"{p}.self_attn_layer_norm"),
            "attn": attn(f"{p}.self_attn"),
            "ln2": ln(f"{p}.final_layer_norm"),
            "fc1": lin(f"{p}.fc1"),
            "fc2": lin(f"{p}.fc2"),
        }

    def dec_layer(i):
        p = f"model.decoder.layers.{i}"
        return {
            "ln1": ln(f"{p}.self_attn_layer_norm"),
            "attn": attn(f"{p}.self_attn"),
            "ln_x": ln(f"{p}.encoder_attn_layer_norm"),
            "xattn": attn(f"{p}.encoder_attn"),
            "ln2": ln(f"{p}.final_layer_norm"),
            "fc1": lin(f"{p}.fc1"),
            "fc2": lin(f"{p}.fc2"),
        }

    key = "model.encoder.embed_positions.weights"
    n_pos = np.asarray(sd[key]).shape[0] if key in sd else cfg.max_positions + 2
    tree = {
        "emb": t("model.shared.weight"),
        "pos": _sinusoidal_table(n_pos, cfg.d_model, cfg.pad_token_id),
        "enc_layers": [enc_layer(i) for i in range(cfg.encoder_layers)],
        "enc_ln": ln("model.encoder.layer_norm"),
        "dec_layers": [dec_layer(i) for i in range(cfg.decoder_layers)],
        "dec_ln": ln("model.decoder.layer_norm"),
    }
    return nllb_params_from_numpy(tree, cfg, dtype, device)
