# SPDX-License-Identifier: Apache-2.0
"""Shared seq2seq decoding for the translation models (Marian and NLLB).

Port of ``streamkit_tpu/models/seq2seq.py``. One definition of the
per-decoder-layer ``(self_k, self_v, cross_k, cross_v)`` cache (cross K/V
computed once from the encoder states, self K/V preallocated ``[b, max_t, d]``
(``d/tp``: this rank's heads, under tensor parallelism)
buffers written in place step by step) and the batched beam search.

The reference's ``lax.while_loop`` becomes a Python loop that stops where its
``cond`` does: at ``max_tokens`` or once every row is done (one host read of
``done`` per step).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

__all__ = ["init_decoder_cache", "beam_decode", "top_k"]

_NEG = -1e30  # the reference's "minus infinity" for beams (finite, so 0 * it stays 0)


def init_decoder_cache(
    dec_layers,
    enc_states: torch.Tensor,
    max_t: int,
    dense: Callable,
) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]:
    b = enc_states.shape[0]
    cache = []
    for layer in dec_layers:
        ck = dense(enc_states, layer["xattn"]["k"])
        cv = dense(enc_states, layer["xattn"]["v"])
        sk = enc_states.new_zeros((b, max_t, layer["attn"]["k"]["w"].shape[-1]))
        cache.append((sk, torch.zeros_like(sk), ck, cv))
    return cache


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row, as ``jax.lax.top_k`` orders them:
    descending, and the lower index first among equal values. ``torch.topk``
    on CUDA promises no order among ties, and ties occur (finished beams carry
    rows of equal scores), so this takes a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_decode(
    step_fn,
    cache,
    first_logits: torch.Tensor,
    b: int,
    beam: int,
    max_tokens: int,
    eos_id: int,
    pad_id: int,
    start_step: int,
    length_penalty: float = 1.0,
):
    """Batched beam search over a cached single-token decoder.

    ``step_fn(tok [b*beam], step, cache) -> (logits [b*beam, V], cache)``;
    ``cache`` is a list of tuples of tensors whose leading axis is the
    ``b*beam`` rows (the caller repeats each row ``beam`` times);
    ``first_logits [b, V]`` is the prefix-fed distribution for the first
    generated token, at sequence position ``start_step``.

    Returns (tokens [b, max_tokens] of the best hypothesis, lengths [b],
    scores [b]). Finished rows continue with a forced ``pad`` at zero cost,
    so scores are final log-probs; hypotheses are ranked by
    ``score / length ** length_penalty``.
    """
    dev = first_logits.device
    v = first_logits.shape[-1]
    logp0 = torch.log_softmax(first_logits.float(), dim=-1)
    # all beams start identical: mask beams 1.. so top-k picks k distinct
    # first tokens out of beam 0
    first_beam = (torch.arange(beam, device=dev) == 0)[None, :, None]
    init = torch.where(first_beam, logp0[:, None, :], torch.tensor(_NEG, device=dev))
    scores, idx0 = top_k(init.reshape(b, beam * v), beam)
    tok0 = idx0 % v
    tokens = torch.full((b * beam, max_tokens), pad_id, dtype=torch.long, device=dev)
    tokens[:, 0] = tok0.reshape(-1)
    done = tok0.reshape(-1) == eos_id
    lengths = torch.ones((b * beam,), dtype=torch.long, device=dev)
    frozen = torch.full((v,), _NEG, device=dev)
    frozen[pad_id] = 0.0
    row0 = torch.arange(b, device=dev)[:, None] * beam

    i = 1
    while i < max_tokens and not bool(done.all()):
        # the fed token sits at sequence position start_step + (i - 1)
        logits, cache = step_fn(tokens[:, i - 1], start_step + i - 1, cache)
        logp = torch.log_softmax(logits.float(), dim=-1)
        # frozen rows: pad continues at zero cost, everything else "-inf"
        logp = torch.where(done[:, None], frozen[None, :], logp)
        total = scores.reshape(b, beam, 1) + logp.reshape(b, beam, v)
        new_scores, idx = top_k(total.reshape(b, beam * v), beam)
        parent = idx // v
        tok = (idx % v).reshape(-1)
        rows = (row0 + parent).reshape(-1)
        cache = [tuple(x.index_select(0, rows) for x in layer) for layer in cache]
        tokens = tokens.index_select(0, rows)
        done = done.index_select(0, rows)
        lengths = lengths.index_select(0, rows)
        tokens[:, i] = tok
        lengths = torch.where(done, lengths, lengths + 1)
        done = done | (tok == eos_id)
        scores = new_scores.reshape(b, beam)
        i += 1

    norm = scores / torch.pow(lengths.reshape(b, beam).clamp(min=1).float(), length_penalty)
    best = torch.argmax(norm, dim=1)
    ar = torch.arange(b, device=dev)
    rows = ar * beam + best
    return (tokens[rows].to(torch.int32), lengths.reshape(b, beam)[ar, best].to(torch.int32),
            scores[ar, best])
