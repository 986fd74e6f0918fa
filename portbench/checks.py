# SPDX-License-Identifier: Apache-2.0
"""Judging the program's answers against the plain reference.

The served tokens of a greedy decode are judged by the reference's logits
at each position, run over the same prompt and tokens: a token's gap is how
far its logit lies below the reference's best there (0 when the reference
agrees). The control (the reference in float8) is read the same way, for
the token it puts first.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch

from reference import whisper as ref

_TOKEN = re.compile(r"<(\d+)>")


def parse_tokens(text: str) -> List[int]:
    """Token ids of a transcript rendered without a vocabulary
    (``<id><id>...``, how the program writes text for random weights)."""
    ids = _TOKEN.findall(text)
    if "".join(f"<{i}>" for i in ids) != text:
        raise ValueError(f"not a numeric transcript: {text[:80]!r}")
    return [int(i) for i in ids]


def gaps(ref_logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """``ref_logits [n, V]``, ``chosen [n]`` → each chosen token's gap."""
    return ref_logits.max(dim=-1).values - ref_logits.gather(-1, chosen.long()[:, None])[:, 0]


def read_positions(ws: Dict[str, "ref.Weights"], logits_of, targets: torch.Tensor,
                   bias: torch.Tensor) -> Dict[str, float]:
    """Widest gap of the served ``targets`` (key ``f32``) and of the tokens
    each lower precision puts first (its own key). ``logits_of(w)`` gives
    ``[n, V]`` logits at the judged positions; ``bias [n, V]`` is what the
    program adds before its argmax (suppressed tokens)."""
    base = logits_of(ws["f32"]) + bias
    out = {"f32": float(gaps(base, targets).max()) if targets.numel() else 0.0}
    for name, w in ws.items():
        if name != "f32":
            mine = logits_of(w) + bias
            out[name] = float(gaps(base, mine.argmax(dim=-1)).max()) if targets.numel() else 0.0
    return out


def full_window_gaps(ws: Dict[str, "ref.Weights"], seg: dict, n_head: int, n_mels: int, device) -> Dict[str, float]:
    """One full-window transcription: ``seg`` has ``audio`` (int16 samples
    of the segment), ``window`` (samples), ``prefix``, ``tokens`` (served),
    ``cap`` (the row's token budget), ``eot`` and ``suppress_first`` (token
    ids biased out of the first sampled position)."""
    audio = torch.zeros((1, seg["window"]), device=device)
    pcm = torch.from_numpy(seg["audio"][: seg["window"]].astype(np.float32) / 32768.0).to(device)
    audio[0, : pcm.numel()] = pcm
    toks = list(seg["prefix"]) + list(seg["tokens"])
    targets = list(seg["tokens"])
    if len(targets) < seg["cap"]:
        targets.append(seg["eot"])  # the decode stopped: eot came first
    p = len(seg["prefix"])
    n = len(targets)
    tok_t = torch.tensor([toks[: p - 1 + n]], device=device)
    states = {}

    def logits_of(w):
        key = id(w)
        if key not in states:
            mel = ref.log_mel_window(audio, n_mels)
            xk, xv = ref.cross_kv(w, ref.encode_full(w, mel, n_head))
            states[key] = ref.decode_logits(w, tok_t, xk, xv, n_head)[0, p - 1 : p - 1 + n]
        return states[key]

    vocab = ws["f32"].tree["dec"]["tok_emb"].shape[0]
    bias = torch.zeros((n, vocab), device=device)
    for t in seg["suppress_first"]:
        bias[0, t] = -1e9
    return read_positions(ws, logits_of, torch.tensor(targets, device=device), bias)


def max_readings(parts: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for d in parts:
        for k, v in d.items():
            out[k] = max(out.get(k, 0.0), v)
    return out
