# SPDX-License-Identifier: Apache-2.0
"""Greedy decoding for Whisper, batched over sessions.

Port of ``streamkit_tpu/models/whisper/decode.py``. The reference's
``lax.while_loop`` becomes a Python loop over :func:`~.model.decode_step`
with the KV cache updated in place. The loop checks ``done.all()`` on the
host every :data:`DONE_CHECK_EVERY` steps instead of every step: rows that
are already done emit ``eot`` and add 0 to the log-prob sum, so the extra
steps change no token, length or log-prob.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ...ops.mel import log_mel_spectrogram
from .config import WhisperConfig
from .model import Params, _check_tokens, decode_logits, decode_step, encode, init_kv_cache

__all__ = [
    "greedy_decode",
    "transcribe_window",
    "transcribe_ring",
    "detect_language_ring",
    "detect_language_window",
    "pad_or_trim",
    "N_SAMPLES_30S",
]

N_SAMPLES_30S = 30 * 16_000
DONE_CHECK_EVERY = 8


def pad_or_trim(audio: np.ndarray, length: int = N_SAMPLES_30S) -> np.ndarray:
    """Whisper's fixed 30 s window: zero-pad or trim."""
    if audio.shape[-1] >= length:
        return audio[..., :length]
    pad = [(0, 0)] * (audio.ndim - 1) + [(0, length - audio.shape[-1])]
    return np.pad(audio, pad)


def _param_dtype(params: Params) -> torch.dtype:
    return params["enc"]["conv1"]["w"].dtype


def _param_device(params: Params) -> torch.device:
    return params["enc"]["conv1"]["w"].device


def _chosen_lp(logits, tok):
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, tok[:, None].long())[:, 0]


@torch.no_grad()
def _greedy_loop(
    params: Params,
    cfg: WhisperConfig,
    audio_states: torch.Tensor,  # [batch, n_audio_ctx, d]
    prefix: torch.Tensor,  # [batch, n_prefix] forced tokens
    max_tokens: int,
    cross_kv_int8: bool = False,
    token_caps: Optional[torch.Tensor] = None,  # [batch] per-row budget
    suppress_bias: Optional[torch.Tensor] = None,  # [n_vocab] added to every step
    begin_bias: Optional[torch.Tensor] = None,  # [n_vocab] first sampled token only
    with_logprobs: bool = False,
):  # -> (tokens, lengths) or (tokens, lengths, lp_sum)
    """Greedy decode → (tokens ``[batch, max_tokens]`` int32, lengths
    ``[batch]``), plus the summed chosen-token log-probs of content tokens
    with ``with_logprobs``. Rows stop at ``eot`` or their ``token_caps``."""
    batch = audio_states.shape[0]
    n_prefix = prefix.shape[1]
    if max_tokens + n_prefix > cfg.n_text_ctx:
        raise ValueError(f"{n_prefix}+{max_tokens} tokens exceed n_text_ctx={cfg.n_text_ctx}")
    dev = audio_states.device
    cache = init_kv_cache(
        params, cfg, audio_states, max_len=max_tokens + n_prefix, cross_kv_int8=cross_kv_int8
    )
    eot = cfg.token_eot

    # forced prefix, one step at a time (≤ 4 tokens)
    logits = None
    for i in range(n_prefix):
        logits, cache = decode_step(params, cfg, prefix[:, i], cache)

    if token_caps is None:
        caps = torch.full((batch,), max_tokens, dtype=torch.int32, device=dev)
    else:
        caps = torch.clamp(token_caps.to(torch.int32), 1, max_tokens)
    if suppress_bias is not None:
        logits = logits + suppress_bias
    if begin_bias is not None:
        logits = logits + begin_bias

    tokens = torch.full((batch, max_tokens), eot, dtype=torch.int32, device=dev)
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    tokens[:, 0] = first
    done = (first == eot) | (caps <= 1)
    # lp_sum covers content tokens only (the set `lengths` counts)
    if with_logprobs:
        lp_sum = torch.where(first == eot, 0.0, _chosen_lp(logits, first))
    else:
        lp_sum = torch.zeros((batch,), dtype=torch.float32, device=dev)

    for i in range(max_tokens - 1):
        if i % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        logits, cache = decode_step(params, cfg, tokens[:, i], cache)
        if suppress_bias is not None:
            logits = logits + suppress_bias
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(done, eot, nxt)
        if with_logprobs:
            lp_sum = lp_sum + torch.where(done | (nxt == eot), 0.0, _chosen_lp(logits, nxt))
        tokens[:, i + 1] = nxt
        done = done | (nxt == eot) | (i + 2 > caps)
    lengths = (tokens != eot).sum(dim=-1).to(torch.int32)
    if with_logprobs:
        return tokens, lengths, lp_sum
    return tokens, lengths


def _default_int8(dtype: torch.dtype) -> bool:
    """Cross K/V int8 defaults on for bf16 serving, off for f32 parity
    paths; ``SK_KV_INT8=0`` turns it off."""
    return dtype == torch.bfloat16 and os.environ.get("SK_KV_INT8", "1") == "1"


def _prefix(cfg: WhisperConfig, lang_rows: torch.Tensor, task_token: int) -> torch.Tensor:
    """``<|sot|><|lang|><|task|><|notimestamps|>`` per row."""
    _check_tokens(cfg, cfg.token_sot, task_token, cfg.token_no_timestamps)
    rows = lang_rows.to(torch.int32)
    if rows.numel() and not (0 <= int(rows.min()) and int(rows.max()) < cfg.n_languages):
        raise ValueError(f"language indices outside [0, {cfg.n_languages})")
    return torch.stack(
        [
            torch.full_like(rows, cfg.token_sot),
            cfg.token_sot + 1 + rows,  # token_language(i)
            torch.full_like(rows, task_token),
            torch.full_like(rows, cfg.token_no_timestamps),
        ],
        dim=1,
    )


def _as_bias(bias, device) -> Optional[torch.Tensor]:
    if bias is None:
        return None
    return torch.as_tensor(bias, dtype=torch.float32, device=device)


@torch.no_grad()
def greedy_decode(
    params: Params,
    cfg: WhisperConfig,
    mel: torch.Tensor,  # [batch, 3000, n_mels]
    language_index: int = 0,
    task: str = "transcribe",
    max_tokens: int = 224,
    cross_kv_int8: Optional[bool] = None,
    suppress_bias=None,
    begin_bias=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode + greedy decode with the forced prefix
    ``<|sot|><|lang|><|task|><|notimestamps|>``."""
    audio_states = encode(params, cfg, mel)
    if cross_kv_int8 is None:
        cross_kv_int8 = _default_int8(audio_states.dtype)
    task_token = cfg.token_transcribe if task == "transcribe" else cfg.token_translate
    lang_rows = torch.full((mel.shape[0],), int(language_index), dtype=torch.int32, device=mel.device)
    tokens, lengths = _greedy_loop(
        params, cfg, audio_states, _prefix(cfg, lang_rows, task_token), max_tokens,
        cross_kv_int8=cross_kv_int8,
        suppress_bias=_as_bias(suppress_bias, mel.device),
        begin_bias=_as_bias(begin_bias, mel.device),
    )
    return tokens.cpu().numpy(), lengths.cpu().numpy()


@torch.no_grad()
def transcribe_window(
    params: Params,
    cfg: WhisperConfig,
    audio_16k: np.ndarray,  # [samples] or [batch, samples] f32 @16 kHz
    window_samples: int = N_SAMPLES_30S,
    **kw,
) -> Tuple[np.ndarray, np.ndarray]:
    """Audio → mel → tokens for one window (batched), on the parameters'
    device. ``window_samples`` < 30 s runs the encoder over a shorter
    context (position table sliced)."""
    audio_16k = np.asarray(audio_16k, np.float32)
    if audio_16k.ndim == 1:
        audio_16k = audio_16k[None]
    audio = torch.from_numpy(np.ascontiguousarray(pad_or_trim(audio_16k, window_samples)))
    mel = log_mel_spectrogram(audio.to(_param_device(params)), cfg.n_mels)
    return greedy_decode(params, cfg, mel.to(_param_dtype(params)), **kw)


def _ring_mel(params, cfg, ring, slot_ids, starts, lengths, window_samples):
    from ...engine.audio_ring import gather_ring_window

    audio = gather_ring_window(ring, slot_ids, starts, lengths, window_samples)
    return log_mel_spectrogram(audio, cfg.n_mels).to(_param_dtype(params))


@torch.no_grad()
def _ring_stt(
    params: Params,
    cfg: WhisperConfig,
    ring: torch.Tensor,  # [slots, ring_samples] int16 (SessionAudioRing)
    slot_ids: torch.Tensor,  # [B]
    starts: torch.Tensor,  # [B] absolute sample positions
    lengths: torch.Tensor,  # [B] valid samples (<= window_samples)
    lang_rows: torch.Tensor,  # [B] language indices
    window_samples: int,
    max_tokens: int,
    cross_kv_int8: bool,
    suppress_bias: Optional[torch.Tensor] = None,
    begin_bias: Optional[torch.Tensor] = None,
    with_logprobs: bool = False,
):
    """Ring gather → mel → encode → greedy decode, one batch."""
    mel = _ring_mel(params, cfg, ring, slot_ids, starts, lengths, window_samples)
    audio_states = encode(params, cfg, mel)
    # per-row token budget from actual audio length: ~4 tok/s + slack
    token_caps = torch.div(lengths, 4000, rounding_mode="floor") + 4
    return _greedy_loop(
        params, cfg, audio_states, _prefix(cfg, lang_rows, cfg.token_transcribe), max_tokens,
        cross_kv_int8=cross_kv_int8, token_caps=token_caps,
        suppress_bias=suppress_bias, begin_bias=begin_bias, with_logprobs=with_logprobs,
    )


@torch.no_grad()
def _ring_detect(
    params: Params,
    cfg: WhisperConfig,
    ring: torch.Tensor,
    slot_ids: torch.Tensor,
    starts: torch.Tensor,
    lengths: torch.Tensor,
    window_samples: int,
) -> torch.Tensor:
    """Language auto-detection: one decoder step after ``<|sot|>``, argmax
    over the language-token block → ``[B]`` int32 language indices."""
    _check_tokens(cfg, cfg.token_sot, cfg.token_sot + cfg.n_languages)
    mel = _ring_mel(params, cfg, ring, slot_ids, starts, lengths, window_samples)
    audio_states = encode(params, cfg, mel)
    sot = torch.full((mel.shape[0], 1), cfg.token_sot, dtype=torch.long, device=mel.device)
    logits = decode_logits(params, cfg, sot, audio_states)[:, -1]
    block = logits[:, cfg.token_sot + 1 : cfg.token_sot + 1 + cfg.n_languages]
    return torch.argmax(block, dim=-1).to(torch.int32)


def _ring_coords(ring, *xs):
    return [torch.as_tensor(x, dtype=torch.int64, device=ring.device) for x in xs]


def detect_language_ring(params, cfg, ring, slot_ids, starts, lengths,
                         window_samples: int) -> torch.Tensor:
    """Batched ring language detector (``[B]`` int32 indices)."""
    return _ring_detect(params, cfg, ring, *_ring_coords(ring, slot_ids, starts, lengths),
                        window_samples)


def transcribe_ring(
    params: Params,
    cfg: WhisperConfig,
    ring: torch.Tensor,
    slot_ids: np.ndarray,
    starts: np.ndarray,
    lengths: np.ndarray,
    window_samples: int,
    language_index=0,
    max_tokens: int = 224,
    cross_kv_int8: Optional[bool] = None,
    suppress_bias=None,
    begin_bias=None,
    with_logprobs: bool = False,
):
    """Decode straight from device-resident audio rings: each row is
    ``(slot, start, length)``; ``language_index`` is one index or one per row.
    Returns device tensors ``(tokens, lengths[, lp_sum])``."""
    if cross_kv_int8 is None:
        cross_kv_int8 = _default_int8(_param_dtype(params))
    slot_ids, starts, lengths = _ring_coords(ring, slot_ids, starts, lengths)
    lang_rows = torch.as_tensor(language_index, dtype=torch.int32, device=ring.device)
    if lang_rows.ndim == 0:
        lang_rows = lang_rows.expand(slot_ids.shape[0])
    return _ring_stt(
        params, cfg, ring, slot_ids, starts, lengths, lang_rows,
        window_samples=window_samples, max_tokens=max_tokens, cross_kv_int8=cross_kv_int8,
        suppress_bias=_as_bias(suppress_bias, ring.device),
        begin_bias=_as_bias(begin_bias, ring.device),
        with_logprobs=with_logprobs,
    )


@torch.no_grad()
def detect_language_window(params, cfg, audio_16k: np.ndarray) -> int:
    """Language auto-detection on a raw audio window (non-batched path)."""
    _check_tokens(cfg, cfg.token_sot, cfg.token_sot + cfg.n_languages)
    audio = np.asarray(audio_16k, np.float32)
    audio = pad_or_trim(audio[None] if audio.ndim == 1 else audio, N_SAMPLES_30S)
    x = torch.from_numpy(np.ascontiguousarray(audio)).to(_param_device(params))
    mel = log_mel_spectrogram(x, cfg.n_mels).to(_param_dtype(params))
    audio_states = encode(params, cfg, mel)
    sot = torch.full((audio.shape[0], 1), cfg.token_sot, dtype=torch.long, device=x.device)
    logits = decode_logits(params, cfg, sot, audio_states)[:, -1]
    block = logits[:, cfg.token_sot + 1 : cfg.token_sot + 1 + cfg.n_languages]
    return int(torch.argmax(block, dim=-1)[0])
