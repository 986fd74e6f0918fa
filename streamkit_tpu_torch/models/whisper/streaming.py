# SPDX-License-Identifier: Apache-2.0
"""Incremental (streaming) Whisper for live partial transcripts.

Port of ``streamkit_tpu/models/whisper/streaming.py``. Each partial costs one
*chunk* encode (8 encoder positions = 160 ms of audio) plus a few decode
steps against per-session caches on the device:

* **chunk-causal encoder**: a chunk's queries attend to the cached K/V of
  every earlier position plus the whole current chunk; its own K/V and the
  decoder's cross K/V are appended to the session's slot. The conv frontend
  reads exact left/right audio context from the session's audio ring, so
  only attention differs from the full-window encoder.
* **continuation decoder**: emitted tokens are frozen (their self-attention
  K/V stay cached); each tick re-feeds the newest token against the grown
  cross context and appends tokens until it proposes ``<|eot|>``, which is
  held back (more audio may continue the utterance).
* **fused block step** (:func:`_stream_step`): segment open, VAD scoring,
  ring append, chunk encode and decode continuation in one call per block.

Approximations (partials only; segment finals run the exact encoder through
:func:`..decode.transcribe_ring`): chunk-causal attention, a chunk-local
log-mel dynamic-range floor, and committed tokens are never revised.

Cache layout, as the reference: layer-major ``[L, S, H, hd, T]`` (time
minor, so one layer's rows feed the score matmul without a transpose). The
four encoder-length caches are int8 with per-column f32 scales ``[L, S, H,
T]`` by default (``SK_STREAM_KV_INT8``); the decoder's self K/V stay in the
model dtype. Attention reads the quantised values, so later chunks see what
was stored.

Kernels. The reference gates its Pallas kernels behind ``SK_PALLAS_WRITES``
and ``SK_ATTN_KERNEL`` (each ``pallas_call`` is an XLA fusion barrier). The
port has no fusion to protect and drops both knobs: in identity mode (batch
row b is table slot b, the serving engine's packing) every cache append and
every decoder fold goes through the windowed-write kernel
(:mod:`...ops.cache_write`; one launch for all of a call's encoder-cache
appends, one for its two folds), and the int8 tables' encoder attention through
the history-attention kernel (:mod:`...ops.stream_attention`). In both modes
the decode continuation's cross-attention over int8 cross caches goes through
the decode-attention kernel (:mod:`...ops.decode_attention`), which reads the
int8 values in place where eager PyTorch would write every upcast to device
memory. The wrappers launch their CUDA kernel on CUDA tensors and take their
plain version on CPU tensors. Float tables keep the reference's eager
formulation; so does the general (gathered-row) mode, but for that
cross-attention, and it scatters, as the reference does outside its gates.

On a mesh (:func:`...parallel.serving.shard_stream_table`) a table holds
this rank's ``[L, S/dp, H/tp, hd, T]`` caches and ``S/dp`` slot vectors; the
fused step takes the rows of this rank's slots (global ids in, local rows
run), the model helpers sum over tp, and :meth:`StreamTable.identity_step_fn`
gathers the rows over dp. The standalone ``encode_chunks`` and
``decode_steps`` stay one-device.

In-place state: the caches are written in place (the reference donates
them). The small per-slot vectors (tokens, counters, positions) are replaced
by new tensors on every call, so a tensor handed back to a caller is never
written again. The audio ring is appended out of place: an exact-final
decode in another thread may hold a :meth:`SessionAudioRing.ring_ref`
snapshot (the reference does not donate the ring for the same reason).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device, strict_fp32
from ...ops import cache_write, decode_attention, stream_attention
from ...ops.mel import HOP_LENGTH, N_FFT, _dft_bases, _mel_mat, frame_signal
from ...ops.stream_attention import scaled_operand
from .config import WhisperConfig
from ...ops.tensor_parallel import embed_rows
from ...utils.tracing import get_tracer, now_ns
from .model import Params, _dense, _layernorm, _logits, _merge_heads, _mlp, _split_heads

__all__ = [
    "StreamTable",
    "get_stream_table",
    "CHUNK_SAMPLES",
    "CHUNK_POS",
    "RIGHT_CTX",
    "META_COLS",
    "META_PREFIX",
]

logger = logging.getLogger(__name__)

# One streaming chunk: 8 encoder positions = 16 mel frames = 2560 samples
# (160 ms @16 kHz). Encoder position = 2 mel frames = 320 samples.
CHUNK_POS = 8
CHUNK_MEL = 2 * CHUNK_POS
CHUNK_SAMPLES = CHUNK_MEL * HOP_LENGTH  # 2560
# conv context: chunk positions p0..p0+7 need mel frames 2p0-2..2p0+16; mel
# frame t covers samples [t*160-200, t*160+200). Left: 2 mel frames + the
# half window = 520, rounded up to 560 for hop alignment.
LEFT_CTX = 560
RIGHT_CTX = 200  # mel frame t0+16 reads 200 samples past the chunk end
GATHER = LEFT_CTX + CHUNK_SAMPLES + RIGHT_CTX  # 3320: the samples one chunk's mel reads

# meta row of the fused step: per-row scalars, then the decoder prefix
META_COLS = 7  # slot, stream, wpos, cstart, n_req, do_dec, do_reset
META_PREFIX = 4


def _mm32(a, b):
    """``a @ b`` in f32 from operands already rounded to the model dtype (the
    reference's ``preferred_element_type=f32`` matmuls)."""
    return torch.matmul(a.float(), b.float())


def _scaled(x, s: float):
    """``x * s`` rounded as the reference rounds a weakly typed scalar."""
    return scaled_operand(x, s, x.dtype)


def _chunk_mel(audio: torch.Tensor, n_mels: int, n_frames: int) -> torch.Tensor:
    """``[B, gather]`` audio → ``[B, n_frames, n_mels]`` log-mel of the
    chunk's conv context (local frame j starts at sample 40 + 160·j). The
    dynamic-range floor uses the chunk-local max."""
    frames = frame_signal(audio, n_frames, offset=40)
    cos_b, sin_b = _dft_bases(N_FFT, audio.device)
    re = torch.matmul(frames, cos_b)
    im = torch.matmul(frames, sin_b)
    power = re * re + im * im
    mel = torch.matmul(power, _mel_mat(n_mels, audio.device))
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def _conv_valid(x, w, b, stride: int):
    """VALID conv over ``[B, t, c_in]`` with the reference's ``[k, c_in,
    c_out]`` weights."""
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=stride)
    return y.transpose(1, 2) + b


# ---------------------------------------------------------------------------
# int8 caches: (q8 [.., hd, T], scale [.., T]) tuples, or one float tensor
# ---------------------------------------------------------------------------
def _quant_cols(cols: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[B, H, hd, c]`` float columns → (int8 columns, f32 per-column scales
    ``[B, H, c]``); scale = absmax over head_dim / 127, round half to even."""
    f = cols.float()
    scale = torch.clamp(f.abs().amax(dim=2), min=1e-8) / 127.0
    q = torch.clamp(torch.round(f / scale[:, :, None, :]), -127, 127).to(torch.int8)
    return q, scale


def _quant_like(cache, cols_f: torch.Tensor):
    """Candidate columns in the cache's representation: attention reads
    these, so later reads of the stored cache see what this call saw."""
    if isinstance(cache, tuple):
        return _quant_cols(cols_f)
    return cols_f.to(cache.dtype)


def _scores_rows(qs, rows, op_scale: float, dtype):
    """``qs [B,H,q,hd]`` (pre-scaled) · K rows ``[B,H,hd,T]`` → f32 scores;
    int8 rows take their column scale after the dot."""
    if isinstance(rows, tuple):
        return _mm32(qs, scaled_operand(rows[0], op_scale, dtype)) * rows[1][:, :, None, :]
    return _mm32(qs, _scaled(rows, op_scale))


def _attend_rows(probs, rows, dtype):
    """``probs [B,H,q,T]`` f32 · V rows ``[B,H,hd,T]`` → ``[B,H,q,hd]`` f32;
    int8 rows fold their column scale into the probabilities."""
    if isinstance(rows, tuple):
        p = (probs * rows[1][:, :, None, :]).to(dtype)
        return _mm32(p, rows[0].to(dtype).transpose(-1, -2))
    return _mm32(probs.to(dtype), rows.transpose(-1, -2))


def _read_layer(cache, li: int, ids):
    """One layer's K or V rows ``[B, H, hd, T]`` (+ scales ``[B, H, T]``).
    ``ids=None`` is identity mode: a contiguous slice of the table."""
    if isinstance(cache, tuple):
        if ids is None:
            return cache[0][li], cache[1][li]
        return cache[0][li, ids], cache[1][li, ids]
    return cache[li] if ids is None else cache[li, ids]


# ---------------------------------------------------------------------------
# cache writes
# ---------------------------------------------------------------------------
def _scatter_rows(arr, upd, ids, pos, lim) -> None:
    """General-mode write, in place: ``arr[:, ids[b], .., (pos[b]+i) % T] =
    upd[:, b, .., i]`` for ``i < lim[b]`` (``arr [L, S, F.., T]``, ``upd [L,
    B, F.., c]``)."""
    L, T, c = arr.shape[0], arr.shape[-1], upd.shape[-1]
    dev = arr.device
    i = torch.arange(c, device=dev)
    cols = (pos.long()[:, None] + i) % T
    b_idx, i_idx = (i[None, :] < lim.long()[:, None]).nonzero(as_tuple=True)
    a4 = arr.view(L, arr.shape[1], -1, T)
    a4[:, ids.long()[b_idx], :, cols[b_idx, i_idx]] = upd.reshape(L, upd.shape[1], -1, c)[:, b_idx, :, i_idx]


def _write_chunks(writes, ids, pos, commit, identity: bool) -> None:
    """Append every layer's candidate columns to the caches, in place.

    ``writes``: ``(cache, cands)`` per cache; ``cands`` per layer, ``(q8
    [B,H,hd,c], scale [B,H,c])`` (int8 cache) or ``[B,H,hd,c]``, one ``c``
    for all. ``commit [B]``: chunks to write per row (``None`` = all).
    Identity mode writes every cache's data and scales with one
    windowed-write launch (the plain version on the CPU); the general mode
    scatters the committed columns into the gathered rows."""
    first = writes[0][1][0]
    b, c = pos.shape[0], (first[0] if isinstance(first, tuple) else first).shape[-1]
    lim = (
        torch.full((b,), c, dtype=torch.int32, device=pos.device)
        if commit is None
        else torch.clamp(CHUNK_POS * commit, max=c).to(torch.int32)
    )
    pairs = []
    for cache, cands in writes:
        quant = isinstance(cache, tuple)
        arr = cache[0] if quant else cache
        L, S, H, hd, T = arr.shape
        cq = torch.stack([x[0] if quant else x for x in cands])  # [L,B,H,hd,c]
        sq = torch.stack([x[1] for x in cands]) if quant else None  # [L,B,H,c]
        if identity:
            pairs.append((arr.view(L, S, H * hd, T), cq.view(L, S, H * hd, c)))
            if quant:
                pairs.append((cache[1], sq))
            continue
        _scatter_rows(arr, cq, ids, pos, lim)
        if quant:
            _scatter_rows(cache[1], sq, ids, pos, lim)
    if pairs:
        cache_write.windowed_write_many(pairs, pos, lim)


def _fold_cols(folds, pos, count) -> None:
    """Fold per-step delta columns into layer-major caches ``[L, B, .., T]``
    in place: ``cache[:, b, .., pos[b]+i] = delta[:, b, .., i]`` for ``i <
    count[b]``, for every ``(cache, delta)`` of ``folds``. One
    windowed-write launch for all (its plain version on the CPU)."""
    pairs = []
    for cache5, delta5 in folds:
        L, B, T = cache5.shape[0], cache5.shape[1], cache5.shape[-1]
        pairs.append((cache5.view(L, B, -1, T), delta5.reshape(L, B, -1, delta5.shape[-1]).contiguous()))
    cache_write.windowed_write_many(pairs, pos, count)


# ---------------------------------------------------------------------------
# cores (shared by the standalone steps and the fused block step)
# ---------------------------------------------------------------------------
def _encode_core(
    params: Params,
    cfg: WhisperConfig,
    ring: torch.Tensor,  # [slots, ring_samples] int16
    slot_ids: torch.Tensor,  # [B] audio-ring slots
    starts: torch.Tensor,  # [B] chunk start samples
    ek, ev, xkr, xvr,  # cache tensors or (q8, scale) tuples
    stream_ids: torch.Tensor,  # [B] rows into the tables
    pos_rows: torch.Tensor,  # [B] encoder positions
    n_chunks: int,
    enc_t: int,
    commit: Optional[torch.Tensor] = None,  # [B] chunks to commit (None = all)
    identity: bool = False,
) -> torch.Tensor:
    """Encode ``n_chunks`` consecutive chunks per row from the audio ring and
    append enc K/V and cross K/V to the tables (in place). With ``commit``
    only each row's first ``commit[b]`` chunks are written and its position
    advances by ``8·commit[b]``. Returns the new positions."""
    dtype = params["enc"]["pos"].dtype
    dev = ring.device
    rs = ring.shape[1]
    n_pos = CHUNK_POS * n_chunks
    gather = LEFT_CTX + CHUNK_SAMPLES * n_chunks + RIGHT_CTX
    g0 = (starts.long() - LEFT_CTX) % rs
    idx = (g0[:, None] + torch.arange(gather, device=dev)) % rs
    audio = ring[slot_ids.long()[:, None], idx].float() / 32768.0
    mel = _chunk_mel(audio, cfg.n_mels, 16 * n_chunks + 3).to(dtype)

    e = params["enc"]
    x = F.gelu(_conv_valid(mel, e["conv1"]["w"], e["conv1"]["b"], 1))
    x = F.gelu(_conv_valid(x, e["conv2"]["w"], e["conv2"]["b"], 2))
    p = pos_rows.long()[:, None] + torch.arange(n_pos, device=dev)
    x = x + e["pos"].to(dtype)[torch.clamp(p, max=e["pos"].shape[0] - 1)]

    hde = cfg.n_audio_state // cfg.n_audio_head
    hd_scale = hde ** -0.25
    # history: visible below each row's position; candidates: block-causal
    # within the call (a query in chunk j sees candidate j2 < (j//8+1)*8,
    # exactly j sequential one-chunk calls). Attention sees every candidate;
    # only the write is commit-guarded.
    col = torch.arange(enc_t, device=dev)
    j = torch.arange(n_pos, device=dev)
    hist_mask = torch.where(col[None, :] < pos_rows[:, None], 0.0, float("-inf"))[:, None, None, :]
    cand_mask = torch.where(j[None, :] < ((j // CHUNK_POS + 1) * CHUNK_POS)[:, None], 0.0, float("-inf"))
    hist_ids = None if identity else stream_ids.long()
    use_kernel = identity and isinstance(ek, tuple)

    cand_ks, cand_vs = [], []
    for li, layer in enumerate(e["layers"]):
        h = _layernorm(x, layer["ln1"])
        q = _split_heads(_dense(h, layer["attn"]["q"]), hde)  # [B,H,c,hd], this rank's heads
        k = _split_heads(_dense(h, layer["attn"]["k"]), hde)
        v = _split_heads(_dense(h, layer["attn"]["v"]), hde)
        kq = _quant_like(ek, k.transpose(-1, -2))
        vq = _quant_like(ev, v.transpose(-1, -2))
        cand_ks.append(kq)
        cand_vs.append(vq)
        qs = _scaled(q, hd_scale)
        ek_li = _read_layer(ek, li, hist_ids)  # pre-write history
        ev_li = _read_layer(ev, li, hist_ids)
        if use_kernel:
            out = stream_attention.history_attention(
                qs.contiguous(), ek_li[0], ek_li[1], ev_li[0], ev_li[1],
                kq[0].contiguous(), kq[1].contiguous(), vq[0].contiguous(), vq[1].contiguous(),
                pos_rows, float(hd_scale),
            ).to(dtype)
        else:
            scores = torch.cat(
                [_scores_rows(qs, ek_li, hd_scale, dtype) + hist_mask,
                 _scores_rows(qs, kq, hd_scale, dtype) + cand_mask],
                dim=-1,
            )
            probs = torch.softmax(scores, dim=-1)
            out = (_attend_rows(probs[..., :enc_t], ev_li, dtype)
                   + _attend_rows(probs[..., enc_t:], vq, dtype)).to(dtype)
        x = x + _dense(_merge_heads(out), layer["attn"]["o"])
        x = x + _mlp(_layernorm(x, layer["ln2"]), layer)
    enc_out = _layernorm(x, e["ln_post"])  # [B, c, d]

    cand_xk, cand_xv = [], []
    hdt = cfg.n_text_state // cfg.n_text_head
    for layer in params["dec"]["layers"]:
        kx = _split_heads(_dense(enc_out, layer["xattn"]["k"]), hdt)
        vx = _split_heads(_dense(enc_out, layer["xattn"]["v"]), hdt)
        cand_xk.append(_quant_like(xkr, kx.transpose(-1, -2)))
        cand_xv.append(_quant_like(xvr, vx.transpose(-1, -2)))

    _write_chunks(((ek, cand_ks), (ev, cand_vs), (xkr, cand_xk), (xvr, cand_xv)), stream_ids, pos_rows, commit,
                  identity)
    adv = n_pos if commit is None else CHUNK_POS * commit
    return pos_rows + adv


def _decode_core(
    params: Params,
    cfg: WhisperConfig,
    dk, dv,  # [Ld, S, H, hd, DEC_T] tables
    xkr, xvr,  # layer-major cross caches
    stream_ids: torch.Tensor,  # [B]
    ep: torch.Tensor,  # [B] encoder positions (cross-attention horizon)
    tok: torch.Tensor,  # [B, DEC_T]
    fed_r: torch.Tensor,
    n_r: torch.Tensor,
    active0: torch.Tensor,  # [B] bool: rows allowed to step
    max_steps: int,
    enc_t: int,
    identity: bool = False,
    suppress_bias=None,
    begin_bias=None,
):
    """Greedy continuation: per step a row feeds ``tokens[min(fed, n_tok-1)]``
    and, once caught up, appends the argmax unless it is ``<|eot|>`` (held
    back). The self K/V history is loop-invariant: each step's columns go to
    a small delta buffer, folded into the table once after the loop at each
    row's start column (one windowed-write launch for K and V). Returns
    ``(tok, fed, n_tok)``; ``dk``/``dv`` are written in place."""
    d = params["dec"]
    dtype = params["enc"]["pos"].dtype
    dev = tok.device
    eot = cfg.token_eot
    Ld = cfg.n_text_layer
    hd = cfg.n_text_state // cfg.n_text_head
    Ht = d["layers"][0]["attn"]["k"]["w"].shape[-1] // hd  # this rank's heads
    dec_t = dk.shape[-1]
    scale = hd ** -0.25
    b = tok.shape[0]
    bi = torch.arange(b, device=dev)
    hist_ids = None if identity else stream_ids.long()
    dkl, dvl = (dk, dv) if identity else (dk[:, hist_ids], dv[:, hist_ids])
    tok = tok.clone()

    ninf = float("-inf")
    # the int8 cross caches' attention is one kernel (K4; its plain version
    # on the CPU); float caches keep the eager expression. max(ep, 1) keeps
    # the softmax finite for rows not yet encoded (they are inactive; this
    # only avoids NaN in dead lanes)
    int8_cross = isinstance(xkr, tuple)
    xmask = None if int8_cross else torch.where(
        torch.arange(enc_t, device=dev)[None, :] < torch.clamp(ep, min=1)[:, None], 0.0, ninf
    )[:, None, None, :]
    # every active row's feed column advances in lockstep from feed0, so
    # this call's columns are delta columns 0..max_steps-1 for every row
    feed0 = torch.clamp(torch.minimum(fed_r, n_r - 1), min=0)
    smask0 = torch.where(torch.arange(dec_t, device=dev)[None, :] < feed0[:, None], 0.0, ninf)[:, None, None, :]
    kd = torch.zeros((Ld, b, Ht, hd, max_steps), dtype=dtype, device=dev)
    vd = torch.zeros_like(kd)
    scol = torch.arange(max_steps, device=dev)
    done = ~active0
    fold_n = torch.zeros((b,), dtype=torch.int32, device=dev)

    for i in range(max_steps):
        active = ~done & (n_r > 0) & (ep > 0)
        fold_n = fold_n + active.to(torch.int32)
        feed_idx = torch.clamp(feed0 + i, max=dec_t - 1).long()
        cur = tok[bi, feed_idx].long()
        x = (embed_rows(d["tok_emb"], cur)[:, None, :] + d["pos_emb"][feed_idx][:, None, :]).to(dtype)
        dmask = torch.where(scol < i, 0.0, ninf).reshape(1, 1, 1, max_steps)
        kcols, vcols = [], []
        for li, layer in enumerate(d["layers"]):
            h = _layernorm(x, layer["ln1"])
            q = _split_heads(_dense(h, layer["attn"]["q"]), hd)  # [B,H,1,hd]
            kcol = _split_heads(_dense(h, layer["attn"]["k"]), hd).transpose(-1, -2)  # [B,H,hd,1]
            vcol = _split_heads(_dense(h, layer["attn"]["v"]), hd).transpose(-1, -2)
            kcols.append(kcol)
            vcols.append(vcol)
            qs = _scaled(q, scale)
            # invariant history (col < feed0) + this call's deltas (col < i)
            # + the current token's own K/V
            scores = torch.cat(
                [_mm32(qs, _scaled(dkl[li], scale)) + smask0,
                 _mm32(qs, _scaled(kd[li], scale)) + dmask,
                 _mm32(qs, _scaled(kcol, scale))],
                dim=-1,
            )
            probs = torch.softmax(scores, dim=-1).to(dtype)
            attn = (
                _mm32(probs[..., :dec_t], dvl[li].transpose(-1, -2))
                + _mm32(probs[..., dec_t : dec_t + max_steps], vd[li].transpose(-1, -2))
                + _mm32(probs[..., dec_t + max_steps :], vcol.transpose(-1, -2))
            ).to(dtype)
            x = x + _dense(_merge_heads(attn), layer["attn"]["o"])
            qx = _split_heads(_dense(_layernorm(x, layer["ln_x"]), layer["xattn"]["q"]), hd)
            qxs = _scaled(qx, scale)
            xk_li, xv_li = _read_layer(xkr, li, hist_ids), _read_layer(xvr, li, hist_ids)
            if int8_cross:
                xa = decode_attention.decode_cross_attention(
                    qxs.contiguous(), xk_li[0], xk_li[1], xv_li[0], xv_li[1], ep, float(scale))
            else:
                xa = _attend_rows(torch.softmax(_scores_rows(qxs, xk_li, scale, dtype) + xmask, dim=-1), xv_li, dtype)
            x = x + _dense(_merge_heads(xa.to(dtype)), layer["xattn"]["o"])
            x = x + _mlp(_layernorm(x, layer["ln2"]), layer)
        # delta append at the uniform column i (inactive rows write dead
        # lanes that the fold's per-row count skips)
        kd[..., i] = torch.stack(kcols)[..., 0]
        vd[..., i] = torch.stack(vcols)[..., 0]
        logits = _logits(_layernorm(x, d["ln"])[:, 0], d["tok_emb"], dtype)  # [B, vocab]
        if suppress_bias is not None:
            logits = logits + suppress_bias
        if begin_bias is not None:
            # first sampled token = the one right after the 4-token prefix
            logits = logits + torch.where((n_r == META_PREFIX)[:, None], begin_bias, 0.0)
        fed_new = torch.where(active, feed_idx.to(fed_r.dtype) + 1, fed_r)
        proposing = active & (fed_new == n_r)
        nxt = torch.argmax(logits, dim=-1).to(tok.dtype)
        append = proposing & (nxt != eot) & (n_r < dec_t - 1)
        wpos = torch.clamp(n_r, max=dec_t - 1).long()
        tok[bi, wpos] = torch.where(append, nxt, tok[bi, wpos])
        n_r = n_r + append.to(n_r.dtype)
        done = done | (proposing & ~append) | ~active
        fed_r = fed_new

    # fold the delta columns once, at each row's start column; fold_n counts
    # the row's active steps (a row that never stepped folds nothing)
    _fold_cols(((dkl, kd), (dvl, vd)), feed0, fold_n)
    if not identity:
        dk[:, hist_ids] = dkl
        dv[:, hist_ids] = dvl
    return tok, fed_r, n_r


def _stream_step(
    params: Params,
    cfg: WhisperConfig,
    tbl: "StreamTable",
    audio_ring,  # SessionAudioRing
    meta: torch.Tensor,  # [B, META_COLS + META_PREFIX] int32
    frames_b: torch.Tensor,  # [B, n_frames, VAD_FRAME] int16 wire or f32
    max_steps: int,
    n_chunks: int,
    identity: bool,
    t_prep: int = 0,
):
    """Fused per-VAD-block step: open segments (``do_reset``), score VAD
    frames, append them to the rings, encode up to ``n_chunks`` chunks per
    row (commit-guarded) against the appended ring, and advance the decode
    continuation. Updates ``tbl`` and ``audio_ring`` (callers hold both step
    locks) and returns ``(probs, tokens, n_tok, enc_pos)`` rows.

    ``identity`` is the dense-serving packing: B = S and row b is slot b;
    every cache read is a slice and every cache write a kernel launch.

    Spans (host time, when the tracer is on): ``stream.prep`` from
    ``t_prep`` (the caller's packing and copies in) through the segment
    open, then ``stream.vad``, ``stream.encode`` and ``stream.decode``. They
    add no device synchronisation."""
    from ...engine.audio_ring import _vad_append

    tracer = get_tracer()

    slot_ids, stream_ids = meta[:, 0], meta[:, 1]
    wpos, cstart, n_req = meta[:, 2], meta[:, 3], meta[:, 4]
    do_dec, do_reset = meta[:, 5] != 0, meta[:, 6] != 0
    prefix_b = meta[:, META_COLS:]
    sid = stream_ids.long()
    p_len = prefix_b.shape[1]

    # 0) segment open: prefix into the token buffer, counters to zero (the
    # caches need no clearing: masks bound every read)
    tokens, fed, n_tok, enc_pos = tbl._tokens, tbl._fed, tbl._n_tok, tbl._enc_pos
    rows = lambda t: t if identity else t[sid]  # noqa: E731
    fresh = torch.zeros_like(rows(tokens))
    fresh[:, :p_len] = prefix_b
    tok_rows = torch.where(do_reset[:, None], fresh, rows(tokens))
    fed_rows = torch.where(do_reset, 0, rows(fed))
    n_rows = torch.where(do_reset, p_len, rows(n_tok))
    pos_rows = torch.where(do_reset, 0, rows(enc_pos))
    if t_prep:
        tracer.record("stream.prep", t_prep, now_ns())

    # 1) VAD score + ring append (out of place, see the module docstring)
    with tracer.span("stream.vad"):
        audio_ring._ring, probs = _vad_append(audio_ring._vad_state, audio_ring._ring, slot_ids.long(),
                                              wpos.long(), frames_b)

    # 2) commit-guarded chunk encode against the appended ring
    with tracer.span("stream.encode"):
        pos_new = _encode_core(
            params, cfg, audio_ring._ring, slot_ids, cstart,
            tbl._enc_k, tbl._enc_v, tbl._xk, tbl._xv, stream_ids, pos_rows, n_chunks, tbl.enc_t,
            commit=n_req, identity=identity,
        )

    # 3) decode continuation against the updated cross context
    with tracer.span("stream.decode"):
        tok_rows, fed_rows, n_rows = _decode_core(
            params, cfg, tbl._dec_k, tbl._dec_v, tbl._xk, tbl._xv, stream_ids, pos_new,
            tok_rows, fed_rows, n_rows, do_dec, max_steps, tbl.enc_t, identity=identity,
            suppress_bias=tbl.suppress_bias, begin_bias=tbl.begin_bias,
        )
    if identity:
        tbl._tokens, tbl._fed, tbl._n_tok, tbl._enc_pos = tok_rows, fed_rows, n_rows, pos_new
    else:
        tbl._tokens = tokens.index_put((sid,), tok_rows)
        tbl._fed = fed.index_put((sid,), fed_rows)
        tbl._n_tok = n_tok.index_put((sid,), n_rows)
        tbl._enc_pos = enc_pos.index_put((sid,), pos_new)
    return probs, tok_rows, n_rows, pos_new


# ---------------------------------------------------------------------------
# slot table
# ---------------------------------------------------------------------------
class StreamTable:
    """Pool of device-resident streaming-decode slots for one model.

    Thread-safe: steps serialize under a step lock; the fused step takes the
    audio ring's step lock first, then this table's."""

    def __init__(
        self,
        cfg: WhisperConfig,
        dtype: torch.dtype,
        max_slots: Optional[int] = None,
        enc_t: Optional[int] = None,
        dec_t: Optional[int] = None,
        kv_int8: Optional[bool] = None,
        suppress_bias=None,  # [vocab] f32 (whisper.cpp suppress_nst set)
        begin_bias=None,  # [vocab] f32, first sampled token per segment
        device=None,
    ) -> None:
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        bias = lambda b: None if b is None else torch.as_tensor(b, dtype=torch.float32, device=dev)  # noqa: E731
        self.suppress_bias = bias(suppress_bias)
        self.begin_bias = bias(begin_bias)
        self.max_slots = max_slots or int(os.environ.get("SK_STREAM_SLOTS", "64"))
        # clamped to the model's position tables (tiny configs)
        self.enc_t = min(enc_t or int(os.environ.get("SK_STREAM_ENC_T", "512")), cfg.n_audio_ctx)
        self.dec_t = min(dec_t or int(os.environ.get("SK_STREAM_DEC_T", "128")), cfg.n_text_ctx)
        self.kv_int8 = kv_int8 if kv_int8 is not None else os.environ.get("SK_STREAM_KV_INT8", "1") == "1"
        self.enc_t -= self.enc_t % CHUNK_POS  # whole chunks
        s = self.max_slots
        he, hde = cfg.n_audio_head, cfg.n_audio_state // cfg.n_audio_head
        ht, hdt = cfg.n_text_head, cfg.n_text_state // cfg.n_text_head

        def enc_cache(layers, h, hd):
            if self.kv_int8:
                return (
                    torch.zeros((layers, s, h, hd, self.enc_t), dtype=torch.int8, device=dev),
                    torch.zeros((layers, s, h, self.enc_t), dtype=torch.float32, device=dev),
                )
            return torch.zeros((layers, s, h, hd, self.enc_t), dtype=dtype, device=dev)

        self._enc_k = enc_cache(cfg.n_audio_layer, he, hde)
        self._enc_v = enc_cache(cfg.n_audio_layer, he, hde)
        self._xk = enc_cache(cfg.n_text_layer, ht, hdt)
        self._xv = enc_cache(cfg.n_text_layer, ht, hdt)
        self._dec_k = torch.zeros((cfg.n_text_layer, s, ht, hdt, self.dec_t), dtype=dtype, device=dev)
        self._dec_v = torch.zeros_like(self._dec_k)
        self._tokens = torch.zeros((s, self.dec_t), dtype=torch.int32, device=dev)
        self._fed = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._n_tok = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._enc_pos = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._free = list(range(s - 1, -1, -1))
        self._alloc_lock = threading.Lock()
        self._step_lock = threading.Lock()
        self.shard = None  # this rank's SlotShard on a mesh (the allocator stays global)

    # -- slot lifecycle ------------------------------------------------------
    def try_alloc(self) -> Optional[int]:
        with self._alloc_lock:
            return self._free.pop() if self._free else None

    def free(self, slot: int) -> None:
        with self._alloc_lock:
            self._free.append(slot)

    def _ids(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=self.device)

    def _one_device(self, what: str) -> None:
        if self.shard is not None:
            raise ValueError(f"{what} runs on one device; a sharded table steps through step()")

    def _local_rows(self, meta: np.ndarray, frames, audio_ring):
        """The rows of this rank's slots with local ids: stream slots of this
        dp rank, their ring slots (which must be on the same rank) and ``-1``
        (this rank's trash row) made local."""
        sh, rsh = self.shard, audio_ring.shard
        own = np.flatnonzero(sh.owner(meta[:, 1]) == sh.rank)
        meta = meta[own].copy()
        ring_ids = meta[:, 0]
        trash = ring_ids < 0
        if (rsh.owner(ring_ids[~trash]) != rsh.rank).any():
            raise ValueError("a row's ring slot and stream slot are on different dp ranks")
        meta[:, 0] = np.where(trash, rsh.local, ring_ids - rsh.rank * rsh.local)
        meta[:, 1] -= sh.rank * sh.local
        return meta, frames[own]

    # -- steps ----------------------------------------------------------------
    @torch.no_grad()
    def reset(self, stream_id: int, prefix) -> None:
        """Open a new segment on ``stream_id``: prefix into the token buffer,
        counters to zero."""
        if self.shard is not None:
            if self.shard.owner(stream_id) != self.shard.rank:
                return
            stream_id -= self.shard.rank * self.shard.local
        prefix = self._ids(prefix)
        row = self._ids([stream_id]).long()
        with self._step_lock:
            tokens = self._tokens.clone()
            tokens[stream_id, : prefix.shape[0]] = prefix
            self._tokens = tokens
            self._fed = self._fed.index_fill(0, row, 0)
            self._n_tok = self._n_tok.index_fill(0, row, prefix.shape[0])
            self._enc_pos = self._enc_pos.index_fill(0, row, 0)

    @torch.no_grad()
    def encode_chunks(self, params: Params, ring, slot_ids, stream_ids, starts, n_chunks: int = 1):
        """Batched standalone chunk encode (general mode) → per-row new
        encoder positions."""
        self._one_device("encode_chunks")
        sid = self._ids(stream_ids)
        with self._step_lock:
            pos_new = _encode_core(
                params, self.cfg, ring, self._ids(slot_ids), self._ids(starts),
                self._enc_k, self._enc_v, self._xk, self._xv, sid, self._enc_pos[sid.long()],
                n_chunks, self.enc_t,
            )
            self._enc_pos = self._enc_pos.index_put((sid.long(),), pos_new)
        return pos_new

    @torch.no_grad()
    def decode_steps(self, params: Params, stream_ids, max_steps: int):
        """Batched standalone decode continuation (general mode) → (tokens
        ``[B, DEC_T]``, n_tok ``[B]``); this segment's new tokens are
        ``tokens[4:n_tok]``."""
        self._one_device("decode_steps")
        sid = self._ids(stream_ids).long()
        with self._step_lock:
            tok, fed, n = _decode_core(
                params, self.cfg, self._dec_k, self._dec_v, self._xk, self._xv, sid,
                self._enc_pos[sid], self._tokens[sid], self._fed[sid], self._n_tok[sid],
                torch.ones(sid.shape, dtype=torch.bool, device=self.device), max_steps, self.enc_t,
                suppress_bias=self.suppress_bias, begin_bias=self.begin_bias,
            )
            self._tokens = self._tokens.index_put((sid,), tok)
            self._fed = self._fed.index_put((sid,), fed)
            self._n_tok = self._n_tok.index_put((sid,), n)
        return tok, n

    @torch.no_grad()
    def step(
        self,
        params: Params,
        audio_ring,  # SessionAudioRing: VAD state and audio rings live there
        slot_ids,
        stream_ids,
        wpos,
        cstart,
        n_req,
        do_dec,
        frames_b,
        max_steps: int,
        do_reset=None,
        prefix_b=None,
        n_chunks: int = 2,
        t_prep: int = 0,
    ):
        """Fused per-block step (VAD + ring append + encode + decode) →
        ``(probs, tokens, n_tok, enc_pos)`` rows as device tensors.
        ``t_prep`` (:func:`...utils.tracing.now_ns`) starts the
        ``stream.prep`` span earlier than this call, at the caller's own
        packing.

        Takes per-field arrays, or (``slot_ids`` 2-D) a packed ``meta`` of
        shape ``[B, META_COLS + META_PREFIX]``. A batch in slot order (B =
        ``max_slots`` and ``meta[:, 1] == arange``) runs in identity mode.

        On a mesh the ids are global and this rank runs the rows of its
        slots (local rows in slot order run in identity mode); it returns
        their outputs, or None when it owns none."""
        if not t_prep and get_tracer().enabled:
            t_prep = now_ns()
        sl = np.asarray(slot_ids)
        if sl.ndim == 2:
            meta = sl.astype(np.int32)
        else:
            b = sl.shape[0]
            if do_reset is None:
                do_reset = np.zeros((b,), bool)
            if prefix_b is None:
                prefix_b = np.zeros((b, META_PREFIX), np.int32)
            cols = [slot_ids, stream_ids, wpos, cstart, n_req, do_dec, do_reset]
            meta = np.concatenate(
                [np.stack([np.asarray(c, np.int32) for c in cols], axis=1),
                 np.asarray(prefix_b, np.int32).reshape(b, META_PREFIX)],
                axis=1,
            )
        n_slots = self.max_slots
        if self.shard is not None:
            meta, frames_b = self._local_rows(meta, frames_b, audio_ring)
            if meta.shape[0] == 0:
                return None
            n_slots = self.shard.local
        identity = bool(meta.shape[0] == n_slots and np.array_equal(meta[:, 1], np.arange(n_slots)))
        if isinstance(frames_b, np.ndarray):
            from ...engine.audio_ring import pcm_to_wire

            frames_b = pcm_to_wire(frames_b)
        frames = torch.as_tensor(frames_b, device=self.device)
        meta_d = torch.as_tensor(meta, device=self.device)
        if self.device.type == "cuda":
            strict_fp32()
        with audio_ring._step_lock:
            with self._step_lock:
                return _stream_step(params, self.cfg, self, audio_ring, meta_d, frames, max_steps, n_chunks,
                                    identity, t_prep)

    def identity_step_fn(
        self,
        params: Params,
        audio_ring,
        trash_slot: int,
        max_steps: int,
        n_chunks: int = 2,
    ):
        """Batcher-ready fused-step closure in identity packing: submitted
        meta rows (host arrays) are scattered into slot order so batch row p
        is stream slot p. Gap rows are inert: their ring writes park on
        ``trash_slot`` and ``n_req = do_dec = do_reset = 0`` leaves absent
        sessions' state untouched.

        On a mesh every rank calls it with the same rows (the serving engine
        broadcasts them); each runs its dp share of the slots and the rows'
        outputs are all-gathered over dp (``trash_slot`` is ``-1``: each
        rank's own trash row). Its spans: ``stream.prep`` from the scatter
        into slot order, the step's own (:func:`_stream_step`), and
        ``stream.fetch``, the copy of the outputs to the host: the one place
        the call waits for the device."""
        from ...engine.audio_ring import pcm_to_wire

        n_slots = self.max_slots
        tracer = get_tracer()

        def batched_sstep(meta, frames):
            t_prep = now_ns() if tracer.enabled else 0
            perm = meta[:, 1].astype(np.int64)
            meta_s = np.zeros((n_slots, meta.shape[1]), np.int32)
            meta_s[:, 0] = trash_slot
            meta_s[:, 1] = np.arange(n_slots)
            frames_s = np.zeros((n_slots,) + frames.shape[1:], np.int16)
            meta_s[perm] = meta
            frames_s[perm] = pcm_to_wire(frames)
            out = self.step(params, audio_ring, meta_s, None, None, None, None, None, frames_s, max_steps,
                            n_chunks=n_chunks, t_prep=t_prep)
            with tracer.span("stream.fetch"):
                if self.shard is None:
                    probs, tok_rows, n_rows, pos_new = (o.cpu().numpy() for o in out)
                else:
                    from ...parallel.serving import gather_rows

                    probs, tok_rows, n_rows, pos_new = gather_rows(self.shard, *out)
            return probs[perm], tok_rows[perm], n_rows[perm], pos_new[perm]

        return batched_sstep

    # -- canonical views (tests / tools) -------------------------------------
    def cache_view(self, which: str):
        """A cache kind as host numpy in the ``[S, L, H, hd, T]`` view (int8
        kinds → ``(q8, scale [S, L, H, 1, T])``)."""
        cache = {"enc_k": self._enc_k, "enc_v": self._enc_v, "xk": self._xk, "xv": self._xv,
                 "dec_k": self._dec_k, "dec_v": self._dec_v}[which]
        if isinstance(cache, tuple):
            q8 = cache[0].cpu().numpy().transpose(1, 0, 2, 3, 4)
            sc = cache[1].cpu().numpy().transpose(1, 0, 2, 3)[:, :, :, None, :]
            return q8, sc
        return cache.float().cpu().numpy().transpose(1, 0, 2, 3, 4)


# process-wide tables keyed by model tag, device and mesh shard
_TABLES: Dict[tuple, StreamTable] = {}
_TABLES_LOCK = threading.Lock()


def get_stream_table(tag: str, cfg: WhisperConfig, dtype, device=None, mesh=None, **kw) -> StreamTable:
    """Process-wide table per model tag and device (and, with a ``mesh``,
    this rank's shard of it: a rank is never handed the unsharded table);
    ``kw`` (max_slots, enc_t, ...) applies only at first creation (the first
    creator sizes the table). A later conflicting request gets the existing
    table and a logged warning: too little capacity surfaces as
    ``try_alloc`` failures."""
    dev = resolve_device(device)
    key = (tag, str(dev))
    if mesh is not None:
        from ...parallel.mesh import mesh_coords

        key += (mesh_coords(mesh),)
    with _TABLES_LOCK:
        tbl = _TABLES.get(key)
        if tbl is None:
            tbl = StreamTable(cfg, dtype, device=dev, **kw)
            if mesh is not None:
                from ...parallel.serving import shard_stream_table

                shard_stream_table(mesh, tbl)
            _TABLES[key] = tbl
        else:
            got = {"max_slots": tbl.max_slots, "enc_t": tbl.enc_t, "dec_t": tbl.dec_t}
            diff = {k: v for k, v in kw.items() if k in got and v is not None and got[k] != v}
            if diff:
                logger.warning("stream table %s already sized %s; ignoring request %s (first creator wins)",
                               tag, got, diff)
        return tbl
