# SPDX-License-Identifier: Apache-2.0
"""Sharded serving state (port of ``streamkit_tpu/parallel/serving.py``): the
streaming STT state and the Whisper weights laid over a ``(dp, tp)`` mesh so
the fused per-block stream step runs on every rank's own shard.

Layout, as the reference's:

* **weights**: tensor parallel per :func:`.mesh.whisper_param_sharding`;
* **KV caches** ``[L, S, H, hd, T]``: session slots (axis 1) over ``dp`` and
  heads over ``tp``, so each rank holds ``[L, S/dp, H/tp, hd, T]`` and the
  windowed-write and history-attention kernels launch on local shapes;
* **audio rings and VAD state** ``[S, ...]``: slots over ``dp``. Each dp
  rank also keeps a trash row of its own (the identity-packed step parks
  its inert rows there);
* **batched step inputs**: rows over ``dp``. A row runs on the dp rank that
  owns its slot.

The reference resolves a row's slot against the split axis with XLA's
gather-with-collectives. The port routes rows instead: every rank sees the
whole batch (the engine broadcasts it), takes the rows of its slots, runs
them, and the outputs are all-gathered over ``dp``
(:meth:`..models.whisper.streaming.StreamTable.identity_step_fn`,
:func:`dp_row_call`). One device stays as it was: sharding is opt-in.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .mesh import mesh_coords, shard_params

__all__ = [
    "SlotShard",
    "shard_serving_state",
    "shard_stream_table",
    "shard_audio_ring",
    "serving_input_shardings",
    "dp_row_call",
    "gather_rows",
]


@dataclass(frozen=True)
class SlotShard:
    """This rank's share of a slot table: slots ``[rank·local, (rank+1)·local)``
    of ``size·local``, dp group ``group``."""

    rank: int
    size: int
    local: int
    group: object

    def owner(self, slot):
        return np.asarray(slot) // self.local


def _dp_shard(mesh, n_slots: int, what: str) -> SlotShard:
    dp_rank, dp, _, _ = mesh_coords(mesh)
    if n_slots % dp != 0:
        raise ValueError(f"{what} of {n_slots} slots does not divide over dp = {dp}")
    return SlotShard(dp_rank, dp, n_slots // dp, mesh.get_group("dp"))


def _split(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    return x.chunk(n, dim=dim)[i].contiguous() if n > 1 else x


def shard_stream_table(mesh, table) -> None:
    """Reshard a :class:`~..models.whisper.streaming.StreamTable` in place to
    this rank's ``[L, S/dp, H/tp, hd, T]`` caches and ``S/dp`` slot vectors.
    A cache's heads are split only where its attention block's heads divide
    by tp (the weights' rule). The slot allocator stays global (``S``)."""
    cfg = table.cfg
    dp_rank, dp, tp_rank, tp = mesh_coords(mesh)
    sh = _dp_shard(mesh, table.max_slots, "stream table")
    ta = tp if cfg.n_audio_head % tp == 0 else 1
    tt = tp if cfg.n_text_head % tp == 0 else 1

    def local(cache, t_split):
        if isinstance(cache, tuple):  # int8: (q8 [L,S,H,hd,T], scale [L,S,H,T])
            return tuple(local(c, t_split) for c in cache)
        x = _split(cache, 1, dp, dp_rank)
        return _split(x, 2, t_split, tp_rank if t_split > 1 else 0)

    table._enc_k = local(table._enc_k, ta)
    table._enc_v = local(table._enc_v, ta)
    table._xk = local(table._xk, tt)
    table._xv = local(table._xv, tt)
    table._dec_k = local(table._dec_k, tt)
    table._dec_v = local(table._dec_v, tt)
    for name in ("_tokens", "_fed", "_n_tok", "_enc_pos"):
        setattr(table, name, _split(getattr(table, name), 0, dp, dp_rank))
    table.shard = sh


def shard_audio_ring(mesh, ring) -> None:
    """Reshard a :class:`~..engine.audio_ring.SessionAudioRing` in place: this
    rank's ``S/dp`` slots plus a trash row of its own (local row ``S/dp``).
    Slot ids stay global."""
    dp_rank, dp, _, _ = mesh_coords(mesh)
    sh = _dp_shard(mesh, ring.max_slots, "audio ring")
    with ring._step_lock:
        ring._ring = torch.cat([_split(ring._ring, 0, dp, dp_rank), ring._ring[:1] * 0])
        ring._vad_state = type(ring._vad_state)(
            *(torch.cat([_split(s, 0, dp, dp_rank), r[None]]) for s, r in zip(ring._vad_state, ring._init_row))
        )
        ring.shard = sh


def shard_serving_state(mesh, params, table=None, ring=None, cfg=None):
    """Whisper weights (tensor parallel; ``cfg`` defaults to the table's) and,
    when given, the stream table and the audio ring (slots over dp, heads
    over tp) onto ``mesh``. Returns the local params; the table and the ring
    are resharded in place."""
    cfg = cfg or (table.cfg if table is not None else None)
    if cfg is None:
        raise ValueError("shard_serving_state needs cfg when no table is given")
    params = shard_params(mesh, params, cfg)
    if table is not None:
        shard_stream_table(mesh, table)
    if ring is not None:
        shard_audio_ring(mesh, ring)
    return params


def serving_input_shardings(mesh, n_rows: int):
    """(meta rows, frames rows) of this dp rank in a slot-ordered batch of
    ``n_rows``: the reference's ``P("dp", None)`` and ``P("dp", None,
    None)``."""
    sh = _dp_shard(mesh, n_rows, "batch")
    rows = slice(sh.rank * sh.local, (sh.rank + 1) * sh.local)
    return rows, rows


def gather_rows(shard: SlotShard, *outs: torch.Tensor):
    """All-gather per-dp-rank row blocks (equal leading sizes) over dp → host
    numpy arrays whose rows are the dp ranks' blocks in order. 4-byte
    outputs travel bit for bit in one f32 buffer."""
    n = outs[0].shape[0]
    flat = [o.reshape(n, -1).contiguous() for o in outs]
    packed = torch.cat([f.view(torch.float32) if f.dtype != torch.float32 else f for f in flat], dim=1)
    if shard.size > 1:
        parts = [torch.empty_like(packed) for _ in range(shard.size)]
        dist.all_gather(parts, packed, group=shard.group)
        packed = torch.cat(parts)
    host = packed.cpu().numpy()
    res, c = [], 0
    for o, f in zip(outs, flat):
        w = f.shape[1]
        block = host[:, c:c + w]
        if o.dtype != torch.float32:
            block = np.ascontiguousarray(block).view(str(o.dtype).replace("torch.", ""))
        res.append(block.reshape((host.shape[0],) + tuple(o.shape[1:])))
        c += w
    return tuple(res)


def dp_row_call(ring, fn, slot_ids, *row_args):
    """Run ``fn(local_slots, *rows)`` on the dp rank that owns each row's
    audio-ring slot; every tp rank of that group runs it. Each dp rank pads
    its rows to the largest share with its trash row (and the batch's first
    row's other inputs), so the outputs gather in one all-gather.
    ``slot_ids`` and ``row_args`` are host arrays of B rows (every rank
    passes the same ones); ``fn`` returns ``[b, ...]`` device tensors of
    4-byte types. Returns host numpy outputs in row order."""
    sh = ring.shard
    slot_ids = np.asarray(slot_ids)
    owner = sh.owner(slot_ids)
    width = int(np.bincount(owner, minlength=sh.size).max())
    mine = np.flatnonzero(owner == sh.rank)
    pad = width - mine.size
    local = np.concatenate([slot_ids[mine] - sh.rank * sh.local, np.full(pad, sh.local, slot_ids.dtype)])
    rows = [np.concatenate([np.asarray(a)[mine], np.repeat(np.asarray(a)[:1], pad, axis=0)]) for a in row_args]
    outs = fn(local, *rows)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gathered = gather_rows(sh, *outs)
    res = []
    for g in gathered:
        g = g.reshape((sh.size, width) + g.shape[1:])
        full = np.empty((slot_ids.shape[0],) + g.shape[2:], g.dtype)
        for d in range(sh.size):
            idx = np.flatnonzero(owner == d)
            full[idx] = g[d, :idx.size]
        res.append(full)
    return tuple(res)
