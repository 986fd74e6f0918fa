# SPDX-License-Identifier: Apache-2.0
"""Tensor-parallel collectives for the model code (Megatron's layout).

The JAX package annotates shardings and lets XLA insert the collectives. The
port runs one process per rank on plain local shards
(:func:`..parallel.mesh.shard_params`), so the model helpers call the
collectives themselves at the Megatron points:

* a column-parallel product (q/k/v, mlp1, fc1, the vocab-sharded logits)
  takes its input through :func:`copy_to_tp`: identity forward, all-reduce of
  the input's gradient backward;
* a row-parallel product (o, mlp2, fc2) and the vocab-sharded embedding sum
  their partial outputs through :func:`reduce_from_tp`: all-reduce forward,
  identity backward. ``torch.distributed.nn``'s all-reduce would all-reduce
  the gradient again and multiply a replicated gradient by tp;
* the vocab-sharded logits are put together by :func:`gather_from_tp`:
  all-gather along the last dim forward, this rank's slice backward.

Half-precision partial sums are reduced in f32 and rounded once. A local
leaf carries its placement as ``leaf._tp`` (:class:`TPShard`); a leaf
without one is whole, and every helper then takes the one-device path.
``collectives`` counts the collectives issued here, by kind.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["TPShard", "tp_of", "copy_to_tp", "reduce_from_tp", "gather_from_tp", "tp_matmul", "embed_rows",
           "project_vocab", "whole_leaf", "collectives"]

collectives = {"all_reduce": 0, "all_gather": 0}


@dataclass(frozen=True)
class TPShard:
    """A leaf split over the ``tp`` ranks of ``group`` along ``dim`` (the
    leaf holds block ``rank`` of ``size``)."""

    dim: int
    group: object
    size: int
    rank: int


def tp_of(t) -> Optional[TPShard]:
    """The placement a local leaf was given, or None for a whole leaf."""
    return getattr(t, "_tp", None)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    collectives["all_reduce"] += 1
    if x.dtype in (torch.bfloat16, torch.float16):
        y = x.float()
        dist.all_reduce(y, group=group)
        return y.to(x.dtype)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


def _all_gather(x: torch.Tensor, tp: TPShard, dim: int) -> torch.Tensor:
    collectives["all_gather"] += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x, group=tp.group)
    return torch.cat(parts, dim=dim)


def whole_leaf(x: torch.Tensor, tp: TPShard) -> torch.Tensor:
    """A leaf's (or its gradient's, or its optimizer moment's) local block
    ``x`` gathered whole over the tp ranks."""
    return _all_gather(x.detach(), tp, tp.dim)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_gather(x, tp, -1)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1] // ctx.tp.size
        return g[..., ctx.tp.rank * n:(ctx.tp.rank + 1) * n].contiguous(), None


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_tp(x: torch.Tensor, tp: TPShard) -> torch.Tensor:
    """The input of a column-parallel product (see the module docstring)."""
    return _CopyToTP.apply(x, tp.group) if _needs_grad(x) else x


def reduce_from_tp(x: torch.Tensor, tp: TPShard) -> torch.Tensor:
    """Sum the partial outputs of a row-parallel product over the tp ranks."""
    return _ReduceFromTP.apply(x, tp.group) if _needs_grad(x) else _all_reduce(x, tp.group)


def gather_from_tp(x: torch.Tensor, tp: TPShard) -> torch.Tensor:
    """Concatenate every tp rank's slice of the last dim."""
    return _GatherFromTP.apply(x, tp) if _needs_grad(x) else _all_gather(x, tp, -1)


def tp_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a ``[d_in, d_out]`` weight that is whole, column-parallel
    (split along ``d_out``: the input is copied to tp) or row-parallel (split
    along ``d_in``: the partial products are summed over tp). A caller adds
    its bias after: a column-parallel bias is split with the outputs, a
    row-parallel one is whole and added once."""
    tp = tp_of(w)
    if tp is None:
        return torch.matmul(x, w)
    if tp.dim == 1:
        return torch.matmul(copy_to_tp(x, tp), w)
    return reduce_from_tp(torch.matmul(x, w), tp)


def project_vocab(x: torch.Tensor, emb: torch.Tensor, fn) -> torch.Tensor:
    """``fn(x, emb)``, the logits over a tied ``[vocab, d]`` table: on the
    whole table, or on this rank's vocab block (``x`` copied to tp) with the
    blocks gathered along the last dim."""
    tp = tp_of(emb)
    if tp is None:
        return fn(x, emb)
    return gather_from_tp(fn(copy_to_tp(x, tp), emb), tp)


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)`` for a whole or a vocab-sharded table: each
    rank looks up the ids in its block (zeros elsewhere), and the blocks are
    summed over tp (one non-zero term per row, so the sum is exact)."""
    tp = tp_of(table)
    if tp is None:
        return torch.nn.functional.embedding(ids, table)
    rows = table.shape[0]
    local = ids - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    emb = torch.nn.functional.embedding(torch.where(inside, local, 0), table)
    return reduce_from_tp(torch.where(inside[..., None], emb, torch.zeros((), dtype=emb.dtype, device=emb.device)),
                          tp)
