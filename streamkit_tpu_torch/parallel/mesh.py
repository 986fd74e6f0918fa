# SPDX-License-Identifier: Apache-2.0
"""Device mesh and the tensor-parallel layout (port of
``streamkit_tpu/parallel/mesh.py``).

The reference is one process that lays a ``(dp, tp)`` ``jax.sharding.Mesh``
over its devices, annotates shardings and lets XLA insert the collectives.
The port follows PyTorch's SPMD idiom: one process per rank (started by
:func:`.launch.run_ranks`), a ``torch.distributed`` ``DeviceMesh`` with the
reference's axis names, and plain local shards. Each rank holds its own
slice of every sharded leaf; the model helpers
(:mod:`..ops.tensor_parallel`) call the collectives at the Megatron points,
and the hand-written kernels run unchanged on each rank's own heads.

Axes: ``dp`` splits the batch (rows, serving slots), ``tp`` the heads, the
ffn width and the vocab. Layout rules (the reference's ``_spec_for_path`` and
``_seq2seq_spec_for_path``, with its ``_fits`` fallback to replication for a
dim that does not divide): q/k/v and mlp1/fc1 column-parallel, o and
mlp2/fc2 row-parallel, the embedding table split over its vocab axis. Two
differences, both of layout only (the results are the same):

* an attention block is split only where its **heads** divide by tp (local
  attention needs whole heads; the reference only needs the width to
  divide);
* Whisper's two encoder convolutions stay replicated (split, they would
  only add two all-gathers before the first layer).

A placement is ``Shard(d)`` (the leaf's dim ``d`` split over ``tp``) or
``Replicate()``; ``dp`` replicates every parameter.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor.placement_types import Replicate, Shard

from ..device import resolve_device
from ..models.whisper.config import WhisperConfig
from ..models.whisper.model import Params, build_params
from ..ops.tensor_parallel import TPShard, tp_of, whole_leaf

__all__ = [
    "make_mesh",
    "whisper_param_sharding",
    "seq2seq_param_sharding",
    "shard_params",
    "gather_params",
    "data_sharding",
    "shard_batch",
    "mesh_coords",
]


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, device=None) -> DeviceMesh:
    """A ``(dp, tp)`` mesh over the ranks of the initialised process group
    (call it on every rank). ``n_devices`` defaults to the world size and
    must equal it; ``device`` (default ``cuda``, which raises without a card)
    names the ranks' device type. The backend is the group's: NCCL where
    each rank has a card of its own, gloo for CPU ranks or ranks that share
    one card."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group on every rank (parallel.run_ranks)")
    n = n_devices or dist.get_world_size()
    if n % tp != 0:
        raise ValueError(f"n_devices {n} not divisible by tp {tp}")
    if n != dist.get_world_size():
        raise ValueError(f"the mesh spans the whole group: n_devices {n} != world size {dist.get_world_size()}")
    return init_device_mesh(dev.type, (n // tp, tp), mesh_dim_names=("dp", "tp"))


def mesh_coords(mesh: DeviceMesh):
    """``(dp_rank, dp, tp_rank, tp)`` of this process."""
    return (mesh.get_local_rank("dp"), mesh.size(0), mesh.get_local_rank("tp"), mesh.size(1))


# ---------------------------------------------------------------------------
# trees: Params modules, or nested dicts / lists of tensors (seq2seq)
# ---------------------------------------------------------------------------
def _items(tree, path=()):
    """``(path, leaf)`` pairs in the tree's order; a path is a tuple of keys
    (str) and list indices (int)."""
    if isinstance(tree, torch.nn.ModuleList) or isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, path + (i,))
    elif isinstance(tree, Params):
        for k, v in tree._parameters.items():
            yield path + (k,), v
        for k, v in tree._modules.items():
            yield from _items(v, path + (k,))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, path + (k,))
    else:
        yield path, tree


def _map(tree, fn, path=()):
    """The tree's structure as nested dicts and lists, each leaf ``fn(path,
    leaf)``."""
    if isinstance(tree, torch.nn.ModuleList) or isinstance(tree, (list, tuple)):
        return [_map(v, fn, path + (i,)) for i, v in enumerate(tree)]
    if isinstance(tree, Params):
        out = {k: fn(path + (k,), v) for k, v in tree._parameters.items()}
        out.update({k: _map(v, fn, path + (k,)) for k, v in tree._modules.items()})
        return out
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _leaf_at(tree, path):
    for p in path:
        tree = tree[p] if not isinstance(tree, Params) else getattr(tree, p)
    return tree


# ---------------------------------------------------------------------------
# layout rules
# ---------------------------------------------------------------------------
def _whisper_spec(path) -> object:
    names, is_w = set(path), path[-1] == "w"
    if names & {"q", "k", "v", "mlp1"}:  # column-parallel; the bias follows the outputs
        return Shard(1) if is_w else Shard(0)
    if names & {"o", "mlp2"}:  # row-parallel; the bias is added once, whole
        return Shard(0) if is_w else Replicate()
    if "tok_emb" in names:
        return Shard(0)  # vocab axis
    return Replicate()  # convolutions, layernorms, positions


def _seq2seq_spec(path) -> object:
    names, is_w, last = set(path), path[-1] == "w", path[-1]
    if names & {"q", "k", "v", "fc1"}:
        return Shard(1) if is_w else Shard(0)
    if names & {"o", "fc2"}:
        return Shard(0) if is_w else Replicate()
    if last in ("emb", "logits_bias"):  # the tied table and its bias: vocab axis
        return Shard(0)
    return Replicate()  # positions, layernorms


def _fits(spec, shape, tp: int) -> bool:
    return not isinstance(spec, Shard) or (spec.dim < len(shape) and shape[spec.dim] % tp == 0)


def _sharding(mesh: DeviceMesh, params, rule, heads_of):
    tp = mesh.size(1)

    def place(path, leaf):
        spec = rule(path)
        if ("attn" in path or "xattn" in path) and heads_of(path) % tp != 0:
            spec = Replicate()  # local attention needs whole heads
        return spec if _fits(spec, tuple(np.shape(leaf)), tp) else Replicate()

    return _map(params, place)


def whisper_param_sharding(mesh: DeviceMesh, params, cfg: WhisperConfig):
    """A placement per leaf of a Whisper parameter tree, as nested dicts and
    lists under the reference's paths (``["enc"]["layers"][0]["attn"]["q"]
    ["w"]``). ``cfg`` gives the head counts."""
    return _sharding(mesh, params, _whisper_spec,
                     lambda path: cfg.n_audio_head if path[0] == "enc" else cfg.n_text_head)


def seq2seq_param_sharding(mesh: DeviceMesh, params, cfg):
    """A placement per leaf of a Marian / NLLB parameter tree (the same
    fallback to replication); ``cfg.heads`` is the head count."""
    return _sharding(mesh, params, _seq2seq_spec, lambda path: cfg.heads)


def _local(leaf: torch.Tensor, spec, tp: int, tp_rank: int) -> torch.Tensor:
    if not isinstance(spec, Shard) or tp == 1:
        return leaf.detach().clone()
    return leaf.detach().chunk(tp, dim=spec.dim)[tp_rank].clone()


def _place(mesh: DeviceMesh, params, placements):
    """This rank's local copy of ``params`` under ``placements`` (a tree of
    the same shape, as :func:`whisper_param_sharding` gives): each split leaf
    keeps its block and records its placement (``leaf._tp``). A ``Params``
    tree gives a ``Params`` tree (``requires_grad`` kept), a dict tree a dict
    tree. At tp = 1 every leaf stays whole and unmarked."""
    _, _, tp_rank, tp = mesh_coords(mesh)
    group = mesh.get_group("tp")
    local = _map(params, lambda path, leaf: _local(leaf, _leaf_at(placements, path), tp, tp_rank))
    out = build_params(local) if isinstance(params, Params) else local
    for path, leaf in _items(out):
        src = _leaf_at(params, path)
        if isinstance(out, Params):
            leaf.requires_grad_(src.requires_grad)
        spec = _leaf_at(placements, path)
        if isinstance(spec, Shard) and tp > 1:
            leaf._tp = TPShard(spec.dim, group, tp, tp_rank)
    return out


def shard_params(mesh: DeviceMesh, params, cfg):
    """This rank's local Whisper (``cfg`` a :class:`WhisperConfig`) or Marian
    / NLLB parameters under the layout rules of the module docstring."""
    if isinstance(cfg, WhisperConfig):
        return _place(mesh, params, whisper_param_sharding(mesh, params, cfg))
    return _place(mesh, params, seq2seq_param_sharding(mesh, params, cfg))


def gather_params(params):
    """The whole tree from a local one (every rank of each tp group gets it):
    each split leaf is all-gathered along its dim, nothing is marked. The
    inverse of :func:`shard_params`; a tree with no split leaf comes back as
    copies."""

    def whole(path, leaf):
        tp = tp_of(leaf)
        return leaf.detach().clone() if tp is None else whole_leaf(leaf, tp)

    out = _map(params, whole)
    if isinstance(params, Params):
        out = build_params(out)
        for path, leaf in _items(out):
            leaf.requires_grad_(_leaf_at(params, path).requires_grad)
    return out


def data_sharding(mesh: DeviceMesh, n_rows: int) -> slice:
    """This dp rank's rows of an ``n_rows`` batch (rows over ``dp``,
    replicated over ``tp``: the reference's ``P("dp")``)."""
    dp_rank, dp, _, _ = mesh_coords(mesh)
    if n_rows % dp != 0:
        raise ValueError(f"batch of {n_rows} rows does not divide over dp = {dp}")
    per = n_rows // dp
    return slice(dp_rank * per, (dp_rank + 1) * per)


def shard_batch(mesh: DeviceMesh, *arrays):
    """Each array's rows of this dp rank (:func:`data_sharding`)."""
    return tuple(a[data_sharding(mesh, a.shape[0])] for a in arrays)
