# SPDX-License-Identifier: Apache-2.0
"""Whisper fine-tune step: teacher-forced cross entropy on the decoder,
gradients, then an AdamW update.

Port of ``streamkit_tpu/parallel/train.py``. The reference jits one
functional ``train_step`` over sharded params; here PyTorch runs it eagerly
and the optimizer updates the params **in place**, so
:class:`TrainState` carries the :class:`~..models.whisper.model.Params`
module and the ``torch.optim.AdamW`` that owns its moments. ``step``
counts as the reference's does. On CUDA every attention that the model's
flash gate sends to K1 is differentiated by K1's backward kernels
(``ops/attention.py`` :class:`~..ops.attention.FlashAttention`).

On a ``(dp, tp)`` mesh (``make_train_step(cfg, mesh=)``, params from
:func:`.mesh.shard_params`, each dp rank on its rows of the batch) each
rank's loss is its rows' ``sum(nll·mask)`` over the batch's global
``max(sum(mask), 1)``; the gradients are summed over dp. A replicated leaf
needs no sum over tp: the model's Megatron collectives leave it the same
gradient on every tp rank. AdamW then runs on each rank's local shards,
which is exact: it works element by element. The reported loss is the
global one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.whisper.config import WhisperConfig
from ..models.whisper.load import params_from_numpy
from ..models.whisper.model import Params, decode_logits, encode

__all__ = [
    "TrainState",
    "make_optimizer",
    "init_train_state",
    "loss_fn",
    "make_train_step",
    "train_state_from_numpy",
]


class TrainState(NamedTuple):
    params: Params
    opt_state: torch.optim.AdamW  # holds each leaf's step, mu and nu
    step: int


def make_optimizer(params: Params, lr: float = 1e-4, weight_decay: float = 0.01) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=...)``: the update
    ``-lr·(m̂/(√v̂ + ε) + wd·p)`` with b1 0.9, b2 0.999, ε 1e-8 and decay on
    every leaf (optax's ``mask=None``)."""
    return torch.optim.AdamW(params.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def init_train_state(params: Params, lr: float = 1e-4) -> TrainState:
    """Turn on ``requires_grad`` for every leaf (the trainer trains them all,
    as the reference differentiates the whole tree) and start AdamW."""
    for p in params.parameters():
        p.requires_grad_(True)
    return TrainState(params=params, opt_state=make_optimizer(params, lr), step=0)


def _dp_group(mesh):
    return mesh.get_group("dp") if mesh is not None and mesh.size(0) > 1 else None


def loss_fn(params: Params, cfg: WhisperConfig, mel, tokens_in, tokens_out, mask, mesh=None) -> torch.Tensor:
    """Teacher-forced cross entropy over the decoder: log-softmax of the f32
    logits, the masked mean over ``max(sum(mask), 1)``. On a ``mesh`` the
    rows are this dp rank's and the count is the whole batch's (summed over
    dp, outside the gradient): the ranks' losses add up to the batch's."""
    audio_states = encode(params, cfg, mel)
    logits = decode_logits(params, cfg, tokens_in.long(), audio_states)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens_out.long()[..., None])[..., 0]
    count = torch.sum(mask)
    group = _dp_group(mesh)
    if group is not None:
        count = count.detach().clone()
        dist.all_reduce(count, group=group)
    return torch.sum(nll * mask) / torch.clamp(count, min=1.0)


def _sum_grads(params: Params, group) -> None:
    """Sum every gradient over ``group``, one all-reduce per dtype."""
    grads = [p.grad for p in params.parameters() if p.grad is not None]
    for dtype in {g.dtype for g in grads}:
        same = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=group)
        for g, part in zip(same, flat.split([g.numel() for g in same])):
            g.copy_(part.view_as(g))


def make_train_step(cfg: WhisperConfig, lr: float = 1e-4, mesh=None):
    """Returns ``train_step(state, mel, tokens_in, tokens_out, mask) ->
    (state, loss)``: the loss and its gradients, then one AdamW update at
    ``lr`` in place on ``state.params``. The returned state shares the
    params and the optimizer with the one passed in. On CUDA the steps
    repeat bit for bit only under ``torch.backends.cudnn.deterministic``
    (``utils/checkpoint.py`` says why); the step does not set it. With a
    ``mesh``, every rank calls it on its local state and its dp rows (module
    docstring); the loss returned is the batch's."""
    group = _dp_group(mesh)

    def train_step(state: TrainState, mel, tokens_in, tokens_out, mask):
        opt = state.opt_state
        for g in opt.param_groups:
            g["lr"] = lr
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, cfg, mel, tokens_in, tokens_out, mask, mesh)
        loss.backward()
        loss = loss.detach()
        if group is not None:
            _sum_grads(state.params, group)
            loss = loss.clone()
            dist.all_reduce(loss, group=group)
        opt.step()
        return TrainState(state.params, opt, state.step + 1), loss

    return train_step


def train_state_from_numpy(params_tree, mu_tree, nu_tree, count: int, cfg: WhisperConfig, lr: float = 1e-4,
                           device=None) -> TrainState:
    """The reference's f32 ``TrainState`` as numpy → the port's, on
    ``device`` (default ``cuda``): the params (through ``params_from_numpy``)
    and optax's ``ScaleByAdamState`` (``mu``, ``nu``: trees of the params'
    layout; ``count``: its step count) as each leaf's AdamW ``exp_avg``,
    ``exp_avg_sq`` and ``step``. ``step`` is ``count``."""
    dev = resolve_device(device)
    state = init_train_state(params_from_numpy(params_tree, cfg, device=dev), lr)
    mu = dict(params_from_numpy(mu_tree, cfg, device=dev).named_parameters())
    nu = dict(params_from_numpy(nu_tree, cfg, device=dev).named_parameters())
    for name, p in state.params.named_parameters():
        if mu[name].shape != p.shape or nu[name].shape != p.shape:
            raise ValueError(f"optimizer state for {name} does not match its parameter {tuple(p.shape)}")
        state.opt_state.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name].detach(),
            "exp_avg_sq": nu[name].detach(),
        }
    return state._replace(step=int(count))
