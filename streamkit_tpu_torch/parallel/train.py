# SPDX-License-Identifier: Apache-2.0
"""Whisper fine-tune step: teacher-forced cross entropy on the decoder,
gradients, then an AdamW update.

Port of ``streamkit_tpu/parallel/train.py`` for one device. The reference
jits one functional ``train_step`` over sharded params; here PyTorch runs
it eagerly and the optimizer updates the params **in place**, so
:class:`TrainState` carries the :class:`~..models.whisper.model.Params`
module and the ``torch.optim.AdamW`` that owns its moments. ``step``
counts as the reference's does. On CUDA every attention that the model's
flash gate sends to K1 is differentiated by K1's backward kernels
(``ops/attention.py`` :class:`~..ops.attention.FlashAttention`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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


def loss_fn(params: Params, cfg: WhisperConfig, mel, tokens_in, tokens_out, mask) -> torch.Tensor:
    """Teacher-forced cross entropy over the decoder: log-softmax of the f32
    logits, the masked mean over ``max(sum(mask), 1)``."""
    audio_states = encode(params, cfg, mel)
    logits = decode_logits(params, cfg, tokens_in.long(), audio_states)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens_out.long()[..., None])[..., 0]
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def make_train_step(cfg: WhisperConfig, lr: float = 1e-4):
    """Returns ``train_step(state, mel, tokens_in, tokens_out, mask) ->
    (state, loss)``: the loss and its gradients, then one AdamW update at
    ``lr`` in place on ``state.params``. The returned state shares the
    params and the optimizer with the one passed in. On CUDA the steps
    repeat bit for bit only under ``torch.backends.cudnn.deterministic``
    (``utils/checkpoint.py`` says why); the step does not set it."""

    def train_step(state: TrainState, mel, tokens_in, tokens_out, mask):
        opt = state.opt_state
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, cfg, mel, tokens_in, tokens_out, mask)
        loss.backward()
        opt.step()
        return TrainState(state.params, opt, state.step + 1), loss.detach()

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
