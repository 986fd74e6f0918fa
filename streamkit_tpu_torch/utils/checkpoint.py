# SPDX-License-Identifier: Apache-2.0
"""Model and train-state checkpoints.

Port of ``streamkit_tpu/utils/checkpoint.py`` with its layout
(``directory/step_N``) and names. The reference writes orbax checkpoints;
orbax is not on the card's machine, so the format is the port's own: each
``step_N`` holds one ``checkpoint.pt``, a ``torch.save`` of
``{"params": {path: tensor}}`` (paths as ``named_parameters`` gives them,
e.g. ``enc.layers.3.attn.q.w``), plus ``"optimizer"`` (the AdamW
``state_dict``) and ``"step"`` for a train state. Reading an orbax directory
written by the reference is not supported.

Resuming repeats the steps bit for bit (2 steps, save, load, 1 step equals
3 steps straight) on the CPU, and on CUDA only with
``torch.backends.cudnn.deterministic = True``: otherwise cuDNN's
algorithms for the backward of the encoder's two convolutions may sum in a
different order from one run to the next, and the gradients differ in the
last bits. The trainer leaves that process-wide setting to the caller (it
can slow the convolutions' backward); K1's backward kernels sum in a fixed
order either way.

On a mesh (params from :func:`..parallel.mesh.shard_params`; every rank
of the process group calls the function) the savers gather each split leaf
and its AdamW moments over tp and rank 0 writes the same ``checkpoint.pt``
as one device; the loaders read it on every rank and keep each rank's block
of the template's placement. So a checkpoint moves both ways between one
device and a mesh.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..models.whisper.model import Params
from ..ops.tensor_parallel import tp_of, whole_leaf

__all__ = ["save_params", "load_params", "latest_step", "save_train_state", "load_train_state"]

_FILE = "checkpoint.pt"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def _on_group() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _save(directory: str, step: int, data: dict) -> str:
    """Write ``data`` (rank 0 only in a process group; every rank returns
    once it is on disk)."""
    path = _step_dir(directory, step)
    if not _on_group() or dist.get_rank() == 0:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, f"{_FILE}.{os.getpid()}.tmp")
        torch.save(data, tmp)
        os.replace(tmp, os.path.join(path, _FILE))
    if _on_group():
        dist.barrier()
    return path


def _whole(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a local leaf, or a moment of one) gathered over tp by the
    placement of ``like``, on the CPU."""
    tp = tp_of(like)
    return (x.detach() if tp is None else whole_leaf(x, tp)).cpu()


def _block(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's block of a whole ``x`` under ``like``'s placement."""
    tp = tp_of(like)
    return x if tp is None else x.chunk(tp.size, dim=tp.dim)[tp.rank].clone()


def _load(directory: str, step: Optional[int]) -> dict:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return torch.load(os.path.join(_step_dir(directory, step), _FILE), map_location="cpu", weights_only=True)


def _flat(params: Params) -> Dict[str, torch.Tensor]:
    return {name: _whole(p, p) for name, p in params.named_parameters()}


def _restore(template: Params, flat: Dict[str, torch.Tensor]) -> Params:
    """A copy of ``template`` (its structure, each leaf's dtype, device,
    ``requires_grad`` and placement) holding the leaves of ``flat`` (whole;
    each keeps the template leaf's block). ``load_state_dict`` raises
    ``RuntimeError`` on a missing, extra or misshapen leaf."""
    leaves = dict(template.named_parameters())
    params = copy.deepcopy(template)
    params.load_state_dict({k: _block(v, leaves[k]) if k in leaves else v for k, v in flat.items()})
    for name, p in params.named_parameters():
        if tp_of(leaves[name]) is not None:
            p._tp = tp_of(leaves[name])
    return params


def _moments(opt_state: dict, params: Params, convert) -> dict:
    """An AdamW ``state_dict`` with each tensor moment passed through
    ``convert(moment, its param)`` (the state is keyed by parameter index)."""
    leaves = list(params.parameters())
    state = {i: {k: convert(v, leaves[i]) if torch.is_tensor(v) and v.dim() else v for k, v in s.items()}
             for i, s in opt_state["state"].items()}
    return {**opt_state, "state": state}


def save_params(directory: str, params: Params, step: int = 0) -> str:
    """Save a parameter tree under ``directory/step_N``; returns the path."""
    return _save(directory, step, {"params": _flat(params)})


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_", 1)[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and d.split("_", 1)[1].isdigit()
    ]
    return max(steps) if steps else None


def load_params(directory: str, template: Params, step: Optional[int] = None) -> Params:
    """Restore a parameter tree (the latest step when ``step`` is None) into
    ``template``'s structure, dtypes and devices. Raises
    ``FileNotFoundError`` when there is no checkpoint."""
    return _restore(template, _load(directory, step)["params"])


def save_train_state(directory: str, state, step: Optional[int] = None) -> str:
    """Save a :class:`~..parallel.train.TrainState` (params, the AdamW
    state and the step) under ``directory/step_N`` (N = ``state.step``)."""
    s = int(state.step) if step is None else step
    opt = _moments(state.opt_state.state_dict(), state.params, _whole)
    return _save(directory, s, {"params": _flat(state.params), "optimizer": opt, "step": int(state.step)})


def load_train_state(directory: str, template_state, step: Optional[int] = None):
    """Restore a train state into ``template_state``'s structure, dtypes and
    devices: new params, and a new AdamW (``make_optimizer``) that holds the
    saved settings, moments and step counts."""
    from ..parallel.train import TrainState, make_optimizer

    data = _load(directory, step)
    params = _restore(template_state.params, data["params"])
    opt = make_optimizer(params)
    opt.load_state_dict(_moments(data["optimizer"], params, _block))
    return TrainState(params=params, opt_state=opt, step=int(data["step"]))
