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
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Optional

import torch

from ..models.whisper.model import Params

__all__ = ["save_params", "load_params", "latest_step", "save_train_state", "load_train_state"]

_FILE = "checkpoint.pt"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def _save(directory: str, step: int, data: dict) -> str:
    path = _step_dir(directory, step)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{_FILE}.{os.getpid()}.tmp")
    torch.save(data, tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


def _load(directory: str, step: Optional[int]) -> dict:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return torch.load(os.path.join(_step_dir(directory, step), _FILE), map_location="cpu", weights_only=True)


def _flat(params: Params) -> Dict[str, torch.Tensor]:
    return {name: p.detach().cpu() for name, p in params.named_parameters()}


def _restore(template: Params, flat: Dict[str, torch.Tensor]) -> Params:
    """A copy of ``template`` (its structure, each leaf's dtype, device and
    ``requires_grad``) holding the leaves of ``flat``. ``load_state_dict``
    raises ``RuntimeError`` on a missing, extra or misshapen leaf."""
    params = copy.deepcopy(template)
    params.load_state_dict(flat)
    return params


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
    return _save(directory, s, {"params": _flat(state.params), "optimizer": state.opt_state.state_dict(),
                                "step": int(state.step)})


def load_train_state(directory: str, template_state, step: Optional[int] = None):
    """Restore a train state into ``template_state``'s structure, dtypes and
    devices: new params, and a new AdamW (``make_optimizer``) that holds the
    saved settings, moments and step counts."""
    from ..parallel.train import TrainState, make_optimizer

    data = _load(directory, step)
    params = _restore(template_state.params, data["params"])
    opt = make_optimizer(params)
    opt.load_state_dict(data["optimizer"])
    return TrainState(params=params, opt_state=opt, step=int(data["step"]))
