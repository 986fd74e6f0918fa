# SPDX-License-Identifier: Apache-2.0
"""Whisper fine-tuning on one device (port of ``streamkit_tpu/parallel``'s
``train.py``). The reference's mesh, shardings and sharded serving state
(``mesh.py``, ``serving.py``) are not ported yet."""

from .train import (
    TrainState,
    init_train_state,
    loss_fn,
    make_optimizer,
    make_train_step,
    train_state_from_numpy,
)
