# SPDX-License-Identifier: Apache-2.0
"""Multi-device scaling: device meshes, the tensor-parallel layout, sharded
train and serve steps (port of ``streamkit_tpu/parallel``). One process per
rank of a ``torch.distributed`` group (:func:`run_ranks` spawns them on one
host); one device needs none of it."""

from .launch import run_ranks
from .mesh import (
    data_sharding,
    gather_params,
    make_mesh,
    seq2seq_param_sharding,
    shard_batch,
    shard_params,
    whisper_param_sharding,
)
from .train import (
    TrainState,
    init_train_state,
    loss_fn,
    make_optimizer,
    make_train_step,
    train_state_from_numpy,
)
