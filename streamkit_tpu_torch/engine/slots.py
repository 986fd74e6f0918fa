# SPDX-License-Identifier: Apache-2.0
"""Device-resident session state tables.

Port of ``streamkit_tpu/engine/slots.py``. Recurrent per-session state
(resampler phase and history, …) lives in a dict of tensors of shape
``[max_slots, ...]`` on one device; a batched step gathers the submitting sessions' rows,
applies the function, and writes the new rows back in place, all on the
device, so per-session state never crosses to the host after allocation.
The reference donates the state buffers to one jitted call; here the rows
are gathered with ``index_select`` and written back with ``index_copy_``
under the step lock.

Collision rule: one batch must not hold the same slot twice. A CUDA
``index_copy_`` with repeated indices writes in no defined order, so a step
refuses such a batch. The batcher keeps to the rule when the kind is
registered with ``host_inputs=True`` (no padding rows) and a session awaits
its result before it submits again.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["SlotTable"]


Rows = Dict[str, torch.Tensor]


class SlotTable:
    """A pool of device-resident state rows keyed by slot index."""

    def __init__(self, init_row_fn: Callable[[], Rows], max_slots: int = 256, device=None) -> None:
        """``init_row_fn() -> {name: tensor}``: one session's state (no batch
        dim). The rows live on ``device`` (default ``cuda``, which raises
        without a card)."""
        self.device = resolve_device(device)
        self.max_slots = max_slots
        self._init_row = {k: torch.as_tensor(x).to(self.device) for k, x in init_row_fn().items()}
        # state: [max_slots, ...] per field, every row the initial row
        self._state = {k: x.unsqueeze(0).expand((max_slots,) + tuple(x.shape)).clone()
                       for k, x in self._init_row.items()}
        self._free: List[int] = list(range(max_slots - 1, -1, -1))
        self._lock = threading.Lock()
        # steps write the state in place: serialize them
        self._step_lock = threading.Lock()

    # -- slot lifecycle ---------------------------------------------------------
    def alloc(self) -> int:
        """Acquire a slot; its row is reset on acquire (so stray writes to
        unallocated slots can't leak state)."""
        with self._lock:
            if not self._free:
                raise RuntimeError(f"slot table exhausted ({self.max_slots} slots)")
            slot = self._free.pop()
        with self._step_lock, torch.no_grad():
            for k, s in self._state.items():
                s[slot].copy_(self._init_row[k])
        return slot

    def free(self, slot: int) -> None:
        with self._lock:
            self._free.append(slot)

    @property
    def in_use(self) -> int:
        with self._lock:
            return self.max_slots - len(self._free)

    def rows(self, slot_ids) -> Rows:
        """A copy of the rows of ``slot_ids`` (inspection and tests)."""
        idx = torch.as_tensor(np.asarray(slot_ids, np.int64), device=self.device)
        with self._step_lock:
            return {k: s.index_select(0, idx) for k, s in self._state.items()}

    # -- batched stepping -------------------------------------------------------
    def make_step(self, fn: Callable) -> Callable:
        """Build a batched step for the continuous batcher.

        ``fn(state_rows, *inputs) -> (new_state_rows, *outputs)`` where
        ``state_rows`` is the gathered ``{name: tensor}`` with a leading batch
        dim. The returned callable has signature ``(slot_ids [B], *inputs)``
        (host arrays or tensors; they are moved to the table's device) and
        returns the outputs; the state stays on the device. A batch that
        names a slot twice raises ``ValueError``."""

        def step(slot_ids, *inputs):
            ids = slot_ids.cpu().numpy() if isinstance(slot_ids, torch.Tensor) else np.asarray(slot_ids)
            ids = ids.astype(np.int64).reshape(-1)
            if np.unique(ids).size != ids.size:
                raise ValueError(f"a batch names a slot twice: {ids.tolist()}")
            if ids.size and (ids.min() < 0 or ids.max() >= self.max_slots):
                raise IndexError(f"slot ids out of range [0, {self.max_slots}): {ids.tolist()}")
            idx = torch.from_numpy(ids).to(self.device)
            args = [torch.as_tensor(x).to(self.device) for x in inputs]
            with self._step_lock, torch.no_grad():
                rows = {k: s.index_select(0, idx) for k, s in self._state.items()}
                result = fn(rows, *args)
                new_rows, outputs = result[0], tuple(result[1:])
                for k, s in self._state.items():
                    s.index_copy_(0, idx, new_rows[k].to(s.dtype))
            return outputs if len(outputs) > 1 else outputs[0]

        return step
