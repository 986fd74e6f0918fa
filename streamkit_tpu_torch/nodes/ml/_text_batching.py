# SPDX-License-Identifier: Apache-2.0
"""Shared pow-2-bucketed decode scaffolding for the text seq2seq nodes.

Port of ``streamkit_tpu/nodes/ml/_text_batching.py``, used by the NLLB and
Marian translation nodes: source token ids pad to pow-2 buckets (clamped to
the model's position table), and with an engine batcher texts from all
sessions sharing a model coalesce per bucket into one device call. Extra
per-row inputs (e.g. NLLB target-language tokens) ride the batch.

The reference jits the decode once per model and shares that compiled
program across node instances (``_shared_jit``). PyTorch runs the decode
eagerly, so there is no program to share and nothing to cache: the bucket
and the batcher kind name (``{kind_tag}:{bucket}``) are what decide which
requests share a device call, and they are kept.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ...device import resolve_device

__all__ = ["BucketedGreedy"]


class BucketedGreedy:
    """``decode(src [b, t], *extras [b, ...]) -> (tokens [b, T], lengths [b])``
    on ``device`` (default ``cuda``)."""

    def __init__(
        self,
        kind_tag: str,
        max_positions: int,
        pad_id: int,
        decode: Callable,
        max_batch: int = 16,
        device=None,
    ) -> None:
        self.kind_tag = kind_tag
        self.max_positions = max_positions
        self.pad_id = pad_id
        self.max_batch = max_batch
        self.decode = decode
        self.device = resolve_device(device)

    def _bucketed(self, ids):
        n = min(len(ids), self.max_positions)
        # the pow-2 bucket must not overrun the position table
        tb = min(1 << max(4, (max(1, n) - 1).bit_length()), self.max_positions)
        n = min(n, tb)
        padded = np.full(tb, self.pad_id, np.int32)
        padded[:n] = ids[:n]
        return tb, padded

    def run_single(self, ids, *extras):
        """Direct path: one row. Returns (tokens row, length)."""
        _, padded = self._bucketed(ids)
        toks, lens = self._batch_fn(padded[None], *[np.asarray(e)[None] for e in extras])
        return toks[0], int(lens[0])

    def _batch_fn(self, src_b, *extra_b):
        with torch.inference_mode():
            toks, lens = self.decode(
                torch.as_tensor(src_b, device=self.device),
                *[torch.as_tensor(e, device=self.device) for e in extra_b],
            )
        return toks.cpu().numpy(), lens.cpu().numpy()

    async def run_batched(self, batcher, ids, *extras):
        """Cross-session path through the engine batcher."""
        tb, padded = self._bucketed(ids)
        kind = f"{self.kind_tag}:{tb}"
        batcher.register(kind, self._batch_fn, max_batch=self.max_batch, transient=True)
        toks, n = await batcher.submit(kind, padded, *[np.asarray(e) for e in extras])
        return np.asarray(toks), int(n)
