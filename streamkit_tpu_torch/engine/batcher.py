# SPDX-License-Identifier: Apache-2.0
"""Continuous batcher: one device call per node *type*, batched over sessions.

Port of ``streamkit_tpu/engine/batcher.py``. Nodes submit work items to a
process-wide batcher which

* groups submissions by ``(kind, input shapes)``,
* ticks on a micro-batch cadence (default 5 ms) or fires early when a group
  reaches ``max_batch`` (or its ``expected`` size),
* stacks inputs to ``[B, ...]`` on the batcher's device and runs ONE call in
  an executor thread, synchronises the device once, and scatters the per-item
  results (host numpy) back to the awaiting nodes.

Spans (when the process tracer is on, :mod:`..utils.tracing`): per device
call a ``batcher.wait`` (from the oldest item's submit to the call's start)
and a ``batcher.call`` (from stacking to the scattered results, with the
executor thread's and the process's CPU milliseconds over the call), current
in the executor thread so the call's own spans are its children. The per-kind
queue wait is counted whether or not spans are on (``kind_wait_s``).

Correctness contract: registered functions must be batch-invariant (row i of
the batched result equals the unbatched computation).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.tracing import NOOP_SPAN, get_tracer

logger = logging.getLogger(__name__)

__all__ = ["DeviceBatcher", "BatchKind"]


@dataclass
class BatchKind:
    """A registered batched computation.

    ``fn(*stacked_inputs) -> tensor | tuple`` where every input has a
    leading batch dim (device tensors, or host numpy with ``host_inputs``).
    """

    name: str
    fn: Callable[..., Any]
    max_batch: int = 64
    # pad every dispatch to exactly this size (when the chunk fits)
    pad_to: Optional[int] = None
    # hold a partial batch up to this long waiting for co-arriving sessions
    gather_ms: float = 0.0
    # pass the stacked batch to fn as host numpy arrays (kinds that re-pack
    # the batch on the host before dispatch)
    host_inputs: bool = False
    # transient kinds may be TTL-purged when idle; durable kinds never are
    transient: bool = False
    last_used: float = field(default_factory=time.monotonic)
    # co-paced coalescing target: a partial batch reaching `expected` fires
    # immediately; the gather window then only bounds the wait for stragglers
    expected: Optional[int] = None


@dataclass
class _Item:
    inputs: Tuple[np.ndarray, ...]
    future: asyncio.Future
    t: float = field(default_factory=time.monotonic)


def _to_host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class DeviceBatcher:
    """Micro-batching dispatcher for device work on ``device`` (default
    ``cuda``)."""

    def __init__(self, tick_ms: float = 5.0, kind_ttl_secs: float = 900.0, device=None) -> None:
        self.device = resolve_device(device)
        self.tick_secs = tick_ms / 1000.0
        # idle transient kinds are purged after this TTL (their fns close
        # over model parameters)
        self.kind_ttl_secs = kind_ttl_secs
        self._last_purge = time.monotonic()
        self._kinds: Dict[str, BatchKind] = {}
        self._pending: Dict[Tuple, List[_Item]] = defaultdict(list)
        self._shape_groups: Dict[str, set] = {}
        self.shape_group_warn_threshold = 12
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._running = False
        self._inflight_tasks: set = set()
        # observability
        self.submissions = 0
        self.device_calls = 0
        self.batched_items = 0
        # per-kind: [calls, items, total_dispatch_wall_s]
        self.kind_stats: Dict[str, list] = defaultdict(lambda: [0, 0, 0.0])
        # per-kind queue wait: seconds summed over the items of the kind's
        # calls, each from its submit to the start of its call
        self.kind_wait_s: Dict[str, float] = defaultdict(float)
        # device calls numbered in the order they start (``batcher.call``'s
        # ``seq``)
        self._dispatch_seq = itertools.count()

    # -- registration --------------------------------------------------------
    def register(
        self,
        name: str,
        fn: Callable[..., Any],
        max_batch: int = 64,
        pad_to: Optional[int] = None,
        gather_ms: float = 0.0,
        host_inputs: bool = False,
        transient: bool = False,
    ) -> None:
        """Idempotent: re-registering a kind keeps the first fn."""
        if name not in self._kinds:
            # with a fixed pad, oversize groups split into pad-sized chunks
            if pad_to is not None:
                max_batch = min(max_batch, pad_to)
            self._kinds[name] = BatchKind(
                name, fn, max_batch, pad_to, gather_ms, host_inputs, transient
            )

    def is_registered(self, name: str) -> bool:
        return name in self._kinds

    def registered_kinds(self) -> Dict[str, BatchKind]:
        """Snapshot of registered kinds (read-only use)."""
        return dict(self._kinds)

    def set_expected(self, name: str, n: Optional[int]) -> None:
        """Update a kind's co-paced coalescing target; 0/None clears it."""
        kind = self._kinds.get(name)
        if kind is not None:
            kind.expected = n or None

    # -- lifecycle --------------------------------------------------------------
    def start(self) -> None:
        if self._task is None or self._task.done():
            self._running = True
            self._task = asyncio.ensure_future(self._run())

    def stop(self) -> None:
        self._running = False
        self._wake.set()

    # -- submission ----------------------------------------------------------
    async def submit(self, kind: str, *inputs: np.ndarray):
        """Submit one item; returns the per-item output tuple (or single
        value if the fn returns one array)."""
        return await self.submit_nowait(kind, *inputs)

    def submit_nowait(self, kind: str, *inputs: np.ndarray) -> asyncio.Future:
        """Enqueue one item synchronously and return the result future."""
        if kind not in self._kinds:
            raise KeyError(f"batch kind not registered: {kind}")
        if self._task is None or self._task.done():
            self.start()
        self.submissions += 1
        self._kinds[kind].last_used = time.monotonic()
        key = (kind,) + tuple(np.asarray(x).shape for x in inputs)
        # shape-group hygiene: each distinct input-shape tuple is its own
        # coalescing group; many groups means un-bucketed submissions
        groups = self._shape_groups.setdefault(kind, set())
        if key not in groups:
            groups.add(key)
            if len(groups) == self.shape_group_warn_threshold:
                logger.warning(
                    "batch kind %r has accumulated %d distinct input-shape "
                    "groups — submissions are un-bucketed and batch "
                    "separately; pad or bucket this kind's inputs",
                    kind, len(groups),
                )
        fut = asyncio.get_running_loop().create_future()
        group = self._pending[key]
        group.append(_Item(tuple(np.asarray(x) for x in inputs), fut))
        k = self._kinds[kind]
        if len(group) >= min(k.max_batch, k.expected or k.max_batch):
            self._wake.set()
        return fut

    # -- dispatcher loop ---------------------------------------------------------
    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while self._running:
            try:
                await asyncio.wait_for(self._wake.wait(), timeout=self.tick_secs)
            except asyncio.TimeoutError:
                pass
            self._wake.clear()
            now = time.monotonic()
            if self.kind_ttl_secs > 0 and now - self._last_purge > 60.0:
                self._last_purge = now
                busy = {key[0] for key in self._pending}
                for name in [
                    n for n, k in self._kinds.items()
                    if k.transient and n not in busy
                    and now - k.last_used > self.kind_ttl_secs
                ]:
                    del self._kinds[name]
            if not self._pending:
                continue
            batches = self._pending
            self._pending = defaultdict(list)
            dispatches = []
            now = time.monotonic()
            for key, items in batches.items():
                kind = self._kinds[key[0]]
                full = kind.pad_to or kind.max_batch
                if kind.expected is not None:
                    full = min(full, kind.expected)
                if (
                    kind.gather_ms > 0
                    and len(items) < full
                    and (now - items[0].t) * 1000.0 < kind.gather_ms
                ):
                    # hold the partial batch for co-arriving sessions
                    self._pending[key].extend(items)
                    continue
                for i in range(0, len(items), kind.max_batch):
                    chunk = items[i : i + kind.max_batch]
                    dispatches.append(self._dispatch(loop, kind, chunk))
            # dispatch groups concurrently, without blocking the tick loop: a
            # slow kind (whisper decode) must not head-of-line-block cheap
            # kinds (VAD). A submitter awaits its result before submitting
            # again, so no session has two batches in flight.
            for d in dispatches:
                task = asyncio.ensure_future(d)
                self._inflight_tasks.add(task)
                task.add_done_callback(self._inflight_tasks.discard)

    async def _dispatch(self, loop, kind: BatchKind, items: List[_Item]) -> None:
        # pad the batch (repeating the last row) to pad_to or the next power
        # of two; duplicates gather the same state and scatter the same values
        n = len(items)
        if kind.host_inputs:
            padded = n
        elif kind.pad_to is not None and n <= kind.pad_to:
            padded = kind.pad_to
        else:
            padded = 1 << (n - 1).bit_length() if n > 1 else 1
        self.device_calls += 1
        self.batched_items += n
        tracer = get_tracer()
        call = NOOP_SPAN

        def run_batch():
            nonlocal call
            # the items' queue wait ends here: the gather hold, the tick and
            # the executor hand-over
            t_run = time.monotonic()
            wait_s = sum(t_run - it.t for it in items)
            seq = next(self._dispatch_seq)
            if tracer.enabled:
                call = tracer.span("batcher.call", {"kind": kind.name, "rows": n, "padded": padded, "seq": seq})
                oldest = min(it.t for it in items)
                tracer.record("batcher.wait", call.start_ns - int((t_run - oldest) * 1e9), call.start_ns,
                              {"kind": kind.name, "rows": n, "seq": seq})
                cpu0 = (time.thread_time_ns(), time.process_time_ns())
            with call.scope():
                rows = items + [items[-1]] * (padded - n)
                stacked = tuple(np.stack([it.inputs[j] for it in rows]) for j in range(len(items[0].inputs)))
                if not kind.host_inputs:
                    stacked = tuple(torch.as_tensor(a, device=self.device) for a in stacked)
                out = kind.fn(*stacked)
                if not isinstance(out, tuple):
                    out = (out,)
                # one synchronisation for the whole call, then the host copies
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                outputs = tuple(_to_host(o) for o in out)
            if call is not NOOP_SPAN:
                # this thread's and the process's CPU over the call: wall
                # beyond the thread's CPU waited (the GIL, the device, a
                # core); beyond the process's too, no thread of it ran
                call.set_attribute("cpu_ms", (time.thread_time_ns() - cpu0[0]) / 1e6)
                call.set_attribute("proc_cpu_ms", (time.process_time_ns() - cpu0[1]) / 1e6)
            return outputs, wait_s

        t0 = time.monotonic()
        try:
            outputs, wait_s = await loop.run_in_executor(None, run_batch)
        except Exception as e:  # noqa: BLE001 — propagate to every waiter
            call.fail(e)
            call.end()
            for it in items:
                if not it.future.done():
                    it.future.set_exception(e)
            return
        ks = self.kind_stats[kind.name]
        ks[0] += 1
        ks[1] += n
        ks[2] += time.monotonic() - t0
        self.kind_wait_s[kind.name] += wait_s
        for idx, it in enumerate(items):
            row = tuple(o[idx] for o in outputs)
            if not it.future.done():
                it.future.set_result(row if len(row) > 1 else row[0])
        call.end()

    # -- stats ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "submissions": self.submissions,
            "device_calls": self.device_calls,
            "batched_items": self.batched_items,
            "mean_batch": (self.batched_items / self.device_calls) if self.device_calls else 0.0,
            "kinds": {
                k: {"calls": v[0], "items": v[1], "dispatch_s": round(v[2], 2),
                    "queue_s": round(self.kind_wait_s[k], 2)}
                for k, v in sorted(self.kind_stats.items())
            },
        }
