# SPDX-License-Identifier: Apache-2.0
"""Spawn the ranks of a ``torch.distributed`` group on one host.

The JAX package drives its whole mesh from one process; PyTorch's idiom on
CUDA is one process per rank. :func:`run_ranks` is the port's one spawner:
the tests, :func:`..dryrun.dryrun_multichip` and ``chip_smoke.py`` start
their ranks through it.

* ``spawn`` start method: a fork after CUDA initialised is fatal in the
  child.
* The ranks meet at a ``FileStore`` in a fresh temporary directory, so two
  groups started at once (parallel test workers) never race for a TCP port.
* CPU ranks run ``torch.set_num_threads(1)``: eight ranks on a shared host
  would otherwise each start a thread per core.
* Each rank's return value (picklable) comes back in rank order; a rank's
  exception is raised again here with its traceback; past ``timeout_s``
  every rank is killed and :class:`TimeoutError` raised.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["run_ranks", "RankError"]


class RankError(RuntimeError):
    """A rank raised: the message holds its rank and traceback."""


def _rank_main(fn, rank: int, world: int, store_path: str, backend: str, dev_type: str, timeout_s: float,
               args, results) -> None:
    try:
        # one host: the ranks talk over the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if dev_type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — every failure goes back to the parent
        results.put((rank, False, traceback.format_exc()))


def _stop(procs, grace_s: float) -> None:
    for p in procs:
        p.join(timeout=grace_s)
        if p.is_alive():
            p.kill()
            p.join(timeout=10)


def run_ranks(fn: Callable[..., Any], world: int, *args, device=None, backend: Optional[str] = None,
              timeout_s: float = 120.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` spawned ranks of one process group and
    return their results in rank order.

    ``device`` (default ``cuda``, which raises without a card) picks the
    ranks' device: rank r takes card ``r % device_count()``. ``backend``
    defaults to NCCL on CUDA (each rank on a card of its own) and gloo on
    the CPU; ranks that share one card pass ``backend="gloo"``. ``fn`` and
    ``args`` must be picklable (``fn`` a module-level function)."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="sk-ranks-") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_rank_main,
                        args=(fn, r, world, store_path, backend, dev.type, timeout_s, args, results),
                        daemon=True)
            for r in range(world)
        ]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout_s
        ok_all = False
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world} ranks of {getattr(fn, '__name__', fn)} did not finish within "
                                       f"{timeout_s:.0f} s (finished: {sorted(got)})")
                try:
                    rank, ok, out = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                    if dead:
                        # a late result may still be in the queue
                        try:
                            rank, ok, out = results.get(timeout=2.0)
                        except queue.Empty:
                            raise RankError(f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                                            "without a result") from None
                    else:
                        continue
                if not ok:
                    raise RankError(f"rank {rank} of {world} failed:\n{out}")
                got[rank] = out
            ok_all = True
        finally:
            # ranks that reported exit by themselves; any other is killed
            _stop(procs, 5.0 if ok_all else 0.0)
            results.close()
    return [got[r] for r in range(world)]
