# SPDX-License-Identifier: Apache-2.0
"""What the benchmark sees of the program's device calls.

:class:`RecordingBatcher` is the program's ``DeviceBatcher``, handed to it
through the ``batcher=`` argument its entry points take. It records, per
batched call, the kind, host start and end and the host inputs and outputs
(the fused live step takes and returns host arrays). In a traced run each call
runs inside a profiler range ``pb.<family>#<n>`` and ends with a device
synchronisation (which the batcher makes right after the call anyway), so
the trace ties each kernel to its call.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from streamkit_tpu_torch.engine.batcher import DeviceBatcher


@dataclass
class Call:
    seq: int
    kind: str
    t0: float
    t1: float
    batch: int
    inputs: Optional[tuple]
    outputs: Optional[tuple]
    error: Optional[str] = None

    @property
    def family(self) -> str:
        return self.kind.split(":")[0]


def _host(x):
    return x if isinstance(x, np.ndarray) else None


class RecordingBatcher(DeviceBatcher):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.calls: List[Call] = []
        self.tracing = False
        self._seq = itertools.count()
        self._lock = threading.Lock()

    def register(self, name: str, fn: Callable[..., Any], *args, **kw) -> None:
        family = name.split(":")[0]

        def recorded(*inputs):
            seq = next(self._seq)
            ctx = torch.profiler.record_function(f"pb.{family}#{seq}") if self.tracing else contextlib.nullcontext()
            t0 = time.monotonic()
            err, out = None, None
            try:
                with ctx:
                    out = fn(*inputs)
                    if self.tracing and self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                return out
            except Exception as e:  # noqa: BLE001 — recorded, then raised to the batcher
                err = repr(e)
                raise
            finally:
                outs = out if isinstance(out, tuple) else (out,)
                batch = int(inputs[0].shape[0]) if inputs else 0
                call = Call(seq, name, t0, time.monotonic(), batch,
                            tuple(_host(x) for x in inputs), tuple(_host(o) for o in outs), err)
                with self._lock:
                    self.calls.append(call)

        super().register(name, recorded, *args, **kw)

    def calls_of(self, family: str) -> List[Call]:
        with self._lock:
            return [c for c in self.calls if c.family == family]

    def counters(self, family: str) -> tuple:
        """The program's own counters for a kind family: (calls, items,
        dispatch seconds), summed over its kinds."""
        calls = items = 0
        secs = 0.0
        for name, (c, i, s) in list(self.kind_stats.items()):
            if name.split(":")[0] == family:
                calls, items, secs = calls + c, items + i, secs + s
        return calls, items, secs

    def snapshot(self) -> Dict[str, tuple]:
        """:meth:`counters` of every kind family."""
        return {f: self.counters(f) for f in {name.split(":")[0] for name in list(self.kind_stats)}}
