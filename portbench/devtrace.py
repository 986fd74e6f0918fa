# SPDX-License-Identifier: Apache-2.0
"""The device trace of a traced run, and what the metrics read from it.

:class:`DeviceTrace` profiles CPU and CUDA activity in every thread (the
program's device calls run in executor threads) over a stretch of the
measured window, then reads the raw Kineto events: device operations
(kernels, copies, sets), the benchmark's ``pb.<family>#<n>`` call ranges
(:mod:`recorder`) and the host operations around them.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from stats import gaps, union_length

_SPAN = re.compile(r"^pb\.([A-Za-z0-9_]+)#(\d+)$")


@dataclass
class Span:
    family: str
    seq: int
    t0: float  # seconds on the trace's clock
    t1: float
    thread: int


@dataclass
class Op:
    name: str
    t0: float
    t1: float


class DeviceTrace:
    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        try:
            cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
            self._prof = profile(activities=acts, experimental_config=cfg)
        except (AttributeError, TypeError):
            self._prof = profile(activities=acts)
        self.host_s = 0.0
        self.ops: List[Op] = []  # device operations
        self.spans: List[Span] = []
        self.host: Dict[int, List[Op]] = defaultdict(list)  # host operations by thread
        self.window: Tuple[float, float] = (0.0, 0.0)

    def prepare(self) -> None:
        """Set the profiler up (CUPTI's start takes seconds): in set-up."""
        self._prof.prepare_trace()

    def start(self) -> None:
        self._t = time.monotonic()
        self._prof.start_trace()

    def stop(self) -> None:
        self.host_s = time.monotonic() - self._t
        self._prof.stop_trace()
        self._read()

    def _read(self) -> None:
        events = self._prof.profiler.kineto_results.events()
        lo, hi = None, None
        for e in events:
            t0, t1 = e.start_ns() / 1e9, (e.start_ns() + e.duration_ns()) / 1e9
            dev = str(e.device_type()).endswith("CUDA")
            name = e.name()
            if dev:
                if e.is_user_annotation() or name.startswith("pb."):
                    continue
                self.ops.append(Op(name, t0, t1))
                continue
            m = _SPAN.match(name)
            if m:
                self.spans.append(Span(m.group(1), int(m.group(2)), t0, t1, e.start_thread_id()))
            else:
                self.host[e.start_thread_id()].append(Op(name, t0, t1))
            lo = t0 if lo is None else min(lo, t0)
            hi = t1 if hi is None else max(hi, t1)
        if self.ops:
            lo = min(lo if lo is not None else self.ops[0].t0, min(o.t0 for o in self.ops))
            hi = max(hi if hi is not None else self.ops[0].t1, max(o.t1 for o in self.ops))
        # the traced stretch: the host's own measure of it, placed where the
        # events lie
        start = lo if lo is not None else 0.0
        self.window = (start, start + max(self.host_s, (hi or start) - start))

    # -- readings --------------------------------------------------------------
    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return union_length((o.t0, o.t1) for o in self.ops)

    def busy_within(self, span: Span) -> float:
        """Device seconds with an operation running, of the operations that
        start inside ``span`` (a traced call ends with a synchronisation, so
        its operations end inside it too)."""
        return union_length((o.t0, o.t1) for o in self.ops if span.t0 <= o.t0 <= span.t1)

    def whole_spans(self, family: str) -> List[Span]:
        """The calls of ``family`` that lie wholly inside the trace."""
        return [s for s in self.spans if s.family == family]

    def kernel_seconds(self, pattern: str, spans: List[Span]) -> float:
        """Device seconds of operations whose name matches ``pattern`` and
        which start inside one of ``spans``."""
        rx = re.compile(pattern)
        ivs = sorted((s.t0, s.t1) for s in spans)
        total = 0.0
        for o in self.ops:
            if rx.search(o.name) and any(a <= o.t0 <= b for a, b in ivs):
                total += o.t1 - o.t0
        return total

    def kernel_count(self, pattern: str, spans: List[Span]) -> int:
        rx = re.compile(pattern)
        ivs = [(s.t0, s.t1) for s in spans]
        return sum(1 for o in self.ops if rx.search(o.name) and any(a <= o.t0 <= b for a, b in ivs))

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = defaultdict(float)
        for o in self.ops:
            by_name[o.name] += o.t1 - o.t0
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        w0, w1 = self.window
        idle = sorted(gaps(((o.t0, o.t1) for o in self.ops), w0, w1), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self._doing(a, b), b - a] for a, b in idle]}

    def _doing(self, a: float, b: float) -> str:
        """What the host was doing over the gap ``[a, b]``: the device call
        under way (``pb`` range) and the host operation under way at the
        gap's middle in that call's thread (the shortest that covers it)."""
        mid = (a + b) / 2
        span: Optional[Span] = None
        for s in self.spans:
            if s.t0 <= mid <= s.t1 and (span is None or s.t1 - s.t0 < span.t1 - span.t0):
                span = s
        if span is None:
            return "no device call under way"
        best = None
        for o in self.host.get(span.thread, ()):
            if o.t0 <= mid <= o.t1 and (best is None or o.t1 - o.t0 < best.t1 - best.t0):
                best = o
        return f"{span.family}: {best.name if best else 'python'}"
