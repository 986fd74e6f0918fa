# SPDX-License-Identifier: Apache-2.0
"""The arithmetic of the benchmark's numbers: rates, spreads, intervals."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple


def overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    """Length of the intersection of ``[a0, a1]`` and ``[b0, b1]``."""
    return max(0.0, min(a1, b1) - max(a0, b0))


def windowed_work(spans: Iterable[Tuple[float, float, float]], w0: float, w1: float) -> float:
    """Work done inside the window ``[w0, w1]`` by spans ``(start, end,
    work)``, each span's work spread evenly over its time."""
    total = 0.0
    for s0, s1, work in spans:
        if s1 <= s0:
            total += work if w0 <= s1 <= w1 else 0.0
        else:
            total += work * overlap(s0, s1, w0, w1) / (s1 - s0)
    return total


def spread(values: Sequence[float]) -> float:
    """Interquartile distance over the median (``statistics.quantiles``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by ``intervals``."""
    total, cur0, cur1 = 0.0, None, None
    for a, b in sorted(intervals):
        if cur1 is None or a > cur1:
            if cur1 is not None:
                total += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        total += cur1 - cur0
    return total


def gaps(intervals: Iterable[Tuple[float, float]], w0: float, w1: float) -> List[Tuple[float, float]]:
    """The uncovered stretches of ``[w0, w1]``."""
    out, cur = [], w0
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, w1)))
        cur = max(cur, b)
        if cur >= w1:
            break
    if cur < w1:
        out.append((cur, w1))
    return [(a, b) for a, b in out if b > a]
