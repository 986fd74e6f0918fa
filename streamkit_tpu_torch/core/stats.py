# SPDX-License-Identifier: Apache-2.0
"""Per-node packet statistics with throttled reporting.

Parity with reference ``crates/core/src/stats.rs:18-206``: counters for
received/sent/discarded/errored packets; a tracker that emits to the stats
channel at most every 2 s or 1000 packets (``stats.rs:62-64``), best-effort.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["NodeStats", "NodeStatsUpdate", "NodeStatsTracker"]

STATS_INTERVAL_SECS = 2.0
STATS_PACKET_INTERVAL = 1000


@dataclass
class NodeStats:
    received: int = 0
    sent: int = 0
    discarded: int = 0
    errored: int = 0
    duration_secs: float = 0.0
    # extension (not in stats.rs): estimated per-packet handling
    # latency — EWMA of receive→send gaps sampled by the tracker. Drives the
    # Monitor view's per-node latency chart.
    proc_ms: float = 0.0

    def to_json(self) -> dict:
        return {
            "received": self.received,
            "sent": self.sent,
            "discarded": self.discarded,
            "errored": self.errored,
            "duration_secs": self.duration_secs,
            "proc_ms": round(self.proc_ms, 3),
        }


@dataclass(frozen=True)
class NodeStatsUpdate:
    node_name: str
    stats: NodeStats


class NodeStatsTracker:
    """Accumulates counters and flushes them (throttled) to a stats queue."""

    def __init__(self, node_name: str, stats_tx=None, clock=time.monotonic) -> None:
        self.node_name = node_name
        self._tx = stats_tx
        self._clock = clock
        self._start = clock()
        self._last_flush = self._start
        self._since_flush = 0
        self._rx_at: float | None = None  # pending receive→send latency sample
        self.stats = NodeStats()

    # -- counter updates ------------------------------------------------------
    def packet_received(self, n: int = 1) -> None:
        self.stats.received += n
        self._rx_at = self._clock()
        self._tick(n)

    def packet_sent(self, n: int = 1) -> None:
        self.stats.sent += n
        if self._rx_at is not None:
            # receive→send gap ≈ per-packet handling latency for 1-in/1-out
            # nodes (an estimate: fan-out/batching nodes sample their first
            # emit per input). EWMA keeps it one float.
            sample_ms = (self._clock() - self._rx_at) * 1000.0
            self._rx_at = None
            s = self.stats
            s.proc_ms = sample_ms if s.proc_ms == 0.0 else 0.9 * s.proc_ms + 0.1 * sample_ms
        self._tick(n)

    def packet_discarded(self, n: int = 1) -> None:
        self.stats.discarded += n
        self._tick(n)

    def packet_errored(self, n: int = 1) -> None:
        self.stats.errored += n
        self._tick(n)

    # -- flushing --------------------------------------------------------------
    def _tick(self, n: int) -> None:
        self._since_flush += n
        now = self._clock()
        if (
            self._since_flush >= STATS_PACKET_INTERVAL
            or (now - self._last_flush) >= STATS_INTERVAL_SECS
        ):
            self.flush(now)

    def flush(self, now: float | None = None) -> None:
        """Force-send current stats (also called on node shutdown)."""
        now = self._clock() if now is None else now
        self._last_flush = now
        self._since_flush = 0
        if self._tx is None:
            return
        self.stats.duration_secs = now - self._start
        snapshot = NodeStats(**self.stats.__dict__)
        try:
            self._tx.put_nowait(NodeStatsUpdate(self.node_name, snapshot))
        except Exception:
            pass  # stats are lossy by design
