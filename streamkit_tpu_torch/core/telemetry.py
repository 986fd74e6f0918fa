# SPDX-License-Identifier: Apache-2.0
"""Telemetry event bus: structured node events that never block audio.

Parity with reference ``crates/core/src/telemetry.rs:57-110``: events are
Custom packets with envelope ``type_id`` ``core::telemetry/event@1`` carrying
an ``event_type`` (e.g. ``vad.speech_start``, ``stt.result``); the emitter
rate-limits and counts drops.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .types import CustomPacketData, PacketMetadata

__all__ = ["TELEMETRY_TYPE_ID", "TelemetryEvent", "TelemetryEmitter"]

TELEMETRY_TYPE_ID = "core::telemetry/event@1"


@dataclass(frozen=True)
class TelemetryEvent:
    """One telemetry event from a node."""

    node_name: str
    event_type: str
    data: Dict[str, Any]
    timestamp_us: Optional[int] = None

    def to_custom(self) -> CustomPacketData:
        payload = dict(self.data)
        payload["event_type"] = self.event_type
        return CustomPacketData(TELEMETRY_TYPE_ID, payload)

    def to_json(self) -> dict:
        d = dict(self.data)
        d["event_type"] = self.event_type
        return d


class TelemetryEmitter:
    """Rate-limited, lossy telemetry emission (reference ``telemetry.rs:57-110``)."""

    def __init__(
        self,
        node_name: str,
        telemetry_tx=None,
        max_events_per_sec: float = 100.0,
        clock=time.monotonic,
    ) -> None:
        self.node_name = node_name
        self._tx = telemetry_tx
        self._clock = clock
        self._min_interval = 1.0 / max_events_per_sec if max_events_per_sec > 0 else 0.0
        self._last_emit: Dict[str, float] = {}
        self.dropped = 0
        self.emitted = 0

    def emit(
        self,
        event_type: str,
        data: Optional[Dict[str, Any]] = None,
        timestamp_us: Optional[int] = None,
        rate_limited: bool = True,
    ) -> bool:
        """Emit an event; returns False when rate-limited/dropped."""
        if self._tx is None:
            return False
        now = self._clock()
        if rate_limited and self._min_interval > 0:
            last = self._last_emit.get(event_type, -1e18)
            if now - last < self._min_interval:
                self.dropped += 1
                return False
        event = TelemetryEvent(self.node_name, event_type, data or {}, timestamp_us)
        try:
            self._tx.put_nowait(event)
        except Exception:
            self.dropped += 1
            return False
        self._last_emit[event_type] = now
        self.emitted += 1
        return True
