# SPDX-License-Identifier: Apache-2.0
"""Session management: dynamic-engine sessions with docker-style names.

Parity with reference ``apps/skit/src/session.rs:48-420``: uuid ids,
``adjective-noun`` names derived from an FNV hash of the id, per-session
forwarding tasks (state/stats/telemetry → event broadcast), name-unique
manager with creator tracking.
"""

from __future__ import annotations

import asyncio
import datetime
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..core import Channel, NodeRegistry
from ..core.state import NodeStateUpdate
from ..core.stats import NodeStatsUpdate
from ..core.telemetry import TELEMETRY_TYPE_ID, TelemetryEvent
from ..engine.dynamic import DynamicEngineConfig, DynamicEngineHandle, start_dynamic_engine

__all__ = ["Session", "SessionManager", "session_name_from_id"]

_ADJECTIVES = [
    "amber", "bold", "calm", "dapper", "eager", "fuzzy", "gentle", "happy",
    "icy", "jolly", "keen", "lively", "mellow", "nimble", "odd", "proud",
    "quick", "rusty", "shy", "tidy", "upbeat", "vivid", "witty", "zesty",
]
_NOUNS = [
    "otter", "falcon", "maple", "comet", "ember", "fjord", "grove", "harbor",
    "island", "jaguar", "kestrel", "lagoon", "meadow", "nebula", "orchid",
    "pine", "quartz", "river", "summit", "tundra", "umbra", "valley",
    "willow", "zephyr",
]


def _fnv1a(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def session_name_from_id(session_id: str) -> str:
    """Docker-style deterministic name (reference ``session.rs:48-72``)."""
    h = _fnv1a(session_id.encode())
    return f"{_ADJECTIVES[h % len(_ADJECTIVES)]}-{_NOUNS[(h >> 8) % len(_NOUNS)]}"


def _utcnow() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%fZ")


_REDACT_TEXT_LIMIT = 500  # server-side telemetry redaction (session.rs:105-133)


@dataclass
class Session:
    id: str
    name: Optional[str]
    handle: DynamicEngineHandle
    created_at: str
    created_by: str
    _forwarders: List[asyncio.Task] = field(default_factory=list)

    @staticmethod
    async def create(
        registry: NodeRegistry,
        name: Optional[str],
        created_by: str,
        broadcast: Callable[[dict], None],
        resources=None,
        engine_config: Optional[DynamicEngineConfig] = None,
        batcher=None,
    ) -> "Session":
        session_id = str(uuid.uuid4())
        display_name = name or session_name_from_id(session_id)
        cfg = engine_config or DynamicEngineConfig()
        cfg.session_id = session_id
        handle = start_dynamic_engine(registry, cfg, resources=resources, batcher=batcher)
        session = Session(
            id=session_id,
            name=display_name,
            handle=handle,
            created_at=_utcnow(),
            created_by=created_by,
        )
        await session._start_forwarders(broadcast)
        return session

    async def _start_forwarders(self, broadcast: Callable[[dict], None]) -> None:
        """state/stats/telemetry → API events (reference session.rs forwarding)."""
        from ..api.messages import make_event

        state_sub = await self.handle.subscribe_state()
        stats_sub = await self.handle.subscribe_stats()
        telemetry_sub = await self.handle.subscribe_telemetry()

        async def forward_states():
            while True:
                upd = await state_sub.recv_optional()
                if upd is None:
                    return
                assert isinstance(upd, NodeStateUpdate)
                broadcast(
                    make_event(
                        "nodestatechanged",
                        session_id=self.id,
                        node_id=upd.node_name,
                        state=upd.state.to_json(),
                        timestamp=_utcnow(),
                    )
                )

        async def forward_stats():
            while True:
                upd = await stats_sub.recv_optional()
                if upd is None:
                    return
                assert isinstance(upd, NodeStatsUpdate)
                broadcast(
                    make_event(
                        "nodestatsupdated",
                        session_id=self.id,
                        node_id=upd.node_name,
                        stats=upd.stats.to_json(),
                        timestamp=_utcnow(),
                    )
                )

        async def forward_telemetry():
            while True:
                ev = await telemetry_sub.recv_optional()
                if ev is None:
                    return
                assert isinstance(ev, TelemetryEvent)
                data = ev.to_json()
                # redaction: truncate long text fields before they hit the wire
                for key, val in list(data.items()):
                    if isinstance(val, str) and len(val) > _REDACT_TEXT_LIMIT:
                        data[key] = val[:_REDACT_TEXT_LIMIT] + "…"
                broadcast(
                    make_event(
                        "nodetelemetry",
                        session_id=self.id,
                        node_id=ev.node_name,
                        type_id=TELEMETRY_TYPE_ID,
                        data=data,
                        timestamp_us=ev.timestamp_us,
                        timestamp=_utcnow(),
                    )
                )

        self._forwarders = [
            asyncio.ensure_future(forward_states()),
            asyncio.ensure_future(forward_stats()),
            asyncio.ensure_future(forward_telemetry()),
        ]

    async def destroy(self) -> None:
        await self.handle.shutdown_and_wait()
        for t in self._forwarders:
            t.cancel()

    def info(self) -> dict:
        return {"id": self.id, "name": self.name, "created_at": self.created_at}


class SessionManager:
    """Name-unique session map (reference ``session.rs:327-420``)."""

    def __init__(self) -> None:
        self._sessions: Dict[str, Session] = {}

    def get(self, session_id: str) -> Optional[Session]:
        return self._sessions.get(session_id)

    def add(self, session: Session) -> None:
        if any(s.name == session.name for s in self._sessions.values()):
            raise ValueError(f"session name {session.name!r} already in use")
        self._sessions[session.id] = session

    async def remove(self, session_id: str) -> Optional[Session]:
        session = self._sessions.pop(session_id, None)
        if session is not None:
            await session.destroy()
        return session

    def list(self, created_by: Optional[str] = None) -> List[Session]:
        out = list(self._sessions.values())
        if created_by is not None:
            out = [s for s in out if s.created_by == created_by]
        return out

    async def destroy_all(self) -> None:
        for sid in list(self._sessions):
            await self.remove(sid)
