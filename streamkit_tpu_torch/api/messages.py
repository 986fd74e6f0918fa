# SPDX-License-Identifier: Apache-2.0
"""Wire-level API contract: WS envelope, requests, responses, events, pipeline.

JSON-compatible with the reference contract (``crates/api/src/lib.rs:82-574``)
so the reference UI/CLI could drive this server:

* envelope ``{"type": "request"|"response"|"event", "correlation_id"?, "payload": {...}}``
* requests tagged by ``"action"`` (lowercase), events by ``"event"`` (lowercase)
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

from ..core.control import ConnectionMode

__all__ = [
    "Connection",
    "PipelineNode",
    "Pipeline",
    "make_request",
    "make_response",
    "make_event",
    "parse_message",
    "PERMISSION_FIELDS",
]


# ---------------------------------------------------------------------------
# Pipeline model (reference lib.rs:466-520)
# ---------------------------------------------------------------------------
@dataclass
class Connection:
    from_node: str
    from_pin: str
    to_node: str
    to_pin: str
    mode: ConnectionMode = ConnectionMode.RELIABLE

    def to_json(self) -> dict:
        d = {
            "from_node": self.from_node,
            "from_pin": self.from_pin,
            "to_node": self.to_node,
            "to_pin": self.to_pin,
        }
        if self.mode is not ConnectionMode.RELIABLE:
            d["mode"] = self.mode.value
        return d

    @staticmethod
    def from_json(d: dict) -> "Connection":
        return Connection(
            from_node=d["from_node"],
            from_pin=d.get("from_pin", "out"),
            to_node=d["to_node"],
            to_pin=d.get("to_pin", "in"),
            mode=ConnectionMode(d.get("mode", "reliable")),
        )

    @property
    def id(self) -> str:
        return f"{self.from_node}:{self.from_pin}->{self.to_node}:{self.to_pin}"


@dataclass
class PipelineNode:
    kind: str
    params: Optional[dict] = None
    state: Optional[Any] = None  # runtime NodeState, API responses only

    def to_json(self) -> dict:
        d: dict = {"kind": self.kind, "params": self.params}
        if self.state is not None:
            d["state"] = self.state.to_json() if hasattr(self.state, "to_json") else self.state
        return d


@dataclass
class Pipeline:
    """Engine-facing explicit pipeline (reference lib.rs:466-520).

    ``nodes`` is insertion-ordered (dict), matching the reference's IndexMap.
    """

    name: Optional[str] = None
    description: Optional[str] = None
    mode: str = "dynamic"  # "oneshot" | "dynamic"
    nodes: Dict[str, PipelineNode] = field(default_factory=dict)
    connections: List[Connection] = field(default_factory=list)

    def to_json(self) -> dict:
        d: dict = {
            "mode": self.mode,
            "nodes": {k: v.to_json() for k, v in self.nodes.items()},
            "connections": [c.to_json() for c in self.connections],
        }
        if self.name is not None:
            d["name"] = self.name
        if self.description is not None:
            d["description"] = self.description
        return d

    @staticmethod
    def from_json(d: dict) -> "Pipeline":
        return Pipeline(
            name=d.get("name"),
            description=d.get("description"),
            mode=d.get("mode", "dynamic"),
            nodes={
                k: PipelineNode(kind=v["kind"], params=v.get("params"))
                for k, v in d.get("nodes", {}).items()
            },
            connections=[Connection.from_json(c) for c in d.get("connections", [])],
        )


# ---------------------------------------------------------------------------
# WS envelope helpers (reference lib.rs:82-93)
# ---------------------------------------------------------------------------
PERMISSION_FIELDS = [
    "create_sessions",
    "destroy_sessions",
    "list_sessions",
    "modify_sessions",
    "tune_nodes",
    "load_plugins",
    "delete_plugins",
    "list_nodes",
    "list_samples",
    "read_samples",
    "write_samples",
    "delete_samples",
    "access_all_sessions",
    "upload_assets",
    "delete_assets",
]


def make_request(action: str, correlation_id: Optional[str] = None, **fields) -> dict:
    payload = {"action": action, **{k: v for k, v in fields.items() if v is not None}}
    msg: dict = {"type": "request", "payload": payload}
    if correlation_id is not None:
        msg["correlation_id"] = correlation_id
    return msg


def make_response(action: str, correlation_id: Optional[str] = None, **fields) -> dict:
    payload = {"action": action, **fields}
    msg: dict = {"type": "response", "payload": payload}
    if correlation_id is not None:
        msg["correlation_id"] = correlation_id
    return msg


def make_event(event: str, **fields) -> dict:
    return {"type": "event", "payload": {"event": event, **fields}}


def parse_message(raw: str | bytes) -> dict:
    msg = json.loads(raw)
    if not isinstance(msg, dict) or "type" not in msg or "payload" not in msg:
        raise ValueError("malformed message: need {type, payload}")
    return msg
