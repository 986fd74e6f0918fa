# SPDX-License-Identifier: Apache-2.0
"""Control messages for nodes and the dynamic engine.

Parity with reference ``crates/core/src/control.rs:19-78``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional

__all__ = ["ConnectionMode", "NodeControlMessage", "EngineControlMessage"]


class ConnectionMode(str, enum.Enum):
    """Backpressure semantics per connection (reference ``control.rs:60-78``).

    * RELIABLE — producer stalls when the consumer is full (lossless).
    * BEST_EFFORT — newest packet kept, oldest pending dropped (bounded lag).
    """

    RELIABLE = "reliable"
    BEST_EFFORT = "best_effort"


@dataclass(frozen=True)
class NodeControlMessage:
    """Per-node control (reference ``control.rs:19-32``).

    ``op``: "update_params" (with ``params`` JSON), "start", or "shutdown".
    """

    op: str
    params: Optional[Any] = None

    @staticmethod
    def update_params(params: Any) -> "NodeControlMessage":
        return NodeControlMessage("update_params", params)

    @staticmethod
    def start() -> "NodeControlMessage":
        return NodeControlMessage("start")

    @staticmethod
    def shutdown() -> "NodeControlMessage":
        return NodeControlMessage("shutdown")

    def to_json(self) -> dict:
        if self.op == "update_params":
            return {"type": "update_params", "params": self.params}
        return {"type": self.op}

    @staticmethod
    def from_json(d: Any) -> "NodeControlMessage":
        if isinstance(d, str):
            return NodeControlMessage(d.lower())
        op = d.get("type") or d.get("op")
        return NodeControlMessage(str(op).lower(), d.get("params"))


@dataclass
class EngineControlMessage:
    """Dynamic-engine graph mutations (reference ``control.rs:34-58``).

    ``op``: add_node / remove_node / connect / disconnect / tune_node / shutdown.
    ``reply`` is an asyncio.Future for request/response ops (set by the handle).
    """

    op: str
    node_id: Optional[str] = None
    kind: Optional[str] = None
    params: Optional[Any] = None
    from_node: Optional[str] = None
    from_pin: Optional[str] = None
    to_node: Optional[str] = None
    to_pin: Optional[str] = None
    mode: ConnectionMode = ConnectionMode.RELIABLE
    message: Optional[NodeControlMessage] = None
    reply: Optional[Any] = None
