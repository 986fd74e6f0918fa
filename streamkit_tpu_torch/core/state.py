# SPDX-License-Identifier: Apache-2.0
"""Node lifecycle state machine.

Parity with reference ``crates/core/src/state.rs:41-317``:
``Initializing → Ready → Running → {Recovering, Degraded, Failed, Stopped}``.

``Ready`` gates source nodes: the dynamic engine withholds ``Start`` until
every node in the pipeline is Ready/Running, so no packets flow into a
half-built graph.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["NodeStateKind", "StopReason", "NodeState", "NodeStateUpdate", "emit_state"]


class NodeStateKind(str, enum.Enum):
    INITIALIZING = "initializing"
    READY = "ready"
    RUNNING = "running"
    RECOVERING = "recovering"
    DEGRADED = "degraded"
    FAILED = "failed"
    STOPPED = "stopped"


class StopReason(str, enum.Enum):
    """Why a node stopped (reference ``state.rs:70-90``)."""

    COMPLETED = "completed"
    INPUT_CLOSED = "input_closed"
    OUTPUT_CLOSED = "output_closed"
    SHUTDOWN = "shutdown"
    NO_INPUTS = "no_inputs"
    UNKNOWN = "unknown"


@dataclass(frozen=True)
class NodeState:
    """A state value with variant payloads (reference ``state.rs:41-55``)."""

    kind: NodeStateKind
    # Recovering payload
    attempt: Optional[int] = None
    max_attempts: Optional[int] = None
    # Degraded/Failed payload
    reason: Optional[str] = None
    # Stopped payload
    stop_reason: Optional[StopReason] = None

    # -- constructors --------------------------------------------------------
    @staticmethod
    def initializing() -> "NodeState":
        return NodeState(NodeStateKind.INITIALIZING)

    @staticmethod
    def ready() -> "NodeState":
        return NodeState(NodeStateKind.READY)

    @staticmethod
    def running() -> "NodeState":
        return NodeState(NodeStateKind.RUNNING)

    @staticmethod
    def recovering(attempt: int, max_attempts: int) -> "NodeState":
        return NodeState(NodeStateKind.RECOVERING, attempt=attempt, max_attempts=max_attempts)

    @staticmethod
    def degraded(reason: str) -> "NodeState":
        return NodeState(NodeStateKind.DEGRADED, reason=reason)

    @staticmethod
    def failed(reason: str) -> "NodeState":
        return NodeState(NodeStateKind.FAILED, reason=reason)

    @staticmethod
    def stopped(reason: StopReason = StopReason.UNKNOWN) -> "NodeState":
        return NodeState(NodeStateKind.STOPPED, stop_reason=reason)

    @property
    def is_terminal(self) -> bool:
        return self.kind in (NodeStateKind.FAILED, NodeStateKind.STOPPED)

    @property
    def is_ready_or_running(self) -> bool:
        return self.kind in (NodeStateKind.READY, NodeStateKind.RUNNING)

    def to_json(self) -> object:
        k = self.kind
        if k is NodeStateKind.RECOVERING:
            return {"recovering": {"attempt": self.attempt, "max_attempts": self.max_attempts}}
        if k is NodeStateKind.DEGRADED:
            return {"degraded": {"reason": self.reason}}
        if k is NodeStateKind.FAILED:
            return {"failed": {"reason": self.reason}}
        if k is NodeStateKind.STOPPED:
            return {"stopped": {"reason": (self.stop_reason or StopReason.UNKNOWN).value}}
        return k.value


@dataclass(frozen=True)
class NodeStateUpdate:
    """State-channel message: (node_name, new state)."""

    node_name: str
    state: NodeState


def emit_state(state_tx, node_name: str, state: NodeState) -> None:
    """Best-effort state emission (reference ``state.rs:211-317`` try_send helpers).

    Never blocks the data path: drops the update if the channel is full.
    """
    if state_tx is None:
        return
    try:
        state_tx.put_nowait(NodeStateUpdate(node_name, state))
    except Exception:
        pass  # full or closed — state updates are lossy by design
