# SPDX-License-Identifier: Apache-2.0
"""Pin model: typed, cardinality-constrained node connection points.

Parity with reference ``crates/core/src/pins.rs:30-110``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

from .types import PacketType

__all__ = ["PinCardinality", "InputPin", "OutputPin", "PinUpdate", "PinManagementMessage"]


class _CardKind(str, enum.Enum):
    ONE = "one"
    BROADCAST = "broadcast"
    DYNAMIC = "dynamic"


@dataclass(frozen=True)
class PinCardinality:
    """Connection cardinality (reference ``pins.rs:30-46``).

    * ``one()`` — exactly one connection.
    * ``broadcast()`` — many connections, packet cloned to each (outputs only).
    * ``dynamic(prefix)`` — pin family created on demand (``in_0``, ``in_1``, …).
    """

    kind: _CardKind
    prefix: Optional[str] = None

    @staticmethod
    def one() -> "PinCardinality":
        return PinCardinality(_CardKind.ONE)

    @staticmethod
    def broadcast() -> "PinCardinality":
        return PinCardinality(_CardKind.BROADCAST)

    @staticmethod
    def dynamic(prefix: str) -> "PinCardinality":
        return PinCardinality(_CardKind.DYNAMIC, prefix=prefix)

    @property
    def is_dynamic(self) -> bool:
        return self.kind is _CardKind.DYNAMIC

    @property
    def is_broadcast(self) -> bool:
        return self.kind is _CardKind.BROADCAST

    def to_json(self) -> object:
        if self.kind is _CardKind.DYNAMIC:
            return {"Dynamic": {"prefix": self.prefix}}
        return "One" if self.kind is _CardKind.ONE else "Broadcast"


@dataclass
class InputPin:
    """Reference ``pins.rs:49-56``."""

    name: str
    accepts_types: List[PacketType]
    cardinality: PinCardinality = field(default_factory=PinCardinality.one)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "accepts_types": [t.to_json() for t in self.accepts_types],
            "cardinality": self.cardinality.to_json(),
        }


@dataclass
class OutputPin:
    """Reference ``pins.rs:58-66``."""

    name: str
    produces_type: PacketType
    cardinality: PinCardinality = field(default_factory=PinCardinality.one)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "produces_type": self.produces_type.to_json(),
            "cardinality": self.cardinality.to_json(),
        }


class PinUpdate:
    """Result of async node initialization (reference ``pins.rs:68-77``)."""

    class NoChange:
        pass

    @dataclass
    class Updated:
        inputs: List[InputPin]
        outputs: List[OutputPin]


@dataclass
class PinManagementMessage:
    """Runtime pin add/remove protocol (reference ``pins.rs:79-110``).

    ``op`` is one of request_add_input / added_input / remove_input /
    request_add_output / added_output / remove_output. ``response`` is an
    asyncio.Future carrying the created pin (for request ops); ``channel`` is
    the asyncio.Queue wired by the engine (for added ops).
    """

    op: str
    suggested_name: Optional[str] = None
    pin: Optional[object] = None
    channel: Optional[object] = None
    pin_name: Optional[str] = None
    response: Optional[object] = None
