# SPDX-License-Identifier: Apache-2.0
"""Packet-type compatibility rules + server-driven UI metadata.

Parity with reference ``crates/core/src/packet_meta.rs:22-225``:

* ``Any`` matches anything.
* Different kinds never match.
* ``RawAudio``: per-field wildcard — ``sample_rate==0`` or ``channels==0`` on
  either side matches; ``sample_format`` must be equal (no wildcard).
* ``Custom``: ``type_id`` must be equal (plus a practical ``*``-suffix glob the
  reference uses at pin level).
* Everything else: kinds equal ⇒ compatible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from .types import PacketType, _TypeTag

__all__ = ["PacketTypeMeta", "packet_type_registry", "can_connect", "can_connect_any"]


@dataclass(frozen=True)
class PacketTypeMeta:
    """UI metadata exposed at ``/api/v1/schema/packets`` (reference ``packet_meta.rs:37-60``)."""

    id: str
    label: str
    color: str
    display_template: Optional[str] = None
    compatibility: str = "exact"  # "any" | "exact" | "struct_field_wildcard"


_REGISTRY: List[PacketTypeMeta] = [
    PacketTypeMeta("Any", "Any", "#96ceb4", None, "any"),
    PacketTypeMeta("Binary", "Binary", "#45b7d1", None, "exact"),
    PacketTypeMeta("Text", "Text", "#4ecdc4", None, "exact"),
    PacketTypeMeta("OpusAudio", "Opus Audio", "#ff6b6b", None, "exact"),
    PacketTypeMeta(
        "RawAudio",
        "Raw Audio",
        "#f39c12",
        "Raw Audio ({sample_rate|*}Hz, {channels|*}ch, {sample_format})",
        "struct_field_wildcard",
    ),
    PacketTypeMeta("Transcription", "Transcription", "#9b59b6", None, "exact"),
    PacketTypeMeta("Custom", "Custom", "#e67e22", "Custom ({type_id})", "struct_field_wildcard"),
]


def packet_type_registry() -> List[PacketTypeMeta]:
    return _REGISTRY


def _custom_ids_match(a: Optional[str], b: Optional[str]) -> bool:
    if a is None or b is None:
        return False
    # glob support: trailing '*' wildcard, as used by telemetry consumers.
    if a.endswith("*"):
        return b.startswith(a[:-1])
    if b.endswith("*"):
        return a.startswith(b[:-1])
    return a == b


def can_connect(output: PacketType, input: PacketType) -> bool:
    """Check if an output type may feed an input type (reference ``packet_meta.rs:162-210``).

    Passthrough types must be resolved before calling (the engines do this);
    an unresolved Passthrough is treated conservatively as incompatible unless
    the other side is Any.
    """
    if output.is_any or input.is_any:
        return True
    if output.is_passthrough or input.is_passthrough:
        return False
    if output.tag is not input.tag:
        return False
    if output.tag is _TypeTag.RAW_AUDIO:
        a, b = output.audio_format, input.audio_format
        if a is None or b is None:
            return True  # absent format = fully wildcard descriptor
        rate_ok = a.sample_rate == 0 or b.sample_rate == 0 or a.sample_rate == b.sample_rate
        ch_ok = a.channels == 0 or b.channels == 0 or a.channels == b.channels
        fmt_ok = a.sample_format == b.sample_format
        return rate_ok and ch_ok and fmt_ok
    if output.tag is _TypeTag.CUSTOM:
        return _custom_ids_match(output.type_id, input.type_id)
    return True


def can_connect_any(output: PacketType, inputs: Sequence[PacketType]) -> bool:
    """Reference ``packet_meta.rs:214-225``."""
    return any(can_connect(output, i) for i in inputs)
