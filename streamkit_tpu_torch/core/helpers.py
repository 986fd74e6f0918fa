# SPDX-License-Identifier: Apache-2.0
"""Config parsing + greedy packet batching helpers.

Parity with reference ``crates/core/src/helpers.rs:15-118``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Type, TypeVar

from .channel import Channel, ChannelClosed, ChannelFull
from .errors import ConfigurationError
from .types import Packet

__all__ = [
    "parse_config_required",
    "parse_config_optional",
    "require_param",
    "batch_packets_greedy",
]

MAX_GREEDY_BATCH = 32


def parse_config_optional(params: Optional[dict], defaults: dict) -> dict:
    """Merge user params over defaults; unknown keys are rejected."""
    cfg = dict(defaults)
    if params:
        for k, v in params.items():
            if k.startswith("_"):
                continue  # engine-injected internals (_resource etc.)
            if k not in defaults:
                raise ConfigurationError(f"unknown parameter {k!r} (valid: {sorted(defaults)})")
            cfg[k] = v
    return cfg


def parse_config_required(params: Optional[dict], required: List[str], defaults: dict) -> dict:
    if not params:
        raise ConfigurationError(f"missing required parameters: {required}")
    for r in required:
        if r not in params:
            raise ConfigurationError(f"missing required parameter {r!r}")
    full_defaults = dict(defaults)
    for r in required:
        full_defaults.setdefault(r, None)
    return parse_config_optional(params, full_defaults)


def require_param(params: Optional[dict], key: str) -> Any:
    if not params or key not in params:
        raise ConfigurationError(f"missing required parameter {key!r}")
    return params[key]


def batch_packets_greedy(ch: Channel, first: Packet, max_batch: int = MAX_GREEDY_BATCH) -> List[Packet]:
    """Drain up to ``max_batch`` already-queued packets without awaiting
    (reference ``helpers.rs:69-118``)."""
    batch = [first]
    while len(batch) < max_batch:
        try:
            batch.append(ch.try_recv())
        except (ChannelClosed, ChannelFull):
            break
    return batch
