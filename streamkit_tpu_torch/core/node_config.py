# SPDX-License-Identifier: Apache-2.0
"""Global buffer-capacity configuration, set once by the server.

Parity with reference ``crates/core/src/node_config.rs`` (set in
``apps/skit/src/server.rs:1752-1774``). Capacities control host channel
latency: capacity N ≈ N × 20 ms of audio per hop (see
``engine/src/constants.rs:22-130``).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["NodeBufferConfig", "get_buffer_config", "set_buffer_config"]


@dataclass(frozen=True)
class NodeBufferConfig:
    codec_channel_capacity: int = 32
    stream_channel_capacity: int = 8
    demuxer_buffer_size: int = 64 * 1024
    moq_peer_channel_capacity: int = 100


_CONFIG = NodeBufferConfig()
_SET = False


def set_buffer_config(cfg: NodeBufferConfig) -> None:
    global _CONFIG, _SET
    _CONFIG = cfg
    _SET = True


def get_buffer_config() -> NodeBufferConfig:
    return _CONFIG
