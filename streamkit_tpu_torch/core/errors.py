# SPDX-License-Identifier: Apache-2.0
"""Framework error taxonomy (reference ``crates/core/src/error.rs:18-43``)."""

from __future__ import annotations

__all__ = [
    "StreamKitError",
    "ConfigurationError",
    "RuntimeNodeError",
    "NetworkError",
    "ValidationFailure",
    "ResourceError",
    "PluginError",
]


class StreamKitError(Exception):
    """Base error for all framework failures."""


class ConfigurationError(StreamKitError):
    """Invalid node/pipeline/server configuration."""


class RuntimeNodeError(StreamKitError):
    """A node failed while processing."""


class NetworkError(StreamKitError):
    """Transport-level failure (HTTP/WS/MoQ)."""


class ValidationFailure(StreamKitError):
    """Graph/type validation rejected an operation."""


class ResourceError(StreamKitError):
    """Shared-resource (model cache) failure."""


class PluginError(StreamKitError):
    """Plugin load/ABI failure."""
