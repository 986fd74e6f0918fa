# SPDX-License-Identifier: Apache-2.0
"""Built-in node inventory + registration (reference ``nodes/src/lib.rs:25-42``).

The kinds ported so far: the oneshot roles, passthrough and sink, the text
nodes, the WAV container pair, and the VAD and Whisper ML nodes. Each kind
has the name and pins of the JAX package's. Pipelines name no device; the
ML nodes run on the one given to :func:`register_nodes`.
"""

from __future__ import annotations

from ..core import NodeRegistry
from ..device import resolve_device


def register_nodes(registry: NodeRegistry, *, device=None) -> None:
    """Register every ported node kind. ``device`` (default ``cuda``) is where
    the ML nodes keep their models and state; without a card ``None`` raises
    (pass ``device="cpu"`` to run on the CPU)."""
    from .containers.wav import WavDemuxerNode, WavMuxerNode
    from .core_nodes.basic import BytesInputNode, BytesOutputNode, PassthroughNode, SinkNode
    from .core_nodes.text import JsonSerializeNode, TextChunkerNode

    dev = resolve_device(device)
    for cls, desc in [
        (PassthroughNode, "Forwards packets unchanged"),
        (SinkNode, "Discards all packets (terminal)"),
        (JsonSerializeNode, "Serializes packets to JSON binary"),
        (TextChunkerNode, "Chunks streaming text at sentence boundaries"),
        (WavDemuxerNode, "Parses WAV (RIFF) into raw audio frames"),
        (WavMuxerNode, "Encodes raw audio frames as a WAV stream"),
    ]:
        registry.register(cls.KIND, _factory(cls), description=desc)

    # oneshot marker kinds (instantiated by the oneshot runner; registered so
    # pipelines validate and the schema lists them)
    registry.register(BytesInputNode.KIND, _factory(BytesInputNode), "HTTP request body source (oneshot)")
    registry.register(BytesOutputNode.KIND, _factory(BytesOutputNode), "HTTP response body sink (oneshot)")

    from .ml import register_ml_nodes

    register_ml_nodes(registry, device=dev)


def _factory(cls):
    return lambda params: cls(params)
