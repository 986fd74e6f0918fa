# SPDX-License-Identifier: Apache-2.0
"""ML nodes ported so far: VAD and Whisper STT, on the registering device."""

from ...device import resolve_device


def register_ml_nodes(registry, *, device=None) -> None:
    """Register the VAD and Whisper kinds; their nodes run on ``device``
    (default ``cuda``, which raises without a card)."""
    from .vad_node import VadNode
    from .whisper_node import WhisperNode

    dev = resolve_device(device)
    registry.register(VadNode.KIND, lambda p: VadNode(p, device=dev), "Voice activity detection (device kernel)")
    registry.register(WhisperNode.KIND, lambda p: WhisperNode(p, device=dev), "Whisper speech-to-text (device model)")
