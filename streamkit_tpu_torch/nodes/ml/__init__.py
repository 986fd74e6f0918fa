# SPDX-License-Identifier: Apache-2.0
"""ML nodes: VAD, Whisper and SenseVoice STT, NLLB and Marian translation, the
TTS node (Kokoro, VITS, FastSpeech) and Matcha TTS, on the registering
device."""

from ...device import resolve_device


def register_ml_nodes(registry, *, device=None) -> None:
    """Register the ML kinds; their nodes run on ``device`` (default
    ``cuda``, which raises without a card)."""
    from .marian_node import MarianTranslateNode
    from .matcha_node import MatchaTtsNode
    from .sensevoice_node import SenseVoiceNode
    from .translate_node import TranslateNode
    from .tts_node import TtsNode
    from .vad_node import VadNode
    from .whisper_node import WhisperNode

    dev = resolve_device(device)
    registry.register(VadNode.KIND, lambda p: VadNode(p, device=dev), "Voice activity detection (device kernel)")
    registry.register(WhisperNode.KIND, lambda p: WhisperNode(p, device=dev), "Whisper speech-to-text (device model)")
    registry.register(TranslateNode.KIND, lambda p: TranslateNode(p, device=dev), "NLLB text translation (device model)")
    registry.register(
        MarianTranslateNode.KIND,
        lambda p: MarianTranslateNode(p, device=dev),
        "Helsinki opus-mt (Marian) translation (device model)",
    )
    registry.register(TtsNode.KIND, lambda p: TtsNode(p, device=dev), "Kokoro-class streaming TTS (device model)")
    # piper: the VITS stack is piper's architecture (TtsNode vits backend)
    registry.register(
        "plugin::native::piper",
        lambda p: TtsNode(p, device=dev),
        "Piper (VITS) streaming TTS (device model)",
    )
    registry.register(
        MatchaTtsNode.KIND,
        lambda p: MatchaTtsNode(p, device=dev),
        "Matcha-TTS flow-matching TTS (device model)",
    )
    registry.register(
        SenseVoiceNode.KIND,
        lambda p: SenseVoiceNode(p, device=dev),
        "SenseVoice non-autoregressive STT (device model)",
    )
