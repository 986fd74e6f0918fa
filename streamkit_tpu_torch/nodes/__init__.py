# SPDX-License-Identifier: Apache-2.0
"""Built-in node inventory + registration (reference ``nodes/src/lib.rs:25-42``).

The kinds ported so far: the oneshot roles, passthrough and sink, file
reader and writer, the pacers, the text and telemetry nodes, the WAV and
Ogg container pairs, the audio filters (gain, resampler, mixer), the Opus
codec pair where libopus loads, and the ML nodes (VAD, Whisper and
SenseVoice STT, NLLB and Marian translation, the Kokoro / VITS / FastSpeech
TTS node as ``kokoro`` and ``piper``, Matcha TTS). Each kind has the name, description and pins of the JAX
package's. Pipelines name no device; the filters and ML nodes run on the one
given to :func:`register_nodes`.
"""

from __future__ import annotations

from ..core import NodeRegistry
from ..device import resolve_device


def register_nodes(registry: NodeRegistry, *, device=None) -> None:
    """Register every ported node kind. ``device`` (default ``cuda``) is where
    the filters and the ML nodes compute and keep their state; without a card
    ``None`` raises (pass ``device="cpu"`` to run on the CPU)."""
    from .audio.filters import GainNode, MixerNode, ResamplerNode
    from .containers.ogg import OggDemuxerNode, OggMuxerNode
    from .containers.wav import WavDemuxerNode, WavMuxerNode
    from .core_nodes.basic import BytesInputNode, BytesOutputNode, PassthroughNode, SinkNode
    from .core_nodes.file_io import FileReaderNode, FileWriterNode
    from .core_nodes.pacer import AudioPacerNode, PacerNode
    from .core_nodes.telemetry_nodes import TelemetryOutNode, TelemetryTapNode
    from .core_nodes.text import JsonSerializeNode, TextChunkerNode

    dev = resolve_device(device)
    for cls, desc in [
        (PassthroughNode, "Forwards packets unchanged"),
        (SinkNode, "Discards all packets (terminal)"),
        (FileReaderNode, "Reads a file in chunks (waits for Start)"),
        (FileWriterNode, "Writes binary packets to a file"),
        (PacerNode, "Releases packets according to timing metadata"),
        (AudioPacerNode, "Audio pacer that synthesizes silence on underrun"),
        (JsonSerializeNode, "Serializes packets to JSON binary"),
        (TextChunkerNode, "Chunks streaming text at sentence boundaries"),
        (WavDemuxerNode, "Parses WAV (RIFF) into raw audio frames"),
        (WavMuxerNode, "Encodes raw audio frames as a WAV stream"),
        (OggDemuxerNode, "Parses Ogg/Opus into Opus packets"),
        (OggMuxerNode, "Packetizes Opus into an Ogg stream"),
        (TelemetryTapNode, "Observes packets and emits telemetry events"),
        (TelemetryOutNode, "Forwards packets to the session telemetry bus"),
    ]:
        registry.register(cls.KIND, _factory(cls), description=desc)
    for cls, desc in [
        (GainNode, "Multiplies audio samples by a gain factor"),
        (ResamplerNode, "Converts audio sample rate (device kernel)"),
        (MixerNode, "Mixes multiple audio inputs into one stream"),
    ]:
        registry.register(cls.KIND, _device_factory(cls, dev), description=desc)

    # oneshot marker kinds (instantiated by the oneshot runner; registered so
    # pipelines validate and the schema lists them)
    registry.register(BytesInputNode.KIND, _factory(BytesInputNode), "HTTP request body source (oneshot)")
    registry.register(BytesOutputNode.KIND, _factory(BytesOutputNode), "HTTP response body sink (oneshot)")

    # codec nodes register where their host library loads
    from .codecs import register_codec_nodes
    from .ml import register_ml_nodes

    register_codec_nodes(registry)
    register_ml_nodes(registry, device=dev)


def _factory(cls):
    return lambda params: cls(params)


def _device_factory(cls, dev):
    return lambda params: cls(params, device=dev)
