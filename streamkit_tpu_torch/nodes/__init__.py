# SPDX-License-Identifier: Apache-2.0
"""Built-in node inventory + registration (reference ``nodes/src/lib.rs:25-42``).

Every kind of the JAX package: the oneshot roles, passthrough and sink, file
reader and writer, the pacers, the text and telemetry nodes, the script
node, the WAV and Ogg container pairs and the WebM muxer, the HTTP fetcher
and the MoQ peer, subscriber and publisher, the audio filters (gain,
resampler, mixer), the Opus pair, the MP3 and the libav (FLAC) decoders
where their host libraries load, and the ML nodes (VAD, Whisper and
SenseVoice STT, NLLB and Marian translation, the Kokoro / VITS / FastSpeech
TTS node as ``kokoro`` and ``piper``, Matcha TTS). Each kind has the name, description and pins of the JAX
package's, but for ``transport::moq::publisher``, whose input also takes
Binary (``live_captions.yml`` publishes JSON lines through it). Pipelines
name no device; the filters and ML nodes run on the one given to
:func:`register_nodes`.
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
    from .containers.webm import WebmMuxerNode
    from .core_nodes.basic import BytesInputNode, BytesOutputNode, PassthroughNode, SinkNode
    from .core_nodes.file_io import FileReaderNode, FileWriterNode
    from .core_nodes.pacer import AudioPacerNode, PacerNode
    from .core_nodes.script import ScriptNode
    from .core_nodes.telemetry_nodes import TelemetryOutNode, TelemetryTapNode
    from .core_nodes.text import JsonSerializeNode, TextChunkerNode
    from .transport.http import HttpFetcherNode
    from .transport.moq import MoqPeerNode, MoqPublisherNode, MoqSubscriberNode

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
        (WebmMuxerNode, "Muxes Opus into a WebM (Matroska) stream"),
        (TelemetryTapNode, "Observes packets and emits telemetry events"),
        (TelemetryOutNode, "Forwards packets to the session telemetry bus"),
        (ScriptNode, "Per-packet sandboxed transform script"),
        (HttpFetcherNode, "Fetches a URL as a binary stream"),
        (MoqPeerNode, "Bidirectional in-server MoQ media endpoint"),
        (MoqSubscriberNode, "Subscribes to a MoQ broadcast"),
        (MoqPublisherNode, "Publishes to MoQ subscribers"),
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

    # codec nodes register where their host library loads (never a device
    # question: the gating is for host libraries only)
    from .codecs import register_codec_nodes
    from .ml import register_ml_nodes

    register_codec_nodes(registry)
    register_ml_nodes(registry, device=dev)


def _factory(cls):
    return lambda params: cls(params)


def _device_factory(cls, dev):
    return lambda params: cls(params, device=dev)
