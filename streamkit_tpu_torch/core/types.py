# SPDX-License-Identifier: Apache-2.0
"""Core packet/frame type system.

Capability parity with the reference's packet model
(``crates/core/src/types.rs:25-381``): typed payload containers flowing
through node graphs, with pre-flight type validation via :class:`PacketType`.

Differences from the reference:

* ``AudioFrame.samples`` is a ``numpy.ndarray`` (float32, interleaved) on the
  host side. Device nodes batch many frames into ``[batch, frame]`` torch
  tensors on the card; the host representation is the staging format, not
  the compute format.
* Copy-on-write is provided by numpy view semantics plus an explicit
  ``writable`` discipline (:meth:`AudioFrame.make_samples_mut`), mirroring the
  reference's ``Arc::make_mut`` behaviour (``types.rs:310-315``).
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field, replace
from typing import Any, Mapping, Optional

import numpy as np

__all__ = [
    "SampleFormat",
    "AudioFormat",
    "PacketMetadata",
    "AudioFrame",
    "TranscriptionSegment",
    "TranscriptionData",
    "CustomPacketData",
    "Packet",
    "PacketType",
]


class SampleFormat(str, enum.Enum):
    """PCM sample encodings (reference: ``types.rs:25-29``)."""

    F32 = "f32"
    S16LE = "s16le"

    @property
    def bytes_per_sample(self) -> int:
        return 4 if self is SampleFormat.F32 else 2


@dataclass(frozen=True)
class AudioFormat:
    """Stream format descriptor (reference: ``types.rs:32-38``)."""

    sample_rate: int
    channels: int
    sample_format: SampleFormat = SampleFormat.F32

    # NOTE: sample_rate=0 / channels=0 act as wildcards in *type descriptors*
    # (reference packet_meta StructFieldWildcard rules, ``packet_meta.rs:57+``).
    # Concrete frames must use positive values — enforced by AudioFrame.

    def __post_init__(self) -> None:
        if self.sample_rate < 0:
            raise ValueError(f"sample_rate must be >= 0, got {self.sample_rate}")
        if self.channels < 0:
            raise ValueError(f"channels must be >= 0, got {self.channels}")

    def to_json(self) -> dict:
        return {
            "sample_rate": self.sample_rate,
            "channels": self.channels,
            "sample_format": self.sample_format.value,
        }

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "AudioFormat":
        return AudioFormat(
            sample_rate=int(d["sample_rate"]),
            channels=int(d["channels"]),
            sample_format=SampleFormat(d.get("sample_format", "f32")),
        )


@dataclass(frozen=True)
class PacketMetadata:
    """Timing/sequencing metadata (reference: ``types.rs:43-52``).

    ``timestamp_us``/``duration_us`` drive pacing, mixing sync and loss
    detection downstream; ``sequence`` is a per-stream monotonic counter.
    """

    timestamp_us: Optional[int] = None
    duration_us: Optional[int] = None
    sequence: Optional[int] = None

    def to_json(self) -> dict:
        d: dict = {}
        if self.timestamp_us is not None:
            d["timestamp_us"] = self.timestamp_us
        if self.duration_us is not None:
            d["duration_us"] = self.duration_us
        if self.sequence is not None:
            d["sequence"] = self.sequence
        return d

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "PacketMetadata":
        return PacketMetadata(
            timestamp_us=d.get("timestamp_us"),
            duration_us=d.get("duration_us"),
            sequence=d.get("sequence"),
        )


class AudioFrame:
    """Interleaved float32 PCM frame (reference: ``types.rs:207-330``).

    Cloning an :class:`AudioFrame` shares the underlying buffer (zero-copy,
    like ``Arc<PooledSamples>``); call :meth:`make_samples_mut` before in-place
    mutation to get an exclusively-owned writable buffer.
    """

    __slots__ = ("_samples", "format", "_pool", "_exclusive")

    def __init__(
        self,
        samples: np.ndarray,
        format: AudioFormat,
        _pool: Any = None,
    ) -> None:
        arr = np.asarray(samples, dtype=np.float32)
        if arr.ndim != 1:
            arr = arr.reshape(-1)
        if format.sample_rate <= 0 or format.channels <= 0:
            raise ValueError(f"concrete AudioFrame requires positive format, got {format}")
        self._samples = arr
        self.format = format
        self._pool = _pool
        self._exclusive = True

    # -- buffer access -----------------------------------------------------
    @property
    def samples(self) -> np.ndarray:
        """Read-only view of the interleaved sample buffer."""
        v = self._samples.view()
        v.flags.writeable = False
        return v

    def make_samples_mut(self) -> np.ndarray:
        """Copy-on-write mutable access (reference ``types.rs:310-315``).

        If this frame is the sole owner of its buffer, returns it writable;
        otherwise copies first. Exclusivity is tracked explicitly: a frame is
        exclusive at construction and loses exclusivity when cloned.
        """
        if not self._exclusive or not self._samples.flags.owndata:
            self._samples = self._samples.copy()
            self._pool = None
            self._exclusive = True
        return self._samples

    def clone(self) -> "AudioFrame":
        """Zero-copy clone sharing the sample buffer."""
        self._exclusive = False
        other = AudioFrame(self._samples, self.format, _pool=self._pool)
        other._exclusive = False
        return other

    # -- derived quantities --------------------------------------------------
    @property
    def num_samples(self) -> int:
        return int(self._samples.shape[0])

    @property
    def frames_per_channel(self) -> int:
        return self.num_samples // self.format.channels

    def duration_us(self) -> int:
        """Frame duration in microseconds (reference ``types.rs:262``)."""
        if self.format.sample_rate == 0:
            return 0
        return (self.frames_per_channel * 1_000_000) // self.format.sample_rate

    def release(self) -> None:
        """Return the buffer to its pool, if pooled."""
        if self._pool is not None:
            self._pool._return_buffer(self._samples)
            self._pool = None
            self._samples = np.empty(0, dtype=np.float32)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"AudioFrame(samples={self.num_samples}, rate={self.format.sample_rate}, "
            f"ch={self.format.channels})"
        )


@dataclass(frozen=True)
class TranscriptionSegment:
    """One recognized segment (reference: ``types.rs:150-161``).

    Timing is in **milliseconds** on the wire, matching the reference.
    """

    text: str
    start_time_ms: int = 0
    end_time_ms: int = 0
    confidence: Optional[float] = None

    def to_json(self) -> dict:
        return {
            "text": self.text,
            "start_time_ms": self.start_time_ms,
            "end_time_ms": self.end_time_ms,
            "confidence": self.confidence,
        }


@dataclass(frozen=True)
class TranscriptionData:
    """STT output payload (reference: ``types.rs:163-175``)."""

    text: str
    segments: tuple = ()
    language: Optional[str] = None
    metadata: Optional["PacketMetadata"] = None
    is_final: bool = True  # extension: partial-transcript support

    def to_json(self) -> dict:
        return {
            "text": self.text,
            "segments": [s.to_json() for s in self.segments],
            "language": self.language,
            "metadata": self.metadata.to_json() if self.metadata else None,
        }


@dataclass(frozen=True)
class CustomPacketData:
    """Namespaced JSON payload (reference: ``types.rs:126-137``).

    ``type_id`` is namespaced like ``plugin::native::vad/vad-event@1``.
    """

    type_id: str
    data: Any  # JSON-serializable

    def to_json_bytes(self) -> bytes:
        return json.dumps({"type_id": self.type_id, "data": self.data}).encode()


class _PayloadKind(str, enum.Enum):
    AUDIO = "audio"
    TEXT = "text"
    TRANSCRIPTION = "transcription"
    CUSTOM = "custom"
    BINARY = "binary"


@dataclass
class Packet:
    """Typed payload container (reference: ``types.rs:93-120``).

    Exactly one payload field is set, matching the reference enum variants
    ``Audio | Text | Transcription | Custom | Binary``.
    """

    kind: _PayloadKind
    metadata: PacketMetadata = field(default_factory=PacketMetadata)
    audio: Optional[AudioFrame] = None
    text: Optional[str] = None
    transcription: Optional[TranscriptionData] = None
    custom: Optional[CustomPacketData] = None
    binary: Optional[bytes] = None
    content_type: Optional[str] = None  # for Binary payloads
    binary_metadata: Optional[dict] = None

    # -- constructors --------------------------------------------------------
    @staticmethod
    def new_audio(frame: AudioFrame, metadata: PacketMetadata = PacketMetadata()) -> "Packet":
        return Packet(kind=_PayloadKind.AUDIO, audio=frame, metadata=metadata)

    @staticmethod
    def new_text(text: str, metadata: PacketMetadata = PacketMetadata()) -> "Packet":
        return Packet(kind=_PayloadKind.TEXT, text=text, metadata=metadata)

    @staticmethod
    def new_transcription(
        data: TranscriptionData, metadata: PacketMetadata = PacketMetadata()
    ) -> "Packet":
        return Packet(kind=_PayloadKind.TRANSCRIPTION, transcription=data, metadata=metadata)

    @staticmethod
    def new_custom(data: CustomPacketData, metadata: PacketMetadata = PacketMetadata()) -> "Packet":
        return Packet(kind=_PayloadKind.CUSTOM, custom=data, metadata=metadata)

    @staticmethod
    def new_binary(
        data: bytes,
        content_type: Optional[str] = None,
        metadata: PacketMetadata = PacketMetadata(),
        binary_metadata: Optional[dict] = None,
    ) -> "Packet":
        return Packet(
            kind=_PayloadKind.BINARY,
            binary=data,
            content_type=content_type,
            metadata=metadata,
            binary_metadata=binary_metadata,
        )

    # -- helpers ------------------------------------------------------------
    def packet_type(self) -> "PacketType":
        """The concrete :class:`PacketType` of this packet's payload."""
        if self.kind is _PayloadKind.AUDIO:
            assert self.audio is not None
            return PacketType.raw_audio(self.audio.format)
        if self.kind is _PayloadKind.TEXT:
            return PacketType.text()
        if self.kind is _PayloadKind.TRANSCRIPTION:
            return PacketType.transcription()
        if self.kind is _PayloadKind.CUSTOM:
            assert self.custom is not None
            return PacketType.custom(self.custom.type_id)
        return PacketType.binary()

    def with_metadata(self, metadata: PacketMetadata) -> "Packet":
        p = Packet(
            kind=self.kind,
            metadata=metadata,
            audio=self.audio,
            text=self.text,
            transcription=self.transcription,
            custom=self.custom,
            binary=self.binary,
            content_type=self.content_type,
            binary_metadata=self.binary_metadata,
        )
        return p

    def to_reference_json(self) -> dict:
        """Serialize to the reference's externally-tagged Packet JSON
        (``types.rs:93-120`` serde shape) — used by ``core::json_serialize``
        and the telemetry wire format so clients see identical payloads."""
        import base64

        meta = self.metadata.to_json() or None if self.metadata else None
        if self.kind is _PayloadKind.AUDIO:
            assert self.audio is not None
            return {
                "Audio": {
                    "sample_rate": self.audio.format.sample_rate,
                    "channels": self.audio.format.channels,
                    "samples": [float(s) for s in self.audio.samples],
                    "metadata": meta,
                }
            }
        if self.kind is _PayloadKind.TEXT:
            return {"Text": self.text}
        if self.kind is _PayloadKind.TRANSCRIPTION:
            assert self.transcription is not None
            return {"Transcription": self.transcription.to_json()}
        if self.kind is _PayloadKind.CUSTOM:
            assert self.custom is not None
            return {
                "Custom": {
                    "type_id": self.custom.type_id,
                    "encoding": "json",
                    "data": self.custom.data,
                    "metadata": meta,
                }
            }
        return {
            "Binary": {
                "data": base64.b64encode(self.binary or b"").decode(),
                "content_type": self.content_type,
                "metadata": meta,
            }
        }

    def clone(self) -> "Packet":
        """Cheap clone: audio buffers are shared, not copied."""
        audio = self.audio.clone() if self.audio is not None else None
        return Packet(
            kind=self.kind,
            metadata=self.metadata,
            audio=audio,
            text=self.text,
            transcription=self.transcription,
            custom=self.custom,
            binary=self.binary,
            content_type=self.content_type,
            binary_metadata=self.binary_metadata,
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"Packet({self.kind.value}, meta={self.metadata})"


class _TypeTag(str, enum.Enum):
    RAW_AUDIO = "raw_audio"
    OPUS_AUDIO = "opus_audio"
    TEXT = "text"
    TRANSCRIPTION = "transcription"
    CUSTOM = "custom"
    BINARY = "binary"
    ANY = "any"
    PASSTHROUGH = "passthrough"


@dataclass(frozen=True)
class PacketType:
    """Pre-flight connection-type descriptor (reference: ``types.rs:56-87``).

    ``Passthrough`` means "my output type equals my input type"; it is resolved
    iteratively at graph-compile time (oneshot) or at connect time (dynamic) —
    see :func:`streamkit_tpu_torch.core.packet_meta.can_connect`.
    """

    tag: _TypeTag
    audio_format: Optional[AudioFormat] = None  # RAW_AUDIO (None = any format)
    type_id: Optional[str] = None  # CUSTOM ("*" suffix wildcards allowed)

    # -- constructors --------------------------------------------------------
    @staticmethod
    def raw_audio(fmt: Optional[AudioFormat] = None) -> "PacketType":
        return PacketType(_TypeTag.RAW_AUDIO, audio_format=fmt)

    @staticmethod
    def opus_audio() -> "PacketType":
        return PacketType(_TypeTag.OPUS_AUDIO)

    @staticmethod
    def text() -> "PacketType":
        return PacketType(_TypeTag.TEXT)

    @staticmethod
    def transcription() -> "PacketType":
        return PacketType(_TypeTag.TRANSCRIPTION)

    @staticmethod
    def custom(type_id: str) -> "PacketType":
        return PacketType(_TypeTag.CUSTOM, type_id=type_id)

    @staticmethod
    def binary() -> "PacketType":
        return PacketType(_TypeTag.BINARY)

    @staticmethod
    def any() -> "PacketType":
        return PacketType(_TypeTag.ANY)

    @staticmethod
    def passthrough() -> "PacketType":
        return PacketType(_TypeTag.PASSTHROUGH)

    # -- predicates ----------------------------------------------------------
    @property
    def is_any(self) -> bool:
        return self.tag is _TypeTag.ANY

    @property
    def is_passthrough(self) -> bool:
        return self.tag is _TypeTag.PASSTHROUGH

    def display(self) -> str:
        if self.tag is _TypeTag.RAW_AUDIO and self.audio_format is not None:
            f = self.audio_format
            return f"raw_audio({f.sample_rate}Hz/{f.channels}ch/{f.sample_format.value})"
        if self.tag is _TypeTag.CUSTOM:
            return f"custom({self.type_id})"
        return self.tag.value

    def to_json(self) -> dict:
        d: dict = {"type": self.tag.value}
        if self.audio_format is not None:
            d["format"] = self.audio_format.to_json()
        if self.type_id is not None:
            d["type_id"] = self.type_id
        return d
