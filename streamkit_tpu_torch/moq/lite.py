# SPDX-License-Identifier: Apache-2.0
"""moq-lite draft-02 + hang wire protocol.

The reference speaks **moq-lite** (kixelated's simplified MoQ) with the
**hang** media layer on top — that is what browser MoQ players and external
relays implement. Observable constraints pinned by the reference source:

* version enum ``moq_lite::lite::Version::Draft02``
  (``crates/nodes/src/transport/moq/peer.rs:870``),
* hang frame = varint u64 **microsecond** timestamp header + media bytes
  (``peer.rs:868-871`` "Skip timestamp header (varint encoded u64
  microseconds)"), millisecond granularity at the API
  (``moq/constants.rs:11-15``, ``hang::Timestamp::from_millis``),
* catalog = JSON on the default catalog track, audio rendition keyed by
  track name with codec/sample-rate/channels/bitrate
  (``peer.rs:1030-1060``), audio track ``audio/data`` at priority 80,
* group-per-uni-stream delivery with keyframe group boundaries on the
  configured cadence (``moq/constants.rs:22-46``).

The moq-lite crate itself is not vendored in the reference checkout, so the
byte-level layout below is reconstructed from the public moq-lite draft-02
protocol: QUIC-varint coding, typed control streams (SESSION=0, ANNOUNCE=1,
SUBSCRIBE=2), GROUP=0 uni data streams, and the 0xff0bbb__ version
constants. Every constant lives in this module's table so a divergence
found against a live moq-lite peer is a one-line fix. The acceptor
negotiates this protocol alongside the native one
(:mod:`.wire`) by sniffing the first varint of the first bidi stream:
moq-lite opens with stream-type 0 where the native protocol's first
control message is ``MSG_SETUP`` (0x01).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..quic.packet import decode_varint, encode_varint

__all__ = [
    "VERSION_DRAFT_02",
    "STREAM_SESSION",
    "STREAM_ANNOUNCE",
    "STREAM_SUBSCRIBE",
    "STREAM_GROUP",
    "ANNOUNCE_ENDED",
    "ANNOUNCE_ACTIVE",
    "ANNOUNCE_LIVE",
    "CATALOG_TRACK",
    "AUDIO_TRACK",
    "AUDIO_PRIORITY",
    "encode_session_client",
    "encode_session_server",
    "decode_session_client",
    "decode_session_server",
    "encode_announce_please",
    "decode_announce_please",
    "encode_announce",
    "AnnounceParser",
    "encode_subscribe",
    "decode_subscribe",
    "encode_subscribe_ok",
    "decode_subscribe_ok",
    "encode_group_header",
    "encode_lite_frame",
    "encode_hang_frame",
    "decode_hang_frame",
    "LiteGroupParser",
    "build_catalog",
    "parse_catalog",
]

# -- constants (reconstruction table; see module docstring) ------------------
VERSION_DRAFT_00 = 0xFF0BBB00
VERSION_DRAFT_01 = 0xFF0BBB01
VERSION_DRAFT_02 = 0xFF0BBB02  # peer.rs:870 Version::Draft02

STREAM_SESSION = 0x00  # bidi
STREAM_ANNOUNCE = 0x01  # bidi
STREAM_SUBSCRIBE = 0x02  # bidi
STREAM_GROUP = 0x00  # uni

ANNOUNCE_ENDED = 0x00
ANNOUNCE_ACTIVE = 0x01
ANNOUNCE_LIVE = 0x02

CATALOG_TRACK = "catalog.json"  # hang::catalog::Catalog::default_track()
CATALOG_PRIORITY = 100
AUDIO_TRACK = "audio/data"  # peer.rs:1022
AUDIO_PRIORITY = 80  # peer.rs:1022,1048


def _estr(s: str) -> bytes:
    b = s.encode()
    return encode_varint(len(b)) + b


def _dstr(buf, off: int) -> Tuple[str, int]:
    n, off = decode_varint(buf, off)
    if off + n > len(buf):
        raise IndexError("truncated string")
    return bytes(buf[off : off + n]).decode(), off + n


# -- session handshake -------------------------------------------------------
def encode_session_client(versions: Optional[List[int]] = None, extensions: Optional[Dict[int, bytes]] = None) -> bytes:
    """SessionClient: supported versions + extension map. Sent by the client
    on its SESSION bidi stream right after the stream-type varint."""
    versions = versions or [VERSION_DRAFT_02]
    out = bytearray(encode_varint(len(versions)))
    for v in versions:
        out += encode_varint(v)
    ext = extensions or {}
    out += encode_varint(len(ext))
    for k, v in ext.items():
        out += encode_varint(k) + encode_varint(len(v)) + v
    return bytes(out)


def decode_session_client(buf, off: int = 0) -> Tuple[List[int], Dict[int, bytes], int]:
    n, off = decode_varint(buf, off)
    if n > 64:
        raise ValueError("unreasonable version count")
    versions = []
    for _ in range(n):
        v, off = decode_varint(buf, off)
        versions.append(v)
    ne, off = decode_varint(buf, off)
    if ne > 64:
        raise ValueError("unreasonable extension count")
    ext: Dict[int, bytes] = {}
    for _ in range(ne):
        k, off = decode_varint(buf, off)
        ln, off = decode_varint(buf, off)
        if off + ln > len(buf):
            raise IndexError("truncated extension")
        ext[k] = bytes(buf[off : off + ln])
        off += ln
    return versions, ext, off


def encode_session_server(version: int = VERSION_DRAFT_02, extensions: Optional[Dict[int, bytes]] = None) -> bytes:
    out = bytearray(encode_varint(version))
    ext = extensions or {}
    out += encode_varint(len(ext))
    for k, v in ext.items():
        out += encode_varint(k) + encode_varint(len(v)) + v
    return bytes(out)


def decode_session_server(buf, off: int = 0) -> Tuple[int, Dict[int, bytes], int]:
    version, off = decode_varint(buf, off)
    ne, off = decode_varint(buf, off)
    if ne > 64:
        raise ValueError("unreasonable extension count")
    ext: Dict[int, bytes] = {}
    for _ in range(ne):
        k, off = decode_varint(buf, off)
        ln, off = decode_varint(buf, off)
        if off + ln > len(buf):
            raise IndexError("truncated extension")
        ext[k] = bytes(buf[off : off + ln])
        off += ln
    return version, ext, off


# -- announce ---------------------------------------------------------------
def encode_announce_please(prefix: str) -> bytes:
    """AnnouncePlease: opens an ANNOUNCE stream asking the peer to announce
    every broadcast path under ``prefix``."""
    return _estr(prefix)


def decode_announce_please(buf, off: int = 0) -> Tuple[str, int]:
    return _dstr(buf, off)


def encode_announce(status: int, suffix: str = "") -> bytes:
    if status == ANNOUNCE_LIVE:
        return encode_varint(ANNOUNCE_LIVE)
    return encode_varint(status) + _estr(suffix)


class AnnounceParser:
    """Incremental parser for Announce messages on an ANNOUNCE stream."""

    def __init__(self) -> None:
        self.buf = bytearray()

    def feed(self, data: bytes) -> List[Tuple[int, str]]:
        self.buf.extend(data)
        out: List[Tuple[int, str]] = []
        while True:
            try:
                status, off = decode_varint(self.buf, 0)
                if status == ANNOUNCE_LIVE:
                    out.append((status, ""))
                    del self.buf[:off]
                    continue
                if status not in (ANNOUNCE_ENDED, ANNOUNCE_ACTIVE):
                    raise ValueError(f"unknown announce status {status}")
                suffix, off = _dstr(self.buf, off)
                del self.buf[:off]
                out.append((status, suffix))
            except IndexError:
                return out


# -- subscribe ---------------------------------------------------------------
def encode_subscribe(sub_id: int, broadcast: str, track: str, priority: int = 0) -> bytes:
    """Subscribe: sent on a SUBSCRIBE bidi stream after the stream type."""
    return encode_varint(sub_id) + _estr(broadcast) + _estr(track) + bytes([priority & 0xFF])


def decode_subscribe(buf, off: int = 0) -> Tuple[int, str, str, int, int]:
    sub_id, off = decode_varint(buf, off)
    broadcast, off = _dstr(buf, off)
    track, off = _dstr(buf, off)
    if off >= len(buf):
        raise IndexError("truncated subscribe")
    priority = buf[off]
    return sub_id, broadcast, track, priority, off + 1


def encode_subscribe_ok(priority: int = 0) -> bytes:
    return bytes([priority & 0xFF])


def decode_subscribe_ok(buf, off: int = 0) -> Tuple[int, int]:
    if off >= len(buf):
        raise IndexError("truncated subscribe_ok")
    return buf[off], off + 1


# -- groups and frames -------------------------------------------------------
def encode_group_header(sub_id: int, sequence: int) -> bytes:
    """Group header on a GROUP uni stream (after the stream-type varint):
    the subscription id it answers + the group sequence number."""
    return encode_varint(sub_id) + encode_varint(sequence)


def encode_lite_frame(payload: bytes) -> bytes:
    """moq-lite frame: varint size + payload (catalog tracks use this)."""
    return encode_varint(len(payload)) + payload


def encode_hang_frame(payload: bytes, timestamp_us: int) -> bytes:
    """hang media frame: the moq-lite frame wraps a varint microsecond
    timestamp header + media bytes (peer.rs:868-871)."""
    inner = encode_varint(max(0, timestamp_us)) + payload
    return encode_varint(len(inner)) + inner


def decode_hang_frame(frame: bytes) -> Tuple[bytes, int]:
    """(media_bytes, timestamp_us) from a complete frame payload."""
    ts, off = decode_varint(frame, 0)
    return bytes(frame[off:]), ts


@dataclass
class LiteGroupParser:
    """Incremental parser for one GROUP uni stream (stream-type varint
    already consumed by the classifier)."""

    buf: bytearray = field(default_factory=bytearray)
    sub_id: Optional[int] = None
    sequence: Optional[int] = None

    def feed(self, data: bytes) -> List[bytes]:
        """Returns completed frame payloads (hang header NOT stripped)."""
        self.buf.extend(data)
        out: List[bytes] = []
        while True:
            try:
                off = 0
                if self.sub_id is None:
                    sub_id, off = decode_varint(self.buf, off)
                    seq, off = decode_varint(self.buf, off)
                    del self.buf[:off]
                    self.sub_id = sub_id
                    self.sequence = seq
                    continue
                ln, off = decode_varint(self.buf, 0)
                if off + ln > len(self.buf):
                    return out
                out.append(bytes(self.buf[off : off + ln]))
                del self.buf[: off + ln]
            except IndexError:
                return out


# -- hang catalog ------------------------------------------------------------
def build_catalog(
    track: str = AUDIO_TRACK,
    sample_rate: int = 48_000,
    channels: int = 1,
    bitrate: Optional[int] = 64_000,
    priority: int = AUDIO_PRIORITY,
) -> bytes:
    """hang catalog JSON advertising one Opus audio rendition
    (peer.rs:1030-1060)."""
    cfg: dict = {
        "codec": "opus",
        "sampleRate": sample_rate,
        "channelCount": channels,
    }
    if bitrate is not None:
        cfg["bitrate"] = bitrate
    return json.dumps(
        {"audio": {"renditions": {track: cfg}, "priority": priority}}
    ).encode()


def parse_catalog(data: bytes) -> List[Tuple[str, dict]]:
    """[(track_name, config)] for every audio rendition in a catalog."""
    doc = json.loads(data.decode())
    audio = doc.get("audio") or {}
    rend = audio.get("renditions") or {}
    return [(name, cfg) for name, cfg in rend.items()]
