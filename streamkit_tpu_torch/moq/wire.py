# SPDX-License-Identifier: Apache-2.0
"""MoQ wire protocol over WebTransport (moq-lite analog, own design).

The reference speaks moq-lite to an external relay
(``crates/transport/moq/src/peer.rs:459-880``, version decode ``peer.rs:870``,
group cadence ``moq/constants.rs:22-46``). Our relay is in-process, so we
define a compact session protocol with the same shape:

* a client-opened *control* bidi stream carrying varint-typed messages:
  SETUP/SETUP_OK (version negotiation), PUBLISH/PUBLISH_OK (intent to send a
  named broadcast), SUBSCRIBE/SUBSCRIBE_OK/SUBSCRIBE_ERROR (receive one)
* *group* uni streams: header ``alias varint, group_seq varint`` then frames
  ``flags u8 | timestamp_us varint | len varint | payload`` — one stream per
  MoQ group, so group-based dropping maps 1:1 onto QUIC stream lifetimes

Names resolve against the gateway's external routes first (peer sessions,
e.g. ``/transcoder/input``), then the relay's broadcast namespace
(e.g. ``lt-live``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..quic.packet import decode_varint, encode_varint

__all__ = [
    "MOQ_VERSION",
    "MSG_SETUP",
    "MSG_PUBLISH",
    "MSG_SUBSCRIBE",
    "MSG_SETUP_OK",
    "MSG_PUBLISH_OK",
    "MSG_SUBSCRIBE_OK",
    "MSG_SUBSCRIBE_ERROR",
    "MSG_UNSUBSCRIBE",
    "encode_msg",
    "ControlParser",
    "encode_group_header",
    "encode_frame",
    "GroupParser",
]

MOQ_VERSION = 1

MSG_SETUP = 0x01
MSG_PUBLISH = 0x02
MSG_SUBSCRIBE = 0x03
MSG_UNSUBSCRIBE = 0x04
MSG_SETUP_OK = 0x41
MSG_PUBLISH_OK = 0x42
MSG_SUBSCRIBE_OK = 0x43
MSG_SUBSCRIBE_ERROR = 0x44


def encode_msg(mtype: int, *fields) -> bytes:
    """Control message: type varint + fields (ints as varints, str/bytes as
    varint-length-prefixed)."""
    out = bytearray(encode_varint(mtype))
    for f in fields:
        if isinstance(f, int):
            out += encode_varint(f)
        else:
            b = f.encode() if isinstance(f, str) else f
            out += encode_varint(len(b)) + b
    return bytes(out)


# field schemas per message type: i = varint, s = string
_SCHEMA = {
    MSG_SETUP: "i",  # version
    MSG_SETUP_OK: "i",  # version
    MSG_PUBLISH: "is",  # alias, name
    MSG_PUBLISH_OK: "i",  # alias
    MSG_SUBSCRIBE: "is",  # alias, name
    MSG_SUBSCRIBE_OK: "i",  # alias
    MSG_SUBSCRIBE_ERROR: "is",  # alias, reason
    MSG_UNSUBSCRIBE: "i",  # alias
}


class ControlParser:
    """Incremental parser for the control stream."""

    def __init__(self) -> None:
        self.buf = bytearray()

    def feed(self, data: bytes) -> List[Tuple[int, tuple]]:
        self.buf.extend(data)
        out = []
        while True:
            parsed = self._try_one()
            if parsed is None:
                return out
            out.append(parsed)

    def _try_one(self) -> Optional[Tuple[int, tuple]]:
        try:
            mtype, off = decode_varint(self.buf, 0)
            schema = _SCHEMA.get(mtype)
            if schema is None:
                raise ValueError(f"unknown MoQ control message {mtype:#x}")
            fields = []
            for kind in schema:
                if kind == "i":
                    v, off = decode_varint(self.buf, off)
                    fields.append(v)
                else:
                    ln, off = decode_varint(self.buf, off)
                    if off + ln > len(self.buf):
                        raise IndexError
                    fields.append(bytes(self.buf[off : off + ln]).decode())
                    off += ln
        except IndexError:
            return None
        del self.buf[:off]
        return mtype, tuple(fields)


def encode_group_header(alias: int, group_seq: int) -> bytes:
    return encode_varint(alias) + encode_varint(group_seq)


def encode_frame(payload: bytes, timestamp_us: int, key: bool = False) -> bytes:
    return (
        bytes([1 if key else 0])
        + encode_varint(max(0, timestamp_us))
        + encode_varint(len(payload))
        + payload
    )


@dataclass
class GroupParser:
    """Incremental parser for one group uni stream."""

    buf: bytearray = None  # type: ignore[assignment]
    alias: Optional[int] = None
    group_seq: Optional[int] = None

    def __post_init__(self) -> None:
        if self.buf is None:
            self.buf = bytearray()

    def feed(self, data: bytes) -> List[Tuple[bytes, int, bool]]:
        """Returns completed frames as (payload, timestamp_us, key)."""
        self.buf.extend(data)
        out: List[Tuple[bytes, int, bool]] = []
        while True:
            try:
                off = 0
                if self.alias is None:
                    alias, off = decode_varint(self.buf, off)
                    seq, off = decode_varint(self.buf, off)
                    del self.buf[:off]
                    self.alias = alias
                    self.group_seq = seq
                    continue
                flags = self.buf[0]
                ts, off = decode_varint(self.buf, 1)
                ln, off = decode_varint(self.buf, off)
                if off + ln > len(self.buf):
                    return out
                payload = bytes(self.buf[off : off + ln])
                del self.buf[: off + ln]
                out.append((payload, ts, bool(flags & 1)))
            except IndexError:
                return out
