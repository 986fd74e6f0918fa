# SPDX-License-Identifier: Apache-2.0
"""QUIC v1 wire encoding: varints, long/short headers, packet (un)protection
(RFC 9000 §16-17, RFC 9001 §5.3-5.4)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .crypto import KeySet

__all__ = [
    "encode_varint",
    "decode_varint",
    "PacketType",
    "PlainPacket",
    "protect_packet",
    "unprotect_packet",
    "encode_packet_number",
    "decode_packet_number",
]

QUIC_V1 = 0x00000001


def encode_varint(v: int) -> bytes:
    if v < 0x40:
        return bytes([v])
    if v < 0x4000:
        return (0x4000 | v).to_bytes(2, "big")
    if v < 0x40000000:
        return (0x80000000 | v).to_bytes(4, "big")
    if v < 0x4000000000000000:
        return (0xC000000000000000 | v).to_bytes(8, "big")
    raise ValueError("varint too large")


def decode_varint(buf: bytes, off: int = 0) -> Tuple[int, int]:
    """Returns (value, new_offset)."""
    first = buf[off]
    prefix = first >> 6
    length = 1 << prefix
    v = first & 0x3F
    for i in range(1, length):
        v = (v << 8) | buf[off + i]
    return v, off + length


class PacketType:
    INITIAL = 0
    ZERO_RTT = 1
    HANDSHAKE = 2
    RETRY = 3
    ONE_RTT = 4  # short header (our own enum value)


@dataclass
class PlainPacket:
    """A decrypted (or to-be-encrypted) packet."""

    type: int
    dcid: bytes
    scid: bytes  # empty for short header
    packet_number: int
    payload: bytes
    token: bytes = b""
    version: int = QUIC_V1


def encode_packet_number(pn: int, largest_acked: int = -1) -> bytes:
    """Smallest encoding with enough bits to disambiguate (RFC 9000 §A.2).
    We always use 4 bytes for simplicity and unambiguity."""
    return pn.to_bytes(4, "big")


def decode_packet_number(truncated: int, pn_len: int, largest: int) -> int:
    """RFC 9000 §A.3 packet number recovery."""
    pn_nbits = pn_len * 8
    expected = largest + 1
    pn_win = 1 << pn_nbits
    pn_hwin = pn_win // 2
    pn_mask = pn_win - 1
    candidate = (expected & ~pn_mask) | truncated
    if candidate <= expected - pn_hwin and candidate < (1 << 62) - pn_win:
        return candidate + pn_win
    if candidate > expected + pn_hwin and candidate >= pn_win:
        return candidate - pn_win
    return candidate


def _long_header(pkt: PlainPacket, pn_bytes: bytes, payload_len: int) -> bytes:
    first = 0xC0 | (pkt.type << 4) | (len(pn_bytes) - 1)
    hdr = bytearray([first])
    hdr += pkt.version.to_bytes(4, "big")
    hdr += bytes([len(pkt.dcid)]) + pkt.dcid
    hdr += bytes([len(pkt.scid)]) + pkt.scid
    if pkt.type == PacketType.INITIAL:
        hdr += encode_varint(len(pkt.token)) + pkt.token
    hdr += encode_varint(payload_len + len(pn_bytes))
    return bytes(hdr)


def protect_packet(keys: KeySet, pkt: PlainPacket) -> bytes:
    """Encrypt + apply header protection. Returns the full datagram bytes
    for this packet (caller may coalesce)."""
    pn_bytes = encode_packet_number(pkt.packet_number)
    if pkt.type == PacketType.ONE_RTT:
        first = 0x40 | (len(pn_bytes) - 1)  # fixed bit, no spin/key-phase
        header = bytes([first]) + pkt.dcid + pn_bytes
        pn_offset = 1 + len(pkt.dcid)
    else:
        header = _long_header(pkt, pn_bytes, len(pkt.payload) + 16) + pn_bytes
        pn_offset = len(header) - len(pn_bytes)
    sealed = keys.seal(pkt.packet_number, header, pkt.payload)
    out = bytearray(header + sealed)
    # header protection (RFC 9001 §5.4.1): sample starts 4 bytes after pn start
    sample = bytes(out[pn_offset + 4 : pn_offset + 20])
    mask = keys.hp_mask(sample)
    if out[0] & 0x80:
        out[0] ^= mask[0] & 0x0F
    else:
        out[0] ^= mask[0] & 0x1F
    for i in range(len(pn_bytes)):
        out[pn_offset + i] ^= mask[1 + i]
    return bytes(out)


def peek_header(datagram: bytes, off: int, short_dcid_len: int) -> dict:
    """Parse the unprotected parts of the packet at ``off``. Returns a dict
    with type/version/dcid/scid/token plus offsets needed for unprotection."""
    first = datagram[off]
    if first & 0x80:  # long header
        version = int.from_bytes(datagram[off + 1 : off + 5], "big")
        p = off + 5
        dcil = datagram[p]
        dcid = datagram[p + 1 : p + 1 + dcil]
        p += 1 + dcil
        scil = datagram[p]
        scid = datagram[p + 1 : p + 1 + scil]
        p += 1 + scil
        ptype = (first >> 4) & 0x03
        token = b""
        if ptype == PacketType.INITIAL:
            tlen, p = decode_varint(datagram, p)
            token = datagram[p : p + tlen]
            p += tlen
        if ptype == PacketType.RETRY:
            return {"type": ptype, "version": version, "dcid": dcid, "scid": scid,
                    "token": datagram[p:], "pn_offset": -1, "end": len(datagram)}
        length, p = decode_varint(datagram, p)
        return {
            "type": ptype,
            "version": version,
            "dcid": dcid,
            "scid": scid,
            "token": token,
            "pn_offset": p,
            "end": p + length,
        }
    # short header
    dcid = datagram[off + 1 : off + 1 + short_dcid_len]
    return {
        "type": PacketType.ONE_RTT,
        "version": QUIC_V1,
        "dcid": dcid,
        "scid": b"",
        "token": b"",
        "pn_offset": off + 1 + short_dcid_len,
        "end": len(datagram),
    }


def unprotect_packet(
    keys: KeySet, datagram: bytes, off: int, hdr: dict, largest_pn: int
) -> Optional[PlainPacket]:
    """Remove header protection + decrypt the packet described by ``hdr``.
    Returns None if authentication fails."""
    buf = bytearray(datagram[off : hdr["end"]])
    pn_offset = hdr["pn_offset"] - off
    sample = bytes(buf[pn_offset + 4 : pn_offset + 20])
    if len(sample) < 16:
        return None
    mask = keys.hp_mask(sample)
    if buf[0] & 0x80:
        buf[0] ^= mask[0] & 0x0F
    else:
        buf[0] ^= mask[0] & 0x1F
    pn_len = (buf[0] & 0x03) + 1
    truncated = 0
    for i in range(pn_len):
        buf[pn_offset + i] ^= mask[1 + i]
        truncated = (truncated << 8) | buf[pn_offset + i]
    pn = decode_packet_number(truncated, pn_len, largest_pn)
    header = bytes(buf[: pn_offset + pn_len])
    ciphertext = bytes(buf[pn_offset + pn_len :])
    try:
        payload = keys.open(pn, header, ciphertext)
    except Exception:
        return None
    return PlainPacket(
        type=hdr["type"],
        dcid=hdr["dcid"],
        scid=hdr["scid"],
        packet_number=pn,
        payload=payload,
        token=hdr["token"],
        version=hdr["version"],
    )
