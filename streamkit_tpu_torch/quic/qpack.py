# SPDX-License-Identifier: Apache-2.0
"""QPACK (RFC 9204) with static-table-only dynamics.

Encoding always uses Required Insert Count = 0 (no dynamic table), which is
fully interoperable — peers are never required to use dynamic entries.
Decoding handles indexed static field lines, literals with static name
references, and literals with literal names, including Huffman-coded string
literals (RFC 7541 Appendix B table) so browser-encoded CONNECT requests
parse. The huffman table below is the standard RFC 7541 code table packed
as (nbits u8, code u32be) × 257, base64."""

from __future__ import annotations

import base64
import struct
from typing import Dict, List, Optional, Tuple

__all__ = ["encode_field_section", "decode_field_section", "QpackError"]


class QpackError(Exception):
    pass


# RFC 9204 Appendix A — the QPACK static table (index → (name, value)).
STATIC_TABLE: List[Tuple[str, str]] = [
    (":authority", ""),
    (":path", "/"),
    ("age", "0"),
    ("content-disposition", ""),
    ("content-length", "0"),
    ("cookie", ""),
    ("date", ""),
    ("etag", ""),
    ("if-modified-since", ""),
    ("if-none-match", ""),
    ("last-modified", ""),
    ("link", ""),
    ("location", ""),
    ("referer", ""),
    ("set-cookie", ""),
    (":method", "CONNECT"),
    (":method", "DELETE"),
    (":method", "GET"),
    (":method", "HEAD"),
    (":method", "OPTIONS"),
    (":method", "POST"),
    (":method", "PUT"),
    (":scheme", "http"),
    (":scheme", "https"),
    (":status", "103"),
    (":status", "200"),
    (":status", "304"),
    (":status", "404"),
    (":status", "503"),
    ("accept", "*/*"),
    ("accept", "application/dns-message"),
    ("accept-encoding", "gzip, deflate, br"),
    ("accept-ranges", "bytes"),
    ("access-control-allow-headers", "cache-control"),
    ("access-control-allow-headers", "content-type"),
    ("access-control-allow-origin", "*"),
    ("cache-control", "max-age=0"),
    ("cache-control", "max-age=2592000"),
    ("cache-control", "max-age=604800"),
    ("cache-control", "no-cache"),
    ("cache-control", "no-store"),
    ("cache-control", "public, max-age=31536000"),
    ("content-encoding", "br"),
    ("content-encoding", "gzip"),
    ("content-type", "application/dns-message"),
    ("content-type", "application/javascript"),
    ("content-type", "application/json"),
    ("content-type", "application/x-www-form-urlencoded"),
    ("content-type", "image/gif"),
    ("content-type", "image/jpeg"),
    ("content-type", "image/png"),
    ("content-type", "text/css"),
    ("content-type", "text/html; charset=utf-8"),
    ("content-type", "text/plain"),
    ("content-type", "text/plain;charset=utf-8"),
    ("range", "bytes=0-"),
    ("strict-transport-security", "max-age=31536000"),
    ("strict-transport-security", "max-age=31536000; includesubdomains"),
    ("strict-transport-security", "max-age=31536000; includesubdomains; preload"),
    ("vary", "accept-encoding"),
    ("vary", "origin"),
    ("x-content-type-options", "nosniff"),
    ("x-xss-protection", "1; mode=block"),
    (":status", "100"),
    (":status", "204"),
    (":status", "206"),
    (":status", "302"),
    (":status", "400"),
    (":status", "403"),
    (":status", "421"),
    (":status", "425"),
    (":status", "500"),
    ("accept-language", ""),
    ("access-control-allow-credentials", "FALSE"),
    ("access-control-allow-credentials", "TRUE"),
    ("access-control-allow-headers", "*"),
    ("access-control-allow-methods", "get"),
    ("access-control-allow-methods", "get, post, options"),
    ("access-control-allow-methods", "options"),
    ("access-control-expose-headers", "content-length"),
    ("access-control-request-headers", "content-type"),
    ("access-control-request-method", "get"),
    ("access-control-request-method", "post"),
    ("alt-svc", "clear"),
    ("authorization", ""),
    (
        "content-security-policy",
        "script-src 'none'; object-src 'none'; base-uri 'none'",
    ),
    ("early-data", "1"),
    ("expect-ct", ""),
    ("forwarded", ""),
    ("if-range", ""),
    ("origin", ""),
    ("purpose", "prefetch"),
    ("server", ""),
    ("timing-allow-origin", "*"),
    ("upgrade-insecure-requests", "1"),
    ("user-agent", ""),
    ("x-forwarded-for", ""),
    ("x-frame-options", "deny"),
    ("x-frame-options", "sameorigin"),
]

_EXACT: Dict[Tuple[str, str], int] = {}
_NAME: Dict[str, int] = {}
for _i, (_n, _v) in enumerate(STATIC_TABLE):
    _EXACT.setdefault((_n, _v), _i)
    _NAME.setdefault(_n, _i)


# ---------------------------------------------------------------------------
# RFC 7541 Appendix B huffman table, packed (nbits u8, code u32be) x 257
_HUFF_B64 = (
    "DQAAH/gXAH//2BwP///iHA///+McD///5BwP///lHA///+YcD///5xwP///oGAD//+oeP////BwP"
    "///pHA///+oeP////RwP///rHA///+wcD///7RwP///uHA///+8cD///8BwP///xHA////IeP///"
    "/hwP///zHA////QcD///9RwP///2HA////ccD///+BwP///5HA////ocD///+wYAAAAUCgAAA/gK"
    "AAAD+QwAAA/6DQAAH/kGAAAAFQgAAAD4CwAAB/oKAAAD+goAAAP7CAAAAPkLAAAH+wgAAAD6BgAA"
    "ABYGAAAAFwYAAAAYBQAAAAAFAAAAAQUAAAACBgAAABkGAAAAGgYAAAAbBgAAABwGAAAAHQYAAAAe"
    "BgAAAB8HAAAAXAgAAAD7DwAAf/wGAAAAIAwAAA/7CgAAA/wNAAAf+gYAAAAhBwAAAF0HAAAAXgcA"
    "AABfBwAAAGAHAAAAYQcAAABiBwAAAGMHAAAAZAcAAABlBwAAAGYHAAAAZwcAAABoBwAAAGkHAAAA"
    "agcAAABrBwAAAGwHAAAAbQcAAABuBwAAAG8HAAAAcAcAAABxBwAAAHIIAAAA/AcAAABzCAAAAP0N"
    "AAAf+xMAB//wDQAAH/wOAAA//AYAAAAiDwAAf/0FAAAAAwYAAAAjBQAAAAQGAAAAJAUAAAAFBgAA"
    "ACUGAAAAJgYAAAAnBQAAAAYHAAAAdAcAAAB1BgAAACgGAAAAKQYAAAAqBQAAAAcGAAAAKwcAAAB2"
    "BgAAACwFAAAACAUAAAAJBgAAAC0HAAAAdwcAAAB4BwAAAHkHAAAAegcAAAB7DwAAf/4LAAAH/A4A"
    "AD/9DQAAH/0cD////BQAD//mFgA//9IUAA//5xQAD//oFgA//9MWAD//1BYAP//VFwB//9kWAD//"
    "1hcAf//aFwB//9sXAH//3BcAf//dFwB//94YAP//6xcAf//fGAD//+wYAP//7RYAP//XFwB//+AY"
    "AP//7hcAf//hFwB//+IXAH//4xcAf//kFQAf/9wWAD//2BcAf//lFgA//9kXAH//5hcAf//nGAD/"
    "/+8WAD//2hUAH//dFAAP/+kWAD//2xYAP//cFwB//+gXAH//6RUAH//eFwB//+oWAD//3RYAP//e"
    "GAD///AVAB//3xYAP//fFwB//+sXAH//7BUAH//gFQAf/+EWAD//4BUAH//iFwB//+0WAD//4RcA"
    "f//uFwB//+8UAA//6hYAP//iFgA//+MWAD//5BcAf//wFgA//+UWAD//5hcAf//xGgP//+AaA///"
    "4RQAD//rEwAH//EWAD//5xcAf//yFgA//+gZAf//7BoD///iGgP//+MaA///5BsH///eGwf//98a"
    "A///5RgA///xGQH//+0TAAf/8hUAH//jGgP//+YbB///4BsH///hGgP//+cbB///4hgA///yFQAf"
    "/+QVAB//5RoD///oGgP//+kcD////RsH///jGwf//+QbB///5RQAD//sGAD///MUAA//7RUAH//m"
    "FgA//+kVAB//5xUAH//oFwB///MWAD//6hYAP//rGQH//+4ZAf//7xgA///0GAD///UaA///6hcA"
    "f//0GgP//+sbB///5hoD///sGgP//+0bB///5xsH///oGwf//+kbB///6hsH///rHA////4bB///"
    "7BsH///tGwf//+4bB///7xsH///wGgP//+4eP////w=="
)

_packed = base64.b64decode(_HUFF_B64)
HUFF_CODES: List[Tuple[int, int]] = [
    struct.unpack_from("!BI", _packed, i * 5) for i in range(257)
]  # (nbits, code) per symbol

# build a decode map from (nbits, code) -> symbol
_HUFF_DECODE: Dict[Tuple[int, int], int] = {
    (nbits, code): sym for sym, (nbits, code) in enumerate(HUFF_CODES)
}
_MIN_BITS = min(n for n, _ in HUFF_CODES)
_MAX_BITS = max(n for n, _ in HUFF_CODES)


def huffman_decode(data: bytes) -> bytes:
    """Decode an RFC 7541 huffman-coded string literal."""
    out = bytearray()
    acc = 0
    nbits = 0
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= _MIN_BITS:
            for ln in range(_MIN_BITS, min(nbits, _MAX_BITS) + 1):
                code = acc >> (nbits - ln)
                sym = _HUFF_DECODE.get((ln, code))
                if sym is not None:
                    if sym == 256:
                        raise QpackError("EOS symbol in huffman stream")
                    out.append(sym)
                    nbits -= ln
                    acc &= (1 << nbits) - 1
                    break
            else:
                break  # need more bits
            continue
    # remaining bits must be a prefix of EOS (all ones), <= 7 bits
    if nbits > 7 or (acc != (1 << nbits) - 1 and nbits > 0):
        raise QpackError("invalid huffman padding")
    return bytes(out)


# ---------------------------------------------------------------------------
# prefix integers (RFC 7541 §5.1)


def _encode_int(value: int, prefix_bits: int, first_byte: int) -> bytes:
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([first_byte | value])
    out = bytearray([first_byte | limit])
    value -= limit
    while value >= 128:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    out.append(value)
    return bytes(out)


def _decode_int(data: bytes, off: int, prefix_bits: int) -> Tuple[int, int]:
    limit = (1 << prefix_bits) - 1
    v = data[off] & limit
    off += 1
    if v < limit:
        return v, off
    shift = 0
    while True:
        b = data[off]
        off += 1
        v += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, off


def _encode_string(s: str) -> bytes:
    b = s.encode()
    return _encode_int(len(b), 7, 0x00) + b  # H=0, no huffman on encode


def _decode_string(data: bytes, off: int, prefix_bits: int) -> Tuple[str, int]:
    huff = bool(data[off] & (1 << prefix_bits))
    ln, off = _decode_int(data, off, prefix_bits)
    raw = data[off : off + ln]
    off += ln
    if huff:
        raw = huffman_decode(raw)
    return raw.decode("utf-8", "replace"), off


# ---------------------------------------------------------------------------
# field sections


def encode_field_section(headers: List[Tuple[str, str]]) -> bytes:
    """Encode with Required Insert Count = 0 (static-only)."""
    out = bytearray(b"\x00\x00")  # RIC=0, Base=0
    for name, value in headers:
        idx = _EXACT.get((name, value))
        if idx is not None:
            out += _encode_int(idx, 6, 0xC0)  # indexed, static
            continue
        nidx = _NAME.get(name)
        if nidx is not None:
            out += _encode_int(nidx, 4, 0x50)  # literal w/ static name ref
            out += _encode_string(value)
        else:
            nb = name.encode()
            out += _encode_int(len(nb), 3, 0x20)  # literal name, H=0
            out += nb
            out += _encode_string(value)
    return bytes(out)


def decode_field_section(data: bytes) -> List[Tuple[str, str]]:
    off = 0
    ric, off = _decode_int(data, off, 8)
    if ric != 0:
        raise QpackError("dynamic table required (RIC != 0) — unsupported")
    _base, off = _decode_int(data, off, 7)
    headers: List[Tuple[str, str]] = []
    while off < len(data):
        b = data[off]
        if b & 0x80:  # indexed field line
            static = bool(b & 0x40)
            idx, off = _decode_int(data, off, 6)
            if not static:
                raise QpackError("dynamic indexed field line — unsupported")
            name, value = STATIC_TABLE[idx]
            headers.append((name, value))
        elif b & 0x40:  # literal with name reference
            static = bool(b & 0x10)
            idx, off = _decode_int(data, off, 4)
            if not static:
                raise QpackError("dynamic name reference — unsupported")
            name = STATIC_TABLE[idx][0]
            value, off = _decode_string(data, off, 7)
            headers.append((name, value))
        elif b & 0x20:  # literal with literal name
            huff_name = bool(b & 0x08)
            nlen, off = _decode_int(data, off, 3)
            raw = data[off : off + nlen]
            off += nlen
            if huff_name:
                raw = huffman_decode(raw)
            name = raw.decode("utf-8", "replace")
            value, off = _decode_string(data, off, 7)
            headers.append((name, value))
        else:
            raise QpackError(f"unsupported field line pattern {b:#x}")
    return headers
