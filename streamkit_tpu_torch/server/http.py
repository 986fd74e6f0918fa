# SPDX-License-Identifier: Apache-2.0
"""HTTP/1.1 and WebSocket (RFC 6455) on the standard library.

The port's own transport, in place of ``aiohttp.web`` (server side) and
``aiohttp.ClientSession`` (client side), with the part of their surface the
server, the CLI and the fetcher node use:

* server: :class:`Application` (a dict, with a :class:`Router` of ``{id}`` /
  ``{path:.*}`` routes, middlewares, ``on_startup`` / ``on_shutdown``),
  :class:`Request` (query, case-insensitive headers, bodies by
  ``Content-Length`` or chunked, ``multipart/form-data``, the
  ``client_max_size`` limit answered with 413), :class:`Response`,
  :func:`json_response`, :class:`StreamResponse` (chunked, one ``drain()``
  per chunk, so a slow client holds the writer back), keep-alive, TLS by
  ``ssl.SSLContext``, and :class:`AppRunner` / :func:`run_app` on
  ``asyncio.start_server``;
* WebSocket: the handshake (``Sec-WebSocket-Accept``), text / binary / ping
  / pong / close frames, fragmented messages (control frames may arrive
  between fragments), masking (required of clients, absent from the
  server), ``max_msg_size`` answered with close code 1009;
* client: :class:`ClientSession` (``get`` / ``post`` / ``delete`` with bytes,
  JSON or :class:`FormData` bodies, streamed responses) and
  :meth:`ClientSession.ws_connect`, with the same framing.

Nothing here blocks the event loop: every read and write is awaited, a body
is read only as far as its handler asks.
"""

from __future__ import annotations

import asyncio
import base64
import enum
import hashlib
import json
import logging
import os
import re
import signal
import ssl
import struct
import time
import urllib.parse
import uuid
from collections.abc import MutableMapping
from email.utils import formatdate
from http import HTTPStatus
from typing import Any, Awaitable, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

log = logging.getLogger(__name__)

__all__ = [
    "Application", "AppRunner", "ClientError", "ClientSession", "FileResponse", "FormData", "Headers",
    "HTTPBadRequest", "HTTPException", "HTTPForbidden", "HTTPMethodNotAllowed", "HTTPNotFound",
    "HTTPRequestEntityTooLarge", "HTTPUnprocessableEntity", "Request", "Response", "Router",
    "StreamResponse", "WSCloseCode", "WSMessage", "WSMsgType", "WebSocketResponse", "json_response",
    "middleware", "run_app",
]

WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
MAX_HEAD_BYTES = 64 * 1024  # request / status line plus headers
READ_CHUNK = 64 * 1024
DISCARD_LIMIT = 1 << 20  # unread request body drained for keep-alive; more closes the connection
DEFAULT_WS_MAX = 4 * 1024 * 1024  # aiohttp's default max_msg_size
WS_CLOSE_TIMEOUT = 10.0
KEEPALIVE_TIMEOUT = 75.0  # an idle connection (or a head that never ends) is closed after this, as aiohttp's


# ---------------------------------------------------------------------------
# headers, errors
# ---------------------------------------------------------------------------
class Headers(MutableMapping):
    """Case-insensitive header map that keeps the names as given."""

    def __init__(self, items=None) -> None:
        self._d: Dict[str, Tuple[str, str]] = {}
        if items:
            for k, v in dict(items).items():
                self[k] = v

    def __getitem__(self, key: str) -> str:
        return self._d[key.lower()][1]

    def __setitem__(self, key: str, value: str) -> None:
        self._d[key.lower()] = (key, str(value))

    def __delitem__(self, key: str) -> None:
        del self._d[key.lower()]

    def __contains__(self, key) -> bool:
        return isinstance(key, str) and key.lower() in self._d

    def __iter__(self) -> Iterator[str]:
        return (name for name, _ in self._d.values())

    def __len__(self) -> int:
        return len(self._d)

    def __repr__(self) -> str:
        return f"Headers({dict(self.items())!r})"


class HTTPException(Exception):
    """An HTTP error a handler raises; answered as ``text/plain`` with
    ``text``, by default ``"{status}: {reason}"`` as aiohttp words it."""

    status = 500

    def __init__(self, *, text: Optional[str] = None, headers=None) -> None:
        self.reason = HTTPStatus(self.status).phrase
        self.text = text if text is not None else f"{self.status}: {self.reason}"
        self.headers = Headers(headers)
        super().__init__(self.text)


class HTTPError(HTTPException):
    pass


def _error(name: str, code: int) -> type:
    return type(name, (HTTPError,), {"status": code})


HTTPBadRequest = _error("HTTPBadRequest", 400)
HTTPForbidden = _error("HTTPForbidden", 403)
HTTPNotFound = _error("HTTPNotFound", 404)
HTTPMethodNotAllowed = _error("HTTPMethodNotAllowed", 405)
HTTPUnprocessableEntity = _error("HTTPUnprocessableEntity", 422)


class HTTPRequestEntityTooLarge(HTTPError):
    status = 413

    def __init__(self, max_size: int, actual_size: int) -> None:
        super().__init__(text=f"Maximum request body size {max_size} exceeded, actual body size {actual_size}")


class ClientError(Exception):
    """A client-side failure: connection, framing or timeout."""


def middleware(fn):
    """Marks a middleware ``async def mw(request, handler)`` (kept for the
    aiohttp spelling; every function in ``Application.middlewares`` is one)."""
    return fn


# ---------------------------------------------------------------------------
# message heads and bodies (shared by both sides)
# ---------------------------------------------------------------------------
async def _read_head(reader: asyncio.StreamReader) -> Optional[Tuple[str, Headers]]:
    """Start line and headers, or None at a clean end of the stream."""
    try:
        raw = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial.strip():
            return None
        raise HTTPBadRequest(text="truncated message head") from None
    except asyncio.LimitOverrunError:
        raise HTTPBadRequest(text="message head too large") from None
    lines = raw[:-4].decode("latin-1").split("\r\n")
    headers = Headers()
    for line in lines[1:]:
        name, sep, value = line.partition(":")
        if not sep or not name or name != name.strip():
            raise HTTPBadRequest(text=f"bad header line {line!r}")
        value = value.strip()
        if name in headers:  # repeated header: comma-joined (RFC 9110 §5.3)
            value = headers[name] + ", " + value
        headers[name] = value
    return lines[0], headers


class _Body:
    """A message body read on demand: by ``Content-Length``, chunked, or (a
    response without either) to the end of the stream. ``max_size`` > 0
    refuses a body that reaches it with 413, as aiohttp's ``client_max_size``."""

    def __init__(self, reader: asyncio.StreamReader, headers: Headers, *, max_size: int = 0,
                 to_eof: bool = False, on_first_read: Optional[Callable[[], None]] = None) -> None:
        self._reader = reader
        self._max = max_size
        self._on_first_read = on_first_read
        self.consumed = 0
        self._chunked = "chunked" in headers.get("Transfer-Encoding", "").lower()
        self._chunk_left = 0
        if self._chunked:
            self._left: Optional[int] = None
        elif "Content-Length" in headers:
            try:
                self._left = int(headers["Content-Length"])
            except ValueError:
                raise HTTPBadRequest(text="bad Content-Length") from None
            if self._left < 0:
                raise HTTPBadRequest(text="bad Content-Length")
        else:
            self._left = None if to_eof else 0
        self.eof = self._left == 0 and not self._chunked

    async def read_some(self, n: int = READ_CHUNK) -> bytes:
        """Up to ``n`` bytes; ``b""`` at the end of the body."""
        if self.eof:
            return b""
        if self._on_first_read is not None:
            cb, self._on_first_read = self._on_first_read, None
            cb()
        if self._chunked:
            data = await self._read_chunked(n)
        elif self._left is None:  # to the end of the stream
            data = await self._reader.read(n)
            if not data:
                self.eof = True
        else:
            data = await self._reader.read(min(n, self._left))
            if not data:
                raise ConnectionResetError("connection closed inside a message body")
            self._left -= len(data)
            self.eof = self._left == 0
        self.consumed += len(data)
        if self._max and self.consumed >= self._max:
            raise HTTPRequestEntityTooLarge(self._max, self.consumed)
        return data

    async def _read_chunked(self, n: int) -> bytes:
        if self._chunk_left == 0:
            line = await self._reader.readuntil(b"\r\n")
            try:
                size = int(line.split(b";", 1)[0].strip(), 16)
            except ValueError:
                raise HTTPBadRequest(text="bad chunk size") from None
            if size == 0:  # last chunk, then trailers up to an empty line
                while (await self._reader.readuntil(b"\r\n")) != b"\r\n":
                    pass
                self.eof = True
                return b""
            self._chunk_left = size
        data = await self._reader.readexactly(min(n, self._chunk_left))
        self._chunk_left -= len(data)
        if self._chunk_left == 0 and (await self._reader.readexactly(2)) != b"\r\n":
            raise HTTPBadRequest(text="bad chunk terminator")
        return data

    async def read_all(self) -> bytes:
        out = bytearray()
        while True:
            data = await self.read_some()
            if not data:
                return bytes(out)
            out += data

    async def discard(self, limit: int = DISCARD_LIMIT) -> bool:
        """Read and drop what is left, up to ``limit`` bytes: True when the
        body ended (the connection can carry the next message)."""
        seen = 0
        try:
            while not self.eof and seen <= limit:
                seen += len(await self.read_some())
        except (HTTPException, ConnectionError, asyncio.IncompleteReadError):
            return False
        return self.eof


# ---------------------------------------------------------------------------
# multipart/form-data
# ---------------------------------------------------------------------------
_PARAM = re.compile(r';\s*([\w*-]+)\s*=\s*("(?:[^"\\]|\\.)*"|[^;]*)')


def _header_params(value: str) -> Dict[str, str]:
    out = {}
    for k, v in _PARAM.findall(value):
        v = v.strip()
        if v.startswith('"') and v.endswith('"'):
            v = re.sub(r"\\(.)", r"\1", v[1:-1])
        out[k.lower()] = v
    return out


class BodyPart:
    """One part of a multipart body, read in chunks."""

    def __init__(self, reader: "MultipartReader", headers: Headers) -> None:
        self._reader = reader
        self.headers = headers
        params = _header_params(headers.get("Content-Disposition", ""))
        self.name: Optional[str] = params.get("name")
        self.filename: Optional[str] = params.get("filename")
        self.at_eof = False

    async def read_chunk(self, size: int = 8192) -> bytes:
        if self.at_eof:
            return b""
        data = await self._reader._part_data(size)
        if not data:
            self.at_eof = True
        return data

    async def read(self) -> bytes:
        out = bytearray()
        while True:
            data = await self.read_chunk(READ_CHUNK)
            if not data:
                return bytes(out)
            out += data

    async def release(self) -> None:
        while await self.read_chunk(READ_CHUNK):
            pass


class MultipartReader:
    """Streaming ``multipart/form-data`` parser over a request body: parts
    come one after another, each read as far as its consumer asks."""

    def __init__(self, body: _Body, boundary: str) -> None:
        self._body = body
        self._dash = b"--" + boundary.encode("latin-1")
        self._delim = b"\r\n" + self._dash
        self._buf = bytearray()
        self._current: Optional[BodyPart] = None
        self._started = False
        self._done = False

    async def _fill(self, need: int) -> bool:
        """Buffer at least ``need`` bytes; False if the body ends first."""
        while len(self._buf) < need:
            data = await self._body.read_some()
            if not data:
                return False
            self._buf += data
        return True

    async def _find(self, token: bytes) -> int:
        start = 0
        while True:
            i = self._buf.find(token, start)
            if i >= 0:
                return i
            start = max(0, len(self._buf) - len(token) + 1)
            if not await self._fill(len(self._buf) + 1):
                raise HTTPBadRequest(text="malformed multipart body")

    async def _part_data(self, size: int) -> bytes:
        while True:
            i = self._buf.find(self._delim)
            if i >= 0:
                if i == 0:
                    del self._buf[: len(self._delim)]
                    self._current = None
                    return b""
                take = min(i, size)
            else:
                take = min(len(self._buf) - len(self._delim) + 1, size)
                if take <= 0:
                    if not await self._fill(len(self._buf) + 1):
                        raise HTTPBadRequest(text="malformed multipart body")
                    continue
            out = bytes(self._buf[:take])
            del self._buf[:take]
            return out

    async def next(self) -> Optional[BodyPart]:
        if self._done:
            return None
        if self._current is not None:
            await self._current.release()
        if not self._started:  # preamble, then the first boundary
            i = await self._find(self._dash)
            del self._buf[: i + len(self._dash)]
            self._started = True
        if not await self._fill(2):
            raise HTTPBadRequest(text="malformed multipart body")
        if self._buf[:2] == b"--":  # closing boundary; the epilogue is dropped
            self._done = True
            await self._body.discard()
            return None
        i = await self._find(b"\r\n\r\n")
        head = bytes(self._buf[:i]).decode("latin-1")
        del self._buf[: i + 4]
        headers = Headers()
        for line in head.split("\r\n"):
            name, sep, value = line.partition(":")
            if sep:
                headers[name.strip()] = value.strip()
        self._current = BodyPart(self, headers)
        return self._current

    def __aiter__(self):
        return self

    async def __anext__(self) -> BodyPart:
        part = await self.next()
        if part is None:
            raise StopAsyncIteration
        return part


class FormData:
    """``multipart/form-data`` request body for the client."""

    def __init__(self) -> None:
        self._fields: List[Tuple[str, bytes, Optional[str], Optional[str]]] = []

    def add_field(self, name: str, value, *, filename: Optional[str] = None,
                  content_type: Optional[str] = None) -> None:
        data = value.encode() if isinstance(value, str) else bytes(value)
        self._fields.append((name, data, filename, content_type))

    def encode(self) -> Tuple[bytes, str]:
        boundary = uuid.uuid4().hex
        out = bytearray()
        for name, data, filename, ctype in self._fields:
            disp = f'form-data; name="{name}"' + (f'; filename="{filename}"' if filename else "")
            out += f"--{boundary}\r\nContent-Disposition: {disp}\r\n".encode()
            if ctype:
                out += f"Content-Type: {ctype}\r\n".encode()
            out += b"\r\n" + data + b"\r\n"
        out += f"--{boundary}--\r\n".encode()
        return bytes(out), f"multipart/form-data; boundary={boundary}"


# ---------------------------------------------------------------------------
# server side: request, responses
# ---------------------------------------------------------------------------
def _content_type(headers: Headers) -> str:
    return headers.get("Content-Type", "application/octet-stream").split(";", 1)[0].strip().lower()


class Request:
    """One HTTP request, its body read on demand."""

    def __init__(self, app: "Application", method: str, target: str, version: str, headers: Headers,
                 reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self.app = app
        self.method = method
        self.version = version
        self.headers = headers
        self.raw_path = target
        split = urllib.parse.urlsplit(target)
        self.path = urllib.parse.unquote(split.path)
        self.query_string = split.query
        self.query: Dict[str, str] = {}
        for k, v in urllib.parse.parse_qsl(split.query, keep_blank_values=True):
            self.query.setdefault(k, v)  # the first value of a repeated key, as a MultiDict's get
        self.match_info: Dict[str, str] = {}
        self._reader = reader
        self._writer = writer
        peer = writer.get_extra_info("peername")
        self.remote = peer[0] if isinstance(peer, tuple) else str(peer)
        expect = headers.get("Expect", "").lower() == "100-continue"
        self._body = _Body(reader, headers, max_size=app.client_max_size,
                           on_first_read=self._send_continue if expect else None)
        self._read_bytes: Optional[bytes] = None
        self._response: Optional[StreamResponse] = None
        self._upgraded: Optional["WebSocketResponse"] = None
        self.keep_alive = (version == "HTTP/1.1" and "close" not in headers.get("Connection", "").lower()) or (
            version == "HTTP/1.0" and "keep-alive" in headers.get("Connection", "").lower())

    def _send_continue(self) -> None:
        self._writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")

    @property
    def content_type(self) -> str:
        return _content_type(self.headers)

    async def read(self) -> bytes:
        if self._read_bytes is None:
            self._read_bytes = await self._body.read_all()
        return self._read_bytes

    async def text(self) -> str:
        return (await self.read()).decode("utf-8")

    async def json(self):
        return json.loads(await self.text())

    async def multipart(self) -> MultipartReader:
        boundary = _header_params(self.headers.get("Content-Type", "")).get("boundary")
        if self.content_type.split("/")[0] != "multipart" or not boundary:
            raise HTTPBadRequest(text="not a multipart body")
        return MultipartReader(self._body, boundary)


_REASONS = {s.value: s.phrase for s in HTTPStatus}


def _header_block(headers: Headers) -> bytes:
    return "".join(f"{k}: {v}\r\n" for k, v in headers.items()).encode("latin-1") + b"\r\n"


def _head_bytes(status: int, headers: Headers) -> bytes:
    return f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n".encode() + _header_block(headers)


class StreamResponse:
    """A response whose body is written as it is produced: chunked transfer
    encoding, and one ``drain()`` per chunk."""

    def __init__(self, *, status: int = 200, headers=None) -> None:
        self.status = status
        self.headers = Headers(headers)
        self.prepared = False
        self._request: Optional[Request] = None
        self._chunked = False
        self._eof_sent = False

    async def prepare(self, request: Request) -> None:
        if self.prepared:
            return
        self._request = request
        self._chunked = "Content-Length" not in self.headers and request.version == "HTTP/1.1"
        if self._chunked:
            self.headers["Transfer-Encoding"] = "chunked"
        elif "Content-Length" not in self.headers:
            request.keep_alive = False  # an HTTP/1.0 client reads to the close
        self.headers.setdefault("Date", formatdate(usegmt=True))
        if not request.keep_alive:
            self.headers["Connection"] = "close"
        request._writer.write(_head_bytes(self.status, self.headers))
        self.prepared = True
        request._response = self
        await request._writer.drain()

    async def write(self, data: bytes) -> None:
        if not data:
            return
        w = self._request._writer
        if w.is_closing():
            raise ConnectionResetError("Cannot write to closing transport")
        w.write(b"%X\r\n%b\r\n" % (len(data), data) if self._chunked else data)
        await w.drain()

    async def write_eof(self) -> None:
        if self._eof_sent:
            return
        self._eof_sent = True
        w = self._request._writer
        if self._chunked and not w.is_closing():
            w.write(b"0\r\n\r\n")
            await w.drain()


class Response(StreamResponse):
    """A whole response: ``body`` bytes or ``text`` (``charset=utf-8``)."""

    def __init__(self, *, body: Optional[bytes] = None, text: Optional[str] = None, status: int = 200,
                 content_type: Optional[str] = None, headers=None) -> None:
        super().__init__(status=status, headers=headers)
        if text is not None:
            self.body = text.encode("utf-8")
            self.headers.setdefault("Content-Type", f"{content_type or 'text/plain'}; charset=utf-8")
        else:
            self.body = body or b""
            self.headers.setdefault("Content-Type", content_type or "application/octet-stream")

    async def prepare(self, request: Request) -> None:
        self.headers["Content-Length"] = str(len(self.body))
        await super().prepare(request)
        if request.method != "HEAD":
            request._writer.write(self.body)
        self._eof_sent = True
        await request._writer.drain()


def json_response(data: Any, *, status: int = 200, headers=None) -> Response:
    return Response(text=json.dumps(data), status=status, content_type="application/json", headers=headers)


def FileResponse(path: str, *, content_type: Optional[str] = None) -> Response:
    """A file's bytes, its type from its name (the files served are small)."""
    import mimetypes

    with open(path, "rb") as f:
        body = f.read()
    return Response(body=body, content_type=content_type or mimetypes.guess_type(path)[0] or "application/octet-stream")


# ---------------------------------------------------------------------------
# WebSocket framing (RFC 6455)
# ---------------------------------------------------------------------------
class WSMsgType(enum.IntEnum):
    CONTINUATION = 0x0
    TEXT = 0x1
    BINARY = 0x2
    CLOSE = 0x8
    PING = 0x9
    PONG = 0xA
    CLOSING = 0x100
    CLOSED = 0x101
    ERROR = 0x102


class WSCloseCode(enum.IntEnum):
    OK = 1000
    GOING_AWAY = 1001
    PROTOCOL_ERROR = 1002
    INVALID_TEXT = 1007
    MESSAGE_TOO_BIG = 1009


class WSMessage(NamedTuple):
    type: WSMsgType
    data: Any
    extra: Any = None

    def json(self):
        return json.loads(self.data)


_CLOSED_MSG = WSMessage(WSMsgType.CLOSED, None)


def _mask(data: bytes, key: bytes) -> bytes:
    n = len(data)
    if not n:
        return b""
    k = (key * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "little") ^ int.from_bytes(k, "little")).to_bytes(n, "little")


def _frame(opcode: int, payload: bytes, *, mask: bool, fin: bool = True) -> bytes:
    b0 = (0x80 if fin else 0) | opcode
    m = 0x80 if mask else 0
    n = len(payload)
    if n < 126:
        head = struct.pack("!BB", b0, m | n)
    elif n < 1 << 16:
        head = struct.pack("!BBH", b0, m | 126, n)
    else:
        head = struct.pack("!BBQ", b0, m | 127, n)
    if mask:
        key = os.urandom(4)
        return head + key + _mask(payload, key)
    return head + payload


class _ProtocolError(Exception):
    def __init__(self, code: int, message: str) -> None:
        super().__init__(message)
        self.code = code


def ws_accept(key: str) -> str:
    return base64.b64encode(hashlib.sha1(key.encode("latin-1") + WS_GUID).digest()).decode()


class _WebSocket:
    """One WebSocket endpoint over a stream pair. ``client`` masks what it
    sends and refuses masked frames; the server side requires masked frames
    and sends them unmasked. Pings are answered with pongs, a close frame
    with a close frame, a message past ``max_msg_size`` with 1009."""

    def __init__(self, max_msg_size: int = DEFAULT_WS_MAX, *, client: bool) -> None:
        self.max_msg_size = max_msg_size
        self._client = client
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._close_sent = False
        self._close_received = asyncio.Event()
        self._reading = False
        self.close_code: Optional[int] = None

    def _attach(self, reader, writer) -> None:
        self._reader, self._writer = reader, writer

    @property
    def closed(self) -> bool:
        return self._close_sent or self._close_received.is_set() or self._writer is None or self._writer.is_closing()

    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        if self._writer is None or self._writer.is_closing():
            raise ConnectionResetError("Cannot write to closing transport")
        self._writer.write(_frame(opcode, payload, mask=self._client))
        await self._writer.drain()

    async def _send_data(self, opcode: int, payload: bytes) -> None:
        if self._close_sent:
            raise ConnectionResetError("Cannot write to closing transport")
        await self._send_frame(opcode, payload)

    async def send_str(self, data: str) -> None:
        await self._send_data(WSMsgType.TEXT, data.encode("utf-8"))

    async def send_bytes(self, data: bytes) -> None:
        await self._send_data(WSMsgType.BINARY, bytes(data))

    async def send_json(self, data: Any) -> None:
        await self.send_str(json.dumps(data))

    async def ping(self, payload: bytes = b"") -> None:
        await self._send_data(WSMsgType.PING, payload)

    async def _send_close(self, code: int, message: bytes = b"") -> None:
        if self._close_sent:
            return
        self._close_sent = True
        try:
            await self._send_frame(WSMsgType.CLOSE, struct.pack("!H", code) + message[:123])
        except (ConnectionError, RuntimeError):
            pass

    def _drop(self) -> None:
        if self._writer is not None and not self._writer.is_closing():
            self._writer.close()
        self._close_received.set()

    async def _read_frame(self) -> Tuple[bool, int, bytes]:
        b0, b1 = await self._reader.readexactly(2)
        if b0 & 0x70:
            raise _ProtocolError(WSCloseCode.PROTOCOL_ERROR, "reserved bits set")
        fin, opcode, masked, n = bool(b0 & 0x80), b0 & 0x0F, bool(b1 & 0x80), b1 & 0x7F
        if n == 126:
            (n,) = struct.unpack("!H", await self._reader.readexactly(2))
        elif n == 127:
            (n,) = struct.unpack("!Q", await self._reader.readexactly(8))
        if masked == self._client:
            raise _ProtocolError(WSCloseCode.PROTOCOL_ERROR,
                                 "masked frame from the server" if self._client else "unmasked frame from a client")
        if opcode >= 0x8 and (n > 125 or not fin):
            raise _ProtocolError(WSCloseCode.PROTOCOL_ERROR, "bad control frame")
        if opcode not in (0x0, 0x1, 0x2, 0x8, 0x9, 0xA):
            raise _ProtocolError(WSCloseCode.PROTOCOL_ERROR, f"unknown opcode {opcode}")
        return fin, opcode, masked, n

    async def receive(self, timeout: Optional[float] = None) -> WSMessage:
        if timeout is not None:
            return await asyncio.wait_for(self.receive(), timeout)
        if self._close_received.is_set() or self._reader is None:
            return _CLOSED_MSG
        self._reading = True
        try:
            return await self._receive()
        finally:
            self._reading = False

    async def _receive(self) -> WSMessage:
        parts: List[bytes] = []
        size, msg_op = 0, None
        try:
            while True:
                fin, opcode, masked, n = await self._read_frame()
                if opcode < 0x8 and size + n > self.max_msg_size:
                    raise _ProtocolError(WSCloseCode.MESSAGE_TOO_BIG,
                                         f"message size {size + n} exceeds limit {self.max_msg_size}")
                if masked:
                    key = await self._reader.readexactly(4)
                    payload = _mask(await self._reader.readexactly(n), key)
                else:
                    payload = await self._reader.readexactly(n)
                if opcode == WSMsgType.PING:
                    await self._send_frame(WSMsgType.PONG, payload)
                    continue
                if opcode == WSMsgType.PONG:
                    continue
                if opcode == WSMsgType.CLOSE:
                    code = struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else WSCloseCode.OK
                    self.close_code = code
                    await self._send_close(code)
                    self._drop()
                    return WSMessage(WSMsgType.CLOSE, code, payload[2:].decode("utf-8", "replace"))
                if opcode == WSMsgType.CONTINUATION:
                    if msg_op is None:
                        raise _ProtocolError(WSCloseCode.PROTOCOL_ERROR, "continuation without a message")
                else:
                    if msg_op is not None:
                        raise _ProtocolError(WSCloseCode.PROTOCOL_ERROR, "new message inside a fragmented one")
                    msg_op = opcode
                parts.append(payload)
                size += n
                if fin:
                    data = b"".join(parts)
                    if msg_op == WSMsgType.TEXT:
                        try:
                            return WSMessage(WSMsgType.TEXT, data.decode("utf-8"))
                        except UnicodeDecodeError:
                            raise _ProtocolError(WSCloseCode.INVALID_TEXT, "invalid UTF-8 text") from None
                    return WSMessage(WSMsgType.BINARY, data)
        except _ProtocolError as e:
            self.close_code = e.code
            await self._send_close(e.code, str(e).encode())
            self._drop()
            return WSMessage(WSMsgType.ERROR, e)
        except (asyncio.IncompleteReadError, ConnectionError):
            self.close_code = WSCloseCode.GOING_AWAY if self.close_code is None else self.close_code
            self._drop()
            return _CLOSED_MSG

    async def close(self, *, code: int = WSCloseCode.OK, message: bytes = b"") -> bool:
        """Send a close frame and wait (up to 10 s) for the peer's."""
        if self._writer is None:
            return False
        already = self._close_sent
        await self._send_close(code, message)
        if self.close_code is None:
            self.close_code = code
        if not self._close_received.is_set():
            try:
                if self._reading:  # another task reads: it sees the close frame
                    await asyncio.wait_for(self._close_received.wait(), WS_CLOSE_TIMEOUT)
                else:
                    async with asyncio.timeout(WS_CLOSE_TIMEOUT):
                        while (await self.receive()).type not in (WSMsgType.CLOSE, WSMsgType.CLOSED,
                                                                 WSMsgType.ERROR):
                            pass
            except asyncio.TimeoutError:
                pass
        self._drop()
        return not already

    def __aiter__(self):
        return self

    async def __anext__(self) -> WSMessage:
        msg = await self.receive()
        if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING, WSMsgType.CLOSED, WSMsgType.ERROR):
            raise StopAsyncIteration
        return msg


class WebSocketResponse(_WebSocket):
    """Server side of a WebSocket, prepared from an upgrade request."""

    def __init__(self, *, max_msg_size: int = DEFAULT_WS_MAX) -> None:
        super().__init__(max_msg_size, client=False)
        self.prepared = False

    async def prepare(self, request: Request) -> None:
        h = request.headers
        key = h.get("Sec-WebSocket-Key", "")
        try:
            key_ok = len(base64.b64decode(key, validate=True)) == 16
        except ValueError:
            key_ok = False
        if (h.get("Upgrade", "").lower() != "websocket" or "upgrade" not in h.get("Connection", "").lower()
                or h.get("Sec-WebSocket-Version") != "13" or not key_ok):
            raise HTTPBadRequest(text="not a WebSocket upgrade request")
        headers = Headers({"Upgrade": "websocket", "Connection": "Upgrade",
                           "Sec-WebSocket-Accept": ws_accept(key)})
        request._writer.write(_head_bytes(101, headers))
        await request._writer.drain()
        self._attach(request._reader, request._writer)
        request._upgraded = self
        self.prepared = True


# ---------------------------------------------------------------------------
# router, application, server
# ---------------------------------------------------------------------------
Handler = Callable[[Request], Awaitable[StreamResponse]]
_SEGMENT = re.compile(r"\{(\w+)(?::([^}]*))?\}")


class Router:
    """Routes by method and path; ``{name}`` matches one path segment,
    ``{name:regex}`` its regex (``{path:.*}`` the rest of the path)."""

    def __init__(self) -> None:
        self._routes: List[Tuple[str, re.Pattern, Handler]] = []

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        pattern, last = "", 0
        for m in _SEGMENT.finditer(path):
            pattern += re.escape(path[last : m.start()]) + f"(?P<{m.group(1)}>{m.group(2) or '[^/]+'})"
            last = m.end()
        pattern += re.escape(path[last:])
        self._routes.append((method.upper(), re.compile(pattern), handler))

    def add_get(self, path: str, handler: Handler) -> None:
        self.add_route("GET", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self.add_route("POST", path, handler)

    def add_delete(self, path: str, handler: Handler) -> None:
        self.add_route("DELETE", path, handler)

    def resolve(self, method: str, raw_path: str) -> Tuple[Handler, Dict[str, str]]:
        allowed = []
        for m, rx, handler in self._routes:
            match = rx.fullmatch(raw_path)
            if match is None:
                continue
            if m == method or (method == "HEAD" and m == "GET"):
                return handler, {k: urllib.parse.unquote(v) for k, v in match.groupdict().items()}
            allowed.append(m)
        if allowed:
            raise HTTPMethodNotAllowed(headers={"Allow": ",".join(sorted(set(allowed)))})
        raise HTTPNotFound()


class Application(dict):
    """Routes, middlewares and lifecycle hooks; holds app state by key
    (``app["state"]``)."""

    def __init__(self, *, client_max_size: int = 1024 ** 2, middlewares=()) -> None:
        super().__init__()
        self.router = Router()
        self.client_max_size = client_max_size
        self.middlewares = list(middlewares)
        self.on_startup: List[Callable[["Application"], Awaitable[None]]] = []
        self.on_shutdown: List[Callable[["Application"], Awaitable[None]]] = []

    async def _handle(self, request: Request) -> StreamResponse:
        async def endpoint(req: Request) -> StreamResponse:
            handler, req.match_info = self.router.resolve(req.method, urllib.parse.urlsplit(req.raw_path).path)
            return await handler(req)

        handler = endpoint
        for mw in reversed(self.middlewares):
            handler = (lambda m, h: (lambda req: m(req, h)))(mw, handler)
        return await handler(request)


def _error_response(status: int, text: str, headers=None) -> Response:
    return Response(text=text, status=status, headers=headers)


class AppRunner:
    """Serves an :class:`Application` on ``asyncio.start_server``:
    ``await runner.start(host, port, ssl_context)`` (port 0 binds an
    ephemeral port, ``runner.port`` names it), ``await runner.cleanup()``."""

    def __init__(self, app: Application) -> None:
        self.app = app
        self.port: Optional[int] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: Dict[asyncio.Task, asyncio.StreamWriter] = {}

    async def start(self, host: str = "127.0.0.1", port: int = 0,
                    ssl_context: Optional[ssl.SSLContext] = None) -> int:
        for cb in self.app.on_startup:
            await cb(self.app)
        self._server = await asyncio.start_server(self._connection, host, port, ssl=ssl_context,
                                                  limit=MAX_HEAD_BYTES)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def cleanup(self) -> None:
        if self._server is not None:
            self._server.close()
        for cb in self.app.on_shutdown:
            await cb(self.app)
        for task, writer in list(self._conns.items()):
            task.cancel()
            writer.close()
        if self._conns:
            await asyncio.wait(list(self._conns), timeout=5.0)
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                log.warning("server: connections still open after shutdown")
            self._server = None

    async def _connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns[task] = writer
        try:
            while await self._one_request(reader, writer):
                pass
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except asyncio.CancelledError:
            pass
        except Exception:  # noqa: BLE001 — one connection's fault must not stop the server
            log.exception("server: connection failed")
        finally:
            self._conns.pop(task, None)
            if not writer.is_closing():
                writer.close()

    async def _one_request(self, reader, writer) -> bool:
        """Serve one request; True when the connection carries another."""
        try:
            head = await asyncio.wait_for(_read_head(reader), KEEPALIVE_TIMEOUT)
            if head is None:
                return False
            start, headers = head
            parts = start.split(" ")
            if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
                raise HTTPBadRequest(text=f"bad request line {start!r}")
            request = Request(self.app, parts[0].upper(), parts[1], parts[2], headers, reader, writer)
        except HTTPException as e:  # no request to answer through: a bare 400, then close
            body = e.text.encode()
            writer.write(_head_bytes(e.status, Headers({"Content-Type": "text/plain; charset=utf-8",
                                                        "Content-Length": str(len(body)),
                                                        "Connection": "close"})) + body)
            await writer.drain()
            return False
        try:
            response = await self.app._handle(request)
        except HTTPException as e:
            response = _error_response(e.status, e.text, e.headers)
        except (ConnectionError, asyncio.IncompleteReadError):
            return False
        except Exception:  # noqa: BLE001 — a handler's fault answers 500, as aiohttp does
            log.exception("server: handler failed for %s %s", request.method, request.path)
            response = _error_response(500, "500 Internal Server Error\n\nServer got itself in trouble")
        if request._upgraded is not None:
            ws = request._upgraded
            if not ws.closed:
                await ws.close()
            ws._drop()
            return False
        if response is None:
            raise RuntimeError("handler returned no response")
        if request._response is None:
            await response.prepare(request)
        elif not response._eof_sent:
            await response.write_eof()
        if not request.keep_alive:
            return False
        return await request._body.discard()


def run_app(app: Application, *, host: str = "127.0.0.1", port: int = 8080,
            ssl_context: Optional[ssl.SSLContext] = None,
            on_bound: Optional[Callable[[int], None]] = None) -> None:
    """Serve until SIGINT or SIGTERM, then shut down and return."""

    async def main() -> None:
        runner = AppRunner(app)
        bound = await runner.start(host, port, ssl_context)
        if on_bound is not None:
            on_bound(bound)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        try:
            await stop.wait()
        finally:
            await runner.cleanup()

    asyncio.run(main())


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------
class ClientResponse:
    """A response head with its body read on demand."""

    def __init__(self, method: str, status: int, reason: str, headers: Headers, body: _Body,
                 writer: asyncio.StreamWriter, deadline: Optional[float]) -> None:
        self.method = method
        self.status = status
        self.reason = reason
        self.headers = headers
        self._body = body
        self._writer = writer
        self._deadline = deadline
        self._read_bytes: Optional[bytes] = None

    @property
    def content_type(self) -> str:
        return _content_type(self.headers)

    async def _some(self, n: int) -> bytes:
        try:
            if self._deadline is None:
                return await self._body.read_some(n)
            return await asyncio.wait_for(self._body.read_some(n), max(0.0, self._deadline - time.monotonic()))
        except asyncio.TimeoutError:
            self.close()
            raise ClientError("response timed out") from None
        except (ConnectionError, asyncio.IncompleteReadError, HTTPException) as e:
            self.close()
            raise ClientError(f"response body failed: {e}") from e

    async def read(self) -> bytes:
        if self._read_bytes is None:
            out = bytearray()
            while True:
                data = await self._some(READ_CHUNK)
                if not data:
                    break
                out += data
            self._read_bytes = bytes(out)
            self.close()
        return self._read_bytes

    async def text(self) -> str:
        return (await self.read()).decode("utf-8")

    async def json(self):
        return json.loads(await self.text())

    async def iter_chunked(self, n: int = READ_CHUNK):
        """Body chunks of up to ``n`` bytes as they arrive."""
        try:
            while True:
                data = await self._some(n)
                if not data:
                    return
                yield data
        finally:
            self.close()

    def close(self) -> None:
        if not self._writer.is_closing():
            self._writer.close()

    async def __aenter__(self) -> "ClientResponse":
        return self

    async def __aexit__(self, *exc) -> None:
        self.close()


class _RequestContext:
    """``await session.get(...)`` or ``async with session.get(...) as r``."""

    def __init__(self, coro) -> None:
        self._coro = coro
        self._resp: Optional[ClientResponse] = None

    def __await__(self):
        return self._coro.__await__()

    async def __aenter__(self) -> ClientResponse:
        self._resp = await self._coro
        return self._resp

    async def __aexit__(self, *exc) -> None:
        if self._resp is not None:
            self._resp.close()


class ClientWebSocket(_WebSocket):
    """Client side of a WebSocket (masks every frame it sends)."""

    def __init__(self, max_msg_size: int = DEFAULT_WS_MAX) -> None:
        super().__init__(max_msg_size, client=True)


async def _open(url: str, timeout: Optional[float]):
    u = urllib.parse.urlsplit(url)
    secure = u.scheme in ("https", "wss")
    if u.scheme not in ("http", "https", "ws", "wss") or not u.hostname:
        raise ClientError(f"unsupported URL {url!r}")
    port = u.port or (443 if secure else 80)
    ctx = ssl.create_default_context() if secure else None
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(u.hostname, port, ssl=ctx, server_hostname=u.hostname if secure else None,
                                    limit=MAX_HEAD_BYTES), timeout)
    except (OSError, asyncio.TimeoutError) as e:
        raise ClientError(f"cannot connect to {u.hostname}:{port}: {e}") from e
    target = (u.path or "/") + (f"?{u.query}" if u.query else "")
    host = u.hostname if u.port is None else f"{u.hostname}:{u.port}"
    return reader, writer, target, host


class ClientSession:
    """HTTP/1.1 client: one connection per request (``Connection: close``),
    responses streamed; ``timeout`` bounds each request from connect to its
    last body byte."""

    def __init__(self, *, timeout: Optional[float] = None) -> None:
        self.timeout = timeout

    async def __aenter__(self) -> "ClientSession":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self) -> None:
        pass

    def request(self, method: str, url: str, *, headers=None, data=None, json=None) -> _RequestContext:
        return _RequestContext(self._request(method, url, headers, data, json))

    def get(self, url: str, **kw) -> _RequestContext:
        return self.request("GET", url, **kw)

    def post(self, url: str, **kw) -> _RequestContext:
        return self.request("POST", url, **kw)

    def delete(self, url: str, **kw) -> _RequestContext:
        return self.request("DELETE", url, **kw)

    async def _request(self, method, url, headers, data, json_body) -> ClientResponse:
        deadline = None if self.timeout is None else time.monotonic() + self.timeout
        h = Headers(headers)
        body = b""
        if json_body is not None:
            body = json.dumps(json_body).encode()
            h.setdefault("Content-Type", "application/json")
        elif isinstance(data, FormData):
            body, ctype = data.encode()
            h["Content-Type"] = ctype
        elif data is not None:
            body = data.encode() if isinstance(data, str) else bytes(data)
        reader, writer, target, host = await _open(url, self.timeout)
        h.setdefault("Host", host)
        h.setdefault("Connection", "close")
        h.setdefault("Accept", "*/*")
        if body or method in ("POST", "PUT"):
            h["Content-Length"] = str(len(body))
        try:
            writer.write(f"{method} {target} HTTP/1.1\r\n".encode() + _header_block(h) + body)
            await writer.drain()
            head = await asyncio.wait_for(_read_head(reader), None if deadline is None
                                          else max(0.0, deadline - time.monotonic()))
            while head is not None and head[0].split(" ")[1:2] == ["100"]:  # interim response
                head = await _read_head(reader)
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.TimeoutError, HTTPException) as e:
            writer.close()
            raise ClientError(f"{method} {url} failed: {e!r}") from e
        if head is None:
            writer.close()
            raise ClientError(f"{method} {url}: connection closed before a response")
        start, rh = head
        parts = start.split(" ", 2)
        status = int(parts[1])
        empty = method == "HEAD" or status in (204, 304) or 100 <= status < 200
        body_reader = _Body(reader, rh if not empty else Headers(), to_eof=not empty)
        return ClientResponse(method, status, parts[2] if len(parts) > 2 else "", rh, body_reader, writer,
                              deadline)

    async def ws_connect(self, url: str, *, headers=None, max_msg_size: int = DEFAULT_WS_MAX) -> ClientWebSocket:
        """Open a WebSocket (``ws://`` / ``wss://``, or ``http(s)://``)."""
        reader, writer, target, host = await _open(url, self.timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        h = Headers(headers)
        h.update({"Host": host, "Upgrade": "websocket", "Connection": "Upgrade", "Sec-WebSocket-Key": key,
                  "Sec-WebSocket-Version": "13"})
        try:
            writer.write(f"GET {target} HTTP/1.1\r\n".encode() + _header_block(h))
            await writer.drain()
            head = await asyncio.wait_for(_read_head(reader), self.timeout)
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.TimeoutError, HTTPException) as e:
            writer.close()
            raise ClientError(f"WebSocket handshake with {url} failed: {e!r}") from e
        if head is None or head[0].split(" ")[1:2] != ["101"]:
            writer.close()
            raise ClientError(f"WebSocket handshake with {url} refused: {head[0] if head else 'closed'}")
        if head[1].get("Sec-WebSocket-Accept") != ws_accept(key):
            writer.close()
            raise ClientError("WebSocket handshake: bad Sec-WebSocket-Accept")
        ws = ClientWebSocket(max_msg_size)
        ws._attach(reader, writer)
        return ws
