# SPDX-License-Identifier: Apache-2.0
"""Minimal HTTP/3 (RFC 9114) + WebTransport (draft-ietf-webtrans-http3).

Just enough H3 to carry WebTransport sessions — the transport the reference
uses for MoQ media (``apps/skit/src/server.rs:1975-2085``):

* control streams + SETTINGS (extended CONNECT, H3 datagrams, WebTransport)
* QPACK with static-table-only encoding (Required Insert Count = 0) and a
  decoder that handles indexed/static-name-ref/literal field lines incl.
  Huffman-coded literals (needed for browser interop)
* extended CONNECT (:protocol = webtransport) request/response
* WebTransport uni streams (type 0x54), bidi streams (frame 0x41),
  and H3 datagrams (quarter-stream-id prefix)
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .connection import CloseEvent, DatagramEvent, HandshakeEvent, StreamEvent
from .endpoint import QuicProtocol
from .packet import decode_varint, encode_varint
from .qpack import decode_field_section, encode_field_section

__all__ = [
    "H3Connection",
    "SessionRequest",
    "SessionEstablished",
    "SessionRejected",
    "WtStreamData",
    "WtDatagram",
    "ConnectionClosed",
]

# uni stream types
ST_CONTROL = 0x00
ST_PUSH = 0x01
ST_QPACK_ENCODER = 0x02
ST_QPACK_DECODER = 0x03
ST_WEBTRANSPORT = 0x54

# frame types
FT_DATA = 0x00
FT_HEADERS = 0x01
FT_SETTINGS = 0x04
FT_GOAWAY = 0x07
FT_WEBTRANSPORT_STREAM = 0x41

# settings
S_QPACK_MAX_TABLE_CAPACITY = 0x01
S_MAX_FIELD_SECTION_SIZE = 0x06
S_QPACK_BLOCKED_STREAMS = 0x07
S_ENABLE_CONNECT_PROTOCOL = 0x08
S_H3_DATAGRAM = 0x33
S_ENABLE_WEBTRANSPORT = 0x2B603742
S_WT_MAX_SESSIONS = 0xC671706A


@dataclass
class SessionRequest:
    """Server-side: a client asked for a WebTransport session."""

    session_id: int
    path: str
    authority: str
    headers: List[Tuple[str, str]]


@dataclass
class SessionEstablished:
    session_id: int


@dataclass
class SessionRejected:
    session_id: int
    status: int


@dataclass
class WtStreamData:
    session_id: int
    stream_id: int
    data: bytes
    fin: bool
    bidi: bool


@dataclass
class WtDatagram:
    session_id: int
    data: bytes


@dataclass
class ConnectionClosed:
    error_code: int
    reason: str


class _StreamState:
    __slots__ = ("buf", "kind", "session_id", "headers_done", "fin_seen")

    def __init__(self) -> None:
        self.buf = bytearray()
        self.kind: Optional[str] = None  # control/qpack/wt_uni/request/wt_bidi
        self.session_id: Optional[int] = None
        self.headers_done = False
        self.fin_seen = False


class H3Connection:
    """HTTP/3-for-WebTransport engine bound to one QuicProtocol."""

    def __init__(self, proto: QuicProtocol, is_server: bool) -> None:
        self.proto = proto
        self.conn = proto.conn
        self.is_server = is_server
        self.events: asyncio.Queue = asyncio.Queue()
        self._streams: Dict[int, _StreamState] = {}
        self._sessions: Dict[int, bool] = {}  # session_id -> established
        self._connect_waiters: Dict[int, asyncio.Future] = {}
        self._task: Optional[asyncio.Task] = None
        self._peer_settings: Dict[int, int] = {}
        self._send_preface()

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def _send_preface(self) -> None:
        """Open control + QPACK streams and send SETTINGS."""
        ctrl = self.conn.open_uni_stream()
        settings = bytearray()
        for k, v in [
            (S_QPACK_MAX_TABLE_CAPACITY, 0),
            (S_QPACK_BLOCKED_STREAMS, 0),
            (S_ENABLE_CONNECT_PROTOCOL, 1),
            (S_H3_DATAGRAM, 1),
            (S_ENABLE_WEBTRANSPORT, 1),
            (S_WT_MAX_SESSIONS, 64),
        ]:
            settings += encode_varint(k) + encode_varint(v)
        frame = encode_varint(FT_SETTINGS) + encode_varint(len(settings)) + settings
        self.conn.send_stream_data(ctrl, encode_varint(ST_CONTROL) + bytes(frame))
        qe = self.conn.open_uni_stream()
        self.conn.send_stream_data(qe, encode_varint(ST_QPACK_ENCODER))
        qd = self.conn.open_uni_stream()
        self.conn.send_stream_data(qd, encode_varint(ST_QPACK_DECODER))
        self.proto.transmit()

    # ---------------------------------------------------------------- client

    async def connect_session(
        self, path: str, authority: str = "localhost", timeout: float = 10.0
    ) -> int:
        """Client: open a WebTransport session via extended CONNECT."""
        assert not self.is_server
        sid = self.conn.open_bidi_stream()
        headers = [
            (":method", "CONNECT"),
            (":protocol", "webtransport"),
            (":scheme", "https"),
            (":authority", authority),
            (":path", path),
            ("origin", f"https://{authority}"),
        ]
        block = encode_field_section(headers)
        frame = encode_varint(FT_HEADERS) + encode_varint(len(block)) + block
        self.conn.send_stream_data(sid, frame)
        self.proto.transmit()
        fut = asyncio.get_running_loop().create_future()
        self._connect_waiters[sid] = fut
        status = await asyncio.wait_for(fut, timeout)
        if status != 200:
            raise ConnectionError(f"WebTransport CONNECT rejected: {status}")
        self._sessions[sid] = True
        return sid

    # ---------------------------------------------------------------- server

    def accept_session(self, session_id: int, status: int = 200) -> None:
        headers = [(":status", str(status))]
        if status == 200:
            headers.append(("sec-webtransport-http3-draft", "draft02"))
        block = encode_field_section(headers)
        frame = encode_varint(FT_HEADERS) + encode_varint(len(block)) + block
        self.conn.send_stream_data(session_id, frame)
        if status == 200:
            self._sessions[session_id] = True
        self.proto.transmit()

    # ------------------------------------------------------------- data plane

    def open_wt_uni(self, session_id: int) -> int:
        sid = self.conn.open_uni_stream()
        self.conn.send_stream_data(
            sid, encode_varint(ST_WEBTRANSPORT) + encode_varint(session_id)
        )
        return sid

    def open_wt_bidi(self, session_id: int) -> int:
        sid = self.conn.open_bidi_stream()
        self.conn.send_stream_data(
            sid, encode_varint(FT_WEBTRANSPORT_STREAM) + encode_varint(session_id)
        )
        # the peer's return data on this stream is raw WT payload, not frames
        st = self._streams[sid] = _StreamState()
        st.kind = "wt_bidi"
        st.session_id = session_id
        return sid

    def send_stream(self, stream_id: int, data: bytes, fin: bool = False) -> None:
        self.conn.send_stream_data(stream_id, data, fin=fin)
        self.proto.transmit()

    def send_wt_datagram(self, session_id: int, data: bytes) -> None:
        self.conn.send_datagram(encode_varint(session_id // 4) + data)
        self.proto.transmit()

    # --------------------------------------------------------------- receive

    async def _run(self) -> None:
        while True:
            ev = await self.proto.events.get()
            try:
                if isinstance(ev, StreamEvent):
                    self._on_stream(ev)
                elif isinstance(ev, DatagramEvent):
                    qsid, off = decode_varint(ev.data, 0)
                    self.events.put_nowait(WtDatagram(qsid * 4, ev.data[off:]))
                elif isinstance(ev, CloseEvent):
                    self.events.put_nowait(ConnectionClosed(ev.error_code, ev.reason))
                    return
                elif isinstance(ev, HandshakeEvent):
                    pass
            except Exception as e:  # malformed peer frames (QpackError,
                # IndexError from truncated varints/static-table refs, ...):
                # convert to a connection close instead of silently killing
                # this pump task and leaking a half-open connection.
                self.conn.close(0x0101, f"h3 protocol error: {e!r}")  # H3_GENERAL_PROTOCOL_ERROR
                self.proto.transmit()
                self.events.put_nowait(ConnectionClosed(0x0101, f"h3 protocol error: {e!r}"))
                return

    def _on_stream(self, ev: StreamEvent) -> None:
        st = self._streams.get(ev.stream_id)
        if st is None:
            st = self._streams[ev.stream_id] = _StreamState()
        st.buf.extend(ev.data)
        st.fin_seen = st.fin_seen or ev.fin
        uni = ev.stream_id % 4 in (2, 3)
        peer_initiated = (ev.stream_id % 2 == 0) != self.is_server  # our view
        if st.kind is None:
            if uni and not self._is_local_stream(ev.stream_id):
                if not self._classify_uni(ev.stream_id, st):
                    return  # need more bytes
            elif not uni and not self._is_local_stream(ev.stream_id):
                st.kind = "request"
            elif not uni:
                st.kind = "request"  # response side of our own CONNECT
            else:
                return  # our own uni stream — nothing to receive
        self._pump_stream(ev.stream_id, st)

    def _is_local_stream(self, stream_id: int) -> bool:
        initiator_server = stream_id % 2 == 1
        return initiator_server == self.is_server

    def _classify_uni(self, stream_id: int, st: _StreamState) -> bool:
        try:
            stype, off = decode_varint(st.buf, 0)
        except IndexError:
            return False
        if stype == ST_WEBTRANSPORT:
            try:
                session_id, off2 = decode_varint(st.buf, off)
            except IndexError:
                return False
            st.kind = "wt_uni"
            st.session_id = session_id
            del st.buf[:off2]
        elif stype == ST_CONTROL:
            st.kind = "control"
            del st.buf[:off]
        elif stype in (ST_QPACK_ENCODER, ST_QPACK_DECODER):
            st.kind = "qpack"
            del st.buf[:off]
        elif stype == ST_PUSH:
            st.kind = "push"
            del st.buf[:off]
        else:
            st.kind = "unknown"
            del st.buf[:off]
        return True

    def _pump_stream(self, stream_id: int, st: _StreamState) -> None:
        if st.kind == "wt_uni":
            if st.buf or st.fin_seen:
                data = bytes(st.buf)
                st.buf.clear()
                self.events.put_nowait(
                    WtStreamData(st.session_id, stream_id, data, st.fin_seen, bidi=False)
                )
        elif st.kind == "wt_bidi":
            if st.buf or st.fin_seen:
                data = bytes(st.buf)
                st.buf.clear()
                self.events.put_nowait(
                    WtStreamData(st.session_id, stream_id, data, st.fin_seen, bidi=True)
                )
        elif st.kind == "control":
            self._pump_control(st)
        elif st.kind == "request":
            self._pump_request(stream_id, st)
        # qpack/push/unknown: drain silently
        elif st.kind in ("qpack", "push", "unknown"):
            st.buf.clear()

    def _pump_control(self, st: _StreamState) -> None:
        while True:
            parsed = self._try_frame(st.buf)
            if parsed is None:
                return
            ftype, payload, consumed = parsed
            del st.buf[:consumed]
            if ftype == FT_SETTINGS:
                off = 0
                while off < len(payload):
                    k, off = decode_varint(payload, off)
                    v, off = decode_varint(payload, off)
                    self._peer_settings[k] = v

    def _pump_request(self, stream_id: int, st: _StreamState) -> None:
        while True:
            if st.headers_done and st.session_id is not None:
                # drained as WT bidi data
                st.kind = "wt_bidi"
                self._pump_stream(stream_id, st)
                return
            parsed = self._try_frame(st.buf)
            if parsed is None:
                return
            ftype, payload, consumed = parsed
            del st.buf[:consumed]
            if ftype == FT_WEBTRANSPORT_STREAM:
                # payload here is actually the session id varint; the rest of
                # the stream is raw WT data (frame has no length in practice:
                # _try_frame special-cases it)
                st.session_id = payload  # type: ignore[assignment]
                st.kind = "wt_bidi"
                self._pump_stream(stream_id, st)
                return
            if ftype == FT_HEADERS:
                headers = decode_field_section(bytes(payload))
                hd = dict(headers)
                st.headers_done = True
                if self.is_server:
                    if hd.get(":method") == "CONNECT" and hd.get(":protocol") == "webtransport":
                        st.session_id = stream_id
                        self.events.put_nowait(
                            SessionRequest(
                                stream_id, hd.get(":path", "/"), hd.get(":authority", ""), headers
                            )
                        )
                    else:
                        # plain h3 request: 404 it
                        self.accept_session(stream_id, status=404)
                else:
                    status = int(hd.get(":status", "0"))
                    fut = self._connect_waiters.pop(stream_id, None)
                    if fut is not None and not fut.done():
                        fut.set_result(status)
                    if status == 200:
                        st.session_id = stream_id
                        self.events.put_nowait(SessionEstablished(stream_id))
                    else:
                        self.events.put_nowait(SessionRejected(stream_id, status))

    @staticmethod
    def _try_frame(buf: bytearray):
        """Try to parse one H3 frame. Returns (type, payload, consumed) or
        None if incomplete. WEBTRANSPORT_STREAM is special: its 'payload' is
        the session id and the rest of the stream is raw data."""
        try:
            ftype, off = decode_varint(buf, 0)
            if ftype == FT_WEBTRANSPORT_STREAM:
                session_id, off2 = decode_varint(buf, off)
                return ftype, session_id, off2
            flen, off = decode_varint(buf, off)
        except IndexError:
            return None
        if len(buf) < off + flen:
            return None
        return ftype, bytes(buf[off : off + flen]), off + flen
