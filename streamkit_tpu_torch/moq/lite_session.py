# SPDX-License-Identifier: Apache-2.0
"""moq-lite session handling: server-side handler + client library.

Wire layer: :mod:`.lite` (moq-lite draft-02 + hang). The WebTransport
acceptor demuxes per session: a first bidi stream opening with stream-type
``0`` (SESSION) is moq-lite; the native protocol's first byte is
``MSG_SETUP`` (0x01) (:func:`..moq.session.serve_moq_session`).

Server model (mirroring ``moq_lite::Session::accept`` usage in the
reference, ``crates/nodes/src/transport/moq/peer.rs:459-880``):

* handshake on the client's SESSION stream,
* **client publishes**: the server opens an ANNOUNCE stream with an empty
  prefix; each ``Announce Active{path}`` from the client triggers a server
  subscription (catalog first, then each audio rendition), and received
  group frames resolve to a gateway route (``/path/input`` peer slots) or
  a relay broadcast — exactly the native protocol's name resolution,
* **client subscribes**: the client opens SUBSCRIBE streams; the catalog
  track answers with a hang catalog JSON, media tracks pump relay/gateway
  frames as hang frames in group-per-uni-stream cadence.

Names are shared with the native protocol and the WS binding, so a
moq-lite client and a native client can exchange media through the same
relay or peer pipeline (tested in ``tests/test_torch_webtransport.py``).
"""

from __future__ import annotations

import asyncio
import itertools
from typing import Dict, Optional, Tuple

from ..core.channel import ChannelClosed, ChannelFull
from ..core.moq_gateway import (
    MoqConnection,
    MoqGateway,
    decode_media_frame,
    encode_media_frame,
)
from ..quic.endpoint import QuicProtocol, connect as quic_connect
from ..quic.h3 import ConnectionClosed, H3Connection, WtStreamData
from ..quic.packet import decode_varint
from .lite import (
    ANNOUNCE_ACTIVE,
    ANNOUNCE_ENDED,
    AUDIO_TRACK,
    CATALOG_TRACK,
    VERSION_DRAFT_02,
    AnnounceParser,
    LiteGroupParser,
    build_catalog,
    decode_announce_please,
    decode_hang_frame,
    decode_session_client,
    decode_session_server,
    decode_subscribe,
    decode_subscribe_ok,
    encode_announce,
    encode_announce_please,
    encode_group_header,
    encode_hang_frame,
    encode_lite_frame,
    encode_session_client,
    encode_session_server,
    encode_subscribe,
    encode_subscribe_ok,
)
from .relay import MoqRelay
from ..quic.packet import encode_varint
from .lite import STREAM_ANNOUNCE, STREAM_GROUP, STREAM_SESSION, STREAM_SUBSCRIBE

__all__ = ["serve_moq_lite_session", "MoqLiteClient"]


class _Stream:
    """Reassembly state for one moq-lite stream."""

    def __init__(self) -> None:
        self.kind: Optional[str] = None
        self.buf = bytearray()
        self.group: Optional[LiteGroupParser] = None
        self.announce: Optional[AnnounceParser] = None
        self.frames_seen = 0  # first frame of a group = hang keyframe


async def serve_moq_lite_session(
    h3: H3Connection,
    session_id: int,
    relay: MoqRelay,
    gateway: Optional[MoqGateway] = None,
    first_event: Optional[WtStreamData] = None,
) -> None:
    """Drive one accepted WebTransport session as a moq-lite session."""
    streams: Dict[int, _Stream] = {}
    sub_ids = itertools.count(1)
    # our outgoing subscriptions (to client publications): id -> target
    out_subs: Dict[int, dict] = {}
    # client subscriptions we serve: pump tasks
    pump_tasks: Dict[int, asyncio.Task] = {}
    pub_relay: Dict[str, object] = {}
    pub_gateway: Dict[str, MoqConnection] = {}
    session_stream: Optional[int] = None

    def open_announce_out() -> None:
        sid = h3.open_wt_bidi(session_id)
        h3.send_stream(
            sid, encode_varint(STREAM_ANNOUNCE) + encode_announce_please("")
        )
        st = streams[sid] = _Stream()
        st.kind = "announce_out"
        st.announce = AnnounceParser()

    def subscribe_to_client(broadcast: str, track: str) -> int:
        sub_id = next(sub_ids)
        sid = h3.open_wt_bidi(session_id)
        h3.send_stream(
            sid,
            encode_varint(STREAM_SUBSCRIBE) + encode_subscribe(sub_id, broadcast, track),
        )
        st = streams[sid] = _Stream()
        st.kind = "subscribe_out"
        out_subs[sub_id] = {"broadcast": broadcast, "track": track, "catalog": bytearray()}
        return sub_id

    async def on_client_broadcast(path: str) -> None:
        """Client announced a publication: wire it into the server."""
        if gateway is not None and gateway.has_route(path):
            conn = MoqConnection(path, "publish")
            if await gateway.accept_connection(conn):
                pub_gateway[path] = conn
        if path not in pub_gateway:
            pub_relay[path] = relay.announce(path)
        subscribe_to_client(path, CATALOG_TRACK)

    def deliver_client_frame(sub_id: int, frame: bytes, first_in_group: bool) -> None:
        info = out_subs.get(sub_id)
        if info is None:
            return
        if info["track"] == CATALOG_TRACK:
            # catalog frame: subscribe every announced audio rendition
            from .lite import parse_catalog

            try:
                for track, _cfg in parse_catalog(bytes(frame)):
                    if not any(
                        s["broadcast"] == info["broadcast"] and s["track"] == track
                        for s in out_subs.values()
                    ):
                        subscribe_to_client(info["broadcast"], track)
            except Exception:
                pass
            return
        payload, ts = decode_hang_frame(frame)
        path = info["broadcast"]
        conn = pub_gateway.get(path)
        if conn is not None:
            try:
                conn.incoming.try_send(encode_media_frame(payload, ts, first_in_group))
            except (ChannelClosed, ChannelFull):
                pass
            return
        b = pub_relay.get(path)
        if b is not None:
            b.publish(payload, ts, key=first_in_group)

    async def pump_subscription(sub_id: int, broadcast: str, track: str) -> None:
        """Serve one client subscription on ``track`` of ``broadcast``."""

        def new_group(seq: int) -> int:
            sid = h3.open_wt_uni(session_id)
            h3.send_stream(
                sid, encode_varint(STREAM_GROUP) + encode_group_header(sub_id, seq)
            )
            return sid

        if track == CATALOG_TRACK:
            sid = new_group(0)
            h3.send_stream(sid, encode_lite_frame(build_catalog()), fin=True)
            return
        # media: gateway route first, then relay — native name resolution
        conn: Optional[MoqConnection] = None
        if gateway is not None and gateway.has_route(broadcast):
            conn = MoqConnection(broadcast, "subscribe")
            if not await gateway.accept_connection(conn):
                conn = None
        seq = 0
        stream: Optional[int] = None
        frames_in_group = 0
        try:
            if conn is not None:
                while True:
                    raw = await conn.outgoing.recv_optional()
                    if raw is None:
                        break
                    payload, ts, key = decode_media_frame(raw)
                    if stream is None or key or frames_in_group >= 50:
                        if stream is not None:
                            h3.send_stream(stream, b"", fin=True)
                        stream = new_group(seq)
                        seq += 1
                        frames_in_group = 0
                    h3.send_stream(stream, encode_hang_frame(payload, ts))
                    frames_in_group += 1
            else:
                consumer = await relay.subscribe(broadcast)
                if consumer is None:
                    return
                while True:
                    frame = await consumer.recv()
                    if frame is None:
                        break
                    if frame.key or stream is None or frames_in_group >= 50:
                        if stream is not None:
                            h3.send_stream(stream, b"", fin=True)
                        stream = new_group(seq)
                        seq += 1
                        frames_in_group = 0
                    h3.send_stream(
                        stream, encode_hang_frame(frame.payload, frame.timestamp_us)
                    )
                    frames_in_group += 1
        finally:
            if conn is not None:
                conn.close()
            if stream is not None:
                h3.send_stream(stream, b"", fin=True)

    async def handle_bidi(sid: int, st: _Stream) -> None:
        nonlocal session_stream
        # classify by the opener's stream-type varint
        if st.kind is None:
            try:
                stype, off = decode_varint(st.buf, 0)
            except IndexError:
                return
            del st.buf[:off]
            if stype == STREAM_SESSION:
                st.kind = "session"
            elif stype == STREAM_ANNOUNCE:
                st.kind = "announce_in"
            elif stype == STREAM_SUBSCRIBE:
                st.kind = "subscribe_in"
            else:
                st.kind = "unknown"
        if st.kind == "session" and session_stream is None:
            try:
                versions, _ext, off = decode_session_client(st.buf, 0)
            except IndexError:
                return
            del st.buf[:off]
            if VERSION_DRAFT_02 not in versions:
                h3.conn.close(0x0101, "no common moq-lite version")
                return
            session_stream = sid
            h3.send_stream(sid, encode_session_server(VERSION_DRAFT_02))
            open_announce_out()
        elif st.kind == "announce_in":
            try:
                prefix, off = decode_announce_please(st.buf, 0)
            except IndexError:
                return
            del st.buf[:off]
            st.kind = "announce_in_active"
            names = []
            if gateway is not None:
                names.extend(r for r in gateway.routes())
            names.extend(b["name"] for b in relay.announced())
            for name in names:
                if name.startswith(prefix):
                    h3.send_stream(
                        sid, encode_announce(ANNOUNCE_ACTIVE, name[len(prefix):])
                    )
        elif st.kind == "subscribe_in":
            try:
                sub_id, broadcast, track, _prio, off = decode_subscribe(st.buf, 0)
            except IndexError:
                return
            del st.buf[:off]
            st.kind = "subscribe_in_active"
            h3.send_stream(sid, encode_subscribe_ok())
            pump_tasks[sub_id] = asyncio.ensure_future(
                pump_subscription(sub_id, broadcast, track)
            )
        elif st.kind == "subscribe_out":
            # client's SubscribeOk — nothing to do beyond consuming it
            try:
                _prio, off = decode_subscribe_ok(st.buf, 0)
                del st.buf[:off]
            except IndexError:
                pass
        elif st.kind == "announce_out":
            for status, suffix in st.announce.feed(bytes(st.buf)):
                if status == ANNOUNCE_ACTIVE:
                    await on_client_broadcast(suffix)
            st.buf.clear()

    try:
        if first_event is not None:
            st = streams.setdefault(first_event.stream_id, _Stream())
            st.buf.extend(first_event.data)
            await handle_bidi(first_event.stream_id, st)
        while True:
            ev = await h3.events.get()
            if isinstance(ev, ConnectionClosed):
                break
            if not isinstance(ev, WtStreamData) or ev.session_id != session_id:
                continue
            st = streams.setdefault(ev.stream_id, _Stream())
            if ev.bidi:
                st.buf.extend(ev.data)
                await handle_bidi(ev.stream_id, st)
            else:
                if st.group is None:
                    st.buf.extend(ev.data)
                    try:
                        stype, off = decode_varint(st.buf, 0)
                    except IndexError:
                        continue
                    if stype != STREAM_GROUP:
                        off = 0  # tolerate: treat the stream as a bare group
                    data = bytes(st.buf[off:])
                    st.buf.clear()
                    st.group = LiteGroupParser()
                    frames = st.group.feed(data)
                else:
                    frames = st.group.feed(ev.data)
                for frame in frames:
                    if st.group.sub_id is not None:
                        deliver_client_frame(st.group.sub_id, frame, st.frames_seen == 0)
                    st.frames_seen += 1
                if ev.fin:
                    streams.pop(ev.stream_id, None)
    except Exception:
        h3.conn.close(0x0101, "moq-lite session protocol error")
        h3.proto.transmit()
    finally:
        for t in pump_tasks.values():
            t.cancel()
        for b in pub_relay.values():
            b.end()
        for conn in pub_gateway.values():
            conn.close()


class MoqLiteClient:
    """moq-lite + hang WebTransport client (publish + subscribe)."""

    def __init__(self) -> None:
        self._client = None
        self._proto: Optional[QuicProtocol] = None
        self._h3: Optional[H3Connection] = None
        self._session: Optional[int] = None
        self._session_stream: Optional[int] = None
        self._setup_done: Optional[asyncio.Future] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._streams: Dict[int, _Stream] = {}
        self._sub_ids = itertools.count(1)
        # subscriptions we made: sub_id -> state
        self._subs: Dict[int, dict] = {}
        # publications: name -> _LitePublication
        self._pubs: Dict[str, "_LitePublication"] = {}
        # server subscriptions into our publications: sub_id -> (name, track)
        self._serving: Dict[int, Tuple[str, str]] = {}

    async def connect(
        self,
        host: str,
        port: int,
        fingerprints: Optional[list] = None,
        path: str = "/moq",
        timeout: float = 10.0,
    ) -> None:
        self._client, self._proto = await quic_connect(
            host, port, fingerprints, alpn="h3", timeout=timeout
        )
        self._h3 = H3Connection(self._proto, False)
        self._h3.start()
        self._session = await self._h3.connect_session(path)
        self._session_stream = self._h3.open_wt_bidi(self._session)
        self._setup_done = asyncio.get_running_loop().create_future()
        self._pump_task = asyncio.ensure_future(self._pump())
        self._h3.send_stream(
            self._session_stream,
            encode_varint(STREAM_SESSION) + encode_session_client(),
        )
        await asyncio.wait_for(self._setup_done, timeout)

    # -- publication --------------------------------------------------------
    async def publish(self, name: str) -> "_LitePublication":
        """Declare a broadcast; frames flow once the server subscribes (it
        opens an announce stream on connect, so this is immediate)."""
        pub = _LitePublication(self, name)
        self._pubs[name] = pub
        # answer the server's standing AnnouncePlease on every announce_in
        for sid, st in self._streams.items():
            if st.kind == "announce_serving":
                self._h3.send_stream(sid, encode_announce(ANNOUNCE_ACTIVE, name))
        return pub

    # -- subscription -------------------------------------------------------
    async def subscribe(self, name: str, timeout: float = 35.0) -> "_LiteSubscription":
        """Subscribe the catalog, then the advertised audio track; yields
        (payload, timestamp_us, key) like the native client."""
        q: asyncio.Queue = asyncio.Queue()
        cat_done: asyncio.Future = asyncio.get_running_loop().create_future()
        self._open_subscribe(name, CATALOG_TRACK, queue=None, catalog_future=cat_done)
        try:
            tracks = await asyncio.wait_for(cat_done, timeout)
        except asyncio.TimeoutError:
            # no catalog (non-hang publisher): fall back to the audio track
            tracks = [AUDIO_TRACK]
        for track in tracks:
            self._open_subscribe(name, track, queue=q, catalog_future=None)
        return _LiteSubscription(q)

    def _open_subscribe(self, broadcast, track, queue, catalog_future) -> int:
        sub_id = next(self._sub_ids)
        sid = self._h3.open_wt_bidi(self._session)
        self._h3.send_stream(
            sid,
            encode_varint(STREAM_SUBSCRIBE) + encode_subscribe(sub_id, broadcast, track),
        )
        st = self._streams[sid] = _Stream()
        st.kind = "subscribe_out"
        self._subs[sub_id] = {
            "track": track,
            "queue": queue,
            "catalog_future": catalog_future,
        }
        return sub_id

    # -- event pump ---------------------------------------------------------
    async def _pump(self) -> None:
        while True:
            ev = await self._h3.events.get()
            if isinstance(ev, ConnectionClosed):
                for info in self._subs.values():
                    if info["queue"] is not None:
                        info["queue"].put_nowait(None)
                if self._setup_done is not None and not self._setup_done.done():
                    self._setup_done.set_exception(ConnectionError(ev.reason))
                return
            if not isinstance(ev, WtStreamData):
                continue
            st = self._streams.setdefault(ev.stream_id, _Stream())
            if ev.bidi:
                st.buf.extend(ev.data)
                self._handle_bidi(ev.stream_id, st)
            else:
                self._handle_uni(ev.stream_id, st, ev.data, ev.fin)

    def _handle_bidi(self, sid: int, st: _Stream) -> None:
        if sid == self._session_stream:
            if self._setup_done is not None and not self._setup_done.done():
                try:
                    version, _ext, off = decode_session_server(st.buf, 0)
                except IndexError:
                    return
                del st.buf[:off]
                self._setup_done.set_result(version)
            return
        if st.kind is None:
            try:
                stype, off = decode_varint(st.buf, 0)
            except IndexError:
                return
            del st.buf[:off]
            if stype == STREAM_ANNOUNCE:
                st.kind = "announce_req"
            elif stype == STREAM_SUBSCRIBE:
                st.kind = "subscribe_serving"
            else:
                st.kind = "unknown"
        if st.kind == "announce_req":
            # server asks us to announce our publications
            try:
                prefix, off = decode_announce_please(st.buf, 0)
            except IndexError:
                return
            del st.buf[:off]
            st.kind = "announce_serving"
            for name in self._pubs:
                if name.startswith(prefix):
                    self._h3.send_stream(
                        sid, encode_announce(ANNOUNCE_ACTIVE, name[len(prefix):])
                    )
        elif st.kind == "subscribe_serving":
            try:
                sub_id, broadcast, track, _prio, off = decode_subscribe(st.buf, 0)
            except IndexError:
                return
            del st.buf[:off]
            st.kind = "subscribe_serving_active"
            self._h3.send_stream(sid, encode_subscribe_ok())
            pub = self._pubs.get(broadcast)
            if pub is None:
                return
            if track == CATALOG_TRACK:
                gsid = self._h3.open_wt_uni(self._session)
                self._h3.send_stream(
                    gsid,
                    encode_varint(STREAM_GROUP)
                    + encode_group_header(sub_id, 0)
                    + encode_lite_frame(build_catalog()),
                    fin=True,
                )
            else:
                pub._add_subscriber(sub_id)
        elif st.kind == "subscribe_out":
            try:
                _prio, off = decode_subscribe_ok(st.buf, 0)
                del st.buf[:off]
            except IndexError:
                pass

    def _handle_uni(self, sid: int, st: _Stream, data: bytes, fin: bool) -> None:
        if st.group is None:
            st.buf.extend(data)
            try:
                stype, off = decode_varint(st.buf, 0)
            except IndexError:
                return
            payload = bytes(st.buf[off:]) if stype == STREAM_GROUP else bytes(st.buf)
            st.buf.clear()
            st.group = LiteGroupParser()
            frames = st.group.feed(payload)
        else:
            frames = st.group.feed(data)
        for frame in frames:
            info = self._subs.get(st.group.sub_id or -1)
            if info is None:
                st.frames_seen += 1
                continue
            if info["catalog_future"] is not None:
                from .lite import parse_catalog

                fut = info["catalog_future"]
                if not fut.done():
                    try:
                        fut.set_result([t for t, _ in parse_catalog(bytes(frame))])
                    except Exception:
                        fut.set_result([AUDIO_TRACK])
                st.frames_seen += 1
                continue
            payload, ts = decode_hang_frame(frame)
            info["queue"].put_nowait((payload, ts, st.frames_seen == 0))
            st.frames_seen += 1
        if fin:
            self._streams.pop(sid, None)

    def close(self) -> None:
        if self._pump_task is not None:
            self._pump_task.cancel()
        if self._h3 is not None:
            self._h3.stop()
        if self._client is not None:
            self._client.close()


class _LitePublication:
    """Write side of one broadcast: frames fan out to every server
    subscription, grouped per keyframe / 50 frames (hang cadence)."""

    def __init__(self, client: MoqLiteClient, name: str, max_group_frames: int = 50) -> None:
        self._c = client
        self.name = name
        # sub_id -> (stream, seq, frames_in_group)
        self._outs: Dict[int, list] = {}

    def _add_subscriber(self, sub_id: int) -> None:
        self._outs[sub_id] = [None, 0, 0]

    def send(self, payload: bytes, timestamp_us: int = 0, key: bool = False) -> None:
        h3 = self._c._h3
        for sub_id, state in self._outs.items():
            stream, seq, n = state
            if stream is None or key or n >= 50:
                if stream is not None:
                    h3.send_stream(stream, b"", fin=True)
                stream = h3.open_wt_uni(self._c._session)
                h3.send_stream(
                    stream, encode_varint(STREAM_GROUP) + encode_group_header(sub_id, seq)
                )
                seq += 1
                n = 0
            h3.send_stream(stream, encode_hang_frame(payload, timestamp_us))
            state[0], state[1], state[2] = stream, seq, n + 1

    def end(self) -> None:
        for state in self._outs.values():
            if state[0] is not None:
                self._c._h3.send_stream(state[0], b"", fin=True)
                state[0] = None


class _LiteSubscription:
    def __init__(self, queue: asyncio.Queue) -> None:
        self._q = queue

    async def recv(self, timeout: Optional[float] = None) -> Optional[Tuple[bytes, int, bool]]:
        if timeout is None:
            return await self._q.get()
        try:
            return await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return None
