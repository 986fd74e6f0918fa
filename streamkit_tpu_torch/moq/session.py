# SPDX-License-Identifier: Apache-2.0
"""MoQ sessions over WebTransport: server-side handler + client library.

Server side: each accepted WebTransport session speaks the control protocol
in :mod:`.wire`. PUBLISH/SUBSCRIBE names resolve against
the gateway's external routes first (``/path/input`` peer slots — same
namespace the WS binding serves), then the relay broadcast namespace.

Client side: :class:`MoqClient` is a full client (used by tests, the CLI
and the load-test harness) — the analog of the reference's moq-lite client
in ``crates/transport/moq/src/pull.rs``/``push.rs``.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional, Tuple

from ..core.channel import ChannelClosed, ChannelFull
from ..core.moq_gateway import MoqConnection, MoqGateway, encode_media_frame, decode_media_frame
from ..quic.endpoint import QuicProtocol, connect as quic_connect
from ..quic.h3 import (
    ConnectionClosed,
    H3Connection,
    SessionRequest,
    WtDatagram,
    WtStreamData,
)
from .relay import MoqRelay
from .wire import (
    MOQ_VERSION,
    MSG_PUBLISH,
    MSG_PUBLISH_OK,
    MSG_SETUP,
    MSG_SETUP_OK,
    MSG_SUBSCRIBE,
    MSG_SUBSCRIBE_ERROR,
    MSG_SUBSCRIBE_OK,
    MSG_UNSUBSCRIBE,
    ControlParser,
    GroupParser,
    encode_frame,
    encode_group_header,
    encode_msg,
)

__all__ = ["serve_moq_session", "MoqClient"]


async def serve_moq_session(
    h3: H3Connection,
    session_id: int,
    relay: MoqRelay,
    gateway: Optional[MoqGateway] = None,
) -> None:
    """Drive one accepted WebTransport session as a MoQ session until it
    (or the connection) closes."""
    control_stream: Optional[int] = None
    parser = ControlParser()
    groups: Dict[int, GroupParser] = {}  # uni stream id -> parser
    # publish targets by alias
    pub_relay: Dict[int, object] = {}
    pub_gateway: Dict[int, MoqConnection] = {}
    # subscription pump tasks by alias
    sub_tasks: Dict[int, asyncio.Task] = {}

    def ctrl_send(msg: bytes) -> None:
        if control_stream is not None:
            h3.send_stream(control_stream, msg)

    async def pump_relay_subscription(alias: int, name: str) -> None:
        consumer = await relay.subscribe(name)
        if consumer is None:
            ctrl_send(encode_msg(MSG_SUBSCRIBE_ERROR, alias, "broadcast not announced"))
            return
        ctrl_send(encode_msg(MSG_SUBSCRIBE_OK, alias))
        seq = 0
        stream: Optional[int] = None
        try:
            while True:
                frame = await consumer.recv()
                if frame is None:
                    break
                if frame.key or stream is None:
                    if stream is not None:
                        h3.send_stream(stream, b"", fin=True)
                    stream = h3.open_wt_uni(session_id)
                    h3.send_stream(stream, encode_group_header(alias, seq))
                    seq += 1
                h3.send_stream(stream, encode_frame(frame.payload, frame.timestamp_us, frame.key))
        finally:
            consumer.close()
            if stream is not None:
                h3.send_stream(stream, b"", fin=True)

    async def pump_gateway_subscription(alias: int, name: str, conn: MoqConnection) -> None:
        ctrl_send(encode_msg(MSG_SUBSCRIBE_OK, alias))
        seq = 0
        stream: Optional[int] = None
        frames_in_group = 0
        try:
            while True:
                raw = await conn.outgoing.recv_optional()
                if raw is None:
                    break
                payload, ts, key = decode_media_frame(raw)
                if stream is None or key or frames_in_group >= 50:
                    if stream is not None:
                        h3.send_stream(stream, b"", fin=True)
                    stream = h3.open_wt_uni(session_id)
                    h3.send_stream(stream, encode_group_header(alias, seq))
                    seq += 1
                    frames_in_group = 0
                h3.send_stream(stream, encode_frame(payload, ts, key))
                frames_in_group += 1
        finally:
            conn.close()
            if stream is not None:
                h3.send_stream(stream, b"", fin=True)

    async def handle_control(mtype: int, fields: tuple) -> None:
        nonlocal control_stream
        if mtype == MSG_SETUP:
            version = fields[0]
            ctrl_send(encode_msg(MSG_SETUP_OK, min(version, MOQ_VERSION)))
        elif mtype == MSG_PUBLISH:
            alias, name = fields
            conn = None
            if gateway is not None and gateway.has_route(name):
                conn = MoqConnection(name, "publish")
                if await gateway.accept_connection(conn):
                    pub_gateway[alias] = conn
                else:
                    conn = None
            if conn is None:
                pub_relay[alias] = relay.announce(name)
            ctrl_send(encode_msg(MSG_PUBLISH_OK, alias))
        elif mtype == MSG_SUBSCRIBE:
            alias, name = fields
            if gateway is not None and gateway.has_route(name):
                conn = MoqConnection(name, "subscribe")
                if await gateway.accept_connection(conn):
                    sub_tasks[alias] = asyncio.ensure_future(
                        pump_gateway_subscription(alias, name, conn)
                    )
                    return
            sub_tasks[alias] = asyncio.ensure_future(pump_relay_subscription(alias, name))
        elif mtype == MSG_UNSUBSCRIBE:
            alias = fields[0]
            task = sub_tasks.pop(alias, None)
            if task is not None:
                task.cancel()

    def publish_frame(alias: int, payload: bytes, ts: int, key: bool) -> None:
        b = pub_relay.get(alias)
        if b is not None:
            b.publish(payload, ts, key=key)
            return
        conn = pub_gateway.get(alias)
        if conn is not None:
            try:
                conn.incoming.try_send(encode_media_frame(payload, ts, key))
            except (ChannelClosed, ChannelFull):
                pass

    try:
        while True:
            ev = await h3.events.get()
            if isinstance(ev, ConnectionClosed):
                break
            if isinstance(ev, WtStreamData):
                if ev.session_id != session_id:
                    continue
                if ev.bidi:
                    if control_stream is None:
                        # protocol demux on the first bidi stream's first
                        # byte: moq-lite opens with stream-type 0 (SESSION);
                        # the native protocol's first control message is
                        # MSG_SETUP (0x01). See moq/lite_session.py.
                        if ev.data[:1] == b"\x00":
                            from .lite_session import serve_moq_lite_session

                            await serve_moq_lite_session(
                                h3, session_id, relay, gateway, first_event=ev
                            )
                            return
                        control_stream = ev.stream_id
                    if ev.stream_id == control_stream:
                        for mtype, fields in parser.feed(ev.data):
                            await handle_control(mtype, fields)
                else:
                    gp = groups.get(ev.stream_id)
                    if gp is None:
                        gp = groups[ev.stream_id] = GroupParser()
                    for payload, ts, key in gp.feed(ev.data):
                        publish_frame(gp.alias, payload, ts, key)
                    if ev.fin:
                        groups.pop(ev.stream_id, None)
            elif isinstance(ev, SessionRequest):
                # another session on the same connection — acceptor handles it
                continue
    except Exception:
        # Malformed control/group wire data (unknown control message,
        # truncated varints, ...) must terminate the session cleanly, not
        # kill the serve task and leak its subscriptions.
        h3.conn.close(0x0101, "moq session protocol error")
        h3.proto.transmit()
    finally:
        for task in sub_tasks.values():
            task.cancel()
        for b in pub_relay.values():
            b.end()
        for conn in pub_gateway.values():
            conn.close()


class MoqClient:
    """WebTransport MoQ client (publish + subscribe)."""

    def __init__(self) -> None:
        self._client = None
        self._proto: Optional[QuicProtocol] = None
        self._h3: Optional[H3Connection] = None
        self._session: Optional[int] = None
        self._control: Optional[int] = None
        self._parser = ControlParser()
        self._groups: Dict[int, GroupParser] = {}
        self._next_alias = 1
        self._replies: Dict[int, asyncio.Future] = {}
        self._subs: Dict[int, asyncio.Queue] = {}
        self._pump_task: Optional[asyncio.Task] = None
        self._setup_done: Optional[asyncio.Future] = None

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
        self._control = self._h3.open_wt_bidi(self._session)
        self._setup_done = asyncio.get_running_loop().create_future()
        self._pump_task = asyncio.ensure_future(self._pump())
        self._h3.send_stream(self._control, encode_msg(MSG_SETUP, MOQ_VERSION))
        await asyncio.wait_for(self._setup_done, timeout)

    async def _pump(self) -> None:
        while True:
            ev = await self._h3.events.get()
            if isinstance(ev, ConnectionClosed):
                for q in self._subs.values():
                    q.put_nowait(None)
                if self._setup_done is not None and not self._setup_done.done():
                    self._setup_done.set_exception(ConnectionError(ev.reason))
                return
            if isinstance(ev, WtStreamData):
                if ev.bidi and ev.stream_id == self._control:
                    for mtype, fields in self._parser.feed(ev.data):
                        self._on_control(mtype, fields)
                elif not ev.bidi:
                    gp = self._groups.get(ev.stream_id)
                    if gp is None:
                        gp = self._groups[ev.stream_id] = GroupParser()
                    for payload, ts, key in gp.feed(ev.data):
                        q = self._subs.get(gp.alias)
                        if q is not None:
                            q.put_nowait((payload, ts, key))
                    if ev.fin:
                        self._groups.pop(ev.stream_id, None)

    def _on_control(self, mtype: int, fields: tuple) -> None:
        if mtype == MSG_SETUP_OK:
            if self._setup_done is not None and not self._setup_done.done():
                self._setup_done.set_result(fields[0])
        elif mtype in (MSG_PUBLISH_OK, MSG_SUBSCRIBE_OK):
            fut = self._replies.pop(fields[0], None)
            if fut is not None and not fut.done():
                fut.set_result(True)
        elif mtype == MSG_SUBSCRIBE_ERROR:
            fut = self._replies.pop(fields[0], None)
            if fut is not None and not fut.done():
                fut.set_exception(ConnectionError(fields[1]))

    async def publish(self, name: str, timeout: float = 10.0) -> "MoqPublication":
        alias = self._next_alias
        self._next_alias += 1
        fut = asyncio.get_running_loop().create_future()
        self._replies[alias] = fut
        self._h3.send_stream(self._control, encode_msg(MSG_PUBLISH, alias, name))
        await asyncio.wait_for(fut, timeout)
        return MoqPublication(self, alias)

    async def subscribe(self, name: str, timeout: float = 35.0) -> "MoqSubscription":
        alias = self._next_alias
        self._next_alias += 1
        fut = asyncio.get_running_loop().create_future()
        self._replies[alias] = fut
        q: asyncio.Queue = asyncio.Queue()
        self._subs[alias] = q
        self._h3.send_stream(self._control, encode_msg(MSG_SUBSCRIBE, alias, name))
        await asyncio.wait_for(fut, timeout)
        return MoqSubscription(self, alias, q)

    def close(self) -> None:
        if self._pump_task is not None:
            self._pump_task.cancel()
        if self._h3 is not None:
            self._h3.stop()
        if self._client is not None:
            self._client.close()


class MoqPublication:
    """Write side: frames grouped into uni streams (new stream per key frame
    or every ``max_group_frames``)."""

    def __init__(self, client: MoqClient, alias: int, max_group_frames: int = 50) -> None:
        self._c = client
        self.alias = alias
        self._stream: Optional[int] = None
        self._seq = 0
        self._in_group = 0
        self._max = max_group_frames

    def send(self, payload: bytes, timestamp_us: int = 0, key: bool = False) -> None:
        h3 = self._c._h3
        if self._stream is None or key or self._in_group >= self._max:
            if self._stream is not None:
                h3.send_stream(self._stream, b"", fin=True)
            self._stream = h3.open_wt_uni(self._c._session)
            h3.send_stream(self._stream, encode_group_header(self.alias, self._seq))
            self._seq += 1
            self._in_group = 0
        h3.send_stream(self._stream, encode_frame(payload, timestamp_us, key))
        self._in_group += 1

    def end(self) -> None:
        if self._stream is not None:
            self._c._h3.send_stream(self._stream, b"", fin=True)
            self._stream = None


class MoqSubscription:
    def __init__(self, client: MoqClient, alias: int, queue: asyncio.Queue) -> None:
        self._c = client
        self.alias = alias
        self._q = queue

    async def recv(self, timeout: Optional[float] = None) -> Optional[Tuple[bytes, int, bool]]:
        if timeout is None:
            return await self._q.get()
        return await asyncio.wait_for(self._q.get(), timeout)

    def close(self) -> None:
        self._c._h3.send_stream(self._c._control, encode_msg(MSG_UNSUBSCRIBE, self.alias))
        self._c._subs.pop(self.alias, None)
