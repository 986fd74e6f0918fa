# SPDX-License-Identifier: Apache-2.0
"""QUIC v1 connection machine (RFC 9000): frames, packet-number spaces, ACK
generation, simple PTO loss recovery, streams, flow control, datagrams
(RFC 9221). Transport-agnostic: feed received datagrams via
:meth:`QuicConnection.receive_datagram`, flush outgoing via
:meth:`QuicConnection.datagrams_to_send`.

Scope notes (what a WebTransport media plane needs, nothing more):
* no 0-RTT, no retry, no key update, no connection migration, no ECN
* single CID per direction (NEW_CONNECTION_ID ignored/retired silently)
* PTO-based retransmit of CRYPTO/STREAM data (media rides uni streams and
  datagrams where loss is tolerable; control rides reliable streams)
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from .crypto import KeySet, initial_secrets
from .packet import (
    PacketType,
    PlainPacket,
    decode_varint,
    encode_varint,
    peek_header,
    protect_packet,
    unprotect_packet,
)
from .tls import EPOCH_APP, EPOCH_HANDSHAKE, EPOCH_INITIAL, TlsError, TlsSession, TransportParams

__all__ = ["QuicConnection", "QuicConnectionError", "StreamEvent", "DatagramEvent", "HandshakeEvent", "CloseEvent"]

# frame types
F_PADDING = 0x00
F_PING = 0x01
F_ACK = 0x02
F_ACK_ECN = 0x03
F_RESET_STREAM = 0x04
F_STOP_SENDING = 0x05
F_CRYPTO = 0x06
F_NEW_TOKEN = 0x07
F_STREAM_BASE = 0x08  # 0x08-0x0f
F_MAX_DATA = 0x10
F_MAX_STREAM_DATA = 0x11
F_MAX_STREAMS_BIDI = 0x12
F_MAX_STREAMS_UNI = 0x13
F_DATA_BLOCKED = 0x14
F_STREAM_DATA_BLOCKED = 0x15
F_STREAMS_BLOCKED_BIDI = 0x16
F_STREAMS_BLOCKED_UNI = 0x17
F_NEW_CONNECTION_ID = 0x18
F_RETIRE_CONNECTION_ID = 0x19
F_PATH_CHALLENGE = 0x1A
F_PATH_RESPONSE = 0x1B
F_CONNECTION_CLOSE = 0x1C
F_CONNECTION_CLOSE_APP = 0x1D
F_HANDSHAKE_DONE = 0x1E
F_DATAGRAM = 0x30
F_DATAGRAM_LEN = 0x31

MAX_DATAGRAM_SIZE = 1350  # conservative vs 1452 MTU
PTO_SECS = 0.25
MAX_PTO_SECS = 4.0

_EPOCH_TO_PTYPE = {
    EPOCH_INITIAL: PacketType.INITIAL,
    EPOCH_HANDSHAKE: PacketType.HANDSHAKE,
    EPOCH_APP: PacketType.ONE_RTT,
}
_PTYPE_TO_EPOCH = {
    PacketType.INITIAL: EPOCH_INITIAL,
    PacketType.HANDSHAKE: EPOCH_HANDSHAKE,
    PacketType.ONE_RTT: EPOCH_APP,
}


class QuicConnectionError(Exception):
    pass


@dataclass
class StreamEvent:
    stream_id: int
    data: bytes
    fin: bool


@dataclass
class DatagramEvent:
    data: bytes


@dataclass
class HandshakeEvent:
    alpn: Optional[str]


@dataclass
class CloseEvent:
    error_code: int
    reason: str


class _RecvStream:
    """Out-of-order reassembly buffer."""

    def __init__(self) -> None:
        self.segments: Dict[int, bytes] = {}
        self.offset = 0  # next byte to deliver
        self.fin_at: Optional[int] = None
        self.delivered_fin = False

    def add(self, offset: int, data: bytes, fin: bool) -> bytes:
        if fin:
            self.fin_at = offset + len(data)
        if data:
            # keep the longest segment seen at an offset (a shorter
            # retransmit must not clobber a longer original)
            prev = self.segments.get(offset)
            if prev is None or len(prev) < len(data):
                self.segments[offset] = data
        out = bytearray()
        while True:
            # find a segment covering self.offset
            advanced = False
            for off in sorted(self.segments):
                seg = self.segments[off]
                if off > self.offset:
                    break
                del self.segments[off]
                if off + len(seg) <= self.offset:
                    continue
                out += seg[self.offset - off :]
                self.offset = off + len(seg)
                advanced = True
                break
            if not advanced:
                break
        return bytes(out)

    @property
    def fin_ready(self) -> bool:
        return self.fin_at is not None and self.offset >= self.fin_at and not self.delivered_fin


class _SendStream:
    def __init__(self, max_stream_data: int) -> None:
        self.buffer = bytearray()
        self.base_offset = 0  # offset of buffer[0]
        self.next_offset = 0  # next byte to transmit
        self.fin = False
        self.fin_sent = False
        self.max_stream_data = max_stream_data
        self.blocked = False


@dataclass
class _SentPacket:
    packet_number: int
    epoch: int
    sent_time: float
    ack_eliciting: bool
    size: int = 0
    # data needed to retransmit on loss
    crypto: List[Tuple[int, bytes]] = field(default_factory=list)  # (offset, data)
    stream: List[Tuple[int, int, bytes, bool]] = field(default_factory=list)  # (sid, off, data, fin)
    handshake_done: bool = False


# Packet-number dedup window per space (≈40 s of 20 ms media frames); see
# receive_datagram for the pruning contract.
_RECV_PN_WINDOW = 2048


class _PnSpace:
    def __init__(self) -> None:
        self.next_pn = 0
        self.largest_received = -1
        self.received: Set[int] = set()
        self.ack_pending = False
        self.sent: Dict[int, _SentPacket] = {}
        self.crypto_offset_send = 0
        self.crypto_recv = _RecvStream()
        self.crypto_to_send: List[Tuple[int, bytes]] = []  # (offset, data)


class QuicConnection:
    """One QUIC connection (client or server role)."""

    def __init__(
        self,
        is_server: bool,
        tls: TlsSession,
        original_dcid: bytes,
        scid: Optional[bytes] = None,
        now: Optional[Callable[[], float]] = None,
    ) -> None:
        self.is_server = is_server
        self.tls = tls
        self.scid = scid if scid is not None else os.urandom(8)
        self.peer_cid = original_dcid if not is_server else b""  # updated from peer's scid
        self.original_dcid = original_dcid
        self._now = now or time.monotonic
        self.spaces = {e: _PnSpace() for e in (EPOCH_INITIAL, EPOCH_HANDSHAKE, EPOCH_APP)}
        # recv/send keys per epoch
        client_init, server_init = initial_secrets(original_dcid)
        if is_server:
            self.recv_keys: Dict[int, KeySet] = {EPOCH_INITIAL: client_init}
            self.send_keys: Dict[int, KeySet] = {EPOCH_INITIAL: server_init}
        else:
            self.recv_keys = {EPOCH_INITIAL: server_init}
            self.send_keys = {EPOCH_INITIAL: client_init}

        self.events: List[object] = []
        self.handshake_complete = False
        self.handshake_confirmed = False
        self.closed = False
        self.close_sent: Optional[Tuple[int, str, bool]] = None

        # streams
        self._recv_streams: Dict[int, _RecvStream] = {}
        self._send_streams: Dict[int, _SendStream] = {}
        self._next_uni = 3 if is_server else 2
        self._next_bidi = 1 if is_server else 0
        self._reset_queue: List[Tuple[int, int]] = []  # (stream_id, error_code)
        self._stream_rtx: List[Tuple[int, int, bytes, bool]] = []  # lost stream chunks

        # flow control (ours advertised to peer; theirs advertised to us)
        tp = tls.transport_params
        self.local_max_data = tp.initial_max_data
        self.local_max_stream_data = tp.initial_max_stream_data
        self.peer_max_data = 0
        self.peer_max_stream_data_default = 0
        self.data_sent = 0
        self.data_received = 0
        self.data_consumed = 0
        self._max_data_to_send: Optional[int] = None
        self._max_stream_data_to_send: Dict[int, int] = {}

        self._datagrams_out: List[bytes] = []
        self._pto_count = 0
        # ACK-clocked congestion control: slow-start doubling to a cap that
        # stays under typical loopback/UDP socket buffers
        self.bytes_in_flight = 0
        self.cwnd = 48 * 1024
        self.cwnd_cap = 512 * 1024
        # RFC 9002-lite loss recovery: RTT-estimated PTO + packet-threshold
        # loss + once-per-epoch cwnd reduction. The round-2 fixed 250 ms PTO
        # that halved cwnd on every fire produced a death spiral under relay
        # load (one >250 ms hiccup -> retransmit storm -> more delay);
        # measured bimodal session stalls in moq_wt_bench (PERF_NOTES r3).
        self.srtt: Optional[float] = None
        self.rttvar = 0.0
        self._recovery_start = -1.0  # sent_time threshold of current loss epoch

        if not is_server:
            tls.client_start()
            self._pump_tls()

    # ------------------------------------------------------------------ TLS

    def _pump_tls(self) -> None:
        while self.tls.pending_output:
            epoch, data = self.tls.pending_output.pop(0)
            space = self.spaces[epoch]
            space.crypto_to_send.append((space.crypto_offset_send, data))
            space.crypto_offset_send += len(data)
        while self.tls.new_keys:
            epoch, recv_ks, send_ks = self.tls.new_keys.pop(0)
            # TlsSession orders (client KeySet, server KeySet) by caller role
            self.recv_keys[epoch] = recv_ks
            self.send_keys[epoch] = send_ks
        if self.tls.handshake_complete and not self.handshake_complete:
            self.handshake_complete = True
            if self.tls.peer_transport_params is not None:
                ptp = self.tls.peer_transport_params
                self.peer_max_data = ptp.initial_max_data
                self.peer_max_stream_data_default = ptp.initial_max_stream_data
                for s in self._send_streams.values():
                    s.max_stream_data = max(s.max_stream_data, ptp.initial_max_stream_data)
            self.events.append(HandshakeEvent(self.tls.negotiated_alpn))
            if self.is_server:
                # HANDSHAKE_DONE + discard initial space
                self.handshake_confirmed = True

    # --------------------------------------------------------------- receive

    def receive_datagram(self, datagram: bytes) -> None:
        if self.closed:
            return
        off = 0
        while off < len(datagram):
            if datagram[off] == 0:  # trailing padding
                break
            try:
                hdr = peek_header(datagram, off, len(self.scid))
            except (IndexError, ValueError):
                return
            epoch = _PTYPE_TO_EPOCH.get(hdr["type"])
            if epoch is None or epoch not in self.recv_keys:
                off = hdr["end"]
                continue
            space = self.spaces[epoch]
            pkt = unprotect_packet(
                self.recv_keys[epoch], datagram, off, hdr, space.largest_received
            )
            off = hdr["end"]
            if pkt is None:
                continue
            if pkt.packet_number in space.received:
                continue
            # Bound the dedup set for long-lived media connections: packet
            # numbers older than the tracking window are treated as stale
            # duplicates, and the set is pruned to the window periodically
            # (also keeps the per-ACK range scan in _ack_frame O(window)).
            if pkt.packet_number < space.largest_received - _RECV_PN_WINDOW:
                continue
            space.received.add(pkt.packet_number)
            space.largest_received = max(space.largest_received, pkt.packet_number)
            if len(space.received) > 2 * _RECV_PN_WINDOW:
                floor = space.largest_received - _RECV_PN_WINDOW
                space.received = {pn for pn in space.received if pn >= floor}
            if self.is_server and not self.peer_cid and pkt.scid:
                self.peer_cid = pkt.scid
            if not self.is_server and epoch == EPOCH_INITIAL and pkt.scid:
                self.peer_cid = pkt.scid  # server's chosen CID
            try:
                ack_eliciting = self._handle_frames(epoch, pkt.payload)
            except TlsError as e:
                self._queue_close(0x0128, str(e))  # crypto error class
                return
            except QuicConnectionError as e:
                self._queue_close(0x0A, str(e))
                return
            except Exception as e:  # malformed wire input (struct.error,
                # IndexError from truncated varints/frames, ...): close the
                # connection instead of letting the error escape into the
                # UDP receive callback — Initial packets are decryptable by
                # anyone, so this path is attacker-reachable pre-handshake.
                self._queue_close(0x07, f"frame encoding error: {e!r}")
                return
            if ack_eliciting:
                space.ack_pending = True

    def _handle_frames(self, epoch: int, payload: bytes) -> bool:
        space = self.spaces[epoch]
        off = 0
        ack_eliciting = False
        while off < len(payload):
            ftype, off = decode_varint(payload, off)
            if ftype == F_PADDING:
                continue
            if ftype == F_PING:
                ack_eliciting = True
                continue
            if ftype in (F_ACK, F_ACK_ECN):
                off = self._handle_ack(space, payload, off, ftype == F_ACK_ECN)
                continue
            ack_eliciting = True
            if ftype == F_CRYPTO:
                coff, off = decode_varint(payload, off)
                clen, off = decode_varint(payload, off)
                data = payload[off : off + clen]
                off += clen
                ready = space.crypto_recv.add(coff, data, False)
                if ready:
                    self.tls.handle_crypto(epoch, ready)
                    self._pump_tls()
            elif F_STREAM_BASE <= ftype <= 0x0F:
                off = self._handle_stream_frame(ftype, payload, off)
            elif ftype == F_MAX_DATA:
                v, off = decode_varint(payload, off)
                self.peer_max_data = max(self.peer_max_data, v)
            elif ftype == F_MAX_STREAM_DATA:
                sid, off = decode_varint(payload, off)
                v, off = decode_varint(payload, off)
                s = self._send_streams.get(sid)
                if s is not None:
                    s.max_stream_data = max(s.max_stream_data, v)
            elif ftype in (F_MAX_STREAMS_BIDI, F_MAX_STREAMS_UNI):
                _, off = decode_varint(payload, off)
            elif ftype in (F_DATA_BLOCKED, F_STREAMS_BLOCKED_BIDI, F_STREAMS_BLOCKED_UNI):
                _, off = decode_varint(payload, off)
            elif ftype == F_STREAM_DATA_BLOCKED:
                _, off = decode_varint(payload, off)
                _, off = decode_varint(payload, off)
            elif ftype == F_RESET_STREAM:
                sid, off = decode_varint(payload, off)
                err, off = decode_varint(payload, off)
                _final, off = decode_varint(payload, off)
                self.events.append(StreamEvent(sid, b"", True))
            elif ftype == F_STOP_SENDING:
                sid, off = decode_varint(payload, off)
                err, off = decode_varint(payload, off)
                s = self._send_streams.get(sid)
                if s is not None:
                    s.fin = True
            elif ftype == F_NEW_TOKEN:
                tlen, off = decode_varint(payload, off)
                off += tlen
            elif ftype == F_NEW_CONNECTION_ID:
                _seq, off = decode_varint(payload, off)
                _retire, off = decode_varint(payload, off)
                cid_len = payload[off]
                off += 1 + cid_len + 16  # cid + stateless reset token
            elif ftype == F_RETIRE_CONNECTION_ID:
                _, off = decode_varint(payload, off)
            elif ftype == F_PATH_CHALLENGE:
                data = payload[off : off + 8]
                off += 8
                self._path_response = data
            elif ftype == F_PATH_RESPONSE:
                off += 8
            elif ftype in (F_CONNECTION_CLOSE, F_CONNECTION_CLOSE_APP):
                err, off = decode_varint(payload, off)
                if ftype == F_CONNECTION_CLOSE:
                    _ft, off = decode_varint(payload, off)
                rlen, off = decode_varint(payload, off)
                reason = payload[off : off + rlen].decode("utf-8", "replace")
                off += rlen
                self.closed = True
                self.events.append(CloseEvent(err, reason))
            elif ftype == F_HANDSHAKE_DONE:
                self.handshake_confirmed = True
                self._drop_epoch(EPOCH_HANDSHAKE)
            elif ftype in (F_DATAGRAM, F_DATAGRAM_LEN):
                if ftype == F_DATAGRAM_LEN:
                    dlen, off = decode_varint(payload, off)
                else:
                    dlen = len(payload) - off
                self.events.append(DatagramEvent(payload[off : off + dlen]))
                off += dlen
            else:
                raise QuicConnectionError(f"unknown frame type {ftype:#x}")
        return ack_eliciting

    def _handle_stream_frame(self, ftype: int, payload: bytes, off: int) -> int:
        has_off = bool(ftype & 0x04)
        has_len = bool(ftype & 0x02)
        fin = bool(ftype & 0x01)
        sid, off = decode_varint(payload, off)
        soff = 0
        if has_off:
            soff, off = decode_varint(payload, off)
        if has_len:
            slen, off = decode_varint(payload, off)
        else:
            slen = len(payload) - off
        data = payload[off : off + slen]
        off += slen
        rs = self._recv_streams.get(sid)
        if rs is None:
            rs = self._recv_streams[sid] = _RecvStream()
        prev_high = max([rs.offset] + [o + len(s) for o, s in rs.segments.items()] or [0])
        ready = rs.add(soff, data, fin)
        new_high = max(rs.offset, soff + len(data))
        self.data_received += max(0, new_high - prev_high)
        if ready or rs.fin_ready:
            fin_now = rs.fin_ready
            if fin_now:
                rs.delivered_fin = True
            self.data_consumed += len(ready)
            self.events.append(StreamEvent(sid, ready, fin_now))
            self._maybe_bump_flow_control(sid, rs)
        return off

    def _maybe_bump_flow_control(self, sid: int, rs: _RecvStream) -> None:
        # replenish connection window when half consumed
        if self.data_consumed * 2 > self.local_max_data:
            self.local_max_data *= 2
            self._max_data_to_send = self.local_max_data
        if rs.offset * 2 > self.local_max_stream_data:
            self._max_stream_data_to_send[sid] = rs.offset + self.local_max_stream_data

    def _handle_ack(self, space: _PnSpace, payload: bytes, off: int, ecn: bool) -> int:
        largest, off = decode_varint(payload, off)
        _delay, off = decode_varint(payload, off)
        range_count, off = decode_varint(payload, off)
        first_range, off = decode_varint(payload, off)
        # ACK ranges are attacker-controlled varints (up to 2^62): never
        # materialize them as sets. Clamp to the packet numbers we actually
        # sent and intersect interval-wise with the sent-packet dict.
        largest = min(largest, space.next_pn - 1)
        ranges: List[Tuple[int, int]] = []  # (smallest, largest) inclusive
        smallest = largest - first_range
        if largest >= 0:
            ranges.append((max(0, smallest), largest))
        for _ in range(range_count):
            gap, off = decode_varint(payload, off)
            rlen, off = decode_varint(payload, off)
            largest_r = smallest - gap - 2
            smallest = largest_r - rlen
            if largest_r >= 0:
                ranges.append((max(0, smallest), largest_r))
        if ecn:
            for _ in range(3):
                _, off = decode_varint(payload, off)
        if ranges:
            now = self._now()
            for pn in list(space.sent):
                if any(lo <= pn <= hi for lo, hi in ranges):
                    sp = space.sent.pop(pn)
                    self.bytes_in_flight = max(0, self.bytes_in_flight - sp.size)
                    self.cwnd = min(self.cwnd_cap, self.cwnd + sp.size)  # slow start
                    if pn == largest:  # RTT sample from the largest acked
                        self._sample_rtt(now - sp.sent_time)
            # packet-threshold loss (RFC 9002 §6.1.1): anything 3+ packets
            # older than the largest acked and still unacked is lost now —
            # requeue without waiting for the PTO timer
            thresh = largest - 3
            for pn in [p for p in space.sent if p <= thresh]:
                self._declare_lost(space, space.sent.pop(pn))
        self._pto_count = 0
        return off

    def _sample_rtt(self, latest: float) -> None:
        if latest < 0:
            return
        if self.srtt is None:
            self.srtt = latest
            self.rttvar = latest / 2
        else:  # RFC 6298 EWMA
            self.rttvar = 0.75 * self.rttvar + 0.25 * abs(self.srtt - latest)
            self.srtt = 0.875 * self.srtt + 0.125 * latest

    def _pto_interval(self) -> float:
        if self.srtt is None:
            base = PTO_SECS
        else:
            base = max(0.05, self.srtt + 4 * self.rttvar + 0.025)
        return min(MAX_PTO_SECS, base * (2**self._pto_count))

    def _declare_lost(self, space: "_PnSpace", sp: "_SentPacket") -> None:
        """Requeue a lost packet's retransmittable data; reduce cwnd at most
        once per loss epoch (RFC 9002 §7.3.1 recovery period)."""
        self.bytes_in_flight = max(0, self.bytes_in_flight - sp.size)
        for coff, data in sp.crypto:
            space.crypto_to_send.append((coff, data))
        for sid, soff, data, fin in sp.stream:
            if sid in self._send_streams or fin:
                self._stream_rtx.append((sid, soff, data, fin))
        if sp.handshake_done:
            self._hd_sent = False
        if sp.sent_time > self._recovery_start:
            self.cwnd = max(16 * 1024, self.cwnd // 2)
            self._recovery_start = self._now()

    def _drop_epoch(self, epoch: int) -> None:
        self.recv_keys.pop(epoch, None)
        self.send_keys.pop(epoch, None)
        self.spaces[epoch] = _PnSpace()

    # ------------------------------------------------------------------ send

    def open_uni_stream(self) -> int:
        sid = self._next_uni
        self._next_uni += 4
        self._send_streams[sid] = _SendStream(self.peer_max_stream_data_default)
        return sid

    def open_bidi_stream(self) -> int:
        sid = self._next_bidi
        self._next_bidi += 4
        self._send_streams[sid] = _SendStream(self.peer_max_stream_data_default)
        return sid

    def send_stream_data(self, sid: int, data: bytes, fin: bool = False) -> None:
        s = self._send_streams.get(sid)
        if s is None:
            # peer-initiated bidi stream we respond on
            s = self._send_streams[sid] = _SendStream(self.peer_max_stream_data_default)
        s.buffer.extend(data)
        if fin:
            s.fin = True

    def reset_stream(self, sid: int, error_code: int = 0) -> None:
        self._reset_queue.append((sid, error_code))
        self._send_streams.pop(sid, None)

    def send_datagram(self, data: bytes) -> None:
        self._datagrams_out.append(data)

    def close(self, error_code: int = 0, reason: str = "") -> None:
        if self.close_sent is None:
            self._queue_close(error_code, reason, app=True)

    def _queue_close(self, error_code: int, reason: str, app: bool = False) -> None:
        if self.close_sent is None:
            # surface the close locally too — callers awaiting the handshake
            # (or pumping events) must fail fast with the real reason, not
            # time out silently (e.g. fingerprint-pinning rejection)
            self.events.append(CloseEvent(error_code, reason))
        self.close_sent = (error_code, reason, app)

    # -- datagram building ------------------------------------------------------

    def datagrams_to_send(self) -> List[bytes]:
        """Build all pending outgoing datagrams (call after receive/timer)."""
        out: List[bytes] = []
        if self.close_sent is not None and not self.closed:
            err, reason, app = self.close_sent
            epoch = EPOCH_APP if EPOCH_APP in self.send_keys else EPOCH_INITIAL
            fr = bytearray(encode_varint(F_CONNECTION_CLOSE_APP if app else F_CONNECTION_CLOSE))
            fr += encode_varint(err)
            if not app:
                fr += encode_varint(0)
            rb = reason.encode()[:128]
            fr += encode_varint(len(rb)) + rb
            out.append(self._build_packet(epoch, bytes(fr), ack_eliciting=False))
            self.closed = True
            return out
        if self.closed:
            return out
        for epoch in (EPOCH_INITIAL, EPOCH_HANDSHAKE, EPOCH_APP):
            if epoch not in self.send_keys:
                continue
            if not self._epoch_has_pending(epoch):
                continue
            while True:
                pkt = self._build_epoch_payload(epoch)
                if pkt is None:
                    break
                out.append(pkt)
        # server: drop initial keys once handshake keys exist
        if self.is_server and EPOCH_HANDSHAKE in self.send_keys and self.handshake_complete:
            if EPOCH_INITIAL in self.send_keys:
                self._drop_epoch(EPOCH_INITIAL)
        if not self.is_server and self.handshake_confirmed and EPOCH_HANDSHAKE in self.send_keys:
            self._drop_epoch(EPOCH_HANDSHAKE)
        return out

    def _ack_frame(self, space: _PnSpace) -> bytes:
        if space.largest_received < 0:
            return b""
        # build ranges from received set (bounded scan)
        pns = sorted(space.received, reverse=True)
        ranges: List[Tuple[int, int]] = []  # (largest, smallest)
        for pn in pns:
            if ranges and ranges[-1][1] == pn + 1:
                ranges[-1] = (ranges[-1][0], pn)
            else:
                ranges.append((pn, pn))
        fr = bytearray(encode_varint(F_ACK))
        fr += encode_varint(ranges[0][0])
        fr += encode_varint(0)  # ack delay
        fr += encode_varint(len(ranges) - 1)
        fr += encode_varint(ranges[0][0] - ranges[0][1])
        prev_smallest = ranges[0][1]
        for largest, smallest in ranges[1:]:
            fr += encode_varint(prev_smallest - largest - 2)
            fr += encode_varint(largest - smallest)
            prev_smallest = smallest
        return bytes(fr)

    def _epoch_has_pending(self, epoch: int) -> bool:
        """Cheap emptiness check so ``datagrams_to_send`` skips the frame
        builder for idle epochs — the builder ran ~3.5x per packet actually
        built under MoQ load, with the misses costing ~10% of relay CPU
        (PERF_NOTES r3). Must stay conservative: returning True for an idle
        epoch only wastes a builder call; returning False for a pending one
        would stall the connection."""
        space = self.spaces[epoch]
        if space.ack_pending or space.crypto_to_send:
            return True
        if epoch != EPOCH_APP:
            return False
        if (
            self._datagrams_out
            or self._stream_rtx
            or self._reset_queue
            or self._max_data_to_send is not None
            or self._max_stream_data_to_send
            or getattr(self, "_path_response", None) is not None
        ):
            return True
        if self.is_server and self.handshake_confirmed and not getattr(self, "_hd_sent", False):
            return True
        if self.handshake_complete and self.bytes_in_flight < self.cwnd:
            for s in self._send_streams.values():
                if s.fin and not s.fin_sent:
                    return True
                if len(s.buffer) - (s.next_offset - s.base_offset) > 0:
                    return True
        return False

    def _build_epoch_payload(self, epoch: int) -> Optional[bytes]:
        """One packet's worth of frames for this epoch, or None if nothing."""
        space = self.spaces[epoch]
        frames = bytearray()
        sent = _SentPacket(
            packet_number=space.next_pn,
            epoch=epoch,
            sent_time=self._now(),
            ack_eliciting=False,
        )
        budget = MAX_DATAGRAM_SIZE - 96  # header + AEAD + margin

        if space.ack_pending:
            ack = self._ack_frame(space)
            frames += ack
            space.ack_pending = False

        # CRYPTO data
        while space.crypto_to_send and budget - len(frames) > 32:
            coff, data = space.crypto_to_send.pop(0)
            room = budget - len(frames) - 24
            chunk, rest = data[:room], data[room:]
            if rest:
                space.crypto_to_send.insert(0, (coff + len(chunk), rest))
            frames += encode_varint(F_CRYPTO)
            frames += encode_varint(coff)
            frames += encode_varint(len(chunk))
            frames += chunk
            sent.crypto.append((coff, chunk))
            sent.ack_eliciting = True

        if epoch == EPOCH_APP:
            # HANDSHAKE_DONE (server, once)
            if self.is_server and self.handshake_confirmed and not getattr(self, "_hd_sent", False):
                frames += encode_varint(F_HANDSHAKE_DONE)
                self._hd_sent = True
                sent.handshake_done = True
                sent.ack_eliciting = True
            if getattr(self, "_path_response", None) is not None:
                frames += encode_varint(F_PATH_RESPONSE) + self._path_response
                self._path_response = None
                sent.ack_eliciting = True
            # flow control updates
            if self._max_data_to_send is not None:
                frames += encode_varint(F_MAX_DATA) + encode_varint(self._max_data_to_send)
                self._max_data_to_send = None
                sent.ack_eliciting = True
            for sid, v in list(self._max_stream_data_to_send.items()):
                frames += encode_varint(F_MAX_STREAM_DATA) + encode_varint(sid) + encode_varint(v)
                del self._max_stream_data_to_send[sid]
                sent.ack_eliciting = True
            while self._reset_queue:
                sid, err = self._reset_queue.pop(0)
                frames += (
                    encode_varint(F_RESET_STREAM)
                    + encode_varint(sid)
                    + encode_varint(err)
                    + encode_varint(0)
                )
                sent.ack_eliciting = True
            # datagrams
            while self._datagrams_out and budget - len(frames) > len(self._datagrams_out[0]) + 8:
                d = self._datagrams_out.pop(0)
                frames += encode_varint(F_DATAGRAM_LEN) + encode_varint(len(d)) + d
                sent.ack_eliciting = True
            # lost stream chunks first (carried by copy, so buffer release is
            # safe); split chunks that don't fit the remaining budget
            while self._stream_rtx:
                room = budget - len(frames) - 24
                if room <= 0:
                    break
                sid, soff, data, fin_bit = self._stream_rtx.pop(0)
                chunk, rest = data[:room], data[room:]
                if rest:
                    self._stream_rtx.insert(0, (sid, soff + len(chunk), rest, fin_bit))
                    fin_now = False
                else:
                    fin_now = fin_bit
                ftype = F_STREAM_BASE | 0x04 | 0x02 | (0x01 if fin_now else 0)
                frames += encode_varint(ftype)
                frames += encode_varint(sid)
                frames += encode_varint(soff)
                frames += encode_varint(len(chunk))
                frames += chunk
                sent.stream.append((sid, soff, chunk, fin_now))
                sent.ack_eliciting = True
            # stream data (ACK-clocked: hold off while a full window is in flight)
            if self.handshake_complete and self.bytes_in_flight < self.cwnd:
                for sid, s in list(self._send_streams.items()):
                    if budget - len(frames) < 40:
                        break
                    pending = len(s.buffer) - (s.next_offset - s.base_offset)
                    want_fin = s.fin and not s.fin_sent
                    if pending <= 0 and not want_fin:
                        continue
                    # flow control limits
                    allowed = min(
                        pending,
                        s.max_stream_data - s.next_offset if s.max_stream_data else pending,
                        self.peer_max_data - self.data_sent if self.peer_max_data else pending,
                        budget - len(frames) - 24,
                    )
                    allowed = max(0, allowed)
                    if allowed <= 0 and not want_fin:
                        continue
                    start = s.next_offset - s.base_offset
                    chunk = bytes(s.buffer[start : start + allowed])
                    fin_bit = want_fin and (start + allowed == len(s.buffer))
                    ftype = F_STREAM_BASE | 0x04 | 0x02 | (0x01 if fin_bit else 0)
                    frames += encode_varint(ftype)
                    frames += encode_varint(sid)
                    frames += encode_varint(s.next_offset)
                    frames += encode_varint(len(chunk))
                    frames += chunk
                    sent.stream.append((sid, s.next_offset, chunk, fin_bit))
                    sent.ack_eliciting = True
                    s.next_offset += len(chunk)
                    self.data_sent += len(chunk)
                    if fin_bit:
                        s.fin_sent = True
                    # release delivered bytes (we retransmit from sent-packet copies)
                    drop = s.next_offset - s.base_offset
                    if drop > 1 << 16:
                        del s.buffer[:drop]
                        s.base_offset = s.next_offset

        if not frames:
            return None

        if sent.ack_eliciting:
            sent.size = len(frames) + 62  # header + AEAD estimate
            self.bytes_in_flight += sent.size
            space.sent[sent.packet_number] = sent
        pn = space.next_pn
        space.next_pn += 1
        payload = bytes(frames)
        # Initial/Handshake ack-eliciting datagrams must be >= 1200 bytes
        if epoch in (EPOCH_INITIAL, EPOCH_HANDSHAKE) and sent.ack_eliciting:
            # datagrams carrying ack-eliciting Initial/Handshake packets must
            # be >= 1200 bytes (RFC 9000 §14.1); header+tag is ~46 bytes
            min_payload = 1200 - 40
            if len(payload) < min_payload:
                payload += bytes(min_payload - len(payload))
        elif len(payload) < 4:
            payload += bytes(4 - len(payload))  # min sample size for HP
        return self._build_packet(epoch, payload, sent.ack_eliciting, pn_override=pn)

    def _build_packet(
        self, epoch: int, payload: bytes, ack_eliciting: bool, pn_override: Optional[int] = None
    ) -> bytes:
        space = self.spaces[epoch]
        pn = pn_override if pn_override is not None else space.next_pn
        if pn_override is None:
            space.next_pn += 1
        if len(payload) < 4:
            payload += bytes(4 - len(payload))
        pkt = PlainPacket(
            type=_EPOCH_TO_PTYPE[epoch],
            dcid=self.peer_cid if self.peer_cid else self.original_dcid,
            scid=self.scid,
            packet_number=pn,
            payload=payload,
        )
        return protect_packet(self.send_keys[epoch], pkt)

    # ----------------------------------------------------------------- timers

    def handle_timer(self) -> None:
        """Call periodically (~50 ms): PTO retransmission.

        PTO is RTT-based (``_pto_interval``) and does NOT collapse cwnd —
        per RFC 9002 a PTO expiry is a probe, not a loss signal; cwnd
        reduction happens in ``_declare_lost`` (packet-threshold, at most
        once per recovery period). The old fixed-250 ms halve-on-every-fire
        behavior death-spiraled under relay load."""
        now = self._now()
        pto = self._pto_interval()
        fired = False
        for epoch, space in self.spaces.items():
            for pn, sp in list(space.sent.items()):
                if now - sp.sent_time > pto:
                    self._declare_lost(space, space.sent.pop(pn))
                    fired = True
        if fired:
            self._pto_count = min(self._pto_count + 1, 6)

    @property
    def timeout_pending(self) -> bool:
        return any(space.sent for space in self.spaces.values())
