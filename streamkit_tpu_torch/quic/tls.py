# SPDX-License-Identifier: Apache-2.0
"""Minimal TLS 1.3 handshake engine for QUIC (RFC 8446 + RFC 9001).

Scope: exactly what a WebTransport media server needs —

* suite TLS_AES_128_GCM_SHA256, group x25519, sig ecdsa_secp256r1_sha256
* server: self-signed ECDSA P-256 certificate (the WebTransport
  ``serverCertificateHashes`` model — reference auto-generates its cert the
  same way, apps/skit/src/server.rs:1975-2085)
* client: certificate fingerprint pinning (sha-256 of DER) instead of chain
  validation, plus full CertificateVerify / Finished verification
* QUIC transport parameters carried in the TLS extensions (RFC 9001 §8.2)

Messages flow over QUIC CRYPTO frames; :class:`TlsSession` consumes
handshake bytes per epoch and emits (epoch, bytes) outputs plus derived
:class:`~.crypto.KeySet` epochs for the connection.

Port of ``streamkit_tpu/quic/tls.py``. X25519, ECDSA and the certificate's
public key come from OpenSSL's libcrypto (:mod:`._libcrypto`);
:func:`generate_self_signed` writes the certificate's DER itself.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ._libcrypto import EcdsaP256Key, X25519Key, cert_public_key
from .crypto import TlsKeySchedule, keys_from_secret

__all__ = ["TlsSession", "generate_self_signed", "TlsError", "TransportParams"]

# handshake message types
HT_CLIENT_HELLO = 1
HT_SERVER_HELLO = 2
HT_NEW_SESSION_TICKET = 4
HT_ENCRYPTED_EXTENSIONS = 8
HT_CERTIFICATE = 11
HT_CERTIFICATE_VERIFY = 15
HT_FINISHED = 20

# extensions
EXT_SERVER_NAME = 0
EXT_SUPPORTED_GROUPS = 10
EXT_SIGNATURE_ALGORITHMS = 13
EXT_ALPN = 16
EXT_SUPPORTED_VERSIONS = 43
EXT_KEY_SHARE = 51
EXT_QUIC_TRANSPORT_PARAMS = 0x39

SUITE_AES128_GCM_SHA256 = 0x1301
GROUP_X25519 = 0x001D
SIG_ECDSA_P256_SHA256 = 0x0403
TLS13 = 0x0304

EPOCH_INITIAL = 0
EPOCH_HANDSHAKE = 1
EPOCH_APP = 2


class TlsError(Exception):
    pass


# ---------------------------------------------------------------------------
# transport parameters (RFC 9000 §18)

TP_ORIGINAL_DCID = 0x00
TP_MAX_IDLE_TIMEOUT = 0x01
TP_MAX_UDP_PAYLOAD = 0x03
TP_INITIAL_MAX_DATA = 0x04
TP_IMSD_BIDI_LOCAL = 0x05
TP_IMSD_BIDI_REMOTE = 0x06
TP_IMSD_UNI = 0x07
TP_INITIAL_MAX_STREAMS_BIDI = 0x08
TP_INITIAL_MAX_STREAMS_UNI = 0x09
TP_INITIAL_SCID = 0x0F
TP_MAX_DATAGRAM_FRAME_SIZE = 0x20


@dataclass
class TransportParams:
    initial_max_data: int = 16 * 1024 * 1024
    initial_max_stream_data: int = 4 * 1024 * 1024
    initial_max_streams_bidi: int = 256
    initial_max_streams_uni: int = 256
    max_idle_timeout_ms: int = 30_000
    max_udp_payload_size: int = 1452
    max_datagram_frame_size: int = 65527
    initial_scid: bytes = b""
    original_dcid: Optional[bytes] = None  # server only

    def encode(self) -> bytes:
        from .packet import encode_varint as vi

        out = bytearray()

        def put(tid: int, val: bytes) -> None:
            out.extend(vi(tid))
            out.extend(vi(len(val)))
            out.extend(val)

        put(TP_MAX_IDLE_TIMEOUT, vi(self.max_idle_timeout_ms))
        put(TP_MAX_UDP_PAYLOAD, vi(self.max_udp_payload_size))
        put(TP_INITIAL_MAX_DATA, vi(self.initial_max_data))
        put(TP_IMSD_BIDI_LOCAL, vi(self.initial_max_stream_data))
        put(TP_IMSD_BIDI_REMOTE, vi(self.initial_max_stream_data))
        put(TP_IMSD_UNI, vi(self.initial_max_stream_data))
        put(TP_INITIAL_MAX_STREAMS_BIDI, vi(self.initial_max_streams_bidi))
        put(TP_INITIAL_MAX_STREAMS_UNI, vi(self.initial_max_streams_uni))
        put(TP_MAX_DATAGRAM_FRAME_SIZE, vi(self.max_datagram_frame_size))
        put(TP_INITIAL_SCID, self.initial_scid)
        if self.original_dcid is not None:
            put(TP_ORIGINAL_DCID, self.original_dcid)
        return bytes(out)

    @staticmethod
    def decode(data: bytes) -> "TransportParams":
        from .packet import decode_varint

        tp = TransportParams()
        off = 0
        while off < len(data):
            tid, off = decode_varint(data, off)
            ln, off = decode_varint(data, off)
            val = data[off : off + ln]
            off += ln

            def vint() -> int:
                return decode_varint(val, 0)[0] if val else 0

            if tid == TP_INITIAL_MAX_DATA:
                tp.initial_max_data = vint()
            elif tid in (TP_IMSD_BIDI_LOCAL, TP_IMSD_BIDI_REMOTE, TP_IMSD_UNI):
                tp.initial_max_stream_data = vint()
            elif tid == TP_INITIAL_MAX_STREAMS_BIDI:
                tp.initial_max_streams_bidi = vint()
            elif tid == TP_INITIAL_MAX_STREAMS_UNI:
                tp.initial_max_streams_uni = vint()
            elif tid == TP_MAX_IDLE_TIMEOUT:
                tp.max_idle_timeout_ms = vint()
            elif tid == TP_MAX_DATAGRAM_FRAME_SIZE:
                tp.max_datagram_frame_size = vint()
            elif tid == TP_INITIAL_SCID:
                tp.initial_scid = val
            elif tid == TP_ORIGINAL_DCID:
                tp.original_dcid = val
        return tp


# ---------------------------------------------------------------------------
# self-signed certificate (X.509 v3, DER; RFC 5280 §4.1)

_OID_ECDSA_SHA256 = bytes.fromhex("2a8648ce3d040302")  # 1.2.840.10045.4.3.2
_OID_COMMON_NAME = bytes.fromhex("550403")  # 2.5.4.3
_OID_SUBJECT_ALT_NAME = bytes.fromhex("551d11")  # 2.5.29.17


def _der(tag: int, body: bytes) -> bytes:
    n = len(body)
    if n < 0x80:
        return bytes([tag, n]) + body
    ln = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([tag, 0x80 | len(ln)]) + ln + body


def _der_seq(*parts: bytes) -> bytes:
    return _der(0x30, b"".join(parts))


def _der_uint(value: int) -> bytes:
    body = value.to_bytes(max(1, (value.bit_length() + 8) // 8), "big")  # room for the sign bit
    return _der(0x02, body)


def _der_time(t: datetime.datetime) -> bytes:
    if t.year < 2050:  # RFC 5280 §4.1.2.5: UTCTime through 2049
        return _der(0x17, t.strftime("%y%m%d%H%M%SZ").encode())
    return _der(0x18, t.strftime("%Y%m%d%H%M%SZ").encode())


def _der_name(common_name: str) -> bytes:
    atv = _der_seq(_der(0x06, _OID_COMMON_NAME), _der(0x0C, common_name.encode()))
    return _der_seq(_der(0x31, atv))


def generate_self_signed(common_name: str = "streamkit-tpu") -> Tuple[bytes, EcdsaP256Key]:
    """Generate (DER certificate, private key). Validity ≤ 14 days: the
    WebTransport serverCertificateHashes trust model requires short-lived
    certs (the reference regenerates its dev cert the same way). ECDSA
    P-256 with SHA-256, issuer = subject = CN, a random positive 159-bit
    serial, SAN ``DNS:localhost``."""
    key = EcdsaP256Key.generate()
    name = _der_name(common_name)
    now = datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)
    sig_alg = _der_seq(_der(0x06, _OID_ECDSA_SHA256))
    san = _der_seq(_der(0x82, b"localhost"))  # GeneralNames { dNSName }
    extensions = _der(0xA3, _der_seq(_der_seq(_der(0x06, _OID_SUBJECT_ALT_NAME), _der(0x04, san))))
    tbs = _der_seq(
        _der(0xA0, _der_uint(2)),  # version v3
        _der_uint(int.from_bytes(os.urandom(20), "big") >> 1),
        sig_alg,
        name,
        _der_seq(_der_time(now - datetime.timedelta(hours=1)), _der_time(now + datetime.timedelta(days=13))),
        name,
        key.public_der(),
        extensions,
    )
    cert = _der_seq(tbs, sig_alg, _der(0x03, b"\x00" + key.sign(tbs)))
    return cert, key


# ---------------------------------------------------------------------------
# wire helpers


def _msg(mtype: int, body: bytes) -> bytes:
    return bytes([mtype]) + len(body).to_bytes(3, "big") + body


def _ext(etype: int, body: bytes) -> bytes:
    return struct.pack("!HH", etype, len(body)) + body


def _parse_extensions(data: bytes) -> Dict[int, bytes]:
    exts: Dict[int, bytes] = {}
    off = 0
    while off + 4 <= len(data):
        etype, elen = struct.unpack_from("!HH", data, off)
        off += 4
        exts[etype] = data[off : off + elen]
        off += elen
    return exts


_CV_SERVER_CONTEXT = b" " * 64 + b"TLS 1.3, server CertificateVerify" + b"\x00"


class TlsSession:
    """One QUIC-TLS handshake (client or server role)."""

    def __init__(
        self,
        is_server: bool,
        transport_params: TransportParams,
        alpn: str = "h3",
        cert_der: Optional[bytes] = None,
        private_key: Optional[EcdsaP256Key] = None,
        pinned_fingerprints: Optional[List[bytes]] = None,
        server_name: str = "localhost",
    ) -> None:
        self.is_server = is_server
        self.alpn = alpn
        self.transport_params = transport_params
        self.cert_der = cert_der
        self.private_key = private_key
        self.pinned = pinned_fingerprints  # None = accept any (tests)
        self.server_name = server_name

        self.schedule = TlsKeySchedule()
        self._transcript = hashlib.sha256()
        self._ecdh = X25519Key.generate()
        self._buffers: Dict[int, bytearray] = {EPOCH_INITIAL: bytearray(), EPOCH_HANDSHAKE: bytearray(), EPOCH_APP: bytearray()}
        # outputs for the connection layer
        self.pending_output: List[Tuple[int, bytes]] = []
        self.new_keys: List[Tuple[int, object, object]] = []  # (epoch, recv KeySet, send KeySet)
        self.handshake_complete = False
        self.peer_transport_params: Optional[TransportParams] = None
        self.negotiated_alpn: Optional[str] = None
        self.peer_cert_der: Optional[bytes] = None
        self._client_hello_sent = False
        self._server_finished_hash: Optional[bytes] = None
        self._peer_finished_ok = False

    # -- transcript helpers --------------------------------------------------

    def _add_transcript(self, msg: bytes) -> None:
        self._transcript.update(msg)

    def _th(self) -> bytes:
        return self._transcript.digest()

    # -- client --------------------------------------------------------------

    def client_start(self) -> None:
        """Queue the ClientHello on the Initial epoch."""
        assert not self.is_server and not self._client_hello_sent
        body = bytearray()
        body += struct.pack("!H", 0x0303)
        body += os.urandom(32)
        body += b"\x00"  # empty legacy_session_id
        body += struct.pack("!HH", 2, SUITE_AES128_GCM_SHA256)
        body += b"\x01\x00"  # legacy_compression_methods
        sni = self.server_name.encode()
        exts = b"".join(
            [
                _ext(EXT_SERVER_NAME, struct.pack("!HBH", len(sni) + 3, 0, len(sni)) + sni),
                _ext(EXT_SUPPORTED_VERSIONS, bytes([2]) + struct.pack("!H", TLS13)),
                _ext(EXT_SUPPORTED_GROUPS, struct.pack("!HH", 2, GROUP_X25519)),
                _ext(
                    EXT_SIGNATURE_ALGORITHMS,
                    struct.pack("!HHH", 4, SIG_ECDSA_P256_SHA256, 0x0804),
                ),
                _ext(
                    EXT_KEY_SHARE,
                    struct.pack("!HHH", 36, GROUP_X25519, 32)
                    + self._ecdh.public_bytes(),
                ),
                _ext(
                    EXT_ALPN,
                    struct.pack("!HB", len(self.alpn) + 1, len(self.alpn)) + self.alpn.encode(),
                ),
                _ext(EXT_QUIC_TRANSPORT_PARAMS, self.transport_params.encode()),
            ]
        )
        body += struct.pack("!H", len(exts)) + exts
        msg = _msg(HT_CLIENT_HELLO, bytes(body))
        self._add_transcript(msg)
        self.pending_output.append((EPOCH_INITIAL, msg))
        self._client_hello_sent = True

    # -- message pump ----------------------------------------------------------

    def handle_crypto(self, epoch: int, data: bytes) -> None:
        """Feed CRYPTO stream bytes received at ``epoch``."""
        buf = self._buffers[epoch]
        buf.extend(data)
        while len(buf) >= 4:
            mlen = int.from_bytes(buf[1:4], "big")
            if len(buf) < 4 + mlen:
                return
            msg = bytes(buf[: 4 + mlen])
            del buf[: 4 + mlen]
            self._handle_message(epoch, msg[0], msg[4:], msg)

    def _handle_message(self, epoch: int, mtype: int, body: bytes, raw: bytes) -> None:
        if self.is_server:
            if mtype == HT_CLIENT_HELLO and epoch == EPOCH_INITIAL:
                self._server_on_client_hello(body, raw)
            elif mtype == HT_FINISHED and epoch == EPOCH_HANDSHAKE:
                self._on_peer_finished(body, raw)
            else:
                raise TlsError(f"unexpected handshake message {mtype} at epoch {epoch}")
        else:
            if mtype == HT_SERVER_HELLO and epoch == EPOCH_INITIAL:
                self._client_on_server_hello(body, raw)
            elif epoch == EPOCH_HANDSHAKE and mtype == HT_ENCRYPTED_EXTENSIONS:
                self._client_on_ee(body, raw)
            elif epoch == EPOCH_HANDSHAKE and mtype == HT_CERTIFICATE:
                self._client_on_certificate(body, raw)
            elif epoch == EPOCH_HANDSHAKE and mtype == HT_CERTIFICATE_VERIFY:
                self._client_on_cert_verify(body, raw)
            elif epoch == EPOCH_HANDSHAKE and mtype == HT_FINISHED:
                self._on_peer_finished(body, raw)
            elif mtype == HT_NEW_SESSION_TICKET:
                pass  # ignored (no resumption)
            else:
                raise TlsError(f"unexpected handshake message {mtype} at epoch {epoch}")

    # -- server handlers -------------------------------------------------------

    def _server_on_client_hello(self, body: bytes, raw: bytes) -> None:
        off = 2 + 32
        sid_len = body[off]
        off += 1 + sid_len
        (n_suites,) = struct.unpack_from("!H", body, off)
        suites = struct.unpack_from(f"!{n_suites // 2}H", body, off + 2)
        off += 2 + n_suites
        comp_len = body[off]
        off += 1 + comp_len
        (ext_len,) = struct.unpack_from("!H", body, off)
        exts = _parse_extensions(body[off + 2 : off + 2 + ext_len])

        if SUITE_AES128_GCM_SHA256 not in suites:
            raise TlsError("no common cipher suite")
        sv = exts.get(EXT_SUPPORTED_VERSIONS, b"")
        if b"\x03\x04" not in sv:
            raise TlsError("TLS 1.3 not offered")
        ks = exts.get(EXT_KEY_SHARE)
        if not ks:
            raise TlsError("no key_share")
        peer_pub = None
        kof = 2
        while kof < len(ks):
            group, klen = struct.unpack_from("!HH", ks, kof)
            if group == GROUP_X25519:
                peer_pub = ks[kof + 4 : kof + 4 + klen]
            kof += 4 + klen
        if peer_pub is None:
            raise TlsError("no x25519 key share")
        alpn_ext = exts.get(EXT_ALPN, b"")
        offered = []
        aof = 2
        while aof < len(alpn_ext):
            ln = alpn_ext[aof]
            offered.append(alpn_ext[aof + 1 : aof + 1 + ln].decode())
            aof += 1 + ln
        if self.alpn not in offered:
            raise TlsError(f"ALPN mismatch: offered {offered}")
        self.negotiated_alpn = self.alpn
        tp = exts.get(EXT_QUIC_TRANSPORT_PARAMS)
        if tp is not None:
            self.peer_transport_params = TransportParams.decode(tp)

        self._add_transcript(raw)

        shared = self._ecdh.exchange(peer_pub)
        self.schedule.set_ecdhe(shared)

        # ServerHello
        sh = bytearray()
        sh += struct.pack("!H", 0x0303)
        sh += os.urandom(32)
        sh += bytes([sid_len]) + body[2 + 32 + 1 : 2 + 32 + 1 + sid_len]  # echo session id
        sh += struct.pack("!H", SUITE_AES128_GCM_SHA256)
        sh += b"\x00"
        sh_exts = b"".join(
            [
                _ext(EXT_SUPPORTED_VERSIONS, struct.pack("!H", TLS13)),
                _ext(
                    EXT_KEY_SHARE,
                    struct.pack("!HH", GROUP_X25519, 32)
                    + self._ecdh.public_bytes(),
                ),
            ]
        )
        sh += struct.pack("!H", len(sh_exts)) + sh_exts
        sh_msg = _msg(HT_SERVER_HELLO, bytes(sh))
        self._add_transcript(sh_msg)
        self.pending_output.append((EPOCH_INITIAL, sh_msg))

        # handshake keys active from here
        self.schedule.handshake_traffic(self._th())
        self.new_keys.append(
            (
                EPOCH_HANDSHAKE,
                keys_from_secret(self.schedule.client_hs_secret),
                keys_from_secret(self.schedule.server_hs_secret),
            )
        )

        # EncryptedExtensions
        ee_exts = b"".join(
            [
                _ext(
                    EXT_ALPN,
                    struct.pack("!HB", len(self.alpn) + 1, len(self.alpn)) + self.alpn.encode(),
                ),
                _ext(EXT_QUIC_TRANSPORT_PARAMS, self.transport_params.encode()),
            ]
        )
        ee = _msg(HT_ENCRYPTED_EXTENSIONS, struct.pack("!H", len(ee_exts)) + ee_exts)
        self._add_transcript(ee)

        # Certificate
        assert self.cert_der is not None and self.private_key is not None
        entry = len(self.cert_der).to_bytes(3, "big") + self.cert_der + b"\x00\x00"
        cert_body = b"\x00" + len(entry).to_bytes(3, "big") + entry
        cert = _msg(HT_CERTIFICATE, cert_body)
        self._add_transcript(cert)

        # CertificateVerify
        to_sign = _CV_SERVER_CONTEXT + self._th()
        sig = self.private_key.sign(to_sign)
        cv = _msg(HT_CERTIFICATE_VERIFY, struct.pack("!HH", SIG_ECDSA_P256_SHA256, len(sig)) + sig)
        self._add_transcript(cv)

        # Finished
        vd = TlsKeySchedule.finished_verify_data(self.schedule.server_hs_secret, self._th())
        fin = _msg(HT_FINISHED, vd)
        self._add_transcript(fin)

        self.pending_output.append((EPOCH_HANDSHAKE, ee + cert + cv + fin))

        # application keys (valid after server Finished in transcript)
        self.schedule.application_traffic(self._th())
        self.new_keys.append(
            (
                EPOCH_APP,
                keys_from_secret(self.schedule.client_ap_secret),
                keys_from_secret(self.schedule.server_ap_secret),
            )
        )
        self._server_finished_hash = self._th()

    # -- client handlers -------------------------------------------------------

    def _client_on_server_hello(self, body: bytes, raw: bytes) -> None:
        off = 2 + 32
        sid_len = body[off]
        off += 1 + sid_len
        (suite,) = struct.unpack_from("!H", body, off)
        if suite != SUITE_AES128_GCM_SHA256:
            raise TlsError("server chose unsupported suite")
        off += 2 + 1  # suite + compression
        (ext_len,) = struct.unpack_from("!H", body, off)
        exts = _parse_extensions(body[off + 2 : off + 2 + ext_len])
        ks = exts.get(EXT_KEY_SHARE)
        if not ks:
            raise TlsError("server sent no key share")
        group, klen = struct.unpack_from("!HH", ks, 0)
        if group != GROUP_X25519:
            raise TlsError("server chose unsupported group")
        peer_pub = ks[4 : 4 + klen]
        self._add_transcript(raw)
        shared = self._ecdh.exchange(peer_pub)
        self.schedule.set_ecdhe(shared)
        self.schedule.handshake_traffic(self._th())
        self.new_keys.append(
            (
                EPOCH_HANDSHAKE,
                keys_from_secret(self.schedule.server_hs_secret),
                keys_from_secret(self.schedule.client_hs_secret),
            )
        )

    def _client_on_ee(self, body: bytes, raw: bytes) -> None:
        (ext_len,) = struct.unpack_from("!H", body, 0)
        exts = _parse_extensions(body[2 : 2 + ext_len])
        alpn = exts.get(EXT_ALPN)
        if alpn is not None:
            ln = alpn[2]
            self.negotiated_alpn = alpn[3 : 3 + ln].decode()
        tp = exts.get(EXT_QUIC_TRANSPORT_PARAMS)
        if tp is not None:
            self.peer_transport_params = TransportParams.decode(tp)
        self._add_transcript(raw)

    def _client_on_certificate(self, body: bytes, raw: bytes) -> None:
        ctx_len = body[0]
        off = 1 + ctx_len
        off += 3  # list length
        cert_len = int.from_bytes(body[off : off + 3], "big")
        self.peer_cert_der = body[off + 3 : off + 3 + cert_len]
        if self.pinned is not None:
            fp = hashlib.sha256(self.peer_cert_der).digest()
            if fp not in self.pinned:
                raise TlsError("server certificate fingerprint not pinned")
        self._add_transcript(raw)

    def _client_on_cert_verify(self, body: bytes, raw: bytes) -> None:
        alg, sig_len = struct.unpack_from("!HH", body, 0)
        if alg != SIG_ECDSA_P256_SHA256:
            raise TlsError(f"unsupported CertificateVerify algorithm {alg:#x}")
        sig = body[4 : 4 + sig_len]
        try:
            public = cert_public_key(self.peer_cert_der)
        except RuntimeError as e:
            raise TlsError(f"server certificate unreadable: {e}")
        to_verify = _CV_SERVER_CONTEXT + self._th()
        if not public.verify(sig, to_verify):
            raise TlsError("CertificateVerify signature invalid")
        self._add_transcript(raw)

    # -- finished (both roles) ---------------------------------------------------

    def _on_peer_finished(self, body: bytes, raw: bytes) -> None:
        if self.is_server:
            expect = TlsKeySchedule.finished_verify_data(
                self.schedule.client_hs_secret, self._th()
            )
            if body != expect:
                raise TlsError("client Finished verify_data mismatch")
            self._add_transcript(raw)
            self.handshake_complete = True
        else:
            expect = TlsKeySchedule.finished_verify_data(
                self.schedule.server_hs_secret, self._th()
            )
            if body != expect:
                raise TlsError("server Finished verify_data mismatch")
            self._add_transcript(raw)
            # application keys derive from transcript through server Finished
            self.schedule.application_traffic(self._th())
            self.new_keys.append(
                (
                    EPOCH_APP,
                    keys_from_secret(self.schedule.server_ap_secret),
                    keys_from_secret(self.schedule.client_ap_secret),
                )
            )
            # client Finished (transcript hash includes server Finished)
            vd = TlsKeySchedule.finished_verify_data(self.schedule.client_hs_secret, self._th())
            fin = _msg(HT_FINISHED, vd)
            self._add_transcript(fin)
            self.pending_output.append((EPOCH_HANDSHAKE, fin))
            self.handshake_complete = True
