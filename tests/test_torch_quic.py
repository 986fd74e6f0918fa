# SPDX-License-Identifier: Apache-2.0
"""The port's QUIC v1 + TLS 1.3 stack (``streamkit_tpu_torch/quic``) against
the JAX package's (``streamkit_tpu/quic``).

* the counterpart of every case of ``tests/test_quic.py``: RFC 9001 A.1
  secrets, varints, loopback handshake with stream echo and datagram, a
  512 KiB transfer, loss recovery, pinning, the ACK-range bound, pn pruning,
  malformed frames, RTT, packet-threshold loss and PTO;
* the handshake across packages in one event loop: the JAX client against
  the port's server and the port's client against the JAX server;
* the libcrypto binding (``quic/_libcrypto.py``) byte for byte against the
  ``cryptography`` package on seeded inputs: AES-GCM seal / open, a flipped
  bit refused, the header-protection mask, X25519 (RFC 7748 §6.1), ECDSA in
  both directions, the port's certificate parsed by ``cryptography``.
"""

import asyncio
import ctypes.util
import hashlib
import random

import numpy as np
import pytest
from cryptography import x509
from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey, X25519PublicKey
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
from cryptography.hazmat.primitives.ciphers.aead import AESGCM
import torch

import streamkit_tpu.quic.connection as jax_connection
import streamkit_tpu.quic.crypto as jax_crypto
import streamkit_tpu.quic.endpoint as jax_endpoint
import streamkit_tpu.quic.packet as jax_packet
import streamkit_tpu.quic.tls as jax_tls
from streamkit_tpu_torch.quic import _libcrypto as lc
from streamkit_tpu_torch.quic.connection import (
    _RECV_PN_WINDOW,
    DatagramEvent,
    QuicConnection,
    StreamEvent,
    _PnSpace,
)
from streamkit_tpu_torch.quic.crypto import (
    INITIAL_SALT_V1,
    KeySet,
    hkdf_expand_label,
    hkdf_extract,
    initial_secrets,
    keys_from_secret,
)
from streamkit_tpu_torch.quic.endpoint import connect, serve
from streamkit_tpu_torch.quic.packet import (
    PacketType,
    PlainPacket,
    decode_varint,
    encode_varint,
    peek_header,
    protect_packet,
    unprotect_packet,
)
from streamkit_tpu_torch.quic.tls import TlsSession, TransportParams, generate_self_signed

import streamkit_tpu_torch.quic.connection as torch_connection
import streamkit_tpu_torch.quic.endpoint as torch_endpoint
import streamkit_tpu_torch.quic.tls as torch_tls

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

STACKS = {
    "jax": (jax_endpoint, jax_tls, jax_connection),
    "torch": (torch_endpoint, torch_tls, torch_connection),
}


def test_varint_roundtrip():
    for v in [0, 1, 63, 64, 16383, 16384, 2**30 - 1, 2**30, 2**62 - 1]:
        enc = encode_varint(v)
        assert enc == jax_packet.encode_varint(v)
        dec, off = decode_varint(enc)
        assert dec == v and off == len(enc)


def test_initial_secrets_rfc9001_vectors():
    """RFC 9001 Appendix A.1: keys for DCID 0x8394c8f03e515708."""
    client, server = initial_secrets(bytes.fromhex("8394c8f03e515708"))
    assert client.key == bytes.fromhex("1f369613dd76d5467730efcbe3b1a22d")
    assert client.iv == bytes.fromhex("fa044b2f42a3fd3b46fb255c")
    assert client.hp == bytes.fromhex("9f50449e04a0e810283a1e9933adedd2")
    assert server.key == bytes.fromhex("cf3a5331653c364c88f0f379b6067e37")
    assert server.iv == bytes.fromhex("0ac1493ca1905853b0bba03e")
    assert server.hp == bytes.fromhex("c206b8d9b9f0f37644430b490eeaa314")


def test_hkdf_expand_label_vector():
    # RFC 9001 A.1 client_initial_secret from initial_secret
    initial = hkdf_extract(INITIAL_SALT_V1, bytes.fromhex("8394c8f03e515708"))
    client = hkdf_expand_label(initial, "client in", b"", 32)
    assert client == bytes.fromhex(
        "c00cf151ca5be075ed0ebfb5c80323c42d6b7db67881289af4008f1f6c357aea"
    )


def test_header_protection_rfc9001_a2_sample():
    """RFC 9001 A.2: the client Initial's sample gives mask 437b9aec36."""
    client, _ = initial_secrets(bytes.fromhex("8394c8f03e515708"))
    assert client.hp_mask(bytes.fromhex("d1b1c98dd7689fb8ec11d242b123dc9b"))[:5] == bytes.fromhex("437b9aec36")


# ---------------------------------------------------------------------------
# loopback over UDP
async def _echo_server(stack, cert=None, key=None, drop=0.0, seed=1):
    """An echo server of ``stack`` → (server, port, fingerprint)."""
    endpoint, tls, conn_mod = STACKS[stack]
    if cert is None:
        cert, key = tls.generate_self_signed()

    async def on_conn(proto):
        await proto.handshake_done
        while True:
            ev = await proto.events.get()
            if isinstance(ev, conn_mod.StreamEvent):
                if ev.data or ev.fin:
                    proto.conn.send_stream_data(ev.stream_id, ev.data, fin=ev.fin)
                    proto.transmit()
            elif isinstance(ev, conn_mod.DatagramEvent):
                proto.conn.send_datagram(b"dg:" + ev.data)
                proto.transmit()

    server, transport = await endpoint.serve("127.0.0.1", 0, cert, key, on_conn)
    port = transport.get_extra_info("sockname")[1]
    if drop > 0:
        rng = random.Random(seed)
        real_sendto = transport.sendto

        def lossy_sendto(data, addr=None):
            if rng.random() >= drop:
                real_sendto(data, addr)

        transport.sendto = lossy_sendto
    return server, port, hashlib.sha256(cert).digest()


@pytest.mark.parametrize("client_pkg,server_pkg", [("torch", "torch"), ("jax", "torch"), ("torch", "jax")])
def test_handshake_and_stream_echo(client_pkg, server_pkg):
    """A handshake, a stream echo and a datagram; across packages the two
    stacks meet in one event loop."""
    endpoint, _, conn_mod = STACKS[client_pkg]

    async def main():
        server, port, fp = await _echo_server(server_pkg)
        client, proto = await endpoint.connect("127.0.0.1", port, [fp])
        assert proto.handshake_done.result() == "h3"

        sid = proto.conn.open_bidi_stream()
        proto.conn.send_stream_data(sid, b"hello quic", fin=True)
        proto.conn.send_datagram(b"ping")
        proto.transmit()
        echoed = bytearray()
        dg = None
        fin = False
        while not (fin and dg):
            ev = await asyncio.wait_for(proto.events.get(), timeout=5)
            if isinstance(ev, conn_mod.StreamEvent) and ev.stream_id == sid:
                echoed += ev.data
                fin = fin or ev.fin
            elif isinstance(ev, conn_mod.DatagramEvent):
                dg = ev.data
        client.close()
        server.close()
        return bytes(echoed), dg

    echoed, dg = asyncio.run(main())
    assert echoed == b"hello quic"
    assert dg == b"dg:ping"


def _transfer(size, seed, drop=0.0, timeout=60):
    async def main():
        server, port, fp = await _echo_server("torch", drop=drop, seed=3)
        client, proto = await connect("127.0.0.1", port, [fp], timeout=20)
        blob = bytes(random.Random(seed).randbytes(size))
        sid = proto.conn.open_bidi_stream()
        proto.conn.send_stream_data(sid, blob, fin=True)
        proto.transmit()
        out = bytearray()
        while True:
            ev = await asyncio.wait_for(proto.events.get(), timeout=timeout)
            if isinstance(ev, StreamEvent) and ev.stream_id == sid:
                out += ev.data
                if ev.fin:
                    break
        client.close()
        server.close()
        return blob, bytes(out)

    return asyncio.run(main())


def test_large_transfer_integrity():
    """512 KiB over one bidi stream, echoed back intact (fragmentation, flow
    control windows, ACK ranges)."""
    blob, out = _transfer(512 * 1024, 7)
    assert out == blob


def test_loss_recovery():
    """10 % datagram loss on the server→client path: PTO retransmits must
    still deliver the stream intact."""
    blob, out = _transfer(64 * 1024, 11, drop=0.10, timeout=30)
    assert out == blob


def test_fingerprint_pinning_rejects_unknown_cert():
    async def main():
        server, port, _ = await _echo_server("torch")
        try:
            with pytest.raises((ConnectionError, asyncio.TimeoutError)):
                await connect("127.0.0.1", port, [b"\x00" * 32], timeout=3)
        finally:
            server.close()

    asyncio.run(main())


# ---------------------------------------------------------------------------
# connection internals
def _client_conn():
    tls = TlsSession(False, TransportParams(initial_scid=b"\x01" * 8), alpn="h3")
    return QuicConnection(False, tls, b"\x02" * 8, scid=b"\x01" * 8)


def test_malicious_ack_ranges_bounded():
    """An ACK claiming largest=2^60 with a huge first range is clamped to the
    packets actually sent (no range materialised)."""
    conn = _client_conn()
    space = _PnSpace()
    space.next_pn = 5  # we sent packets 0..4
    payload = (
        encode_varint(2**60)   # largest acked (lying)
        + encode_varint(0)     # delay
        + encode_varint(0)     # range count
        + encode_varint(2**60 - 1)  # first range (huge)
    )
    off = conn._handle_ack(space, payload, 0, ecn=False)
    assert off == len(payload)  # parsed fully, no MemoryError


def test_received_pn_set_pruned():
    """The per-space dedup set stays bounded on long-lived connections."""
    assert _RECV_PN_WINDOW == jax_connection._RECV_PN_WINDOW
    space = _PnSpace()
    for pn in range(10 * _RECV_PN_WINDOW):
        if pn in space.received:
            continue
        if pn < space.largest_received - _RECV_PN_WINDOW:
            continue
        space.received.add(pn)
        space.largest_received = max(space.largest_received, pn)
        if len(space.received) > 2 * _RECV_PN_WINDOW:
            floor = space.largest_received - _RECV_PN_WINDOW
            space.received = {p for p in space.received if p >= floor}
    assert len(space.received) <= 2 * _RECV_PN_WINDOW


def test_malformed_frame_closes_connection_not_raises():
    """A frame that explodes while parsing closes the connection (queues a
    CONNECTION_CLOSE); nothing propagates into the UDP receive callback."""
    conn = _client_conn()

    def boom(epoch, payload):
        raise IndexError("truncated varint")

    conn._handle_frames = boom
    # loop the client's own Initial back through its own keys so decryption
    # succeeds and the patched handler runs
    conn.recv_keys = dict(conn.send_keys)
    datagrams = conn.datagrams_to_send()
    assert datagrams
    conn.receive_datagram(datagrams[0])  # must not raise
    assert conn.close_sent is not None or conn.closed


def _mem_pair(now):
    """Two connections wired in memory with an injectable clock."""
    import os

    cert, key = generate_self_signed()
    fp = hashlib.sha256(cert).digest()
    odcid, scid_c, scid_s = os.urandom(8), os.urandom(8), os.urandom(8)
    ctls = TlsSession(False, TransportParams(initial_scid=scid_c), alpn="h3",
                      pinned_fingerprints=[fp], server_name="localhost")
    client = QuicConnection(False, ctls, odcid, scid=scid_c, now=now)
    stls = TlsSession(True, TransportParams(initial_scid=scid_s, original_dcid=odcid), alpn="h3",
                      cert_der=cert, private_key=key)
    server = QuicConnection(True, stls, odcid, scid=scid_s, now=now)
    return client, server


def _pump(a, b, rounds=12):
    for _ in range(rounds):
        moved = False
        for d in a.datagrams_to_send():
            b.receive_datagram(d)
            moved = True
        for d in b.datagrams_to_send():
            a.receive_datagram(d)
            moved = True
        if not moved:
            break


def test_rtt_estimation_from_acks():
    clock = [0.0]
    client, server = _mem_pair(lambda: clock[0])
    _pump(client, server)
    assert client.handshake_complete and server.handshake_complete
    sid = client.open_uni_stream()
    for _ in range(12):
        client.send_stream_data(sid, b"x" * 100)
        outs = client.datagrams_to_send()
        clock[0] += 0.030
        for d in outs:
            server.receive_datagram(d)
        for d in server.datagrams_to_send():
            client.receive_datagram(d)
    assert client.srtt is not None and 0.015 <= client.srtt <= 0.05
    assert client._pto_interval() < 0.25


def test_packet_threshold_loss_requeues_without_timer():
    """One dropped data packet is declared lost by 3+ later acked packets and
    retransmitted on the ACKs alone (no PTO timer call)."""
    clock = [0.0]
    client, server = _mem_pair(lambda: clock[0])
    _pump(client, server)
    sid = client.open_uni_stream()
    got = bytearray()

    def drain_server():
        for ev in server.events:
            if hasattr(ev, "stream_id") and ev.stream_id == sid:
                got.extend(ev.data)
        server.events.clear()

    client.send_stream_data(sid, b"A" * 800)
    assert len(client.datagrams_to_send()) == 1  # dropped
    for i in range(4):
        client.send_stream_data(sid, bytes([66 + i]) * 800)
        for d in client.datagrams_to_send():
            server.receive_datagram(d)
        drain_server()
        for d in server.datagrams_to_send():
            client.receive_datagram(d)
    for d in client.datagrams_to_send():
        server.receive_datagram(d)
    drain_server()
    assert b"A" * 800 in bytes(got), "lost chunk not retransmitted via packet-threshold"


def test_pto_fires_as_probe_without_cwnd_collapse():
    """Repeated PTO expiries inside one recovery period reduce cwnd at most once."""
    clock = [0.0]
    client, server = _mem_pair(lambda: clock[0])
    _pump(client, server)
    cwnd0 = client.cwnd
    sid = client.open_uni_stream()
    for _ in range(4):
        client.send_stream_data(sid, b"z" * 500)
        client.datagrams_to_send()  # sent but never delivered
    clock[0] += 10.0
    client.handle_timer()
    assert client.cwnd >= max(16 * 1024, cwnd0 // 2)
    cwnd_after_first = client.cwnd
    client.send_stream_data(sid, b"z" * 500)
    client.datagrams_to_send()
    clock[0] += 0.0001
    client.handle_timer()
    assert client.cwnd == cwnd_after_first


# ---------------------------------------------------------------------------
# the libcrypto binding against the cryptography package
@pytest.mark.parametrize("length", [0, 1, 15, 16, 17, 1200, 1350])
def test_aes_gcm_matches_cryptography(length):
    rng = np.random.default_rng(length)
    key, nonce = rng.bytes(16), rng.bytes(12)
    aad, payload = rng.bytes(int(rng.integers(0, 40))), rng.bytes(length)
    gcm = lc.AesGcm(key)
    sealed = gcm.seal(nonce, payload, aad)
    assert sealed == AESGCM(key).encrypt(nonce, payload, aad)
    assert len(sealed) == length + lc.GCM_TAG_LEN
    assert gcm.open(nonce, sealed, aad) == payload
    # a context serves call after call: the key schedule stays, the nonce changes
    nonce2 = rng.bytes(12)
    assert gcm.seal(nonce2, payload, aad) == AESGCM(key).encrypt(nonce2, payload, aad)


@pytest.mark.parametrize("where", ["ciphertext", "tag", "aad", "nonce"])
def test_aes_gcm_refuses_a_flipped_bit(where):
    rng = np.random.default_rng(42)
    key, nonce, aad, payload = rng.bytes(16), rng.bytes(12), rng.bytes(20), rng.bytes(64)
    gcm = lc.AesGcm(key)
    sealed = bytearray(gcm.seal(nonce, payload, aad))
    aad_b, nonce_b = bytearray(aad), bytearray(nonce)
    if where == "ciphertext":
        sealed[5] ^= 0x10
    elif where == "tag":
        sealed[-1] ^= 0x01
    elif where == "aad":
        aad_b[0] ^= 0x80
    else:
        nonce_b[11] ^= 0x01
    with pytest.raises(lc.AuthenticationError):
        gcm.open(bytes(nonce_b), bytes(sealed), bytes(aad_b))
    assert gcm.open(nonce, gcm.seal(nonce, payload, aad), aad) == payload  # context still usable
    with pytest.raises(lc.AuthenticationError):
        gcm.open(nonce, b"short", aad)


def test_header_protection_mask_matches_cryptography():
    rng = np.random.default_rng(7)
    for _ in range(8):
        hp, sample = rng.bytes(16), rng.bytes(16)
        want = Cipher(algorithms.AES(hp), modes.ECB()).encryptor().update(sample)
        ecb = lc.AesEcb(hp)
        assert ecb.encrypt_block(sample) == want
        with pytest.raises(ValueError):
            ecb.encrypt_block(sample + b"tail")


def test_keyset_and_packet_protection_match_the_jax_package():
    """Same secrets → the same KeySet bytes, sealed payloads, masks and whole
    protected packets; each package opens the other's packets."""
    rng = np.random.default_rng(3)
    secret = rng.bytes(32)
    pk = keys_from_secret(secret)
    jk = jax_crypto.keys_from_secret(secret)
    assert (pk.key, pk.iv, pk.hp) == (jk.key, jk.iv, jk.hp)
    for pn in (0, 1, 255, 2**20 + 3):
        header, payload = rng.bytes(24), rng.bytes(int(rng.integers(20, 1200)))
        assert pk.seal(pn, header, payload) == jk.seal(pn, header, payload)
        sample = rng.bytes(16)
        assert pk.hp_mask(sample) == jk.hp_mask(sample)
    for ptype, scid in ((PacketType.INITIAL, rng.bytes(8)), (PacketType.HANDSHAKE, rng.bytes(8)),
                        (PacketType.ONE_RTT, b"")):
        dcid = rng.bytes(8)
        payload = rng.bytes(300)
        pkt = PlainPacket(ptype, dcid, scid, 17, payload)
        jpkt = jax_packet.PlainPacket(ptype, dcid, scid, 17, payload)
        wire = protect_packet(pk, pkt)
        assert wire == jax_packet.protect_packet(jk, jpkt)
        hdr = peek_header(wire, 0, 8)
        back = unprotect_packet(pk, wire, 0, hdr, 16)
        assert back is not None and back.payload == payload and back.packet_number == 17
        forged = bytearray(wire)
        forged[-3] ^= 0x04
        assert unprotect_packet(pk, bytes(forged), 0, hdr, 16) is None


def test_x25519_rfc7748_vector_and_cryptography():
    """RFC 7748 §6.1: Alice's and Bob's keys and their shared secret; then a
    seeded exchange with ``cryptography``'s X25519 in both directions."""
    alice = lc.X25519Key(bytes.fromhex("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a"))
    bob = lc.X25519Key(bytes.fromhex("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb"))
    assert alice.public_bytes() == bytes.fromhex("8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
    assert bob.public_bytes() == bytes.fromhex("de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f")
    shared = bytes.fromhex("4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742")
    assert alice.exchange(bob.public_bytes()) == shared == bob.exchange(alice.public_bytes())
    rng = np.random.default_rng(25519)
    for _ in range(4):
        a_raw, b_raw = rng.bytes(32), rng.bytes(32)
        ours = lc.X25519Key(a_raw)
        theirs = X25519PrivateKey.from_private_bytes(b_raw)
        assert ours.public_bytes() == X25519PrivateKey.from_private_bytes(a_raw).public_key().public_bytes_raw()
        peer = theirs.public_key().public_bytes_raw()
        assert ours.exchange(peer) == theirs.exchange(X25519PublicKey.from_public_bytes(ours.public_bytes()))


def test_ecdsa_port_signs_cryptography_verifies_and_back():
    rng = np.random.default_rng(256)
    ours = lc.EcdsaP256Key.generate()
    theirs = ec.generate_private_key(ec.SECP256R1())
    their_spki = theirs.public_key().public_bytes(
        serialization.Encoding.DER, serialization.PublicFormat.SubjectPublicKeyInfo)
    for _ in range(4):
        data = rng.bytes(int(rng.integers(1, 200)))
        sig = ours.sign(data)
        serialization.load_der_public_key(ours.public_der()).verify(sig, data, ec.ECDSA(hashes.SHA256()))
        with pytest.raises(InvalidSignature):
            serialization.load_der_public_key(ours.public_der()).verify(sig, data + b"x",
                                                                        ec.ECDSA(hashes.SHA256()))
        their_sig = theirs.sign(data, ec.ECDSA(hashes.SHA256()))
        public = lc.EcPublicKey.from_der(their_spki)
        assert public.der() == their_spki
        assert public.verify(their_sig, data)
        assert not public.verify(their_sig, data + b"x")
        assert not public.verify(b"\x30\x02\x02\x00", data)  # malformed DER refused, not raised


def test_certificate_parsed_by_cryptography():
    """The port's self-signed certificate: ``cryptography`` reads it to the
    same public key, its signature holds, and its fields are the ones the
    JAX package's builder writes."""
    der, key = generate_self_signed("streamkit-tpu-moq")
    cert = x509.load_der_x509_certificate(der)
    spki = cert.public_key().public_bytes(serialization.Encoding.DER,
                                          serialization.PublicFormat.SubjectPublicKeyInfo)
    assert spki == key.public_der()
    cert.public_key().verify(cert.signature, cert.tbs_certificate_bytes, ec.ECDSA(hashes.SHA256()))
    jder, _ = jax_tls.generate_self_signed("streamkit-tpu-moq")
    jcert = x509.load_der_x509_certificate(jder)
    assert cert.subject == cert.issuer == jcert.subject
    assert cert.version == jcert.version and cert.signature_algorithm_oid == jcert.signature_algorithm_oid
    assert [(e.oid, e.critical, e.value) for e in cert.extensions] == [
        (e.oid, e.critical, e.value) for e in jcert.extensions]
    life = cert.not_valid_after_utc - cert.not_valid_before_utc
    assert life == jcert.not_valid_after_utc - jcert.not_valid_before_utc
    assert life.days <= 14 and cert.serial_number > 0
    assert lc.cert_public_key(der).der() == spki
    assert lc.cert_public_key(jder).der() == jcert.public_key().public_bytes(
        serialization.Encoding.DER, serialization.PublicFormat.SubjectPublicKeyInfo)
    with pytest.raises(RuntimeError, match="d2i_X509"):
        lc.cert_public_key(der[:40])


def test_libcrypto_names_its_library():
    assert lc.available()
    assert "libcrypto" in lc.library_path()
    assert lc.version().startswith("OpenSSL")


def test_missing_libcrypto_raises_one_clear_error(monkeypatch):
    """Where no libcrypto loads, every entry point raises
    ``LibcryptoUnavailable`` and nothing falls back."""
    monkeypatch.setattr(lc, "_lib", None)
    monkeypatch.setattr(lc, "_error", None)
    monkeypatch.setattr(lc, "_mapped_libcrypto", lambda: None)
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    assert not lc.available()
    with pytest.raises(lc.LibcryptoUnavailable, match="libcrypto"):
        initial_secrets(b"\x00" * 8)
    with pytest.raises(lc.LibcryptoUnavailable):
        generate_self_signed()
    with pytest.raises(lc.LibcryptoUnavailable):
        KeySet(b"\x00" * 16, b"\x00" * 12, b"\x00" * 16)
