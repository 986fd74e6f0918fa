# SPDX-License-Identifier: Apache-2.0
"""QUIC v1 packet protection (RFC 9001) + TLS 1.3 key schedule (RFC 8446 §7).

Covers: HKDF-Expand-Label, initial secrets, per-epoch AEAD keys, header
protection masks, and the TLS 1.3 secret ladder for the handshake engine in
:mod:`.tls`.

Port of ``streamkit_tpu/quic/crypto.py``: HKDF runs on ``hashlib``/``hmac``
as there; AES-GCM and the AES-ECB header-protection block come from OpenSSL's
libcrypto (:mod:`._libcrypto`) in place of the ``cryptography`` package.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import struct
from dataclasses import dataclass
from typing import Optional

from ._libcrypto import AesEcb, AesGcm

__all__ = [
    "hkdf_extract",
    "hkdf_expand_label",
    "derive_secret",
    "initial_secrets",
    "KeySet",
    "keys_from_secret",
    "TlsKeySchedule",
]

# RFC 9001 §5.2: salt for QUIC v1 initial secrets
INITIAL_SALT_V1 = bytes.fromhex("38762cf7f55934b34d179ae6a4c80cadccbb7f0a")
HASH = hashlib.sha256
HASH_LEN = 32


def hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return hmac_mod.new(salt, ikm, HASH).digest()


def _hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = hmac_mod.new(prk, t + info + bytes([i]), HASH).digest()
        out += t
        i += 1
    return out[:length]


def hkdf_expand_label(secret: bytes, label: str, context: bytes, length: int) -> bytes:
    """RFC 8446 §7.1 HKDF-Expand-Label."""
    full = b"tls13 " + label.encode()
    info = struct.pack("!H", length) + bytes([len(full)]) + full + bytes([len(context)]) + context
    return _hkdf_expand(secret, info, length)


def derive_secret(secret: bytes, label: str, transcript_hash: bytes) -> bytes:
    return hkdf_expand_label(secret, label, transcript_hash, HASH_LEN)


@dataclass
class KeySet:
    """AEAD key + iv + header-protection key for one direction of one epoch."""

    key: bytes
    iv: bytes
    hp: bytes

    def __post_init__(self) -> None:
        # one AEAD context per direction and ONE ECB context per key set:
        # ECB is stateless block-by-block, so one context serves every
        # header-protection mask (building a context per packet cost about
        # 15 % of relay CPU under MoQ load in the JAX package)
        self._aead = AesGcm(self.key)
        self._hp_enc = AesEcb(self.hp)

    def _nonce(self, packet_number: int) -> bytes:
        pn = packet_number.to_bytes(12, "big")
        return bytes(a ^ b for a, b in zip(self.iv, pn))

    def seal(self, packet_number: int, header: bytes, payload: bytes) -> bytes:
        """ciphertext‖tag with the header as AAD."""
        return self._aead.seal(self._nonce(packet_number), payload, header)

    def open(self, packet_number: int, header: bytes, ciphertext: bytes) -> bytes:
        """Raises :class:`._libcrypto.AuthenticationError` on a bad tag."""
        return self._aead.open(self._nonce(packet_number), ciphertext, header)

    def hp_mask(self, sample: bytes) -> bytes:
        """RFC 9001 §5.4.3 AES-based header protection."""
        return self._hp_enc.encrypt_block(sample[:16])


def keys_from_secret(secret: bytes) -> KeySet:
    """RFC 9001 §5.1: derive packet-protection keys from a traffic secret."""
    return KeySet(
        key=hkdf_expand_label(secret, "quic key", b"", 16),
        iv=hkdf_expand_label(secret, "quic iv", b"", 12),
        hp=hkdf_expand_label(secret, "quic hp", b"", 16),
    )


def initial_secrets(dcid: bytes) -> tuple:
    """RFC 9001 §5.2: (client KeySet, server KeySet) for the Initial epoch."""
    initial = hkdf_extract(INITIAL_SALT_V1, dcid)
    client = hkdf_expand_label(initial, "client in", b"", HASH_LEN)
    server = hkdf_expand_label(initial, "server in", b"", HASH_LEN)
    return keys_from_secret(client), keys_from_secret(server)


class TlsKeySchedule:
    """RFC 8446 §7.1 secret ladder (x25519 ECDHE, SHA-256 suite)."""

    def __init__(self) -> None:
        zeros = bytes(HASH_LEN)
        self.early_secret = hkdf_extract(b"\x00", zeros)
        self.handshake_secret: Optional[bytes] = None
        self.master_secret: Optional[bytes] = None
        self.client_hs_secret: Optional[bytes] = None
        self.server_hs_secret: Optional[bytes] = None
        self.client_ap_secret: Optional[bytes] = None
        self.server_ap_secret: Optional[bytes] = None

    @staticmethod
    def empty_hash() -> bytes:
        return HASH(b"").digest()

    def set_ecdhe(self, shared_secret: bytes) -> None:
        derived = derive_secret(self.early_secret, "derived", self.empty_hash())
        self.handshake_secret = hkdf_extract(derived, shared_secret)
        derived2 = derive_secret(self.handshake_secret, "derived", self.empty_hash())
        self.master_secret = hkdf_extract(derived2, bytes(HASH_LEN))

    def handshake_traffic(self, transcript_hash: bytes) -> None:
        assert self.handshake_secret is not None
        self.client_hs_secret = derive_secret(self.handshake_secret, "c hs traffic", transcript_hash)
        self.server_hs_secret = derive_secret(self.handshake_secret, "s hs traffic", transcript_hash)

    def application_traffic(self, transcript_hash: bytes) -> None:
        assert self.master_secret is not None
        self.client_ap_secret = derive_secret(self.master_secret, "c ap traffic", transcript_hash)
        self.server_ap_secret = derive_secret(self.master_secret, "s ap traffic", transcript_hash)

    @staticmethod
    def finished_verify_data(traffic_secret: bytes, transcript_hash: bytes) -> bytes:
        finished_key = hkdf_expand_label(traffic_secret, "finished", b"", HASH_LEN)
        return hmac_mod.new(finished_key, transcript_hash, HASH).digest()
