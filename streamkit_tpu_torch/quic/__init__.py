# SPDX-License-Identifier: Apache-2.0
"""Minimal QUIC v1 + TLS 1.3 + HTTP/3 WebTransport stack.

The reference serves MoQ over WebTransport via quinn/wtransport
(``apps/skit/src/server.rs:1975-2085``). This environment has no QUIC
library, so we implement the slice of RFC 9000/9001/8446/9114 needed to
serve (and client-connect) WebTransport sessions:

* QUIC v1 transport: Initial/Handshake/1-RTT packet protection, CRYPTO and
  STREAM frames, ACK + simple loss recovery, flow control, datagrams.
* TLS 1.3: x25519 + TLS_AES_128_GCM_SHA256, ECDSA P-256 self-signed server
  certificates, client fingerprint pinning (the WebTransport
  ``serverCertificateHashes`` trust model, so no X.509 chain validation).
* HTTP/3: SETTINGS + QPACK static-table encoding, extended CONNECT
  (:protocol = webtransport), WebTransport uni/bidi streams + datagrams.

Pure asyncio. The JAX package takes its AES-GCM, X25519, ECDSA and X.509
from the ``cryptography`` package; the port binds OpenSSL's libcrypto, which
every Python with ``ssl`` maps already (:mod:`._libcrypto`), and writes its
certificate's DER itself.
"""

__all__ = []

