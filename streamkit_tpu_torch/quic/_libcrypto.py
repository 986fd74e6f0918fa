# SPDX-License-Identifier: Apache-2.0
"""OpenSSL ``libcrypto`` by ctypes: the primitives the QUIC/TLS stack needs.

The JAX package takes these from the ``cryptography`` package, which the
port does not require of the machine it runs on. Every Python with an
``ssl`` module maps OpenSSL's ``libcrypto`` already, so the port binds that
one library:

* AES-128-GCM packet protection (:class:`AesGcm`) and the AES-ECB block for
  header-protection masks (:class:`AesEcb`);
* X25519 key exchange (:class:`X25519Key`);
* ECDSA P-256 / SHA-256 keys, signatures and SubjectPublicKeyInfo DER
  (:class:`EcdsaP256Key`, :class:`EcPublicKey`);
* the public key of a DER X.509 certificate (:func:`cert_public_key`).

Only symbols present in both OpenSSL 1.1.1 and 3.x are used; helpers that
are macros in 1.1.1 go through ``EVP_PKEY_CTX_ctrl``. The library loads at
first use; where it cannot, :func:`lib` raises :class:`LibcryptoUnavailable`
and nothing falls back. Every OpenSSL object is freed by its owner.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
from typing import Optional

__all__ = [
    "LibcryptoUnavailable",
    "AuthenticationError",
    "lib",
    "available",
    "library_path",
    "version",
    "AesGcm",
    "AesEcb",
    "X25519Key",
    "EcdsaP256Key",
    "EcPublicKey",
    "cert_public_key",
]

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_size_t = ctypes.c_size_t
_c_char_p = ctypes.c_char_p

# evp.h / obj_mac.h constants (identical in 1.1.1 and 3.x)
_EVP_CTRL_GCM_SET_IVLEN = 0x9
_EVP_CTRL_GCM_GET_TAG = 0x10
_EVP_CTRL_GCM_SET_TAG = 0x11
_EVP_PKEY_X25519 = 1034
_EVP_PKEY_EC = 408
_NID_X9_62_PRIME256V1 = 415
_EVP_PKEY_OP_PARAMGEN = 1 << 1
_EVP_PKEY_OP_KEYGEN = 1 << 2
_EVP_PKEY_CTRL_EC_PARAMGEN_CURVE_NID = 0x1000 + 1
GCM_TAG_LEN = 16


class LibcryptoUnavailable(RuntimeError):
    """OpenSSL's libcrypto could not be loaded in this process."""


class AuthenticationError(ValueError):
    """An AEAD open failed its tag check (the plaintext is never returned)."""


# name -> (restype, argtypes)
_SIGNATURES = {
    "OpenSSL_version": (_c_char_p, [_c_int]),
    "ERR_clear_error": (None, []),
    "ERR_get_error": (ctypes.c_ulong, []),
    "ERR_error_string_n": (None, [ctypes.c_ulong, _c_char_p, _c_size_t]),
    "EVP_CIPHER_CTX_new": (_c_void_p, []),
    "EVP_CIPHER_CTX_free": (None, [_c_void_p]),
    "EVP_CIPHER_CTX_ctrl": (_c_int, [_c_void_p, _c_int, _c_int, _c_void_p]),
    "EVP_CIPHER_CTX_set_padding": (_c_int, [_c_void_p, _c_int]),
    "EVP_aes_128_gcm": (_c_void_p, []),
    "EVP_aes_128_ecb": (_c_void_p, []),
    "EVP_EncryptInit_ex": (_c_int, [_c_void_p, _c_void_p, _c_void_p, _c_char_p, _c_char_p]),
    "EVP_EncryptUpdate": (_c_int, [_c_void_p, _c_void_p, ctypes.POINTER(_c_int), _c_char_p, _c_int]),
    "EVP_EncryptFinal_ex": (_c_int, [_c_void_p, _c_void_p, ctypes.POINTER(_c_int)]),
    "EVP_DecryptInit_ex": (_c_int, [_c_void_p, _c_void_p, _c_void_p, _c_char_p, _c_char_p]),
    "EVP_DecryptUpdate": (_c_int, [_c_void_p, _c_void_p, ctypes.POINTER(_c_int), _c_char_p, _c_int]),
    "EVP_DecryptFinal_ex": (_c_int, [_c_void_p, _c_void_p, ctypes.POINTER(_c_int)]),
    "EVP_PKEY_free": (None, [_c_void_p]),
    "EVP_PKEY_new_raw_private_key": (_c_void_p, [_c_int, _c_void_p, _c_char_p, _c_size_t]),
    "EVP_PKEY_new_raw_public_key": (_c_void_p, [_c_int, _c_void_p, _c_char_p, _c_size_t]),
    "EVP_PKEY_get_raw_public_key": (_c_int, [_c_void_p, _c_void_p, ctypes.POINTER(_c_size_t)]),
    "EVP_PKEY_CTX_new": (_c_void_p, [_c_void_p, _c_void_p]),
    "EVP_PKEY_CTX_new_id": (_c_void_p, [_c_int, _c_void_p]),
    "EVP_PKEY_CTX_free": (None, [_c_void_p]),
    "EVP_PKEY_CTX_ctrl": (_c_int, [_c_void_p, _c_int, _c_int, _c_int, _c_int, _c_void_p]),
    "EVP_PKEY_derive_init": (_c_int, [_c_void_p]),
    "EVP_PKEY_derive_set_peer": (_c_int, [_c_void_p, _c_void_p]),
    "EVP_PKEY_derive": (_c_int, [_c_void_p, _c_void_p, ctypes.POINTER(_c_size_t)]),
    "EVP_PKEY_keygen_init": (_c_int, [_c_void_p]),
    "EVP_PKEY_keygen": (_c_int, [_c_void_p, ctypes.POINTER(_c_void_p)]),
    "EVP_MD_CTX_new": (_c_void_p, []),
    "EVP_MD_CTX_free": (None, [_c_void_p]),
    "EVP_sha256": (_c_void_p, []),
    "EVP_DigestSignInit": (_c_int, [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p]),
    "EVP_DigestSign": (_c_int, [_c_void_p, _c_void_p, ctypes.POINTER(_c_size_t), _c_char_p, _c_size_t]),
    "EVP_DigestVerifyInit": (_c_int, [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p]),
    "EVP_DigestVerify": (_c_int, [_c_void_p, _c_char_p, _c_size_t, _c_char_p, _c_size_t]),
    "i2d_PUBKEY": (_c_int, [_c_void_p, ctypes.POINTER(_c_void_p)]),
    "d2i_PUBKEY": (_c_void_p, [_c_void_p, ctypes.POINTER(_c_void_p), ctypes.c_long]),
    "d2i_X509": (_c_void_p, [_c_void_p, ctypes.POINTER(_c_void_p), ctypes.c_long]),
    "X509_free": (None, [_c_void_p]),
    "X509_get_pubkey": (_c_void_p, [_c_void_p]),
}

_lib: Optional[ctypes.CDLL] = None
_path: Optional[str] = None
_error: Optional[str] = None


def _mapped_libcrypto() -> Optional[str]:
    """The libcrypto that ``ssl`` already mapped into this process, if any."""
    try:
        import ssl  # noqa: F401 — loads _ssl and with it libcrypto
    except ImportError:
        return None
    try:
        with open("/proc/self/maps") as f:
            for line in f:
                path = line.rstrip("\n").split(" ")[-1]
                if "/libcrypto" in path and os.path.exists(path):
                    return path
    except OSError:
        pass
    return None


def lib() -> ctypes.CDLL:
    """The bound libcrypto; raises :class:`LibcryptoUnavailable` where none loads."""
    global _lib, _path, _error
    if _lib is not None:
        return _lib
    if _error is not None:
        raise LibcryptoUnavailable(_error)
    candidates = [p for p in (_mapped_libcrypto(), ctypes.util.find_library("crypto")) if p]
    problems = []
    for cand in candidates:
        try:
            handle = ctypes.CDLL(cand)
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype = restype
                fn.argtypes = argtypes
        except (OSError, AttributeError) as e:
            problems.append(f"{cand}: {e}")
            continue
        _lib, _path = handle, cand
        return handle
    _error = ("OpenSSL libcrypto (1.1.1 or 3.x) not found"
              + (": " + "; ".join(problems) if problems else " (no ssl mapping, find_library('crypto') empty)"))
    raise LibcryptoUnavailable(_error)


def available() -> bool:
    try:
        lib()
    except LibcryptoUnavailable:
        return False
    return True


def library_path() -> str:
    lib()
    return _path


def version() -> str:
    return lib().OpenSSL_version(0).decode()


def _fail(what: str) -> RuntimeError:
    """A RuntimeError naming the OpenSSL call and its first queued error; the
    queue is cleared so no later caller (``ssl`` included) reads it."""
    L = lib()
    code = L.ERR_get_error()
    detail = ""
    if code:
        buf = ctypes.create_string_buffer(256)
        L.ERR_error_string_n(code, buf, len(buf))
        detail = ": " + buf.value.decode(errors="replace")
    L.ERR_clear_error()
    return RuntimeError(f"libcrypto {what} failed{detail}")


def _check(ok: int, what: str) -> None:
    if ok <= 0:
        raise _fail(what)


# ---------------------------------------------------------------------------
# symmetric


class _CipherCtx:
    """One owned ``EVP_CIPHER_CTX``."""

    def __init__(self) -> None:
        self._L = lib()
        self.ptr = self._L.EVP_CIPHER_CTX_new()
        if not self.ptr:
            raise _fail("EVP_CIPHER_CTX_new")

    def __del__(self) -> None:
        ptr, self.ptr = getattr(self, "ptr", None), None
        if ptr:
            self._L.EVP_CIPHER_CTX_free(ptr)


class AesGcm:
    """AES-128-GCM with a 12-byte nonce and a 16-byte tag, laid out as
    ``cryptography``'s ``AESGCM``: ``seal`` returns ciphertext‖tag. The key
    schedule is set once per direction; each call sets only the nonce."""

    def __init__(self, key: bytes) -> None:
        if len(key) != 16:
            raise ValueError("AES-128-GCM key must be 16 bytes")
        self._key = bytes(key)
        self._enc: Optional[_CipherCtx] = None
        self._dec: Optional[_CipherCtx] = None

    def _ctx(self, encrypt: bool) -> _CipherCtx:
        ctx = self._enc if encrypt else self._dec
        if ctx is None:
            L = lib()
            ctx = _CipherCtx()
            init = L.EVP_EncryptInit_ex if encrypt else L.EVP_DecryptInit_ex
            _check(init(ctx.ptr, L.EVP_aes_128_gcm(), None, None, None), "GCM init")
            _check(L.EVP_CIPHER_CTX_ctrl(ctx.ptr, _EVP_CTRL_GCM_SET_IVLEN, 12, None), "GCM ivlen")
            _check(init(ctx.ptr, None, None, self._key, None), "GCM key")
            if encrypt:
                self._enc = ctx
            else:
                self._dec = ctx
        return ctx

    def seal(self, nonce: bytes, plaintext: bytes, aad: bytes) -> bytes:
        L = lib()
        ctx = self._ctx(True).ptr
        plaintext = bytes(plaintext)
        n = len(plaintext)
        out = ctypes.create_string_buffer(n + GCM_TAG_LEN)
        outl = _c_int(0)
        _check(L.EVP_EncryptInit_ex(ctx, None, None, None, bytes(nonce)), "GCM nonce")
        if aad:
            _check(L.EVP_EncryptUpdate(ctx, None, ctypes.byref(outl), bytes(aad), len(aad)), "GCM aad")
        if n:
            _check(L.EVP_EncryptUpdate(ctx, out, ctypes.byref(outl), plaintext, n), "GCM encrypt")
        _check(L.EVP_EncryptFinal_ex(ctx, ctypes.byref(out, n), ctypes.byref(outl)), "GCM final")
        _check(L.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_GET_TAG, GCM_TAG_LEN, ctypes.byref(out, n)),
               "GCM tag")
        return out.raw

    def open(self, nonce: bytes, data: bytes, aad: bytes) -> bytes:
        """Decrypt ciphertext‖tag; raises :class:`AuthenticationError` when
        the tag does not verify."""
        if len(data) < GCM_TAG_LEN:
            raise AuthenticationError("ciphertext shorter than the GCM tag")
        L = lib()
        ctx = self._ctx(False).ptr
        data = bytes(data)
        n = len(data) - GCM_TAG_LEN
        out = ctypes.create_string_buffer(max(n, 1))
        outl = _c_int(0)
        tag = ctypes.create_string_buffer(data[n:], GCM_TAG_LEN)
        _check(L.EVP_DecryptInit_ex(ctx, None, None, None, bytes(nonce)), "GCM nonce")
        if aad:
            _check(L.EVP_DecryptUpdate(ctx, None, ctypes.byref(outl), bytes(aad), len(aad)), "GCM aad")
        if n:
            _check(L.EVP_DecryptUpdate(ctx, out, ctypes.byref(outl), data[:n], n), "GCM decrypt")
        _check(L.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_SET_TAG, GCM_TAG_LEN, tag), "GCM set tag")
        if L.EVP_DecryptFinal_ex(ctx, ctypes.byref(out, n), ctypes.byref(outl)) <= 0:
            L.ERR_clear_error()
            raise AuthenticationError("AES-GCM tag mismatch")
        return out.raw[:n]


class AesEcb:
    """AES-128 in ECB mode without padding: one context encrypts block by
    block (the header-protection mask of RFC 9001 §5.4.3)."""

    def __init__(self, key: bytes) -> None:
        if len(key) != 16:
            raise ValueError("AES-128 key must be 16 bytes")
        L = lib()
        self._ctx = _CipherCtx()
        _check(L.EVP_EncryptInit_ex(self._ctx.ptr, L.EVP_aes_128_ecb(), None, bytes(key), None), "ECB init")
        _check(L.EVP_CIPHER_CTX_set_padding(self._ctx.ptr, 0), "ECB padding")
        self._out = ctypes.create_string_buffer(16)
        self._outl = _c_int(0)

    def encrypt_block(self, block: bytes) -> bytes:
        block = bytes(block)
        if len(block) != 16:
            raise ValueError("AES block must be 16 bytes")
        _check(lib().EVP_EncryptUpdate(self._ctx.ptr, self._out, ctypes.byref(self._outl), block, 16),
               "ECB encrypt")
        return self._out.raw


# ---------------------------------------------------------------------------
# asymmetric


class _PKey:
    """One owned ``EVP_PKEY``."""

    def __init__(self, ptr) -> None:
        self._L = lib()
        self.ptr = ptr

    def __del__(self) -> None:
        ptr, self.ptr = getattr(self, "ptr", None), None
        if ptr:
            self._L.EVP_PKEY_free(ptr)

    def spki_der(self) -> bytes:
        """SubjectPublicKeyInfo DER of the key (``i2d_PUBKEY``)."""
        L = self._L
        n = L.i2d_PUBKEY(self.ptr, None)
        _check(n, "i2d_PUBKEY")
        buf = ctypes.create_string_buffer(n)
        p = _c_void_p(ctypes.addressof(buf))
        _check(L.i2d_PUBKEY(self.ptr, ctypes.byref(p)), "i2d_PUBKEY")
        return buf.raw


class _PKeyCtx:
    def __init__(self, ptr, what: str) -> None:
        self._L = lib()
        if not ptr:
            raise _fail(what)
        self.ptr = ptr

    def __del__(self) -> None:
        ptr, self.ptr = getattr(self, "ptr", None), None
        if ptr:
            self._L.EVP_PKEY_CTX_free(ptr)


class _MdCtx:
    def __init__(self) -> None:
        self._L = lib()
        self.ptr = self._L.EVP_MD_CTX_new()
        if not self.ptr:
            raise _fail("EVP_MD_CTX_new")

    def __del__(self) -> None:
        ptr, self.ptr = getattr(self, "ptr", None), None
        if ptr:
            self._L.EVP_MD_CTX_free(ptr)


class X25519Key:
    """An X25519 private key (RFC 7748)."""

    def __init__(self, private: bytes) -> None:
        if len(private) != 32:
            raise ValueError("X25519 private key must be 32 bytes")
        L = lib()
        ptr = L.EVP_PKEY_new_raw_private_key(_EVP_PKEY_X25519, None, bytes(private), 32)
        if not ptr:
            raise _fail("EVP_PKEY_new_raw_private_key")
        self._key = _PKey(ptr)

    @classmethod
    def generate(cls) -> "X25519Key":
        return cls(os.urandom(32))

    def public_bytes(self) -> bytes:
        buf = ctypes.create_string_buffer(32)
        n = _c_size_t(32)
        _check(lib().EVP_PKEY_get_raw_public_key(self._key.ptr, buf, ctypes.byref(n)),
               "EVP_PKEY_get_raw_public_key")
        return buf.raw[: n.value]

    def exchange(self, peer_public: bytes) -> bytes:
        """The shared secret with the peer's 32-byte public key."""
        if len(peer_public) != 32:
            raise ValueError("X25519 public key must be 32 bytes")
        L = lib()
        ptr = L.EVP_PKEY_new_raw_public_key(_EVP_PKEY_X25519, None, bytes(peer_public), 32)
        if not ptr:
            raise _fail("EVP_PKEY_new_raw_public_key")
        peer = _PKey(ptr)
        ctx = _PKeyCtx(L.EVP_PKEY_CTX_new(self._key.ptr, None), "EVP_PKEY_CTX_new")
        _check(L.EVP_PKEY_derive_init(ctx.ptr), "EVP_PKEY_derive_init")
        _check(L.EVP_PKEY_derive_set_peer(ctx.ptr, peer.ptr), "EVP_PKEY_derive_set_peer")
        buf = ctypes.create_string_buffer(32)
        n = _c_size_t(32)
        _check(L.EVP_PKEY_derive(ctx.ptr, buf, ctypes.byref(n)), "X25519 derive")
        return buf.raw[: n.value]


class EcPublicKey:
    """An EC public key (P-256 in this stack) that verifies ECDSA/SHA-256."""

    def __init__(self, key: _PKey) -> None:
        self._key = key

    @classmethod
    def from_der(cls, spki: bytes) -> "EcPublicKey":
        """From SubjectPublicKeyInfo DER (``d2i_PUBKEY``)."""
        L = lib()
        spki = bytes(spki)
        buf = ctypes.create_string_buffer(spki, len(spki))
        p = _c_void_p(ctypes.addressof(buf))
        ptr = L.d2i_PUBKEY(None, ctypes.byref(p), len(spki))
        if not ptr:
            raise _fail("d2i_PUBKEY")
        return cls(_PKey(ptr))

    def der(self) -> bytes:
        return self._key.spki_der()

    def verify(self, signature: bytes, data: bytes) -> bool:
        """Whether the DER ECDSA ``signature`` over SHA-256(``data``) holds."""
        L = lib()
        md = _MdCtx()
        _check(L.EVP_DigestVerifyInit(md.ptr, None, L.EVP_sha256(), None, self._key.ptr),
               "EVP_DigestVerifyInit")
        ok = L.EVP_DigestVerify(md.ptr, bytes(signature), len(signature), bytes(data), len(data))
        if ok != 1:
            L.ERR_clear_error()
        return ok == 1


class EcdsaP256Key:
    """An ECDSA P-256 private key; signatures are DER ``ECDSA-Sig-Value``
    over SHA-256, as TLS 1.3's ``ecdsa_secp256r1_sha256`` expects."""

    def __init__(self, key: _PKey) -> None:
        self._key = key

    @classmethod
    def generate(cls) -> "EcdsaP256Key":
        L = lib()
        ctx = _PKeyCtx(L.EVP_PKEY_CTX_new_id(_EVP_PKEY_EC, None), "EVP_PKEY_CTX_new_id")
        _check(L.EVP_PKEY_keygen_init(ctx.ptr), "EVP_PKEY_keygen_init")
        # EVP_PKEY_CTX_set_ec_paramgen_curve_nid is a macro over this ctrl in
        # 1.1.1 and a function in 3.x; the ctrl works in both
        _check(L.EVP_PKEY_CTX_ctrl(ctx.ptr, _EVP_PKEY_EC, _EVP_PKEY_OP_PARAMGEN | _EVP_PKEY_OP_KEYGEN,
                                   _EVP_PKEY_CTRL_EC_PARAMGEN_CURVE_NID, _NID_X9_62_PRIME256V1, None),
               "EC curve P-256")
        out = _c_void_p(None)
        _check(L.EVP_PKEY_keygen(ctx.ptr, ctypes.byref(out)), "EVP_PKEY_keygen")
        return cls(_PKey(out.value))

    def public_der(self) -> bytes:
        return self._key.spki_der()

    def sign(self, data: bytes) -> bytes:
        L = lib()
        md = _MdCtx()
        _check(L.EVP_DigestSignInit(md.ptr, None, L.EVP_sha256(), None, self._key.ptr), "EVP_DigestSignInit")
        data = bytes(data)
        n = _c_size_t(0)
        _check(L.EVP_DigestSign(md.ptr, None, ctypes.byref(n), data, len(data)), "EVP_DigestSign (size)")
        buf = ctypes.create_string_buffer(n.value)
        _check(L.EVP_DigestSign(md.ptr, buf, ctypes.byref(n), data, len(data)), "EVP_DigestSign")
        return buf.raw[: n.value]


def cert_public_key(cert_der: bytes) -> EcPublicKey:
    """The public key of a DER X.509 certificate (``d2i_X509``)."""
    L = lib()
    cert_der = bytes(cert_der)
    buf = ctypes.create_string_buffer(cert_der, len(cert_der))
    p = _c_void_p(ctypes.addressof(buf))
    x509 = L.d2i_X509(None, ctypes.byref(p), len(cert_der))
    if not x509:
        raise _fail("d2i_X509")
    try:
        ptr = L.X509_get_pubkey(x509)
        if not ptr:
            raise _fail("X509_get_pubkey")
        return EcPublicKey(_PKey(ptr))
    finally:
        L.X509_free(x509)
