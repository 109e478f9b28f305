"""At-rest chunk encryption: AES-256-GCM over OpenSSL's libcrypto.

Reference: weed/util/cipher.go (Encrypt/Decrypt used by the cipher
upload option, weed/operation/upload_content.go:150-170) — the chunks a
filer writes are sealed with a fresh random 256-bit key per chunk and
the key lives only in the filer's metadata (FileChunk.cipher_key), so a
volume server holds opaque bytes.

The AES primitive comes from the system libcrypto through ctypes (the
EVP interface) — a native code path, not a Python reimplementation.
Wire format: 12-byte nonce || ciphertext || 16-byte GCM tag, matching
Go's cipher.NewGCM layout of nonce + Seal output.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading

NONCE_SIZE = 12
TAG_SIZE = 16
KEY_SIZE = 32


class CipherError(Exception):
    """Encryption unavailable or decryption failed (tamper/wrong key)."""


_lib = None
_lib_err: str | None = None
_lock = threading.Lock()


def _crypto():
    """Load libcrypto once and declare the EVP signatures we use."""
    global _lib, _lib_err
    with _lock:
        if _lib is not None or _lib_err is not None:
            if _lib is None:
                raise CipherError(_lib_err)
            return _lib
        name = ctypes.util.find_library("crypto")
        if not name:
            _lib_err = ("libcrypto not found: the cipher upload option "
                        "requires OpenSSL's libcrypto on the host")
            raise CipherError(_lib_err)
        try:
            lib = ctypes.CDLL(name)
            lib.EVP_CIPHER_CTX_new.restype = ctypes.c_void_p
            lib.EVP_CIPHER_CTX_free.argtypes = [ctypes.c_void_p]
            lib.EVP_aes_256_gcm.restype = ctypes.c_void_p
            for fn in ("EVP_EncryptInit_ex", "EVP_DecryptInit_ex"):
                getattr(lib, fn).argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_char_p, ctypes.c_char_p]
            for fn in ("EVP_EncryptUpdate", "EVP_DecryptUpdate"):
                getattr(lib, fn).argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
                    ctypes.c_int]
            for fn in ("EVP_EncryptFinal_ex", "EVP_DecryptFinal_ex"):
                getattr(lib, fn).argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int)]
            lib.EVP_CIPHER_CTX_ctrl.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
        except (OSError, AttributeError) as e:
            _lib_err = f"libcrypto unusable: {e}"
            raise CipherError(_lib_err) from None
        _lib = lib
        return _lib


# EVP_CIPHER_CTX_ctrl commands (openssl/evp.h)
_EVP_CTRL_GCM_SET_IVLEN = 0x9
_EVP_CTRL_GCM_GET_TAG = 0x10
_EVP_CTRL_GCM_SET_TAG = 0x11


def available() -> bool:
    try:
        _crypto()
        return True
    except CipherError:
        return False


def new_key() -> bytes:
    return os.urandom(KEY_SIZE)


def encrypt(plaintext: bytes, key: bytes | None = None
            ) -> tuple[bytes, bytes]:
    """Seal plaintext; returns (nonce||ct||tag, key). A fresh random key
    is minted when none is given (the per-chunk key model)."""
    lib = _crypto()
    if key is None:
        key = new_key()
    if len(key) != KEY_SIZE:
        raise CipherError(f"key must be {KEY_SIZE} bytes")
    nonce = os.urandom(NONCE_SIZE)
    ctx = lib.EVP_CIPHER_CTX_new()
    if not ctx:
        raise CipherError("EVP_CIPHER_CTX_new failed")
    try:
        if not lib.EVP_EncryptInit_ex(ctx, lib.EVP_aes_256_gcm(),
                                      None, None, None):
            raise CipherError("EncryptInit(cipher) failed")
        lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_SET_IVLEN,
                                NONCE_SIZE, None)
        if not lib.EVP_EncryptInit_ex(ctx, None, None, key, nonce):
            raise CipherError("EncryptInit(key) failed")
        out = ctypes.create_string_buffer(len(plaintext) or 1)
        n = ctypes.c_int(0)
        if not lib.EVP_EncryptUpdate(ctx, out, ctypes.byref(n),
                                     plaintext, len(plaintext)):
            raise CipherError("EncryptUpdate failed")
        ct = out.raw[:n.value]
        fin = ctypes.create_string_buffer(TAG_SIZE)
        if not lib.EVP_EncryptFinal_ex(ctx, fin, ctypes.byref(n)):
            raise CipherError("EncryptFinal failed")
        ct += fin.raw[:n.value]
        tag = ctypes.create_string_buffer(TAG_SIZE)
        if not lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_GET_TAG,
                                       TAG_SIZE, tag):
            raise CipherError("GET_TAG failed")
        return nonce + ct + tag.raw, key
    finally:
        lib.EVP_CIPHER_CTX_free(ctx)


def decrypt(blob: bytes, key: bytes) -> bytes:
    """Open nonce||ct||tag; raises CipherError on wrong key or tamper."""
    lib = _crypto()
    if len(key) != KEY_SIZE:
        raise CipherError(f"key must be {KEY_SIZE} bytes")
    if len(blob) < NONCE_SIZE + TAG_SIZE:
        raise CipherError("ciphertext too short")
    nonce = blob[:NONCE_SIZE]
    tag = blob[-TAG_SIZE:]
    ct = blob[NONCE_SIZE:-TAG_SIZE]
    ctx = lib.EVP_CIPHER_CTX_new()
    if not ctx:
        raise CipherError("EVP_CIPHER_CTX_new failed")
    try:
        if not lib.EVP_DecryptInit_ex(ctx, lib.EVP_aes_256_gcm(),
                                      None, None, None):
            raise CipherError("DecryptInit(cipher) failed")
        lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_SET_IVLEN,
                                NONCE_SIZE, None)
        if not lib.EVP_DecryptInit_ex(ctx, None, None, key, nonce):
            raise CipherError("DecryptInit(key) failed")
        out = ctypes.create_string_buffer(len(ct) or 1)
        n = ctypes.c_int(0)
        if not lib.EVP_DecryptUpdate(ctx, out, ctypes.byref(n),
                                     ct, len(ct)):
            raise CipherError("DecryptUpdate failed")
        pt = out.raw[:n.value]
        tag_buf = ctypes.create_string_buffer(tag, TAG_SIZE)
        lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_SET_TAG,
                                TAG_SIZE, tag_buf)
        fin = ctypes.create_string_buffer(TAG_SIZE)
        if lib.EVP_DecryptFinal_ex(ctx, fin, ctypes.byref(n)) <= 0:
            raise CipherError("decryption failed: bad key or "
                              "tampered ciphertext")
        return pt + fin.raw[:n.value]
    finally:
        lib.EVP_CIPHER_CTX_free(ctx)


# -- RS256 (service-account JWT signing) -------------------------------------
#
# Google service accounts authenticate with an RS256-signed JWT grant
# (the Pub/Sub notification queue needs one); the RSA-SHA256 primitive
# comes from the same libcrypto the AES path uses.

def _crypto_rsa():
    lib = _crypto()
    if getattr(lib, "_rsa_ready", False):
        return lib
    lib.BIO_new_mem_buf.restype = ctypes.c_void_p
    lib.BIO_new_mem_buf.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.BIO_free.argtypes = [ctypes.c_void_p]
    lib.PEM_read_bio_PrivateKey.restype = ctypes.c_void_p
    lib.PEM_read_bio_PrivateKey.argtypes = [ctypes.c_void_p] + \
        [ctypes.c_void_p] * 3
    lib.PEM_read_bio_PUBKEY.restype = ctypes.c_void_p
    lib.PEM_read_bio_PUBKEY.argtypes = [ctypes.c_void_p] + \
        [ctypes.c_void_p] * 3
    lib.EVP_PKEY_free.argtypes = [ctypes.c_void_p]
    lib.EVP_MD_CTX_new.restype = ctypes.c_void_p
    lib.EVP_MD_CTX_free.argtypes = [ctypes.c_void_p]
    lib.EVP_sha256.restype = ctypes.c_void_p
    lib.EVP_DigestSignInit.argtypes = [ctypes.c_void_p] * 5
    lib.EVP_DigestSign.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p,
        ctypes.c_size_t]
    lib.EVP_DigestVerifyInit.argtypes = [ctypes.c_void_p] * 5
    lib.EVP_DigestVerify.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t]
    lib._rsa_ready = True
    return lib


def _load_pem(pem: bytes, public: bool):
    lib = _crypto_rsa()
    bio = lib.BIO_new_mem_buf(pem, len(pem))
    if not bio:
        raise CipherError("BIO_new_mem_buf failed")
    try:
        fn = lib.PEM_read_bio_PUBKEY if public \
            else lib.PEM_read_bio_PrivateKey
        pkey = fn(bio, None, None, None)
        if not pkey:
            raise CipherError("could not parse PEM key")
        return pkey
    finally:
        lib.BIO_free(bio)


def rs256_sign(pem_private_key: bytes, data: bytes) -> bytes:
    """RSASSA-PKCS1-v1_5 over SHA-256 (JWT alg RS256)."""
    lib = _crypto_rsa()
    pkey = _load_pem(pem_private_key, public=False)
    ctx = lib.EVP_MD_CTX_new()
    try:
        if lib.EVP_DigestSignInit(ctx, None, lib.EVP_sha256(),
                                  None, pkey) != 1:
            raise CipherError("DigestSignInit failed")
        n = ctypes.c_size_t(0)
        if lib.EVP_DigestSign(ctx, None, ctypes.byref(n),
                              data, len(data)) != 1:
            raise CipherError("DigestSign(size) failed")
        sig = ctypes.create_string_buffer(n.value)
        if lib.EVP_DigestSign(ctx, sig, ctypes.byref(n),
                              data, len(data)) != 1:
            raise CipherError("DigestSign failed")
        return sig.raw[:n.value]
    finally:
        lib.EVP_MD_CTX_free(ctx)
        lib.EVP_PKEY_free(pkey)


def rs256_verify(pem_public_key: bytes, data: bytes,
                 signature: bytes) -> bool:
    lib = _crypto_rsa()
    pkey = _load_pem(pem_public_key, public=True)
    ctx = lib.EVP_MD_CTX_new()
    try:
        if lib.EVP_DigestVerifyInit(ctx, None, lib.EVP_sha256(),
                                    None, pkey) != 1:
            raise CipherError("DigestVerifyInit failed")
        return lib.EVP_DigestVerify(ctx, signature, len(signature),
                                    data, len(data)) == 1
    finally:
        lib.EVP_MD_CTX_free(ctx)
        lib.EVP_PKEY_free(pkey)
