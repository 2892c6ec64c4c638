"""At-rest encryption for spilled send buffers.

Reference: core/plugin/flusher/sls/DiskBufferWriter.h:56 — payloads that
spill to disk (endpoint down, agent exiting) are encrypted so a host-level
reader of the buffer directory cannot recover log content.

Construction (stdlib-only; no AES in hashlib): counter-mode stream cipher
with HMAC-SHA256 as the PRF, plus an encrypt-then-MAC integrity tag:

    keystream_i = HMAC(enc_key, nonce || be64(i))          (32 B per block)
    ct          = data XOR keystream
    tag         = HMAC(mac_key, nonce || ct)
    blob        = magic(4) || nonce(16) || tag(32) || ct

enc_key/mac_key are derived from one 32-byte master key (created on first
use, file mode 0600) via HMAC domain separation.  HMAC-CTR is a standard
PRF-counter-mode construction; throughput is ~30 MB/s in CPython — far
above the spill path's needs.

The port's copy of the JAX package's ``utils/payload_crypto.py``: the
same construction and key labels, so a spill file either agent writes
decrypts in the other with the same key file.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct
from typing import Optional

_MAGIC = b"LCE1"
_NONCE_LEN = 16
_TAG_LEN = 32
_BLOCK = 32  # SHA-256 digest size


def _derive(master: bytes, label: bytes) -> bytes:
    return hmac.new(master, label, hashlib.sha256).digest()


def _keystream(enc_key: bytes, nonce: bytes, n: int) -> bytes:
    out = bytearray()
    for i in range((n + _BLOCK - 1) // _BLOCK):
        out += hmac.new(enc_key, nonce + struct.pack(">Q", i),
                        hashlib.sha256).digest()
    return bytes(out[:n])


def _xor(data: bytes, ks: bytes) -> bytes:
    return (int.from_bytes(data, "little")
            ^ int.from_bytes(ks, "little")).to_bytes(len(data), "little")


class PayloadCipher:
    """Encrypt/decrypt spill payloads with a host-local master key."""

    def __init__(self, key_path: str):
        self.key_path = key_path
        master = self._load_or_create_key()
        self._enc_key = _derive(master, b"loongcollector-spill-enc")
        self._mac_key = _derive(master, b"loongcollector-spill-mac")

    def _load_or_create_key(self) -> bytes:
        """Create the key ONLY when it genuinely does not exist.  Any other
        failure (permissions, truncation) raises: silently rotating the key
        would make every previously spilled payload permanently
        undecryptable — worse than failing loudly."""
        try:
            with open(self.key_path, "rb") as f:
                key = f.read()
        except FileNotFoundError:
            key = None
        if key is not None:
            if len(key) != 32:
                raise ValueError(
                    f"spill key file {self.key_path} is malformed "
                    f"({len(key)} bytes, want 32); refusing to rotate — "
                    f"restore or delete it explicitly")
            return key
        key = os.urandom(32)
        d = os.path.dirname(self.key_path)
        if d:
            os.makedirs(d, exist_ok=True)
        fd = os.open(self.key_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                     0o600)
        try:
            os.write(fd, key)
        finally:
            os.close(fd)
        return key

    def encrypt(self, data: bytes) -> bytes:
        nonce = os.urandom(_NONCE_LEN)
        ct = _xor(data, _keystream(self._enc_key, nonce, len(data)))
        tag = hmac.new(self._mac_key, nonce + ct, hashlib.sha256).digest()
        return _MAGIC + nonce + tag + ct

    def decrypt(self, blob: bytes) -> Optional[bytes]:
        """None on wrong magic, truncation, or MAC mismatch."""
        if len(blob) < len(_MAGIC) + _NONCE_LEN + _TAG_LEN \
                or not blob.startswith(_MAGIC):
            return None
        off = len(_MAGIC)
        nonce = blob[off:off + _NONCE_LEN]
        tag = blob[off + _NONCE_LEN:off + _NONCE_LEN + _TAG_LEN]
        ct = blob[off + _NONCE_LEN + _TAG_LEN:]
        want = hmac.new(self._mac_key, nonce + ct, hashlib.sha256).digest()
        if not hmac.compare_digest(tag, want):
            return None
        return _xor(ct, _keystream(self._enc_key, nonce, len(ct)))
