"""Payload compression for the send path.

Reference: core/common/compression/ — Compressor interface + LZ4/ZSTD impls,
CompressorFactory per flusher config.

The port's copy of the JAX package's ``pipeline/compression.py``.  LZ4 and
snappy run on the native library's block codecs (``native.lz4_compress``,
``native.snappy_compress``), zstd on ``zstandard`` where it imports.  One
change: where the JAX package's ``create_compressor`` falls back to zlib
for a codec it cannot load, the port raises ``RuntimeError`` — a sink
that negotiated lz4 must not quietly receive deflate.
"""

from __future__ import annotations

import zlib
from typing import Optional

try:
    import zstandard as _zstd  # pragma: no cover - optional
except ImportError:
    _zstd = None


class Compressor:
    name = "none"

    def compress(self, data: bytes) -> bytes:
        # serializers may hand over a memoryview; uncompressed payloads are
        # long-lived (sender queue, spill) so materialize here
        return data if isinstance(data, bytes) else bytes(data)

    def decompress(self, data: bytes, raw_size: int = 0) -> bytes:
        return data if isinstance(data, bytes) else bytes(data)


class ZlibCompressor(Compressor):
    name = "zlib"

    def __init__(self, level: int = 1):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes, raw_size: int = 0) -> bytes:
        return zlib.decompress(data)


class LZ4Compressor(Compressor):
    """LZ4 BLOCK format via the native lib — SLS's default wire codec
    sends raw lz4 blocks with x-log-bodyrawsize carrying the raw size
    (FlusherSLS.h:124-159), not the frame format."""

    name = "lz4"

    def compress(self, data: bytes) -> bytes:
        from .. import native
        out = native.lz4_compress(data)
        if out is None:
            raise RuntimeError("lz4 codec unavailable (native lib missing)")
        return out

    def decompress(self, data: bytes, raw_size: int = 0) -> bytes:
        from .. import native
        out = native.lz4_decompress(data, raw_size)
        if out is None:
            raise RuntimeError("lz4 decompress failed")
        return out


class SnappyCompressor(Compressor):
    """Snappy block format via the native lib (Prometheus remote-write)."""

    name = "snappy"

    def compress(self, data: bytes) -> bytes:
        from .. import native
        out = native.snappy_compress(data)
        if out is None:
            raise RuntimeError("snappy codec unavailable")
        return out

    def decompress(self, data: bytes, raw_size: int = 0) -> bytes:
        from .. import native
        out = native.snappy_decompress(data)
        if out is None:
            raise RuntimeError("snappy decompress failed")
        return out


class ZstdCompressor(Compressor):
    name = "zstd"

    def __init__(self, level: int = 1):
        self._c = _zstd.ZstdCompressor(level=level)
        self._d = _zstd.ZstdDecompressor()

    def compress(self, data: bytes) -> bytes:
        return self._c.compress(data)

    def decompress(self, data: bytes, raw_size: int = 0) -> bytes:
        return self._d.decompress(data)


def _native_codecs_available() -> bool:
    from .. import native
    lib = native.get_lib()
    return lib is not None and hasattr(lib, "lct_lz4_compress")


def create_compressor(kind: Optional[str]) -> Compressor:
    """The compressor a flusher's ``Compression`` names; raises
    ``RuntimeError`` when its codec cannot be loaded, and ``ValueError``
    for a name no codec answers to."""
    kind = (kind or "none").lower()
    if kind in ("none", ""):
        return Compressor()
    if kind == "zlib":
        return ZlibCompressor()
    if kind in ("lz4", "snappy"):
        if not _native_codecs_available():
            raise RuntimeError(f"{kind} codec unavailable (native lib "
                               f"missing)")
        return LZ4Compressor() if kind == "lz4" else SnappyCompressor()
    if kind == "zstd":
        if _zstd is None:
            raise RuntimeError("zstd codec unavailable (zstandard not "
                               "installed)")
        return ZstdCompressor()
    raise ValueError(f"unknown compression {kind!r}")
