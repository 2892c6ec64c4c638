"""ctypes bridge to the repo's C++ host library (``native/``).

The port's copy of the JAX package's bridge, reduced to the entry points
the port calls: ``split_lines`` (line spans of a read chunk),
``pack_rows`` (arena → zero-padded ``[B, L]`` row tile),
``ndjson_serialize`` (columnar NDJSON assembly) and ``dfa_scan`` (the host
walk of a byte-indexed DFA table, ``ops/regex/fuse.ByteTableScanner``).  The library is built from
the repo's sources with ``make -C native`` on first use; when neither the
library nor a toolchain exists, every wrapper returns None and its caller
runs the numpy fallback, with byte-identical results.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from .utils.logger import get_logger

log = get_logger("native")

_lib = None
_load_lock = threading.Lock()
_load_attempted = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_NAME = "libloongcollector_native.so"
_SO_PATH = os.path.join(_NATIVE_DIR, _LIB_NAME)
_ENTRY_POINTS = ("lct_split_lines", "lct_pack_rows", "lct_ndjson_serialize",
                 "lct_dfa_scan")


def _try_build() -> bool:
    if not os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
        return False
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, "-s", _LIB_NAME],
                       check=True, timeout=600, capture_output=True)
        return os.path.exists(_SO_PATH)
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    with _load_lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        if os.environ.get("LOONG_DISABLE_NATIVE"):
            return None
        if not os.path.exists(_SO_PATH) and not _try_build():
            log.info("native library unavailable; using numpy fallbacks")
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError as e:
            log.warning("failed to load native library: %s", e)
            return None
        if not all(hasattr(lib, fn) for fn in _ENTRY_POINTS):
            # stale build predating an entry point: rebuild and reload
            if not _try_build():
                return None
            lib = ctypes.CDLL(_SO_PATH)
        # pointer params bind as c_void_p and calls pass raw addresses
        # (arr.ctypes.data); ctypes POINTER casts cost microseconds each
        vp = ctypes.c_void_p
        i64 = ctypes.c_int64
        lib.lct_split_lines.restype = i64
        lib.lct_split_lines.argtypes = [vp, i64, ctypes.c_uint8, i64, vp, vp]
        lib.lct_pack_rows.restype = None
        lib.lct_pack_rows.argtypes = [vp, i64, vp, vp, i64, i64, vp]
        lib.lct_ndjson_serialize.restype = i64
        lib.lct_ndjson_serialize.argtypes = [
            vp, i64, vp, i64, i64,
            vp, vp, vp, vp, i64, i64,
            vp, i64, ctypes.c_int32,
            vp, i64, ctypes.c_int32, ctypes.c_int32,
            vp, i64, vp, i64]
        i32 = ctypes.c_int32
        lib.lct_dfa_scan.restype = i64
        lib.lct_dfa_scan.argtypes = [vp, i64, vp, vp, i64, vp, i32, i32, i32,
                                     vp, vp]
        _lib = lib
        log.info("native library loaded: %s", _SO_PATH)
        return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


_split_scratch = threading.local()


def split_lines(seg: np.ndarray, sep: int, base_offset: int
                ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = get_lib()
    if lib is None or len(seg) == 0:
        return None
    seg = np.ascontiguousarray(seg)
    # worst case is one line per byte, so the span buffers are chunk-sized;
    # reuse a per-thread scratch and return right-sized copies
    cap = len(seg) + 1
    sc = getattr(_split_scratch, "bufs", None)
    if sc is None or len(sc[0]) < cap:
        sc = (np.empty(cap, dtype=np.int32), np.empty(cap, dtype=np.int32))
        _split_scratch.bufs = sc
    offs, lens = sc
    n = lib.lct_split_lines(_ptr(seg), len(seg), sep, base_offset,
                            _ptr(offs), _ptr(lens))
    return offs[:n].copy(), lens[:n].copy()


def pack_rows(arena: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
              L: int, B: int,
              out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    arena = np.ascontiguousarray(arena)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    n = len(offsets)
    if out is not None:
        # the C packer fully writes rows [0, n) (memcpy + tail memset) but
        # never touches the padding rows [n, B) — zero only those
        rows = out
        if n < B:
            rows[n:].fill(0)
    else:
        rows = np.zeros((B, L), dtype=np.uint8)
    lib.lct_pack_rows(_ptr(arena), len(arena), _ptr(offsets), _ptr(lengths),
                      n, L, _ptr(rows))
    return rows


NDJSON_TS_NONE = 0
NDJSON_TS_EPOCH = 1
NDJSON_TS_ISO8601 = 2

_key_cache: dict = {}
_key_cache_lock = threading.Lock()


def _key_struct(keys: tuple) -> Tuple[np.ndarray, np.ndarray]:
    """(keys_blob, key_lens) for a key tuple, cached per schema."""
    with _key_cache_lock:
        st = _key_cache.get(keys)
    if st is None:
        blob = np.frombuffer(b"".join(keys) or b"\0",
                             dtype=np.uint8).copy()
        lens = np.array([len(k) for k in keys], dtype=np.int32)
        with _key_cache_lock:
            if len(_key_cache) >= 256:    # unbounded schemas must not leak
                _key_cache.clear()
            st = _key_cache.setdefault(keys, (blob, lens))
    return st


def ndjson_serialize(arena: np.ndarray, timestamps: np.ndarray,
                     key_frags: tuple, field_offs: np.ndarray,
                     field_lens: np.ndarray, prefix: bytes,
                     prefix_members: bool, ts_frag: bytes, ts_mode: int,
                     ts_first: bool, suffix: bytes = b"\n"
                     ) -> Optional[memoryview]:
    """NDJSON rows from columnar spans.

    key_frags: per-field ``b'"key": "'`` fragments (keys pre-escaped by the
    caller); prefix: row head (``{`` + encoded group tags, no trailing
    separator); ts_frag: ``b'"<key>": '``.  The caller guarantees every
    emitted span is valid UTF-8.  Returns a memoryview over the output
    buffer, or None when the library is unavailable or the row shape is
    unsupported."""
    lib = get_lib()
    if lib is None or len(key_frags) > 64:
        return None
    arena = np.ascontiguousarray(arena)
    timestamps = np.ascontiguousarray(timestamps, dtype=np.int64)
    field_offs = np.ascontiguousarray(field_offs, dtype=np.int32)
    field_lens = np.ascontiguousarray(field_lens, dtype=np.int32)
    frags_blob, frag_lens = _key_struct(key_frags)
    F = len(key_frags)
    n = len(timestamps)
    sf, si = n, 1          # field-major span matrices [F, n]
    prefix_b = np.frombuffer(prefix or b"\0", dtype=np.uint8)
    ts_b = np.frombuffer(ts_frag or b"\0", dtype=np.uint8)
    suffix_b = np.frombuffer(suffix or b"\0", dtype=np.uint8)
    # worst case: every value byte expands 6x (\u00XX), plus per-row
    # framing — mirrors the C row bound so -1 can only mean "unsupported"
    cap = int(n * (len(prefix) + len(ts_frag) + 48 + int(frag_lens.sum())
                   + 4 * F + len(suffix) + 2) + 6 * len(arena) + 64)
    out = np.empty(cap, dtype=np.uint8)
    written = lib.lct_ndjson_serialize(
        _ptr(arena), len(arena), _ptr(timestamps), n, F,
        _ptr(frags_blob), _ptr(frag_lens), _ptr(field_offs),
        _ptr(field_lens), sf, si,
        _ptr(prefix_b), len(prefix), 1 if prefix_members else 0,
        _ptr(ts_b), len(ts_frag), ts_mode, 1 if ts_first else 0,
        _ptr(suffix_b), len(suffix), _ptr(out), cap)
    if written < 0:
        return None
    return memoryview(out)[:written]


def dfa_scan(arena: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
             t256: np.ndarray, n_states: int, wide: bool, start: int,
             accept_tags: np.ndarray, out: np.ndarray) -> bool:
    """Walk each row ``arena[offsets[i]:offsets[i]+lengths[i]]`` through the
    byte-indexed table ``t256`` (u8, or u16 when ``wide``) and write its
    accept tags into ``out`` (u32).  All arrays contiguous, offsets i64,
    lengths i32.  False when the library is unavailable or refused the
    table (the caller walks in numpy)."""
    lib = get_lib()
    if lib is None:
        return False
    rc = lib.lct_dfa_scan(_ptr(arena), len(arena), _ptr(offsets),
                          _ptr(lengths), len(offsets), _ptr(t256), n_states,
                          1 if wide else 0, start, _ptr(accept_tags),
                          _ptr(out))
    return rc == 0
