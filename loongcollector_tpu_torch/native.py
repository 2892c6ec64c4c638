"""ctypes bridge to the repo's C++ host library (``native/``).

The port's copy of the JAX package's bridge, reduced to the entry points
the port calls: ``split_lines`` (line spans of a read chunk),
``pack_rows`` (arena → zero-padded ``[B, L]`` row tile),
``ndjson_serialize`` (columnar NDJSON assembly), ``dfa_scan`` (the host
walk of a byte-indexed DFA table, ``ops/regex/fuse.ByteTableScanner``),
``json_struct_parse`` and ``json_extract`` (the structural-index JSON
parse of ``processor/parse_json.py`` and its ``LOONG_STRUCT=0`` plane),
and ``group_reduce`` (the native fold of the metric rollup,
``ops/kernels/segment_reduce.fold_batch_native``).  The library is built
from the repo's sources with ``make -C native`` on first use; when neither
the library nor a toolchain exists, every wrapper returns None and its
caller runs the numpy fallback, with byte-identical results.
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
                 "lct_dfa_scan", "lct_json_struct_parse", "lct_json_extract",
                 "lct_group_reduce")


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
        lib.lct_json_struct_parse.restype = i64
        lib.lct_json_struct_parse.argtypes = [
            vp, i64, vp, vp, i64,
            vp, vp, i64, vp, vp, vp,
            vp, i64,
            vp, vp, vp, vp, vp, i64, vp]
        lib.lct_json_extract.restype = None
        lib.lct_json_extract.argtypes = [vp, i64, vp, vp, i64, vp, vp, i64,
                                         vp, vp, vp, vp]
        lib.lct_group_reduce.restype = i64
        lib.lct_group_reduce.argtypes = [
            vp, i64,
            vp, vp, vp, vp, vp,
            i64, i64,
            ctypes.c_double, i64,
            vp, vp, vp, vp, vp, vp, vp,
            vp, i64]
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


def json_extract(arena: np.ndarray, offsets: np.ndarray,
                 lengths: np.ndarray, keys: list):
    """Flat-schema JSON field extraction.  keys: list[bytes] (≤128).
    Returns (offs [F,n] i32, lens [F,n] i32, ok [n] bool, fallback [n] bool)
    or None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None or len(keys) > 128:
        return None
    arena = np.ascontiguousarray(arena)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    keys_blob = np.frombuffer(b"".join(keys) or b"\0", dtype=np.uint8).copy()
    key_lens = np.array([len(k) for k in keys], dtype=np.int32)
    n = len(offsets)
    F = len(keys)
    out_offs = np.zeros((F, n), dtype=np.int32)
    out_lens = np.full((F, n), -1, dtype=np.int32)
    ok = np.zeros(n, dtype=np.uint8)
    fallback = np.zeros(n, dtype=np.uint8)
    lib.lct_json_extract(_ptr(arena), len(arena), _ptr(offsets),
                         _ptr(lengths), n, _ptr(keys_blob), _ptr(key_lens), F,
                         _ptr(out_offs), _ptr(out_lens), _ptr(ok),
                         _ptr(fallback))
    return out_offs, out_lens, ok.astype(bool), fallback.astype(bool)


def json_struct_parse(arena: np.ndarray, offsets: np.ndarray,
                      lengths: np.ndarray, keys: list,
                      extra_cap: Optional[int] = None):
    """Structural-index JSON parse.  keys: list[bytes] (<= 128).  Returns
    (offs [F,n] i32, lens [F,n] i32, status [n] u8 (0 parsed / 1 fallback /
    2 parsed-with-extras), side bytes ndarray (the unescape arena, already
    right-sized), extras tuple of 5 int32 arrays (row, key_off, key_len,
    val_off, val_len)) or None when the native library is unavailable.
    Span offsets >= len(arena) index into `side` at offset - len(arena)."""
    lib = get_lib()
    if lib is None or len(keys) > 128:
        return None
    arena = np.ascontiguousarray(arena)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    n = len(offsets)
    # side spans encode as arena_len + side_off in an int32
    total = int(lengths.clip(min=0).sum())
    if len(arena) + total >= 2**31 - 16:
        return None
    keys_blob, key_lens = _key_struct(tuple(keys))
    F = len(keys)
    # np.empty throughout: the C side fully writes status and every
    # out_lens slot (-1 default), and only the returned prefixes of the
    # side/extras buffers are exposed
    out_offs = np.empty((F, n), dtype=np.int32)
    out_lens = np.empty((F, n), dtype=np.int32)
    status = np.empty(n, dtype=np.uint8)
    side = np.empty(max(total, 1), dtype=np.uint8)
    if extra_cap is None:
        extra_cap = 4 * n + 64
    extras = tuple(np.empty(extra_cap, dtype=np.int32) for _ in range(5))
    counts = np.zeros(4, dtype=np.int64)
    rc = lib.lct_json_struct_parse(
        _ptr(arena), len(arena), _ptr(offsets), _ptr(lengths), n,
        _ptr(keys_blob), _ptr(key_lens), F, _ptr(out_offs), _ptr(out_lens),
        _ptr(status), _ptr(side), len(side),
        _ptr(extras[0]), _ptr(extras[1]), _ptr(extras[2]),
        _ptr(extras[3]), _ptr(extras[4]), extra_cap, _ptr(counts))
    if rc != 0:
        return None
    e = int(counts[1])
    return (out_offs, out_lens, status, side[: int(counts[0])],
            tuple(a[:e] for a in extras))


def group_reduce(arena: np.ndarray, slots: np.ndarray,
                 key_offs: np.ndarray, key_lens: np.ndarray,
                 val_offs: np.ndarray, val_lens: np.ndarray,
                 hist_base: float = 1.0, n_hist: int = 41):
    """The rollup's native fold: hashed segment identity over (window slot,
    K key spans) + row-order f64 reduction.

    slots i64 [n]; key_offs i64 / key_lens i32 [n, K] (len -1 = absent);
    val_offs i64 / val_lens i32 [n].  Returns (group_id i32 [n] with -1
    marking invalid-value rows, rep_row i32 [G], sum f64 [G], count i64
    [G], min f64 [G], max f64 [G], last f64 [G], hist i64 [G, n_hist]) —
    group ids in first-seen row order, the same partition and the same
    accumulation order as the numpy twin.  None when the native library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arena = np.ascontiguousarray(arena)
    slots = np.ascontiguousarray(slots, dtype=np.int64)
    key_offs = np.ascontiguousarray(key_offs, dtype=np.int64)
    key_lens = np.ascontiguousarray(key_lens, dtype=np.int32)
    val_offs = np.ascontiguousarray(val_offs, dtype=np.int64)
    val_lens = np.ascontiguousarray(val_lens, dtype=np.int32)
    n = len(slots)
    K = key_offs.shape[1] if key_offs.ndim == 2 else 1
    group_id = np.empty(max(n, 1), dtype=np.int32)
    # start with a small group capacity (the common case: cardinality per
    # batch << rows per batch) and retry once at the n ceiling on -1
    cap = min(n, 4096) or 1
    while True:
        rep_row = np.empty(cap, dtype=np.int32)
        sums = np.empty(cap, dtype=np.float64)
        cnt = np.empty(cap, dtype=np.int64)
        mn = np.empty(cap, dtype=np.float64)
        mx = np.empty(cap, dtype=np.float64)
        last = np.empty(cap, dtype=np.float64)
        hist = np.empty((cap, n_hist), dtype=np.int64)
        rc = lib.lct_group_reduce(
            _ptr(arena), len(arena), _ptr(slots), _ptr(key_offs),
            _ptr(key_lens), _ptr(val_offs), _ptr(val_lens), n, K,
            ctypes.c_double(hist_base), n_hist,
            _ptr(group_id), _ptr(rep_row), _ptr(sums), _ptr(cnt),
            _ptr(mn), _ptr(mx), _ptr(last), _ptr(hist), cap)
        if rc == -1 and cap < n:
            cap = n
            continue
        if rc < 0:
            return None
        G = int(rc)
        return (group_id[:n], rep_row[:G], sums[:G], cnt[:G], mn[:G],
                mx[:G], last[:G], hist[:G])
