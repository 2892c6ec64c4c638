"""ctypes bridge to the repo's C++ host library (``native/``).

The port's copy of the JAX package's bridge, reduced to the entry points
the port calls: ``split_lines`` (line spans of a read chunk),
``pack_rows`` (arena → zero-padded ``[B, L]`` row tile),
``ndjson_serialize`` (columnar NDJSON assembly), ``dfa_scan`` (the host
walk of a byte-indexed DFA table, ``ops/regex/fuse.ByteTableScanner``),
``json_struct_parse`` and ``json_extract`` (the structural-index JSON
parse of ``processor/parse_json.py`` and its ``LOONG_STRUCT=0`` plane),
``struct_index`` (the host structural index, K5's third reference) and
``delim_struct_parse`` (the quote-mode delimiter's native walk,
``processor/parse_delimiter.py``), and ``group_reduce`` (the native fold of
the metric rollup, ``ops/kernels/segment_reduce.fold_batch_native``), and
for the send path ``sls_serialize`` (the SLS LogGroup wire bytes of
``pipeline/serializer/sls_serializer.py``) and the ``lct_lz4_*`` /
``lct_snappy_*`` block codecs (``pipeline/compression.py``; the JAX
bridge's ``native.py:150-152``, ``:559-590``).  The library is built
from the repo's sources on first use, with the rule and flags of
``native/Makefile``; when neither the library nor a toolchain exists, every
wrapper returns None and its caller runs the numpy fallback, with
byte-identical results.

Several processes may want the library at once (test workers, an agent
beside its tests), and the JAX package's bridge runs ``make`` on the same
output path, whose linker writes the file in place.  So the port never
loads a file it has not checked: it opens the library, checks that the ELF
file is whole (its program headers, loaded segments and section headers
all lie inside the file) and loads that very inode through
``/proc/self/fd``; a library that is missing, incomplete or older than an
entry point is rebuilt under an exclusive ``flock`` on
``native/libloongcollector_native.so.lock``, into a temporary file beside
it that ``os.replace`` then puts in place.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import struct
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
                 "lct_group_reduce", "lct_struct_index",
                 "lct_delim_struct_parse", "lct_sls_serialize",
                 "lct_sls_serialize_strided", "lct_lz4_bound",
                 "lct_lz4_compress", "lct_lz4_decompress", "lct_snappy_bound",
                 "lct_snappy_compress", "lct_snappy_uncompressed_len",
                 "lct_snappy_decompress")


_LOCK_PATH = _SO_PATH + ".lock"
# a make rule with the Makefile's compiler and flags, writing OUT
_BUILD_RULE = ("lct_port_build: loongcollector_native.cpp ; "
               "$(CXX) $(CXXFLAGS) -shared -o $(OUT) $<")
_ELF64 = struct.Struct("<16sHHIQQQIHHHHHH")
_PHDR64 = struct.Struct("<IIQQQQQQ")
_loaded_fds: list = []


def _elf_whole(fd: int) -> bool:
    """True when the file behind ``fd`` is a 64-bit ELF object whose
    program headers, loaded segments and section headers all lie inside
    it: a file a linker is still writing fails this."""
    size = os.fstat(fd).st_size
    hdr = os.pread(fd, _ELF64.size, 0)
    if len(hdr) < _ELF64.size or hdr[:5] != b"\x7fELF\x02":
        return False
    (_, _, _, _, _, phoff, shoff, _, _, phentsize, phnum, shentsize, shnum,
     _) = _ELF64.unpack(hdr)
    end = max(phoff + phentsize * phnum, shoff + shentsize * shnum)
    if not phnum or phentsize < _PHDR64.size or end > size:
        return False
    table = os.pread(fd, phentsize * phnum, phoff)
    for i in range(phnum):
        ptype, _, off, _, _, filesz, _, _ = _PHDR64.unpack_from(
            table, i * phentsize)
        if ptype == 1 and off + filesz > size:      # PT_LOAD
            return False
    return True


def _open_whole(path: str) -> Optional[ctypes.CDLL]:
    """The library at ``path`` if it is whole and has every entry point;
    the inode checked is the inode loaded.  A descriptor the loader has
    seen stays open for the life of the process: the loader remembers a
    library by the name it was opened under, and a closed descriptor's
    number would name another file later."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return None
    try:
        if not _elf_whole(fd):
            os.close(fd)
            return None
        _loaded_fds.append(fd)
        lib = ctypes.CDLL(f"/proc/self/fd/{fd}")
    except OSError as e:
        log.warning("failed to load native library %s: %s", path, e)
        return None
    if not all(hasattr(lib, fn) for fn in _ENTRY_POINTS):
        return None                 # a build predating an entry point
    return lib


def ensure_built() -> bool:
    """Make sure a whole library with every entry point is in place,
    building it under the lock when it is not; False when it cannot be
    built (no Makefile or no toolchain)."""
    if not os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
        return False
    with open(_LOCK_PATH, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        # another process may have built it while this one waited
        if _open_whole(_SO_PATH) is not None:
            return True
        tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "-s",
                            "--eval", _BUILD_RULE, "lct_port_build",
                            f"OUT={tmp}"],
                           check=True, timeout=600, capture_output=True)
            os.replace(tmp, _SO_PATH)
        except (OSError, subprocess.SubprocessError) as e:
            log.warning("native library build failed: %s", e)
            return False
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return True


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
        lib = _open_whole(_SO_PATH)
        if lib is None:
            if not ensure_built():
                log.info("native library unavailable; using numpy fallbacks")
                return None
            lib = _open_whole(_SO_PATH)
            if lib is None:
                log.warning("native library %s does not load", _SO_PATH)
                return None
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
        lib.lct_struct_index.restype = None
        lib.lct_struct_index.argtypes = [
            vp, i64, vp, vp, i64, i32, ctypes.c_uint8, ctypes.c_uint8, i64,
            vp, vp, vp, vp]
        lib.lct_delim_struct_parse.restype = i64
        lib.lct_delim_struct_parse.argtypes = [
            vp, i64, vp, vp, i64, ctypes.c_uint8, ctypes.c_uint8, i64,
            vp, vp, vp, vp, i64, vp]
        lib.lct_sls_serialize.restype = i64
        lib.lct_sls_serialize.argtypes = [vp, i64, vp, i64, i64, vp, vp, vp,
                                          vp, vp, i64]
        lib.lct_sls_serialize_strided.restype = i64
        lib.lct_sls_serialize_strided.argtypes = [
            vp, i64, vp, i64, i64, vp, vp, vp, vp, i64, i64, vp, i64]
        for fn in ("lct_lz4_bound", "lct_snappy_bound"):
            getattr(lib, fn).restype = i64
            getattr(lib, fn).argtypes = [i64]
        for fn in ("lct_lz4_compress", "lct_lz4_decompress",
                   "lct_snappy_compress", "lct_snappy_decompress"):
            getattr(lib, fn).restype = i64
            getattr(lib, fn).argtypes = [vp, i64, vp, i64]
        lib.lct_snappy_uncompressed_len.restype = i64
        lib.lct_snappy_uncompressed_len.argtypes = [vp, i64]
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


STRUCT_MODE_JSON = 0
STRUCT_MODE_DELIM = 1


def struct_index(arena: np.ndarray, offsets: np.ndarray,
                 lengths: np.ndarray, mode: int = STRUCT_MODE_JSON,
                 sep: int = 0x2C, quote: int = 0x22,
                 W: Optional[int] = None):
    """Per-row structural bitmaps: uint64 [n, W] arrays (in_string,
    structural, escaped, quote) with row-local bit positions — the host
    reference K5 (``ops/kernels/struct_index.py``) is held against.
    Returns None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arena = np.ascontiguousarray(arena)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    n = len(offsets)
    if W is None:
        W = max(1, (int(lengths.max()) + 63) // 64) if n else 1
    shape = (n, W)
    s_mask = np.zeros(shape, dtype=np.uint64)
    t_mask = np.zeros(shape, dtype=np.uint64)
    e_mask = np.zeros(shape, dtype=np.uint64)
    q_mask = np.zeros(shape, dtype=np.uint64)
    lib.lct_struct_index(_ptr(arena), len(arena), _ptr(offsets),
                         _ptr(lengths), n, mode, sep, quote, W,
                         _ptr(s_mask), _ptr(t_mask), _ptr(e_mask),
                         _ptr(q_mask))
    return s_mask, t_mask, e_mask, q_mask


def delim_struct_parse(arena: np.ndarray, offsets: np.ndarray,
                       lengths: np.ndarray, sep: int, quote: int,
                       F: int):
    """Structural-index quote-mode delimiter parse: event-major spans
    (offs [n,F] i32, lens [n,F] i32, nfields [n] i32, side bytes).  Span
    offsets >= len(arena) index into `side`.  Returns None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None or F <= 0:
        return None
    arena = np.ascontiguousarray(arena)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    n = len(offsets)
    total = int(lengths.clip(min=0).sum())
    if len(arena) + total >= 2**31 - 16:
        return None
    out_offs = np.zeros((n, F), dtype=np.int32)
    out_lens = np.full((n, F), -1, dtype=np.int32)
    nfields = np.zeros(n, dtype=np.int32)
    side = np.empty(max(total, 1), dtype=np.uint8)
    counts = np.zeros(2, dtype=np.int64)
    rc = lib.lct_delim_struct_parse(
        _ptr(arena), len(arena), _ptr(offsets), _ptr(lengths), n,
        sep, quote, F, _ptr(out_offs), _ptr(out_lens), _ptr(nfields),
        _ptr(side), len(side), _ptr(counts))
    if rc != 0:
        return None
    return out_offs, out_lens, nfields, side[: int(counts[0])]


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


def sls_serialize(arena: np.ndarray, timestamps: np.ndarray,
                  keys: list, field_offs: np.ndarray, field_lens: np.ndarray,
                  event_major: bool = False) -> Optional[memoryview]:
    """SLS LogGroup ``Log`` messages from columnar spans.  keys: list[bytes]
    (at most 64); field_offs/field_lens: int32 — [F, n] field-major by
    default, [n, F] when event_major=True (the parse kernel's layout).
    Returns a memoryview over the output buffer, or None when the library
    is unavailable."""
    lib = get_lib()
    if lib is None or len(keys) > 64:
        return None
    arena = np.ascontiguousarray(arena)
    timestamps = np.ascontiguousarray(timestamps, dtype=np.int64)
    field_offs = np.ascontiguousarray(field_offs, dtype=np.int32)
    field_lens = np.ascontiguousarray(field_lens, dtype=np.int32)
    keys_blob, key_lens = _key_struct(tuple(keys))
    F = len(keys)
    n = len(timestamps)
    sf, si = (1, F) if event_major else (n, 1)
    # field values live in the arena, so its length bounds them unless
    # spans overlap; then the call returns -needed and the retry sizes it
    cap = int(len(arena) + n * (int(key_lens.sum()) + 12 * F + 16) + 64)

    def call(buf, buf_cap):
        if event_major:
            return lib.lct_sls_serialize_strided(
                _ptr(arena), len(arena), _ptr(timestamps), n, F,
                _ptr(keys_blob), _ptr(key_lens), _ptr(field_offs),
                _ptr(field_lens), sf, si, _ptr(buf), buf_cap)
        return lib.lct_sls_serialize(
            _ptr(arena), len(arena), _ptr(timestamps), n, F,
            _ptr(keys_blob), _ptr(key_lens), _ptr(field_offs),
            _ptr(field_lens), _ptr(buf), buf_cap)

    out = np.empty(cap, dtype=np.uint8)
    written = call(out, cap)
    if written < 0:
        # exact-size retry; the +16 keeps the 16-byte fast copies legal
        out = np.empty(-written + 16, dtype=np.uint8)
        written = call(out, -written + 16)
        if written < 0:
            return None
    return memoryview(out)[:written]


def _codec(fn_c: str, fn_bound: str, data: bytes) -> Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    cap = int(getattr(lib, fn_bound)(len(src)))
    out = np.empty(max(cap, 16), dtype=np.uint8)
    n = getattr(lib, fn_c)(_ptr(src), len(src), _ptr(out), len(out))
    if n < 0:
        return None
    return out[:n].tobytes()


def lz4_compress(data: bytes) -> Optional[bytes]:
    """LZ4 block format (raw, no frame): SLS's default wire codec."""
    return _codec("lct_lz4_compress", "lct_lz4_bound", data)


def lz4_decompress(data: bytes, raw_size: int) -> Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(max(raw_size, 1), dtype=np.uint8)
    n = lib.lct_lz4_decompress(_ptr(src), len(src), _ptr(out), raw_size)
    if n < 0:
        return None
    return out[:n].tobytes()


def snappy_compress(data: bytes) -> Optional[bytes]:
    """Snappy block format: required by Prometheus remote write."""
    return _codec("lct_snappy_compress", "lct_snappy_bound", data)


def snappy_decompress(data: bytes) -> Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    raw = lib.lct_snappy_uncompressed_len(_ptr(src), len(src))
    if raw < 0:
        return None
    out = np.empty(max(int(raw), 1), dtype=np.uint8)
    n = lib.lct_snappy_decompress(_ptr(src), len(src), _ptr(out), int(raw))
    if n != raw:
        return None
    return out[:n].tobytes()
