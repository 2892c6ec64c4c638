"""Build, bind and launch the hand-written CUDA field-extraction kernel.

The counterpart of the JAX package's ``field_extract_pallas.py``.  The
kernel (``csrc/field_extract.cu``) is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, into
``build/kernels/<source hash>/`` at the repo root, and loaded with ctypes.
A build failure raises; nothing here falls back to the plain version.

The kernel's input is one int32 blob packed from the serialized IR
(``ops/regex/native_exec.serialize_program``):

    [0, 32)          header (``_META`` indices below)
    words            the IR words, as serialized
    bitsets [K][8]   class membership, 256 bits per class
    lit_offs, lit_lens
    lit bytes        padded to a whole int32 word

A block holds the blob, its rows and their capture state in shared memory
(``smem_bytes``); ``launch_geometry`` picks the block size for each launch
and ``MAX_PROGRAM_BYTES`` is what is left of the card's budget at the
largest row bucket.  The kernel is instantiated for depth-0 or nested
programs and for no, single or double pivot; the header picks one
(``KernelProgram.entry_point``).  Each instantiation has a second entry
point, ``lct_sharded_extract_*`` (K8, ``launch_stats``): the same walk
over one or more shards of equal size, plus each piece's three counts
(matched, events, bytes; ``stat_pieces``), each written once, nothing
zeroed first.  A program over a limit (captures,
classes, nesting depth, blob size) raises ``KernelUnsupported`` when the
engine is built; the engine then runs the pattern on Python ``re``
(counted and logged).  Importing this module needs no CUDA: only
``build()`` and ``launch()`` touch the toolchain and the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import compile_watch
from ..device_batch import LENGTH_BUCKETS
from ..regex.native_exec import (MAX_CAPS, MAX_CLASSES, NativeUnsupported,
                                 serialize_program)
from ..regex.program import SegmentProgram

MAX_DEPTH = 8                 # kMaxDepth in field_extract.cu
HEADER_WORDS = 32

# launch geometry on the H100 (sm_90)
SMEM_BUDGET = 232_448         # kSmemBudget in field_extract.cu
NUM_SMS = 132
MIN_THREADS, MAX_THREADS = 32, 128   # kMaxThreads in field_extract.cu
ROW_TILE_BYTES = 64 * 1024    # rows a block stages: three blocks fit an SM


def smem_bytes(threads: int, L: int, C: int, pivot: int,
               prog_words: int) -> int:
    """Dynamic shared memory of one block, as field_extract.cu lays it out:
    the program, the row tile at a stride of ceil(L/4) + 1 words, and the
    capture state at a stride of 3C | 1 words (twice for a pivot program,
    whose reverse walk has its own copy)."""
    tile_words = (L + 3) // 4 + 1
    caps = (2 if pivot else 1) * ((3 * C) | 1)
    return 4 * (prog_words + threads * (tile_words + caps))


# what the budget leaves for the program at the largest row bucket, the
# smallest block and the widest state
MAX_PROGRAM_BYTES = SMEM_BUDGET - smem_bytes(
    MIN_THREADS, LENGTH_BUCKETS[-1], MAX_CAPS, 2, 0)


@functools.lru_cache(maxsize=256)
def launch_geometry(B: int, L: int, C: int, pivot: int,
                    prog_words: int) -> Tuple[int, int]:
    """(threads per block, dynamic shared-memory bytes) for one launch.

    A block stages one row per thread.  It starts at 128 rows and halves,
    down to one warp, while its row tile exceeds ROW_TILE_BYTES, while it
    does not fit the budget, or while B would leave an SM without a block.
    Raises ValueError when not even one warp's rows fit (L far above the
    largest bucket)."""
    t = MAX_THREADS
    while t > MIN_THREADS and (
            t * L > ROW_TILE_BYTES
            or smem_bytes(t, L, C, pivot, prog_words) > SMEM_BUDGET
            or -(-B // t) < NUM_SMS):
        t //= 2
    smem = smem_bytes(t, L, C, pivot, prog_words)
    if smem > SMEM_BUDGET:
        raise ValueError(f"field_extract: {smem} bytes of shared memory for "
                         f"{t} rows of {L} bytes > {SMEM_BUDGET}")
    return t, smem

_META = [
    "NCAPS", "PREFIX_OFF", "PREFIX_N", "HAS_P1", "P1_CLS", "P1_MIN",
    "P1_MAX", "P1_LAZY", "SUFFIX_OFF", "SUFFIX_N", "HAS_P2", "P2_CLS",
    "P2_MIN", "P2_MAX", "MID_OFF", "MID_N", "MID_LIT", "MID_FIXED",
    "SPLIT_OFF", "NSPLIT", "MIDEND_OFF", "NMIDEND", "BITS_OFF", "NCLASSES",
    "LOFFS_OFF", "LLENS_OFF", "NLITS", "BLOB_OFF", "BLOB_LEN", "DEPTH",
    "TOTAL",
]
M = {name: i for i, name in enumerate(_META)}

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "field_extract.cu")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
BUILD_ROOT = os.path.join(_REPO_ROOT, "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelUnsupported(NativeUnsupported):
    """The program exceeds a build-time limit of the CUDA kernel."""


@dataclass
class KernelProgram:
    """The packed program blob (int32) and the output width."""

    blob: np.ndarray
    num_caps: int
    depth: int

    @property
    def pivot(self) -> int:
        """0 for no pivot, 1 for a single pivot, 2 for a double pivot."""
        if self.blob[M["HAS_P2"]]:
            return 2
        return int(self.blob[M["HAS_P1"]])

    @property
    def entry_point(self) -> str:
        """The C entry point of the instantiation this program takes."""
        return f"lct_field_extract_d{int(self.depth > 0)}_p{self.pivot}"

    @property
    def stats_entry_point(self) -> str:
        """The same instantiation's K8 entry point (``launch_stats``)."""
        return f"lct_sharded_extract_d{int(self.depth > 0)}_p{self.pivot}"


def _ops_depth(words, lo: int, hi: int) -> int:
    """Deepest Optional_/Alt nesting of the ops in words[lo:hi]."""
    depth = 0
    i = lo
    while i < hi:
        op = int(words[i])
        if op == 0 or op in (3, 4):
            i += 2
        elif op == 1:
            i += 5
        elif op == 2:
            i += 3
        elif op == 5:
            bw = int(words[i + 1])
            depth = max(depth, 1 + _ops_depth(words, i + 2, i + 2 + bw))
            i += 2 + bw
        elif op == 6:
            nb = int(words[i + 1])
            j = i + 2
            for _ in range(nb):
                bw = int(words[j])
                depth = max(depth, 1 + _ops_depth(words, j + 1, j + 1 + bw))
                j += 1 + bw
            i = j
        else:
            raise KernelUnsupported(f"unknown op {op} at word {i}")
    if i != hi:
        raise KernelUnsupported("malformed op stream")
    return depth


def program_arrays_from_reference(words, bitmaps, lit_blob, lit_offs,
                                  lit_lens, num_caps) -> KernelProgram:
    """Pack the serialized IR (the arrays ``serialize_program`` returns, in
    either package) into the kernel's int32 blob, checking every limit."""
    words = np.asarray(words, dtype=np.int32)
    bitmaps = np.asarray(bitmaps, dtype=np.uint8).reshape(-1, 256)
    lit_blob = np.asarray(lit_blob, dtype=np.uint8)
    lit_offs = np.asarray(lit_offs, dtype=np.int32)
    lit_lens = np.asarray(lit_lens, dtype=np.int32)
    num_caps = int(num_caps)
    if not 1 <= num_caps <= MAX_CAPS:
        raise KernelUnsupported(f"{num_caps} captures outside 1..{MAX_CAPS}")
    K = len(bitmaps)
    if K > MAX_CLASSES:
        raise KernelUnsupported(f"{K} classes > {MAX_CLASSES}")
    if words[0] != 1 or words[1] != num_caps:
        raise KernelUnsupported("bad program header")
    hdr = np.zeros(HEADER_WORDS, np.int32)
    base = HEADER_WORDS
    hdr[M["NCAPS"]] = num_caps
    i = 2

    def section(name_off: str, name_n: str) -> Tuple[int, int]:
        nonlocal i
        n = int(words[i])
        hdr[M[name_off]] = base + i + 1
        hdr[M[name_n]] = n
        lo = i + 1
        i += 1 + n
        return lo, lo + n

    def pivot(prefix: str) -> None:
        nonlocal i
        if words[i]:
            hdr[M[f"HAS_{prefix}"]] = 1
            hdr[M[f"{prefix}_CLS"]] = words[i + 1]
            hdr[M[f"{prefix}_MIN"]] = words[i + 2]
            hdr[M[f"{prefix}_MAX"]] = words[i + 3]
            if prefix == "P1":
                hdr[M["P1_LAZY"]] = words[i + 4]
            i += 5
        else:
            i += 1

    spans = [section("PREFIX_OFF", "PREFIX_N")]
    pivot("P1")
    spans.append(section("SUFFIX_OFF", "SUFFIX_N"))
    pivot("P2")
    mid_lo, mid_hi = section("MID_OFF", "MID_N")
    spans.append((mid_lo, mid_hi))
    section("SPLIT_OFF", "NSPLIT")
    section("MIDEND_OFF", "NMIDEND")
    if i != len(words):
        raise KernelUnsupported("trailing program words")
    depth = max(_ops_depth(words, lo, hi) for lo, hi in spans)
    if depth > MAX_DEPTH:
        raise KernelUnsupported(f"nesting depth {depth} > {MAX_DEPTH}")
    if hdr[M["HAS_P2"]]:
        # the boundary literal: the first Lit among the middle ops
        j = mid_lo
        while j < mid_hi and words[j] != 0:
            j += 2
        if j >= mid_hi:
            raise KernelUnsupported("double pivot without a mid literal")
        hdr[M["MID_LIT"]] = words[j + 1]
        hdr[M["MID_FIXED"]] = lit_lens[words[j + 1]]
    hdr[M["DEPTH"]] = depth

    bits = np.packbits(bitmaps.astype(bool), axis=1, bitorder="little")
    bits = np.ascontiguousarray(bits).view(np.uint32).view(np.int32)
    padded = np.zeros((len(lit_blob) + 3) // 4 * 4, np.uint8)
    padded[:len(lit_blob)] = lit_blob
    parts = [hdr, words, bits.reshape(-1), lit_offs, lit_lens,
             padded.view(np.int32)]
    off = 0
    offs = []
    for p in parts:
        offs.append(off)
        off += len(p)
    hdr[M["BITS_OFF"]] = offs[2]
    hdr[M["NCLASSES"]] = K
    hdr[M["LOFFS_OFF"]] = offs[3]
    hdr[M["LLENS_OFF"]] = offs[4]
    hdr[M["NLITS"]] = len(lit_offs)
    hdr[M["BLOB_OFF"]] = offs[5]
    hdr[M["BLOB_LEN"]] = len(lit_blob)
    hdr[M["TOTAL"]] = off
    if off * 4 > MAX_PROGRAM_BYTES:
        raise KernelUnsupported(
            f"program of {off * 4} bytes > {MAX_PROGRAM_BYTES} shared memory")
    return KernelProgram(np.concatenate(parts).astype(np.int32), num_caps,
                         depth)


def program_arrays(program: SegmentProgram) -> KernelProgram:
    """The port's own serialization of ``program``, packed for the kernel."""
    return program_arrays_from_reference(*serialize_program(program))


# -- build ------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()
build_log = ""

# compile_watch families: the nvcc build, and each geometry's first launch
BUILD_FAMILY = "field_extract_cuda.build"
LAUNCH_FAMILY = "field_extract_cuda.launch"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return path


ENTRY_POINTS = [f"lct_field_extract_d{d}_p{p}" for d in (0, 1)
                for p in (0, 1, 2)]
# K8: the same instantiations with the count epilogue
STATS_ENTRY_POINTS = [e.replace("lct_field_extract_", "lct_sharded_extract_")
                      for e in ENTRY_POINTS]


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(src: str = _SRC) -> List[str]:
    """``src`` and every file it includes with ``#include "..."``, resolved
    beside the including file, recursively, each once."""
    out: List[str] = []
    todo = [os.path.abspath(src)]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        with open(path, "rb") as f:
            for m in _INCLUDE.finditer(f.read()):
                todo.append(os.path.join(os.path.dirname(path),
                                         m.group(1).decode()))
    return out


def source_hash(src: str = _SRC) -> str:
    """The build directory's key: the bytes of ``src`` and of the headers it
    includes, and the nvcc flags."""
    h = hashlib.sha256()
    for path in source_files(src):
        h.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def compile_library(src: str, lib_name: str, family: str) -> Tuple[str, str]:
    """``nvcc`` ``src`` into ``build/kernels/<source hash>/<lib_name>``
    unless that library exists; returns (library path, nvcc log).  The
    run is a compile of ``family`` in compile_watch, a library found
    without one a cache hit.  Raises when nvcc is missing or fails."""
    digest = source_hash(src)
    out_dir = os.path.join(BUILD_ROOT, digest)
    so_path = os.path.join(out_dir, lib_name)
    log_path = os.path.join(out_dir, "nvcc.log")
    if os.path.exists(so_path):
        compile_watch.note_hit(family)
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return so_path, log
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, so_path)
    compile_watch.note_compile(family, digest,
                               (time.perf_counter() - t0) * 1e3)
    return so_path, log


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so_path, build_log = compile_library(_SRC, "libfield_extract.so",
                                             BUILD_FAMILY)
        lib = ctypes.CDLL(so_path)
        vp, i32 = ctypes.c_void_p, ctypes.c_int32
        for name in ENTRY_POINTS:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [vp, vp, ctypes.c_int64, i32, vp, i32, vp, vp, vp,
                           i32, i32, vp]
        i64 = ctypes.c_int64
        for name in STATS_ENTRY_POINTS:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [vp, vp, i64, i32, vp, i32, vp, vp, vp, vp, i64,
                           i64, i32, i32, vp]
        lib.lct_cuda_error_string.restype = ctypes.c_char_p
        lib.lct_cuda_error_string.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


_PTXAS_FUNC = re.compile(r"(?:Compiling entry function|Function properties "
                         r"for) '?([\w.$]+)")
# K1's instantiations, and K8's (the count epilogue on); a source from
# before K8 has no third template argument
_PTXAS_KERNEL = re.compile(
    r"field_extract_kernelILb([01])ELi([0-2])E(?:Lb([01])E)?")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def _extract_key(m: "re.Match") -> str:
    stats = "stats_" if m.group(3) == "1" else ""
    return f"{stats}d{m.group(1)}_p{m.group(2)}"


def ptxas_report(log: str, kernel: "re.Pattern" = _PTXAS_KERNEL,
                 key_of=_extract_key) -> Dict[str, Dict[str, int]]:
    """What ``nvcc -Xptxas -v`` reported for each function: registers,
    stack frame and spill bytes.  A function whose mangled name matches
    ``kernel`` is keyed ``key_of(match)`` (here like the entry points:
    ``d0_p0`` = depth 0, no pivot; K8's ``stats_d0_p0``), any other
    function by its mangled name."""
    out: Dict[str, Dict[str, int]] = {}
    key = None
    for ln in log.splitlines():
        m = _PTXAS_FUNC.search(ln)
        if m:
            k = kernel.search(m.group(1))
            key = key_of(k) if k else m.group(1)
            out.setdefault(key, {})
            continue
        if key is None:
            continue
        m = _PTXAS_FRAME.search(ln)
        if m:
            out[key].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = _PTXAS_REGS.search(ln)
        if m:
            out[key]["registers"] = int(m.group(1))
    return out


# -- launch -----------------------------------------------------------------

@dataclass(frozen=True)
class LaunchShape:
    """What one launch passed to the C entry point: the instantiation, the
    batch, threads per block, dynamic shared-memory bytes, and the grid the
    entry point launches, ceil(B / threads) blocks."""

    entry_point: str
    B: int
    L: int
    threads: int
    smem: int
    blocks: int


# launches by shape since the last reset_launch_shapes(), counted in
# launch() once the entry point has launched
launch_shapes: Dict[LaunchShape, int] = {}
_shapes_lock = threading.Lock()


def reset_launch_shapes() -> None:
    with _shapes_lock:
        launch_shapes.clear()


def launch(rows: torch.Tensor, lengths: torch.Tensor, prog: torch.Tensor,
           kprog: KernelProgram, events=None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One kernel launch on PyTorch's current stream (no synchronise).

    rows u8 [B, L] and lengths i32 [B] on one CUDA device, contiguous;
    returns (ok bool [B], cap_off i32 [B, C], cap_len i32 [B, C]), allocated
    on the current stream.  ``events``, a (start, end) pair of CUDA events
    when given, is recorded on the stream right around the entry point's
    call: the dispatch timeline's exec leg.  Each launch is counted in
    ``launch_shapes`` under the geometry it was given, and the first launch
    of each (entry point, B, L) is recorded by ``compile_watch``."""
    ok, off, length, _ = _launch(rows, lengths, prog, kprog, events,
                                 kprog.entry_point, False)
    return ok, off, length


@functools.lru_cache(maxsize=256)
def stat_pieces(B: int, shard_rows: int) -> Tuple[int, int]:
    """(pieces, lcm_rows) of a K8 launch of ``B`` rows in shards of
    ``shard_rows``: a piece is where a warp's 32 rows meet a shard, the
    pieces ordered by first row.  The piece that starts at row r (a
    multiple of 32 or of ``shard_rows``) has index ``ceil(r / 32) + ceil(r
    / shard_rows) - ceil(r / lcm_rows)``, the starts below it; ``lcm_rows``
    is ``min(lcm(32, shard_rows), B)``, which counts the same common
    starts below B.  The number of pieces is that index at r = B."""
    if B == 0:
        return 0, 1
    if shard_rows < 1 or B % shard_rows:
        raise ValueError(f"sharded_extract: B={B} is not a multiple of the "
                         f"shard's {shard_rows} rows")
    lcm_rows = min(math.lcm(32, shard_rows), B)
    n = -(-B // 32) + -(-B // shard_rows) - -(-B // lcm_rows)
    return n, lcm_rows


def piece_starts(B: int, shard_rows: int) -> np.ndarray:
    """i64 [pieces]: the first row of each of K8's pieces, in order: the
    rows below ``B`` that are a multiple of 32 or of ``shard_rows``."""
    starts = np.union1d(np.arange(0, B, 32), np.arange(0, B, shard_rows))
    return starts.astype(np.int64)


def launch_stats(rows: torch.Tensor, lengths: torch.Tensor,
                 prog: torch.Tensor, kprog: KernelProgram, events=None,
                 shard_rows: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """One K8 launch over shards of ``shard_rows`` rows (0: one shard of
    all ``B``): ``launch`` plus the pieces' counts as a fourth output, i64
    [pieces, 3] on the device (``stat_pieces``): matched (rows with ok,
    padding rows included), events (rows with a length above 0) and bytes
    (the sum of the lengths) of each piece, every piece written by the
    kernel, nothing zeroed; ``field_extract.fold_pieces`` sums them per
    shard.  The C entry point launches on the current CUDA device, so the
    rows must lie on it: a launch for another device would write through
    that device's pointers, and raises instead.  Counted in
    ``launch_shapes`` under K8's entry point."""
    if rows.device.type == "cuda" \
            and rows.device.index != torch.cuda.current_device():
        raise ValueError(f"sharded_extract: rows on {rows.device}, but the "
                         f"current device is cuda:"
                         f"{torch.cuda.current_device()}")
    return _launch(rows, lengths, prog, kprog, events,
                   kprog.stats_entry_point, True, shard_rows)


def _launch(rows, lengths, prog, kprog: KernelProgram, events, entry: str,
            with_stats: bool, shard_rows: int = 0):
    if rows.device.type != "cuda" or lengths.device != rows.device \
            or prog.device != rows.device:
        raise ValueError("field_extract: rows, lengths and program must lie "
                         "on one CUDA device")
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"field_extract: rows must be u8 [B, L], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    B, L = rows.shape
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError(f"field_extract: lengths must be i32 [{B}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if not (rows.is_contiguous() and lengths.is_contiguous()
            and prog.is_contiguous()):
        raise ValueError("field_extract: inputs must be contiguous")
    lib = build()
    C = kprog.num_caps
    threads, smem = launch_geometry(B, L, C, kprog.pivot, prog.numel())
    shape = LaunchShape(entry, B, L, threads, smem, -(-B // threads))
    ok = torch.empty(B, dtype=torch.bool, device=rows.device)
    off = torch.empty((B, C), dtype=torch.int32, device=rows.device)
    length = torch.empty((B, C), dtype=torch.int32, device=rows.device)
    args = [rows.data_ptr(), lengths.data_ptr(), B, L, prog.data_ptr(),
            prog.numel(), ok.data_ptr(), off.data_ptr(), length.data_ptr()]
    stats = None
    if with_stats:
        s = shard_rows or max(B, 1)
        n_pieces, lcm_rows = stat_pieces(B, s)
        stats = torch.empty((n_pieces, 3), dtype=torch.int64,
                            device=rows.device)
        args += [stats.data_ptr(), s, lcm_rows]
    stream = torch.cuda.current_stream(rows.device)
    start, end = events if events is not None else (None, None)
    if start is not None:
        start.record(stream)
    t0 = time.perf_counter()
    rc = getattr(lib, entry)(*args, shape.threads, shape.smem,
                             stream.cuda_stream)
    if end is not None:
        end.record(stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           + lib.lct_cuda_error_string(rc).decode())
    compile_watch.note_call(LAUNCH_FAMILY, f"{entry}:{B}x{L}", t0)
    with _shapes_lock:
        launch_shapes[shape] = launch_shapes.get(shape, 0) + 1
    return ok, off, length, stats
