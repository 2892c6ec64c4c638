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

The whole blob sits in shared memory, so its size is a build-time limit
checked here, with the caps/classes limits of the serializer and the
nesting depth of Optional_/Alt.  A program over any limit raises
``KernelUnsupported`` when the engine is built; the engine then runs the
pattern on Python ``re`` (counted and logged).  Importing this module needs
no CUDA: only ``build()`` and ``launch()`` touch the toolchain and the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..regex.native_exec import (MAX_CAPS, MAX_CLASSES, NativeUnsupported,
                                 serialize_program)
from ..regex.program import SegmentProgram

MAX_DEPTH = 8                 # kMaxDepth in field_extract.cu
MAX_PROGRAM_BYTES = 48 * 1024  # static shared-memory budget of one block
HEADER_WORDS = 32

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


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return path


def source_hash() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        out_dir = os.path.join(BUILD_ROOT, source_hash())
        so_path = os.path.join(out_dir, "libfield_extract.so")
        if not os.path.exists(so_path):
            os.makedirs(out_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{build_log}")
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        vp = ctypes.c_void_p
        lib.lct_field_extract.restype = ctypes.c_int
        lib.lct_field_extract.argtypes = [vp, vp, ctypes.c_int64,
                                          ctypes.c_int32, vp, ctypes.c_int32,
                                          vp, vp, vp, vp]
        lib.lct_cuda_error_string.restype = ctypes.c_char_p
        lib.lct_cuda_error_string.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


# -- launch -----------------------------------------------------------------

def launch(rows: torch.Tensor, lengths: torch.Tensor, prog: torch.Tensor,
           kprog: KernelProgram, events: Optional[list] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One kernel launch on PyTorch's current stream (no synchronise).

    rows u8 [B, L] and lengths i32 [B] on one CUDA device, contiguous;
    returns (ok bool [B], cap_off i32 [B, C], cap_len i32 [B, C]).  With
    ``events``, a (start, end) CUDA event pair recorded right around the
    launch is appended to it."""
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
    ok = torch.empty(B, dtype=torch.bool, device=rows.device)
    off = torch.empty((B, C), dtype=torch.int32, device=rows.device)
    length = torch.empty((B, C), dtype=torch.int32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device)
    if events is not None:
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record(stream)
    rc = lib.lct_field_extract(rows.data_ptr(), lengths.data_ptr(), B, L,
                               prog.data_ptr(), prog.numel(), ok.data_ptr(),
                               off.data_ptr(), length.data_ptr(),
                               stream.cuda_stream)
    if events is not None:
        ev[1].record(stream)
        events.append(ev)
    if rc != 0:
        raise RuntimeError("field_extract launch failed: "
                           + lib.lct_cuda_error_string(rc).decode())
    return ok, off, length
