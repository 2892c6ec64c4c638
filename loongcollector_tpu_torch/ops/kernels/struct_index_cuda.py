"""Build, bind and launch the hand-written CUDA structural index (K5).

The kernel (``csrc/struct_index.cu``, its walk in ``csrc/struct_walk.cuh``,
which K7's ``struct_index`` stage shares) is built like K1's
(``field_extract_cuda.compile_library``): ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/kernels/<source hash>/`` (the hash covers the header), loaded with
ctypes; the build and each geometry's first launch are recorded by
``ops/compile_watch.py``.  A build or launch failure raises; nothing here
falls back to the plain version.

One launch (``launch``) runs ``lct_struct_index_cuda``: one warp a row,
eight rows a block of 256 threads, ``L`` up to ``MAX_L``, and writes one
flat i32 tensor ``[4, B, ceil(L / 16)]`` (in_string, structural, escaped,
quote).  Each warp copies its row's bytes below the length into shared
memory first, walks ``ceil(n / 32)`` steps of 32 bytes, and stores each
mask 32 words at a time; ``schedule_twin`` is that schedule in numpy.
Importing this module needs no CUDA.
"""

from __future__ import annotations

import ctypes
import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from .. import compile_watch
from . import field_extract_cuda as fxc

THREADS = 256                 # kThreads in struct_index.cu
ROWS_PER_BLOCK = THREADS // 32
MAX_L = 4096                  # kMaxL: a block's tile is 8 rows of L bytes
MODES = {"json": 0, "delim": 1}   # kStructJson, kStructDelim

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "struct_index.cu")

BUILD_FAMILY = "struct_index_cuda.build"
LAUNCH_FAMILY = "struct_index_cuda.launch"
ENTRY_POINT = "lct_struct_index_cuda"

_PTXAS_KERNEL = re.compile(r"struct_index_kernelILi([01])E")


def words16(L: int) -> int:
    """16-bit words of a row's mask: ceil(L / 16)."""
    return (L + 15) // 16


def _ballot(bits: np.ndarray) -> np.ndarray:
    """[R, 32] booleans as one u32 a row, lane l at bit l."""
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)
            ).sum(axis=1).astype(np.uint32)


def _high_bit(x: np.ndarray) -> np.ndarray:
    """The index of the highest set bit of each nonzero u32 (31 - clz)."""
    return np.floor(np.log2(np.maximum(x, 1).astype(np.float64))
                    ).astype(np.int64)


def _parity(x: np.ndarray) -> np.ndarray:
    """The parity of each u32's set bits (``__popc(x) & 1``)."""
    x = x.astype(np.uint32)
    for sh in (16, 8, 4, 2, 1):
        x = x ^ (x >> np.uint32(sh))
    return x & np.uint32(1)


def schedule_twin(rows: np.ndarray, lengths: np.ndarray, mode: str,
                  sep: int) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's schedule in numpy, step for step: each row (u8 [B, L],
    lengths i32 [B]) walks ``ceil(n / 32)`` steps of 32 bytes (n the length
    cut to [0, L]), reads no byte at or past n, and turns each step's
    per-byte tests into 32-bit ballots with the carried backslash-run and
    in-string parities (``struct_walk.cuh`` ``struct_step``); step s makes
    words 2s and 2s + 1, kept by lanes 2(s % 16) and 2(s % 16) + 1; every
    32 words the lanes store their words, zeros past the walk's end.
    Returns (words i32 [4, B, ceil(L / 16)], steps i64 [B])."""
    rows = np.asarray(rows, np.uint8)
    B, L = rows.shape
    W = words16(L)
    n = np.clip(np.asarray(lengths, np.int64), 0, L)
    steps = (n + 31) // 32
    out = np.zeros((4, B, W), np.int32)
    bs_odd = np.zeros(B, np.uint32)
    in_str = np.zeros(B, np.uint32)
    lane = np.arange(32, dtype=np.int64)
    below_all = ((np.uint64(1) << lane.astype(np.uint64)) - np.uint64(1)
                 ).astype(np.uint32)
    for w0 in range(0, W, 32):
        kw = np.zeros((4, B, 32), np.uint32)
        for s in range(w0 // 2, min(int(steps.max(initial=0)),
                                    (w0 + 32) // 2)):
            live = s < steps                      # rows still walking
            p = 32 * s + lane
            valid = (p[None, :] < n[:, None]) & live[:, None]
            b = np.where(valid, rows[:, np.minimum(p, L - 1)], 0
                         ).astype(np.uint32)
            vmask = _ballot(valid)
            quote = _ballot(valid & (b == ord('"')))
            esc = np.zeros(B, np.uint32)
            if mode == "json":
                bs = _ballot(valid & (b == ord("\\")))
                below = ~bs[:, None] & below_all[None, :]      # [B, 32]
                odd = np.where(
                    below != 0,
                    (lane[None, :] - 1 - _high_bit(below)) & 1,
                    (lane[None, :] + bs_odd[:, None]) & 1)
                esc = _ballot(valid & (b != ord("\\")) & (odd == 1))
                full = bs == np.uint32(0xFFFFFFFF)
                bs_odd = np.where(live & ~full,
                                  (31 - _high_bit(~bs)) & 1,
                                  bs_odd).astype(np.uint32)
                st = _ballot(valid & np.isin(b, [ord(c) for c in "{}[]:,"]))
            else:
                st = _ballot(valid & (b == sep))
            q = quote & ~esc
            x = q.copy()
            for sh in (1, 2, 4, 8, 16):
                x ^= x << np.uint32(sh)
            x = np.where(in_str == 1, ~x, x)
            in_str = np.where(live, in_str ^ _parity(q),
                              in_str).astype(np.uint32)
            ins = x & vmask
            lo = 2 * (s % 16)
            for k, m in enumerate((ins, st & ~ins, esc, q)):
                kw[k, live, lo] = m[live] & 0xFFFF
                kw[k, live, lo + 1] = m[live] >> 16
        w = w0 + np.arange(32)
        keep = w < W
        out[:, :, w[keep]] = kw[:, :, keep].astype(np.int32)
    return out, steps


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """ptxas's registers, stack and spills for each mode's kernel
    (``json``, ``delim``)."""
    names = {v: k for k, v in MODES.items()}
    return fxc.ptxas_report(log, _PTXAS_KERNEL,
                            lambda m: names[int(m.group(1))])


_lib = None
_lib_lock = threading.Lock()
build_log = ""


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library, and
    load both modes' code onto the current device."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so_path, build_log = fxc.compile_library(
            _SRC, "libstruct_index.so", BUILD_FAMILY)
        lib = ctypes.CDLL(so_path)
        vp, i32 = ctypes.c_void_p, ctypes.c_int32
        fn = getattr(lib, ENTRY_POINT)
        fn.restype = ctypes.c_int
        fn.argtypes = [vp, vp, ctypes.c_int64, i32, i32, i32, vp, vp, vp, vp]
        lib.lct_struct_index_error_string.restype = ctypes.c_char_p
        lib.lct_struct_index_error_string.argtypes = [ctypes.c_int]
        lib.lct_struct_index_prepare.restype = ctypes.c_int
        lib.lct_struct_index_prepare.argtypes = []
        rc = lib.lct_struct_index_prepare()
        if rc != 0:
            raise RuntimeError(
                "struct_index: loading the kernels failed: "
                + lib.lct_struct_index_error_string(rc).decode())
        _lib = lib
        return lib


@dataclass(frozen=True)
class LaunchShape:
    """What one launch passed to the C entry point: the mode, the batch,
    and the grid (ceil(B / 8) blocks of 256 threads, a warp a row)."""

    mode: str
    B: int
    L: int
    blocks: int


# launches by shape since the last reset_launch_shapes(), counted in
# launch() once the entry point has launched
launch_shapes: Dict[LaunchShape, int] = {}
_shapes_lock = threading.Lock()


def reset_launch_shapes() -> None:
    with _shapes_lock:
        launch_shapes.clear()


def launch(rows: torch.Tensor, lengths: torch.Tensor, mode: str, sep: int,
           events=None) -> torch.Tensor:
    """One K5 launch on PyTorch's current stream, without a synchronise:
    rows u8 [B, L] (L up to ``MAX_L``) and lengths i32 [B] on one CUDA
    device, contiguous; returns the i32 output ``[4, B, ceil(L / 16)]``.
    ``events``, a (start, end) pair of timing CUDA events when given, is
    recorded by the entry point right around the kernel."""
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"struct_index: rows must be u8 [B, L], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    B, L = rows.shape
    if mode not in MODES or not 0 <= sep <= 255 or not 1 <= L <= MAX_L:
        raise ValueError(f"struct_index: bad mode {mode!r}, separator {sep} "
                         f"or L={L}")
    dev = rows.device
    if dev.type != "cuda" or lengths.device != dev:
        raise ValueError("struct_index: rows and lengths must lie on one "
                         "CUDA device")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError(f"struct_index: lengths must be i32 [{B}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if not (rows.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("struct_index: inputs must be contiguous")
    lib = build()
    shape = LaunchShape(mode, B, L, -(-B // ROWS_PER_BLOCK))
    out = torch.empty((4, B, words16(L)), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev)
    handles = (None, None)
    if events is not None:
        for ev in events:
            ev.record(stream)         # torch makes the event's handle here
        handles = (events[0].cuda_event, events[1].cuda_event)
        if not all(handles):
            raise RuntimeError("struct_index: a timing event has no CUDA "
                               "handle")
    t0 = time.perf_counter()
    rc = getattr(lib, ENTRY_POINT)(
        rows.data_ptr(), lengths.data_ptr(), B, L, MODES[mode], sep,
        out.data_ptr(), stream.cuda_stream, *handles)
    if rc != 0:
        raise RuntimeError("struct_index launch failed: "
                           + lib.lct_struct_index_error_string(rc).decode())
    compile_watch.note_call(LAUNCH_FAMILY, f"{ENTRY_POINT}:{mode}:{B}x{L}",
                            t0)
    with _shapes_lock:
        launch_shapes[shape] = launch_shapes.get(shape, 0) + 1
    return out
