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
eight rows a block of 256 threads, and writes one flat i32 tensor
``[4, B, ceil(L / 16)]`` (in_string, structural, escaped, quote).
Importing this module needs no CUDA.
"""

from __future__ import annotations

import ctypes
import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Dict

import torch

from .. import compile_watch
from . import field_extract_cuda as fxc

THREADS = 256                 # kThreads in struct_index.cu
ROWS_PER_BLOCK = THREADS // 32
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
    rows u8 [B, L] and lengths i32 [B] on one CUDA device, contiguous;
    returns the i32 output ``[4, B, ceil(L / 16)]``.  ``events``, a
    (start, end) pair of timing CUDA events when given, is recorded by the
    entry point right around the kernel."""
    dev = rows.device
    if dev.type != "cuda" or lengths.device != dev:
        raise ValueError("struct_index: rows and lengths must lie on one "
                         "CUDA device")
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"struct_index: rows must be u8 [B, L], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    B, L = rows.shape
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError(f"struct_index: lengths must be i32 [{B}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if not (rows.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("struct_index: inputs must be contiguous")
    if mode not in MODES or not 0 <= sep <= 255 or L < 1:
        raise ValueError(f"struct_index: bad mode {mode!r}, separator {sep} "
                         f"or L={L}")
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
