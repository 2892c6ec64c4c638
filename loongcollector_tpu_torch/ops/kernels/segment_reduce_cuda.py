"""Build, bind and launch the hand-written CUDA segment reduce (K6).

The kernel (``csrc/segment_reduce.cu``) is built like K1's
(``field_extract_cuda.compile_library``): ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/kernels/<source hash>/``, loaded with ctypes; the build and each
geometry's first launch are recorded by ``ops/compile_watch.py``.  A build
or launch failure raises; nothing here falls back to the plain version.

One launch (``launch``) runs the entry point ``lct_segment_reduce``: an
init kernel writes the empty values over the ``G`` segments, one thread a
row folds the batch in with atomics, and a finalize kernel writes the
last values.  The outputs are one flat i32 tensor (``split_outputs`` in
``segment_reduce.py`` gives the six views).  Importing this module needs
no CUDA.
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

THREADS = 256                 # kThreads in segment_reduce.cu
INIT_BLOCKS_MAX = 8 * fxc.NUM_SMS

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "segment_reduce.cu")

BUILD_FAMILY = "segment_reduce_cuda.build"
LAUNCH_FAMILY = "segment_reduce_cuda.launch"
ENTRY_POINT = "lct_segment_reduce"
KERNELS = ("init", "scatter", "finalize")

_PTXAS_KERNEL = re.compile(r"(init|scatter|finalize)_kernel")


def out_words(G: int, n_hist: int) -> int:
    """Words of the flat output: sum, count, min, max and last ``[G]``,
    then the histogram ``[G, n_hist]``."""
    return 5 * G + G * n_hist


def init_blocks(G: int, n_hist: int) -> int:
    """Blocks of the init kernel's grid-stride loop: one a 256 output
    words, at most eight an SM."""
    return max(1, min(INIT_BLOCKS_MAX, -(-out_words(G, n_hist) // THREADS)))


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """ptxas's registers, stack and spills for each of the three kernels
    (``init``, ``scatter``, ``finalize``)."""
    return fxc.ptxas_report(log, _PTXAS_KERNEL, lambda m: m.group(1))


_lib = None
_lib_lock = threading.Lock()
build_log = ""


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library, and
    load the kernels' code onto the current device."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so_path, build_log = fxc.compile_library(
            _SRC, "libsegment_reduce.so", BUILD_FAMILY)
        lib = ctypes.CDLL(so_path)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.lct_segment_reduce.restype = ctypes.c_int
        lib.lct_segment_reduce.argtypes = [vp, vp, vp, vp, i64, i64, i32, vp,
                                           vp, i32, vp, vp, vp]
        lib.lct_segment_reduce_error_string.restype = ctypes.c_char_p
        lib.lct_segment_reduce_error_string.argtypes = [ctypes.c_int]
        lib.lct_segment_reduce_prepare.restype = ctypes.c_int
        lib.lct_segment_reduce_prepare.argtypes = []
        rc = lib.lct_segment_reduce_prepare()
        if rc != 0:
            raise RuntimeError(
                "segment_reduce: loading the kernels failed: "
                + lib.lct_segment_reduce_error_string(rc).decode())
        _lib = lib
        return lib


@dataclass(frozen=True)
class LaunchShape:
    """What one launch passed to the C entry point: the batch, segments,
    histogram buckets, and the blocks of the init and scatter grids (256
    threads a block)."""

    B: int
    G: int
    n_hist: int
    init_blocks: int
    blocks: int


# launches by shape since the last reset_launch_shapes(), counted in
# launch() once the entry point has launched
launch_shapes: Dict[LaunchShape, int] = {}
_shapes_lock = threading.Lock()


def reset_launch_shapes() -> None:
    with _shapes_lock:
        launch_shapes.clear()


def launch(values: torch.Tensor, seg: torch.Tensor, buckets: torch.Tensor,
           valid: torch.Tensor, G: int, n_hist: int,
           events=None) -> torch.Tensor:
    """One K6 launch on PyTorch's current stream, without a synchronise.
    values f32, seg i32, buckets i32 and valid bool, each ``[B]``, on one
    CUDA device, contiguous; returns the flat i32 output of
    ``out_words(G, n_hist)`` words.  ``events``, a (start, end) pair of
    timing CUDA events when given, is recorded on the stream by the entry
    point itself, right around the kernels."""
    dev = values.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (seg, buckets, valid)):
        raise ValueError("segment_reduce: values, seg, buckets and valid "
                         "must lie on one CUDA device")
    if values.dtype != torch.float32 or values.dim() != 1:
        raise ValueError(f"segment_reduce: values must be f32 [B], got "
                         f"{values.dtype} {tuple(values.shape)}")
    B = values.shape[0]
    for name, t, dt in (("seg", seg, torch.int32),
                        ("buckets", buckets, torch.int32),
                        ("valid", valid, torch.bool)):
        if t.dtype != dt or tuple(t.shape) != (B,):
            raise ValueError(f"segment_reduce: {name} must be {dt} [{B}], "
                             f"got {t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (values, seg, buckets, valid)):
        raise ValueError("segment_reduce: inputs must be contiguous")
    if G < 1 or n_hist < 1 or B >= 2 ** 31:
        raise ValueError(f"segment_reduce: bad geometry B={B} G={G} "
                         f"n_hist={n_hist}")
    lib = build()
    shape = LaunchShape(B, G, n_hist, init_blocks(G, n_hist),
                        -(-B // THREADS))
    out = torch.empty(out_words(G, n_hist), dtype=torch.int32, device=dev)
    last = torch.empty(G, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev)
    handles = (None, None)
    if events is not None:
        for ev in events:
            ev.record(stream)         # torch makes the event's handle here
        handles = (events[0].cuda_event, events[1].cuda_event)
        if not all(handles):
            raise RuntimeError("segment_reduce: a timing event has no CUDA "
                               "handle")
    t0 = time.perf_counter()
    rc = lib.lct_segment_reduce(
        values.data_ptr(), seg.data_ptr(), buckets.data_ptr(),
        valid.data_ptr(), B, G, n_hist, out.data_ptr(), last.data_ptr(),
        shape.init_blocks, stream.cuda_stream, *handles)
    if rc != 0:
        raise RuntimeError("segment_reduce launch failed: "
                           + lib.lct_segment_reduce_error_string(rc).decode())
    compile_watch.note_call(LAUNCH_FAMILY, f"{ENTRY_POINT}:{B}x{G}x{n_hist}",
                            t0)
    with _shapes_lock:
        launch_shapes[shape] = launch_shapes.get(shape, 0) + 1
    return out
