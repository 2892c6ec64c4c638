"""Build, bind and launch the hand-written CUDA DFA walk (K2, K3 and K4).

The kernels (``csrc/dfa_scan.cu``) are built like K1's
(``field_extract_cuda.compile_library``): ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/kernels/<source hash>/``, loaded with ctypes; the build and each
geometry's first launch are recorded by ``ops/compile_watch.py``.  A build
or launch failure raises; nothing here falls back to the plain version.

A launch takes the automaton as two device tables (``AutomatonArrays``):
``t256`` u8 ``[S, 256]`` and ``accept`` i32 ``[S]``, which each block copies
into shared memory, and its first settled state, where a walk stops; K3
also takes each row's span, ``starts`` and ``spanlens`` i32 ``[B]``, and
the automaton's length gate (``dfa_scan.length_gate``: the accepted span
lengths' hull and, where the hull is not exact, their bitmap), which a row
passes before it reads a row byte or a table byte; K4
its skip table (``AutomatonArrays.skip_table``, u64 ``[S]``), copied
beside the other two, from which its walk scans past the bytes that
cannot move a skip state.
``launch_geometry`` picks threads per block so that a batch of at least 32
rows an SM gives every SM a block.  Importing this module needs no CUDA.
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

MAX_THREADS = 128             # kMaxThreads in dfa_scan.cu
MIN_THREADS = 32
MAX_STATES = 128              # kMaxStates: fuse.DEVICE_MAX_STATES

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "dfa_scan.cu")

BUILD_FAMILY = "dfa_scan_cuda.build"
LAUNCH_FAMILY = "dfa_scan_cuda.launch"

# entry point of each kernel, by the wrapper's mode
ENTRY_POINTS = {"match": "lct_dfa_match", "tags": "lct_fused_scan",
                "span": "lct_dfa_span_match"}

# the kernels ptxas reports (``ptxas_report``'s keys)
KERNELS = ("match", "span", "tags")

_PTXAS_KERNEL = re.compile(
    r"dfa_walk_kernel(?:ILb([01])E)?|dfa_span_kernel|fused_scan_kernel")


def smem_bytes(S: int, skip: bool = False) -> int:
    """Dynamic shared memory of one block: t256, then accept; with
    ``skip`` (K4), t256, the u64 skip table, then accept."""
    return S * 256 + (12 if skip else 4) * S


def launch_geometry(B: int) -> int:
    """Threads per block (one row each): 128, halved down to one warp
    while ceil(B / threads) would leave an SM without a block."""
    t = MAX_THREADS
    while t > MIN_THREADS and -(-B // t) < fxc.NUM_SMS:
        t //= 2
    return t


def geometry(mode: str, B: int) -> int:
    """Threads per block of an entry point: ``launch_geometry`` for K2 and
    K3; K4 takes ``MAX_THREADS`` whatever the batch, since after its skip
    a row is a short walk, and a block's table copy, shared by more rows in
    a larger block, is what its time hangs on."""
    return MAX_THREADS if mode == "tags" else launch_geometry(B)


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """ptxas's registers, stack and spills per walker: ``match`` (K2:
    ``dfa_walk_kernel``, in an earlier form ``dfa_walk_kernel<false>``),
    ``span`` (K3) and ``tags`` (K4: ``fused_scan_kernel``, in an earlier
    form ``dfa_walk_kernel<true>``)."""
    return fxc.ptxas_report(
        log, _PTXAS_KERNEL,
        lambda m: ("span" if "span" in m.group(0)
                   else "tags" if m.group(0).startswith("fused")
                   or m.group(1) == "1" else "match"))


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
        so_path, build_log = fxc.compile_library(_SRC, "libdfa_scan.so",
                                                 BUILD_FAMILY)
        lib = ctypes.CDLL(so_path)
        vp, i32 = ctypes.c_void_p, ctypes.c_int32
        for mode, name in ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            # K3: starts, spanlens, then its length gate (lo, hi, bits)
            spans = [vp, vp, i32, i32, vp] if mode == "span" else []
            skip = [vp] if mode == "tags" else []
            fn.argtypes = [vp, vp, ctypes.c_int64, i32, vp, i32, vp, i32,
                           i32, *spans, *skip, vp, i32, i32, vp, vp, vp]
        lib.lct_dfa_error_string.restype = ctypes.c_char_p
        lib.lct_dfa_error_string.argtypes = [ctypes.c_int]
        lib.lct_dfa_prepare.restype = ctypes.c_int
        lib.lct_dfa_prepare.argtypes = []
        rc = lib.lct_dfa_prepare()
        if rc != 0:
            raise RuntimeError("dfa_scan: loading the kernels failed: "
                               + lib.lct_dfa_error_string(rc).decode())
        _lib = lib
        return lib


@dataclass(frozen=True)
class LaunchShape:
    """What one launch passed to the C entry point: the entry point, the
    batch, the automaton's states, threads per block, dynamic shared-memory
    bytes, and the grid, ceil(B / threads) blocks."""

    entry_point: str
    B: int
    L: int
    S: int
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


def launch(mode: str, rows: torch.Tensor, lengths: torch.Tensor,
           t256: torch.Tensor, accept: torch.Tensor, start: int,
           first_settled: int, events=None, spans=None,
           skips=None, gate=None) -> torch.Tensor:
    """One launch of K2 (``mode="match"``, bool ``[B]``), K3
    (``mode="span"``, bool ``[B]``; ``spans`` the (starts, spanlens) i32
    ``[B]`` pair, ``gate`` its length gate ``(lo, hi, bits)``,
    ``DFASpanMatchKernel.gate``: bits an i32 tensor on the device or None)
    or K4 (``mode="tags"``, i32 ``[B]``) on PyTorch's current
    stream, without a synchronise.  rows u8 ``[B, L]``, lengths i32
    ``[B]``, t256 u8 ``[S, 256]`` and accept i32 ``[S]`` on one CUDA
    device, contiguous; states ``first_settled`` and above are settled
    (``S``: none is); K4 also takes ``skips``, the i64 ``[S]`` view of the
    automaton's skip table.  ``events``, a (start, end) pair of timing CUDA
    events when given, is recorded on the stream by the entry point itself,
    right around the kernel."""
    dev = rows.device
    span_args = tuple(spans or ()) if mode == "span" else ()
    if mode == "span" and (len(span_args) != 2 or gate is None):
        raise ValueError("dfa_scan: K3 takes (starts, spanlens) and its "
                         "length gate")
    skip_args = (skips,) if mode == "tags" else ()
    if mode == "tags" and skips is None:
        raise ValueError("dfa_scan: K4 takes its skip table")
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (lengths, t256, accept,
                                           *span_args, *skip_args)):
        raise ValueError("dfa_scan: rows, lengths and tables must lie on "
                         "one CUDA device")
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"dfa_scan: rows must be u8 [B, L], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    B, L = rows.shape
    S = t256.shape[0]
    gate_bits = gate[2] if mode == "span" else None
    if gate_bits is not None and (gate_bits.device != dev
                                  or gate_bits.dtype != torch.int32
                                  or gate_bits.numel() * 32 <= L
                                  or not gate_bits.is_contiguous()):
        raise ValueError(f"dfa_scan: the gate's bitmap must be i32 words "
                         f"over lengths 0..{L} on {dev}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError(f"dfa_scan: lengths must be i32 [{B}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if t256.dtype != torch.uint8 or tuple(t256.shape) != (S, 256) \
            or accept.dtype != torch.int32 or tuple(accept.shape) != (S,) \
            or not 1 <= S <= MAX_STATES or not 0 <= start < S \
            or not 0 <= first_settled <= S:
        raise ValueError(f"dfa_scan: bad tables: t256 {t256.dtype} "
                         f"{tuple(t256.shape)}, accept {accept.dtype} "
                         f"{tuple(accept.shape)}, start {start}, first "
                         f"settled {first_settled}")
    if any(t.dtype != torch.int32 or tuple(t.shape) != (B,)
           for t in span_args):
        raise ValueError(f"dfa_scan: starts and spanlens must be i32 [{B}]")
    if any(t.dtype != torch.int64 or tuple(t.shape) != (S,)
           for t in skip_args):
        raise ValueError(f"dfa_scan: the skip table must be i64 [{S}]")
    if not all(t.is_contiguous() for t in (rows, lengths, t256, accept,
                                           *span_args, *skip_args)):
        raise ValueError("dfa_scan: inputs must be contiguous")
    lib = build()
    entry = ENTRY_POINTS[mode]
    threads = geometry(mode, B)
    shape = LaunchShape(entry, B, L, S, threads,
                        smem_bytes(S, skip=mode == "tags"), -(-B // threads))
    out = torch.empty(B, dtype=torch.int32 if mode == "tags"
                      else torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev)
    handles = (None, None)
    if events is not None:
        for ev in events:
            ev.record(stream)         # torch makes the event's handle here
        handles = (events[0].cuda_event, events[1].cuda_event)
        if not all(handles):
            raise RuntimeError("dfa_scan: a timing event has no CUDA handle")
    t0 = time.perf_counter()
    rc = getattr(lib, entry)(
        rows.data_ptr(), lengths.data_ptr(), B, L, t256.data_ptr(), S,
        accept.data_ptr(), start, first_settled,
        *(t.data_ptr() for t in span_args + skip_args),
        *(() if mode != "span" else (
            gate[0], gate[1],
            None if gate_bits is None else gate_bits.data_ptr())),
        out.data_ptr(),
        shape.threads, shape.smem, stream.cuda_stream, *handles)
    if rc != 0:
        raise RuntimeError(f"dfa_scan launch failed ({entry}): "
                           + lib.lct_dfa_error_string(rc).decode())
    compile_watch.note_call(LAUNCH_FAMILY, f"{entry}:{B}x{L}", t0)
    with _shapes_lock:
        launch_shapes[shape] = launch_shapes.get(shape, 0) + 1
    return out
