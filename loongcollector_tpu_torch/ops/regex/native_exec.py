"""Serialize a Tier-1 ``SegmentProgram`` into the flat IR its walkers run.

The port's copy of the JAX package's serializer (``serialize_program``),
without the host ctypes executor.  The IR — ``words``, ``class_bitmaps
[K, 256]``, ``lit_blob``, ``lit_offs``, ``lit_lens`` — is the one the repo's
C++ host walker (``native/loongcollector_native.cpp`` ``lct_t1_exec``)
already runs, and the CUDA kernel's input is packed from it
(``ops/kernels/field_extract_cuda.program_arrays_from_reference``).

Word layout: ``[1, ncaps, len(prefix), prefix..., pivot, len(suffix),
suffix..., pivot2, len(mid), mid..., len(split), split..., len(mid_end),
mid_end...]`` where a pivot is ``[1, class, min, max(-1 = inf), lazy]`` or
``[0]``, and ops are ``0 Lit lit_idx`` · ``1 Span class min max lazy`` ·
``2 FixedSpan class n`` · ``3 CapStart id`` · ``4 CapEnd id`` ·
``5 Optional nwords body`` · ``6 Alt nbranches (nwords body)*``.  Suffix
ops arrive reversed, with their literals stored in forward spelling.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .program import (INF, Alt, CapEnd, CapStart, FixedSpan, Lit, Optional_,
                      SegmentProgram, Span)

MAX_CAPS = 32     # kT1MaxCaps in the C++ executor and the CUDA kernel
MAX_CLASSES = 64  # kT1MaxClasses in the C++ executor and the CUDA kernel


class NativeUnsupported(Exception):
    """Program exceeds the walkers' limits (too many caps or classes)."""


class _LitTable:
    def __init__(self) -> None:
        self._idx: Dict[bytes, int] = {}
        self.blob = bytearray()
        self.offs: List[int] = []
        self.lens: List[int] = []

    def add(self, data: bytes) -> int:
        got = self._idx.get(data)
        if got is not None:
            return got
        idx = len(self.offs)
        self._idx[data] = idx
        self.offs.append(len(self.blob))
        self.lens.append(len(data))
        self.blob.extend(data)
        return idx


def _ser_ops(ops, words: List[int], lits: _LitTable, reverse: bool) -> None:
    for op in ops:
        if isinstance(op, Lit):
            # suffix ops store literal bytes pre-reversed; the walkers
            # compare the FORWARD spelling at (cur - k), so un-reverse here
            data = op.data[::-1] if reverse else op.data
            words.extend([0, lits.add(data)])
        elif isinstance(op, Span):
            words.extend([1, op.class_id, op.min_len,
                          -1 if op.max_len == INF else op.max_len,
                          1 if op.lazy else 0])
        elif isinstance(op, FixedSpan):
            words.extend([2, op.class_id, op.n])
        elif isinstance(op, CapStart):
            words.extend([3, op.cap_id])
        elif isinstance(op, CapEnd):
            words.extend([4, op.cap_id])
        elif isinstance(op, Optional_):
            body: List[int] = []
            _ser_ops(op.body, body, lits, reverse)
            words.extend([5, len(body)])
            words.extend(body)
        elif isinstance(op, Alt):
            words.extend([6, len(op.branches)])
            for branch in op.branches:
                body = []
                _ser_ops(branch, body, lits, reverse)
                words.append(len(body))
                words.extend(body)
        else:  # pragma: no cover
            raise NativeUnsupported(f"op {op!r}")


def serialize_program(program: SegmentProgram
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray, int]:
    """Returns (words i32, class_bitmaps u8 [K,256], lit_blob u8,
    lit_offs i32, lit_lens i32, num_caps)."""
    ncaps = max(program.num_caps, 1)
    if ncaps > MAX_CAPS:
        raise NativeUnsupported(f"{ncaps} captures > {MAX_CAPS}")
    if len(program.classes) > MAX_CLASSES:
        raise NativeUnsupported(
            f"{len(program.classes)} classes > {MAX_CLASSES}")
    lits = _LitTable()
    words: List[int] = [1, ncaps]

    prefix: List[int] = []
    _ser_ops(program.ops, prefix, lits, reverse=False)
    words.append(len(prefix))
    words.extend(prefix)

    if program.pivot is not None:
        p = program.pivot
        words.extend([1, p.class_id, p.min_len,
                      -1 if p.max_len == INF else p.max_len,
                      1 if p.lazy else 0])
    else:
        words.append(0)

    suffix: List[int] = []
    if program.suffix_ops:
        _ser_ops(program.suffix_ops, suffix, lits, reverse=True)
    words.append(len(suffix))
    words.extend(suffix)

    if program.pivot2 is not None:
        p2 = program.pivot2
        words.extend([1, p2.class_id, p2.min_len,
                      -1 if p2.max_len == INF else p2.max_len,
                      1 if p2.lazy else 0])
    else:
        words.append(0)

    mid: List[int] = []
    if program.mid_ops:
        _ser_ops(program.mid_ops, mid, lits, reverse=False)
    words.append(len(mid))
    words.extend(mid)

    words.append(len(program.split_caps))
    words.extend(program.split_caps)
    words.append(len(program.mid_end_caps))
    words.extend(program.mid_end_caps)

    bitmaps = np.stack([c.mask for c in program.classes]).astype(np.uint8) \
        if program.classes else np.zeros((0, 256), np.uint8)
    return (np.array(words, dtype=np.int32),
            np.ascontiguousarray(bitmaps),
            np.frombuffer(bytes(lits.blob) or b"\0", dtype=np.uint8).copy(),
            np.array(lits.offs or [0], dtype=np.int32),
            np.array(lits.lens or [0], dtype=np.int32),
            ncaps)
