"""Device batch assembly: variable-length events → fixed-geometry tensors.

The hard part of putting a log parser on fixed-shape hardware (SURVEY.md §5.7,
§7): events have arbitrary lengths, XLA wants static shapes.  Strategy:

* row width L is quantised into LENGTH_BUCKETS; an event group picks the
  smallest bucket ≥ its longest event (overlong events are separated out for
  the CPU fallback path);
* batch size B is rounded up to a power of two (≥ MIN_BATCH) with zero-length
  padding rows, so each compiled kernel geometry (program, B, L) is reused;
* packing the arena into [B, L] rows is one vectorised numpy gather — the
  host-side analogue of the reference's single pread into the arena
  (reader/LogFileReader.cpp:1518); spans returned by the kernel are
  row-relative and are mapped back to arena offsets by adding row origins.

loongcolumn contract: ``pack_rows`` consumes (arena, offsets, lengths)
SPAN COLUMNS directly — the exact arrays a ``ColumnarLogs`` group carries
— with NO per-row Python list or bytes intermediary anywhere on the H2D
path (the native gather or the clipped index-matrix fallback read the
arena in place).  The loonglint ``hot-path-materialize`` checker enforces
this for all of ``ops/``: building row objects or lists here would
reintroduce exactly the per-event churn the columnar plane removed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

LENGTH_BUCKETS = (128, 256, 512, 1024, 2048, 4096)
MIN_BATCH = 256
MAX_BATCH = 65536


def pick_length_bucket(max_len: int) -> Optional[int]:
    for b in LENGTH_BUCKETS:
        if max_len <= b:
            return b
    return None  # overlong → CPU fallback


def pad_batch(n: int, min_batch: Optional[int] = None,
              multiple_of: int = 1) -> int:
    """Power-of-two batch size ≥ n, capped at MAX_BATCH (callers must chunk
    inputs larger than MAX_BATCH).  ``min_batch`` lowers the floor below
    the static MIN_BATCH — the width auto-tuner
    (ops/device_stream.WidthAutoTuner) passes its per-length-bucket floor
    here so sparse traffic stops paying 256-row tensors for 8 real rows.

    ``multiple_of`` (loongmesh) rounds the result up to a shard multiple —
    the engine passes ``ShardedKernel.batch_multiple`` so mesh dispatches
    arrive shard-aligned and never pay a host-side realign copy.  A
    power-of-two mesh divides any pow2 B ≥ its size, so this only adds
    rows for odd mesh widths."""
    b = min_batch if min_batch else MIN_BATCH
    while b < n:
        b *= 2
    b = min(b, MAX_BATCH)
    if multiple_of > 1:
        b = max(b, multiple_of)
        if b % multiple_of:
            b += multiple_of - (b % multiple_of)
        if b > MAX_BATCH:
            # the MAX_BATCH cap outranks alignment: take the largest
            # in-cap multiple that still fits n, else plain MAX_BATCH
            # (the sharded kernel's private pad fallback realigns the
            # rare odd-width remainder)
            floor_mult = (MAX_BATCH // multiple_of) * multiple_of
            b = floor_mult if floor_mult >= n else MAX_BATCH
    return b


@dataclass
class DeviceBatch:
    """A packed batch plus the bookkeeping to map results back."""

    rows: np.ndarray          # uint8 [B, L]
    lengths: np.ndarray       # int32 [B] (0 for padding rows)
    origins: np.ndarray       # int32 [B] arena offset of each row's byte 0
    n_real: int               # number of non-padding rows


def pack_rows(arena: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
              L: int, B: Optional[int] = None,
              out: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
              ) -> DeviceBatch:
    """Gather per-event byte rows out of the flat arena.

    arena: uint8 [N]; offsets/lengths: int32 [n].  Events longer than L must
    be filtered out by the caller beforehand.

    ``out=(rows, lengths, origins)`` packs into pre-allocated [B, L]/[B]
    buffers instead of allocating — the streaming batch-ring path
    (ops/device_stream.BatchSlot) reuses the same host pages every
    generation, so the H2D staging side never churns the allocator.
    """
    n = len(offsets)
    if B is None:
        B = pad_batch(n)
    assert n <= B
    offsets = np.asarray(offsets, dtype=np.int64)
    lengths32 = np.asarray(lengths, dtype=np.int32)
    out_rows = None
    if out is not None:
        out_rows, out_lengths, out_origins = out
        assert out_rows.shape == (B, L), (out_rows.shape, B, L)

    from ..native import pack_rows as native_pack
    rows = native_pack(arena, offsets, lengths32, L, B, out=out_rows)
    if rows is None:
        # numpy fallback: index matrix [n, L], clipped so OOB reads land on
        # a valid byte, then tail-zeroed for deterministic padding
        idx = offsets[:, None] + np.arange(L, dtype=np.int64)[None, :]
        np.clip(idx, 0, len(arena) - 1 if len(arena) else 0, out=idx)
        body = arena[idx] if len(arena) else np.zeros((n, L), np.uint8)
        mask = np.arange(L, dtype=np.int32)[None, :] < lengths32[:, None]
        body &= mask.astype(np.uint8) * np.uint8(255)
        if out_rows is not None:
            rows = out_rows
            rows[:n] = body
            rows[n:] = 0
        elif B > n:
            rows = np.concatenate([body, np.zeros((B - n, L), np.uint8)],
                                  axis=0)
        else:
            rows = body
    if out is not None:
        out_lengths[:n] = lengths32
        out_lengths[n:] = 0
        out_origins[:n] = offsets.astype(np.int32)
        out_origins[n:] = 0
        return DeviceBatch(rows=rows, lengths=out_lengths,
                           origins=out_origins, n_real=n)
    if B > n:
        lengths32 = np.concatenate([lengths32, np.zeros(B - n, np.int32)])
        origins = np.concatenate(
            [offsets.astype(np.int32), np.zeros(B - n, np.int32)])
    else:
        origins = offsets.astype(np.int32)
    return DeviceBatch(rows=rows, lengths=lengths32, origins=origins, n_real=n)


def split_by_length(offsets: np.ndarray, lengths: np.ndarray,
                    max_bucket: int = LENGTH_BUCKETS[-1]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (device_idx, overlong_idx) index arrays."""
    lengths = np.asarray(lengths)
    over = lengths > max_bucket
    idx = np.arange(len(lengths))
    return idx[~over], idx[over]
