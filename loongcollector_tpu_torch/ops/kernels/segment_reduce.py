"""Segment reduce for the windowed metric rollup (K6): the host twins,
the plain PyTorch version and the kernel wrapper.

The JAX package's module (``loongcollector_tpu/ops/kernels/
segment_reduce.py``) carries three substrates of one batch fold, and the
port keeps all three:

* the **numpy twin** (``fold_batch_numpy``) — the no-native tier and the
  shared reference: vectorised value parsing, the FNV-keyed first-seen
  grouping with an exact re-check, and an ``np.add.at`` fold in row
  order, bit-identical to the native fold.  Copied from the reference
  with its helpers (``hist_bucket``, ``parse_values``, ``_key_matrix``,
  ``_first_seen_ids``, ``BatchFold``), byte for byte in behaviour;
* the **native substrate** (``fold_batch_native``) — ``lct_group_reduce``
  in the repo's host library (``native/``), through the port's bridge;
* the **device substrate** (``SegmentReduceKernel.fold_batch``) — keys,
  value parsing and bucket ids stay on the host in f64 (frexp in f32
  disagrees at powers of two), and the device reduces: values f32 ``[B]``,
  segment ids i32 ``[B]``, bucket ids i32 ``[B]`` and valid bool ``[B]``
  give, per segment of ``Gq``, the f32 sum, the i32 count, min, max, the
  last value in row order and an i32 ``[Gq, n_hist]`` histogram.  ``B`` is
  ``pad_batch(n)`` and ``Gq`` the group count rounded up to a power of two
  of at least 16; padding rows go to segment ``Gq`` and are dropped.

K6 replaces ``build_reduce_fn`` (reference ``segment_reduce.py:362``).
``reduce_plain`` is its op-for-op PyTorch twin (``torch.where`` masks,
``index_add_`` for the sum, count and histogram, ``scatter_reduce_`` with
"amin"/"amax" for the min, max and last index, a gather for the last
value); it runs the CPU tests and ``--cpu``, and on the card it is also
the library yardstick, since those calls compute the program directly.
``SegmentReduceKernel`` sends a CPU tensor to the plain version and a CUDA
tensor to the hand-written kernel (``segment_reduce_cuda``, source
``csrc/segment_reduce.cu``), counted in ``launches``, or raises.  The fold
is synchronous, as the reference's (``jax.device_get``): one pinned
staging buffer up, one launch, one pinned buffer back, and the host waits
on its own event.  While the dispatch timeline (``ops/xprof.py``) is on,
each fold is a dispatch there (program ``segment_reduce``) with h2d, exec
and d2h legs.

Sums accumulate in f32 with atomics in an order that changes from run to
run, so they are held to the reference's own tolerance (rtol = atol =
1e-5, ``scripts/agg_equivalence.py:163``); counts, histograms, group ids
and representative rows are exact, and min, max and last equal the f32 of
the numpy twin's.

A group of more than ``MAX_BATCH`` rows cannot take the device substrate:
``pad_batch`` caps ``B`` there, and the reference's fold fails on the
broadcast.  The port raises a clear error instead; it does not chunk.
"""

from __future__ import annotations

import math
import os
import re
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .. import xprof
from ..device_batch import MAX_BATCH, pad_batch
from ..device_plane import mem_note_alloc, mem_note_free
from ...utils.device import resolve_device

#: metrics.py Histogram geometry applied to metric VALUES: base 1.0
#: (values ≤ 1 land in bucket 0), 40 log2 buckets + the +Inf slot
HIST_BASE = 1.0
N_HIST = 41

#: the strtod-subset value grammar shared with the native plane (see
#: lct_group_reduce): sign, decimal digits with optional fraction and
#: exponent, or inf/infinity.  NaN is invalid BY GRAMMAR — it would make
#: min/max accumulation order-visible across substrates.
_VALUE_RE = re.compile(
    rb"^[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|"
    rb"[iI][nN][fF](?:[iI][nN][iI][tT][yY])?)$")


def hist_bucket(values: np.ndarray, base: float = HIST_BASE,
                n_hist: int = N_HIST) -> np.ndarray:
    """Vectorised metrics.py bucket shape on f64: v <= base (and
    negatives) -> 0, +inf -> the last slot, else ceil(log2(v/base))
    clamped.  Shared by the numpy twin and the device path (bucket ids
    are computed on the host in f64 for all substrates)."""
    v = np.asarray(values, dtype=np.float64)
    m, e = np.frexp(np.where(v > base, v / base, 1.0))
    idx = np.where(m == 0.5, e - 1, e).astype(np.int64)
    idx = np.clip(idx, 0, n_hist - 1)
    idx = np.where(v > base, idx, 0)
    return np.where(np.isinf(v) & (v > 0), n_hist - 1, idx)


#: vector parse only reads this many bytes per span; longer tokens (rare:
#: huge paddings, absurd precision) take the per-row reference path
_VEC_WIDTH = 32
#: ≤ 15 decimal digits ⇒ the mantissa integer is exact in f64 and
#: m / 10^frac is a single correctly-rounded division (Clinger) — the
#: same fast-path argument the native strtod subset uses
_VEC_MAX_DIGITS = 15


def _parse_values_rows(arena: np.ndarray, val_offs: np.ndarray,
                       val_lens: np.ndarray, rows, values: np.ndarray,
                       valid: np.ndarray) -> None:
    """Reference per-row parse of selected rows: the shared grammar regex
    gates, Python float() converts (correctly rounded ⇒ bit-identical to
    the native strtod)."""
    buf = memoryview(np.ascontiguousarray(arena))
    for i in rows:
        ln = int(val_lens[i])
        if ln < 0:
            continue
        off = int(val_offs[i])
        tok = bytes(buf[off:off + ln]).strip(b" \t")
        if not _VALUE_RE.match(tok):
            continue
        values[i] = float(tok)
        valid[i] = True


def parse_values(arena: np.ndarray, val_offs: np.ndarray,
                 val_lens: np.ndarray):
    """(values f64 [n], valid bool [n]) from value text spans.

    The common shape — optional sign, ≤ 15 digits, at most one '.' , no
    exponent — parses VECTORISED: one byte-matrix gather, per-column
    digit folds into an exact int64 mantissa, one correctly-rounded
    division by an exact power of ten.  Clinger's fast-path argument
    makes that bit-identical to Python float(), which the
    scripts/agg_equivalence.py gate asserts against the reference loop.
    Everything else (exponents, inf, over-long, malformed) drops to the
    per-row reference path — the counted exception, not the steady
    state.  Part of the BENCH_r11 device-substrate cliff fix: the per-row
    float() loop priced every twin's fold, not the kernel
    (``LOONG_AGG_PREP=0`` restores the r11 prep for the bench's
    before/after)."""
    n = len(val_offs)
    values = np.zeros(n, dtype=np.float64)
    valid = np.zeros(n, dtype=bool)
    if n == 0:
        return values, valid
    if not _prep_opt_enabled():
        _parse_values_rows(arena, val_offs, val_lens, range(n), values,
                           valid)
        return values, valid
    offs = np.asarray(val_offs, dtype=np.int64)
    lens = np.asarray(val_lens, dtype=np.int64)
    W = min(int(lens.max()), _VEC_WIDTH)
    if W <= 0:
        # nothing with a positive length; empty spans are invalid by
        # grammar, negative lengths are the absent convention
        return values, valid
    arena_hi = max(len(arena) - 1, 0)
    idx = offs[:, None] + np.arange(W, dtype=np.int64)[None, :]
    np.clip(idx, 0, arena_hi, out=idx)
    mat = arena[idx] if len(arena) else np.zeros((n, W), np.uint8)
    inrow = np.arange(W, dtype=np.int64)[None, :] < lens[:, None]
    SPACE = np.uint8(0x20)
    mat = np.where(inrow, mat, SPACE)      # pad reads as trimmable space
    is_sp = (mat == 0x20) | (mat == 0x09)
    nonsp = ~is_sp
    any_ns = nonsp.any(axis=1)
    first = np.argmax(nonsp, axis=1)
    last = W - 1 - np.argmax(nonsp[:, ::-1], axis=1)
    colpos = np.arange(W, dtype=np.int64)[None, :]
    is_digit = (mat >= 0x30) & (mat <= 0x39)
    is_dot = mat == 0x2E
    sign_byte = mat[np.arange(n), first]
    has_sign = (sign_byte == 0x2B) | (sign_byte == 0x2D)
    body_lo = first + has_sign
    within = (colpos >= body_lo[:, None]) & (colpos <= last[:, None])
    digits = np.count_nonzero(is_digit & within, axis=1)
    dots = np.count_nonzero(is_dot & within, axis=1)
    clean = (within & ~(is_digit | is_dot)).sum(axis=1) == 0
    fast = (any_ns & clean & (dots <= 1) & (digits >= 1)
            & (digits <= _VEC_MAX_DIGITS) & (lens <= _VEC_WIDTH)
            & (body_lo <= last))
    # per-column mantissa fold: m = m*10 + d over the token's digit
    # positions (int64-exact: ≤ 15 digits), frac counts digits after the
    # dot — vector ops per COLUMN, never per row
    m = np.zeros(n, dtype=np.int64)
    frac = np.zeros(n, dtype=np.int64)
    seen_dot = np.zeros(n, dtype=bool)
    for c in range(W):
        active = fast & within[:, c]
        d = is_digit[:, c] & active
        m = np.where(d, m * 10 + (mat[:, c].astype(np.int64) - 0x30), m)
        frac = np.where(d & seen_dot, frac + 1, frac)
        seen_dot = seen_dot | (is_dot[:, c] & active)
    v = m.astype(np.float64) / np.power(10.0, frac)
    v = np.where(sign_byte == 0x2D, -v, v)
    values[fast] = v[fast]
    valid[fast] = True
    # rows longer than the window may hide their token past byte W (all
    # leading spaces): they must take the reference path, not "invalid"
    slow = np.nonzero((lens >= 0) & ~fast & (any_ns | (lens > W)))[0]
    if len(slow):
        _parse_values_rows(arena, val_offs, val_lens, slow, values, valid)
    return values, valid


def _key_matrix(arena: np.ndarray, slots: np.ndarray,
                key_offs: np.ndarray, key_lens: np.ndarray):
    """Length-prefixed key bytes as one uint8 matrix [n, W] — the
    vectorised identity the first-seen grouping runs np.unique over.
    The i32 length prefix keeps absent (-1) distinct from empty and
    ("ab","") distinct from ("a","b"); the slot rides as an i64 prefix
    column so window identity is part of the segment key, exactly as in
    the native hash.

    Returns (mat, widths): ``widths`` is the per-key padded column width
    (the batch max per key) — matrix rows are only comparable ACROSS
    batches together with their widths, because the zero padding between
    key segments is width-dependent (the merge-side intern cache keys on
    both)."""
    n, K = key_lens.shape
    parts = [np.ascontiguousarray(slots, dtype="<i8").view(
        np.uint8).reshape(n, 8)]
    arena_hi = max(len(arena) - 1, 0)
    widths = []
    for k in range(K):
        lens = key_lens[:, k]
        parts.append(np.ascontiguousarray(lens, dtype="<i4").view(
            np.uint8).reshape(n, 4))
        m = int(lens.max()) if n else 0
        widths.append(max(m, 0))
        if m > 0:
            idx = key_offs[:, k, None] + np.arange(m, dtype=np.int64)[None, :]
            np.clip(idx, 0, arena_hi, out=idx)
            body = (arena[idx] if len(arena)
                    else np.zeros((n, m), np.uint8))
            mask = np.arange(m, dtype=np.int32)[None, :] < lens[:, None]
            parts.append(np.where(mask, body, 0).astype(np.uint8))
    return np.concatenate(parts, axis=1), tuple(widths)


def _prep_opt_enabled() -> bool:
    """``LOONG_AGG_PREP=0`` restores the r11 host-prep path (per-row
    float() parse + full-byte-matrix np.unique) — the bench's before/after
    comparator for the device-substrate cliff fix."""
    return os.environ.get("LOONG_AGG_PREP") != "0"


def _first_seen_ids_exact(mat: np.ndarray):
    """Reference grouping: np.unique over the whole byte matrix is
    lexicographic, so remap through the argsort of first occurrences to
    match the native assignment order.  This was the BENCH_r11 device
    cliff's dominant term (~107 of 137 ms per 16 k-row fold)."""
    _uniq, first_idx, inv = np.unique(mat, axis=0, return_index=True,
                                      return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    remap = np.empty(len(order), dtype=np.int64)
    remap[order] = np.arange(len(order))
    return remap[np.asarray(inv).reshape(-1)], first_idx[order]


def _first_seen_ids(mat: np.ndarray):
    """(group ids [rows] in first-seen order, representative row per
    group).

    Fast path: a vectorised 64-bit FNV-1a over the matrix columns gives
    one hash per row; np.unique on the [n] u64 vector replaces the
    lexicographic sort of the full byte matrix.  Grouping stays EXACT —
    every row's bytes are compared against its hash-group
    representative's (one gather + one matrix compare); any mismatch (a
    64-bit collision, astronomically rare) falls back to the byte-exact
    reference, so the partition and the first-seen id order are always
    identical to the native assignment."""
    if not _prep_opt_enabled():
        return _first_seen_ids_exact(mat)
    n, W = mat.shape
    if n == 0:
        return _first_seen_ids_exact(mat)
    h = np.full(n, 0xcbf29ce484222325, dtype=np.uint64)
    prime = np.uint64(0x100000001B3)
    for c in range(W):
        h = (h ^ mat[:, c].astype(np.uint64)) * prime
    _uniq, first_idx, inv = np.unique(h, return_index=True,
                                      return_inverse=True)
    inv = np.asarray(inv).reshape(-1)
    rep_rows = first_idx[inv]
    if not np.array_equal(mat, mat[rep_rows]):
        return _first_seen_ids_exact(mat)
    order = np.argsort(first_idx, kind="stable")
    remap = np.empty(len(order), dtype=np.int64)
    remap[order] = np.arange(len(order))
    return remap[inv], first_idx[order]


@dataclass
class BatchFold:
    """One batch's partial fold, identical shape across substrates."""

    group_id: np.ndarray   # i32/i64 [n]; -1 = invalid-value row
    rep_row: np.ndarray    # [G] first row index per group
    sum: np.ndarray        # f64 [G]
    count: np.ndarray      # i64 [G]
    min: np.ndarray        # f64 [G]
    max: np.ndarray        # f64 [G]
    last: np.ndarray       # f64 [G]
    hist: np.ndarray       # i64 [G, N_HIST]
    #: [G, W] uint8 key-matrix rows of the representatives, when the
    #: substrate already gathered them (numpy/device twins): the fold's
    #: hash-key bytes, reusable by the window merge as interning keys so
    #: steady-state batches never rebuild per-group key tuples
    #: (BENCH_r11 device-cliff satellite).  None on the native substrate.
    rep_key_blob: Optional[np.ndarray] = None
    #: per-key padded widths of ``rep_key_blob`` (see _key_matrix): blob
    #: rows are only comparable across batches together with these —
    #: interning on the bytes alone would let two different key tuples
    #: from different-width batches collide
    key_widths: Optional[tuple] = None

    @property
    def n_groups(self) -> int:
        return int(len(self.rep_row))

    @property
    def n_invalid(self) -> int:
        return int(np.count_nonzero(self.group_id < 0))


def fold_batch_numpy(arena: np.ndarray, slots: np.ndarray,
                     key_offs: np.ndarray, key_lens: np.ndarray,
                     val_offs: np.ndarray, val_lens: np.ndarray,
                     hist_base: float = HIST_BASE,
                     n_hist: int = N_HIST) -> BatchFold:
    """The numpy substrate / shared reference (see module docstring)."""
    n = len(slots)
    values, valid = parse_values(arena, val_offs, val_lens)
    group_id = np.full(n, -1, dtype=np.int32)
    vrows = np.nonzero(valid)[0]
    if len(vrows) == 0:
        z = np.zeros(0)
        return BatchFold(group_id, np.zeros(0, np.int32), z,
                         np.zeros(0, np.int64), z, z, z,
                         np.zeros((0, n_hist), np.int64))
    mat, widths = _key_matrix(arena, slots[vrows], key_offs[vrows],
                              key_lens[vrows])
    ids, first = _first_seen_ids(mat)
    group_id[vrows] = ids
    rep_row = vrows[first].astype(np.int32)
    G = int(ids.max()) + 1
    vv = values[vrows]
    sums = np.zeros(G, dtype=np.float64)
    # np.add.at applies adds in index order — the native loop's exact
    # accumulation order, which is what makes sums bit-identical (np.sum
    # style pairwise reduction would not be).  inf + -inf inside one key
    # is legal (sum -> NaN on every substrate): silence the warning
    with np.errstate(invalid="ignore"):
        np.add.at(sums, ids, vv)
    counts = np.bincount(ids, minlength=G).astype(np.int64)
    order = np.argsort(ids, kind="stable")
    sv = vv[order]
    starts = np.searchsorted(ids[order], np.arange(G))
    mins = np.minimum.reduceat(sv, starts)
    maxs = np.maximum.reduceat(sv, starts)
    ends = np.append(starts[1:], len(sv))
    last = sv[ends - 1]
    hist = np.zeros((G, n_hist), dtype=np.int64)
    np.add.at(hist, (ids, hist_bucket(vv, hist_base, n_hist)), 1)
    return BatchFold(group_id, rep_row, sums, counts, mins, maxs, last,
                     hist, rep_key_blob=mat[first], key_widths=widths)


def fold_batch_native(arena: np.ndarray, slots: np.ndarray,
                      key_offs: np.ndarray, key_lens: np.ndarray,
                      val_offs: np.ndarray, val_lens: np.ndarray,
                      hist_base: float = HIST_BASE,
                      n_hist: int = N_HIST) -> Optional[BatchFold]:
    """The native substrate; None when the library is unavailable."""
    from ...native import group_reduce
    res = group_reduce(arena, slots, key_offs, key_lens, val_offs,
                       val_lens, hist_base=hist_base, n_hist=n_hist)
    if res is None:
        return None
    return BatchFold(*res)



# ---------------------------------------------------------------------------
# device substrate


def reduce_plain(values: torch.Tensor, seg: torch.Tensor,
                 buckets: torch.Tensor, valid: torch.Tensor, G: int,
                 n_hist: int) -> Tuple[torch.Tensor, ...]:
    """The reference's ``build_reduce_fn`` on tensors: (sum f32 [G], count
    i32 [G], min f32 [G], max f32 [G], last f32 [G], hist i32 [G, n_hist]).
    A row is dropped when it is not valid or its segment lies outside
    ``[0, G)`` (the reference's out-of-range scatter); the scatters here
    take one more segment, ``G``, for the dropped rows and cut it off.  A
    kept row's histogram count is dropped too when its bucket lies outside
    ``[0, n_hist)``, which the host's bucketing never gives."""
    dev = values.device
    B = values.shape[0]
    seg = seg.to(torch.int64)
    buckets = buckets.to(torch.int64)
    keep = valid & (seg >= 0) & (seg < G)
    seg = torch.where(keep, seg, G)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    sums = torch.zeros(G + 1, dtype=torch.float32, device=dev).index_add_(
        0, seg, torch.where(keep, values, zero))
    cnt = torch.zeros(G + 1, dtype=torch.int32, device=dev).index_add_(
        0, seg, keep.to(torch.int32))
    mins = torch.full((G + 1,), float("inf"), dtype=torch.float32,
                      device=dev).scatter_reduce_(
        0, seg, torch.where(keep, values, inf), "amin", include_self=True)
    maxs = torch.full((G + 1,), float("-inf"), dtype=torch.float32,
                      device=dev).scatter_reduce_(
        0, seg, torch.where(keep, values, -inf), "amax", include_self=True)
    idx = torch.arange(B, dtype=torch.int64, device=dev)
    last_idx = torch.full((G + 1,), -1, dtype=torch.int64,
                          device=dev).scatter_reduce_(
        0, seg, torch.where(keep, idx, -1), "amax", include_self=True)
    # an empty segment gathers the appended zero (a batch may be empty)
    last = torch.cat([values, zero.reshape(1)])[
        torch.where(last_idx >= 0, last_idx, B)]
    in_hist = keep & (buckets >= 0) & (buckets < n_hist)
    hidx = torch.where(in_hist, seg * n_hist + buckets, G * n_hist)
    hist = torch.zeros((G + 1) * n_hist, dtype=torch.int32,
                       device=dev).index_add_(0, hidx,
                                              in_hist.to(torch.int32))
    return (sums[:G], cnt[:G], mins[:G], maxs[:G], last[:G],
            hist[:G * n_hist].view(G, n_hist))


def segment_pad(n_groups: int) -> int:
    """``Gq``: the group count rounded up to a power of two, at least 16
    (reference ``segment_reduce.py:466-469``)."""
    Gq = 16
    while Gq < n_groups:
        Gq *= 2
    return Gq


class BatchTooLarge(ValueError):
    """A fold of more rows than the device substrate takes (``MAX_BATCH``);
    the reference's fold fails there too."""


class SegmentReduceKernel:
    """K6 for one histogram geometry (``n_hist``), dispatched by tensor
    device (see the module docstring).  ``dispatch_count`` counts every
    reduce, ``launches`` the CUDA launches; the rollup's folds and runner
    workers share a kernel, so the counts are taken under a lock.

    Staging buffers are kept per (device, B) and leased out of the pool
    under a lock for one fold (reference ``:491-497``): two pipelines that
    share the module-global kernel never write one buffer at once; a
    buffer returned while the pool holds its geometry is dropped."""

    program = "segment_reduce"

    def __init__(self, n_hist: int = N_HIST):
        self.n_hist = n_hist
        self.dispatch_count = 0
        self.launches = 0
        self._count_lock = threading.Lock()
        self._staging: Dict[Tuple[str, int], torch.Tensor] = {}
        self._staging_lock = threading.Lock()

    def reset_counts(self) -> None:
        with self._count_lock:
            self.dispatch_count = 0
            self.launches = 0

    def plain(self, values, seg, buckets, valid, G: int):
        return reduce_plain(values, seg, buckets, valid, G, self.n_hist)

    def launch_flat(self, values: torch.Tensor, seg: torch.Tensor,
                    buckets: torch.Tensor, valid: torch.Tensor, G: int,
                    events=None) -> torch.Tensor:
        """One K6 launch on CUDA tensors: the kernel's flat i32 output
        (layout in ``segment_reduce_cuda.split_outputs``).  ``events``, a
        (start, end) pair of timing CUDA events, is recorded right around
        the kernel."""
        from . import segment_reduce_cuda
        flat = segment_reduce_cuda.launch(values, seg, buckets, valid, G,
                                          self.n_hist, events)
        with self._count_lock:
            self.dispatch_count += 1
            self.launches += 1
        return flat

    def __call__(self, values: torch.Tensor, seg: torch.Tensor,
                 buckets: torch.Tensor, valid: torch.Tensor, G: int
                 ) -> Tuple[torch.Tensor, ...]:
        """The six outputs of ``reduce_plain`` for ``G`` segments (on CUDA,
        views of the kernel's flat output)."""
        dev = values.device
        if dev.type == "cpu":
            with self._count_lock:
                self.dispatch_count += 1
            return self.plain(values, seg, buckets, valid, G)
        if dev.type != "cuda":
            raise ValueError(f"no segment_reduce kernel for {dev}")
        return split_outputs(
            self.launch_flat(values, seg, buckets, valid, G), G, self.n_hist)

    # -- the fold --------------------------------------------------------

    def _lease(self, device: torch.device, B: int) -> torch.Tensor:
        """A u8 staging tensor of ``13 B`` bytes (values f32, segments i32,
        buckets i32, valid u8), pinned when it feeds a CUDA device.  It
        counts as live in the memory ledger's ``side_arenas`` while leased,
        as a ring slot does."""
        key = (str(device), B)
        with self._staging_lock:
            buf = self._staging.pop(key, None)
        if buf is None:
            buf = torch.empty(13 * B, dtype=torch.uint8,
                              pin_memory=device.type == "cuda")
        mem_note_alloc("side_arenas", buf.numel())
        return buf

    def _release(self, device: torch.device, B: int, buf) -> None:
        mem_note_free("side_arenas", buf.numel())
        with self._staging_lock:
            self._staging.setdefault((str(device), B), buf)

    def _reduce_staged(self, buf: torch.Tensor, B: int, Gq: int,
                       device: torch.device) -> Tuple[np.ndarray, ...]:
        """One reduce of the staged batch on ``device``; the outputs as
        numpy (sum, count, min, max, last, hist)."""
        if device.type == "cpu":
            return tuple(t.numpy() for t in self(*staged_views(buf, B), Gq))
        stream = torch.cuda.current_stream(device)
        xid = xprof.begin_dispatch(buf.numel())
        ev = None
        if xid:
            xprof.annotate(xid, self.program, f"{B}x{Gq}")
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record(stream)
        buf_d = buf.to(device, non_blocking=True)
        if xid:
            ev[1].record(stream)
        flat_d = self.launch_flat(*staged_views(buf_d, B), Gq,
                                  events=None if ev is None else ev[2:4])
        flat_h = torch.empty(flat_d.shape, dtype=flat_d.dtype,
                             pin_memory=True)
        flat_h.copy_(flat_d, non_blocking=True)
        done = ev[4] if xid else torch.cuda.Event()
        done.record(stream)
        done.synchronize()
        if xid:
            xprof.event_leg(xid, "h2d", ev[0], ev[1])
            xprof.event_leg(xid, "exec", ev[2], ev[3])
            xprof.event_leg(xid, "d2h", ev[3], done)
            xprof.close_dispatch(xid)
        return tuple(t.numpy() for t in split_outputs(flat_h, Gq,
                                                      self.n_hist))

    def fold_batch(self, arena: np.ndarray, slots: np.ndarray,
                   key_offs: np.ndarray, key_lens: np.ndarray,
                   val_offs: np.ndarray, val_lens: np.ndarray,
                   hist_base: float = HIST_BASE,
                   device: Union[str, torch.device, None] = None
                   ) -> BatchFold:
        """Device substrate: host keying and bucketing (exact f64), one
        padded segment reduce on ``device`` (the card unless the caller
        asks for the CPU, ``utils.device.resolve_device``)."""
        device = resolve_device(device)
        n_hist = self.n_hist
        keyed = key_fold(arena, slots, key_offs, key_lens, val_offs,
                         val_lens)
        if keyed is None:
            z = np.zeros(0)
            return BatchFold(np.full(len(slots), -1, dtype=np.int32),
                             np.zeros(0, np.int32), z,
                             np.zeros(0, np.int64), z, z, z,
                             np.zeros((0, n_hist), np.int64))
        B, G = keyed.B, keyed.G
        buf = self._lease(device, B)
        try:
            keyed.stage(buf.numpy(), hist_base, n_hist)
            sums, cnt, mins, maxs, last, hist = self._reduce_staged(
                buf, B, keyed.Gq, device)
        finally:
            self._release(device, B, buf)
        return BatchFold(keyed.group_id, keyed.rep_row,
                         sums[:G].astype(np.float64),
                         cnt[:G].astype(np.int64),
                         mins[:G].astype(np.float64),
                         maxs[:G].astype(np.float64),
                         last[:G].astype(np.float64),
                         hist[:G].astype(np.int64),
                         rep_key_blob=keyed.rep_key_blob,
                         key_widths=keyed.key_widths)


@dataclass
class KeyedFold:
    """The device substrate's host half of one fold (reference
    ``segment_reduce.py:440-497``): the rows' f64 values and validity,
    their first-seen group ids (-1 on an invalid row), the groups'
    representative rows and key-matrix rows, and the reduce's padded
    shape, ``B`` rows over ``Gq`` segments for ``G`` groups."""

    values: np.ndarray     # f64 [n]
    valid: np.ndarray      # bool [n]
    group_id: np.ndarray   # i32 [n]
    rep_row: np.ndarray    # i32 [G]
    rep_key_blob: np.ndarray
    key_widths: tuple
    G: int
    B: int
    Gq: int

    def stage(self, buf: np.ndarray, hist_base: float, n_hist: int) -> None:
        """Write K6's inputs into a ``13 B``-byte staging buffer
        (``staged_views``): padding rows go to segment ``Gq``, not valid."""
        n = len(self.values)
        vals, seg, buckets, ok = staged_views(buf, self.B)
        vals[:n] = self.values.astype(np.float32)
        vals[n:] = 0
        seg[:n] = self.group_id.clip(min=0)
        seg[n:] = self.Gq
        ok[:n] = self.valid
        ok[n:] = False
        buckets[:n] = hist_bucket(self.values, hist_base, n_hist)
        buckets[n:] = 0


def key_fold(arena: np.ndarray, slots: np.ndarray, key_offs: np.ndarray,
             key_lens: np.ndarray, val_offs: np.ndarray,
             val_lens: np.ndarray) -> Optional[KeyedFold]:
    """Parse and key one fold's rows for the device substrate; None when
    no row is valid.  A fold of more than ``MAX_BATCH`` rows raises
    ``BatchTooLarge``."""
    n = len(slots)
    if n > MAX_BATCH:
        raise BatchTooLarge(
            f"segment_reduce: a fold of {n} rows exceeds MAX_BATCH "
            f"({MAX_BATCH}); the device substrate takes one batch a "
            f"fold, as the reference's does")
    values, valid = parse_values(arena, val_offs, val_lens)
    vrows = np.nonzero(valid)[0]
    if len(vrows) == 0:
        return None
    group_id = np.full(n, -1, dtype=np.int32)
    mat, widths = _key_matrix(arena, slots[vrows], key_offs[vrows],
                              key_lens[vrows])
    ids, first = _first_seen_ids(mat)
    group_id[vrows] = ids
    G = int(ids.max()) + 1
    return KeyedFold(values, valid, group_id, vrows[first].astype(np.int32),
                     mat[first], widths, G, pad_batch(n), segment_pad(G))


def split_outputs(flat: torch.Tensor, G: int, n_hist: int
                  ) -> Tuple[torch.Tensor, ...]:
    """(sum f32, count i32, min f32, max f32, last f32 ``[G]``, hist i32
    ``[G, n_hist]``) views of K6's flat i32 output, which holds them in
    that order, ``5 G + G n_hist`` words."""
    f32 = flat[:5 * G].view(torch.float32)
    return (f32[:G], flat[G:2 * G], f32[2 * G:3 * G], f32[3 * G:4 * G],
            f32[4 * G:5 * G], flat[5 * G:].view(G, n_hist))


def staged_views(buf, B: int):
    """(values f32, segments i32, buckets i32, valid bool) views, each
    ``[B]``, of one ``13 B``-byte staging buffer (numpy or a u8 tensor)."""
    if isinstance(buf, np.ndarray):
        return (buf[:4 * B].view(np.float32), buf[4 * B:8 * B].view(np.int32),
                buf[8 * B:12 * B].view(np.int32),
                buf[12 * B:13 * B].view(np.bool_))
    return (buf[:4 * B].view(torch.float32), buf[4 * B:8 * B].view(torch.int32),
            buf[8 * B:12 * B].view(torch.int32),
            buf[12 * B:13 * B].view(torch.bool))


_device_kernel: Optional[SegmentReduceKernel] = None
_device_kernel_lock = threading.Lock()


def device_kernel() -> SegmentReduceKernel:
    """The module-global kernel at the default histogram geometry."""
    global _device_kernel
    with _device_kernel_lock:
        if _device_kernel is None:
            _device_kernel = SegmentReduceKernel()
        return _device_kernel


def hist_bucket_scalar(v: float, base: float = HIST_BASE,
                       n_hist: int = N_HIST) -> int:
    """Scalar shape twin for the per-event dict path (exactly the
    vectorised hist_bucket, which itself mirrors metrics.py)."""
    if math.isinf(v) and v > 0:
        return n_hist - 1
    if not v > base:
        return 0
    m, e = math.frexp(v / base)
    idx = e - 1 if m == 0.5 else e
    return min(max(idx, 0), n_hist - 1)
