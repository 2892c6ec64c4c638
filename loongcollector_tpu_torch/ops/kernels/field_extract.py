"""Tier-1 field extraction: the plain PyTorch version and its kernel wrapper.

``build_extract_core`` is the JAX package's ``build_extract_core``
(``loongcollector_tpu/ops/kernels/field_extract.py``) ported op for op to
eager torch tensors: every data-dependent query of the cursor walk is a
masked reduction over the length axis, all per-row state is a ``[B, 1]``
column, and composite ops (optional groups, alternation) run their bodies
over all rows and commit per row with masks.  It is the reference semantics
the CUDA kernel (``csrc/field_extract.cu``) is held bit-exact against, and
it is what runs for tensors on the CPU.

``ExtractKernel`` is the one surface callers use: a CPU tensor takes the
plain version, a CUDA tensor launches the hand-written kernel — or raises.
There is no fallback from one to the other.  ``ExtractKernel.with_stats``
is K8, the sharded parse step of one device (``parallel/mesh.py``): the
same extraction over one or more shards of equal size, and each shard's
three counts, as pieces (``plain_pieces``) that ``fold_pieces`` sums per
shard; ``extract_stats_plain`` is its plain version on one shard.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

from ..regex.program import (INF, Alt, CapEnd, CapStart, FixedSpan, Lit,
                             Optional_, SegmentProgram, Span)
from .field_extract_cuda import piece_starts


def _membership(rows: torch.Tensor, intervals, complement_intervals
                ) -> torch.Tensor:
    """bool [B, L] membership via the cheaper of (intervals, ~complement)."""
    negate = len(complement_intervals) < len(intervals)
    if negate:
        intervals = complement_intervals
    m = None
    for lo, hi in intervals:
        t = (rows == lo) if lo == hi else ((rows >= lo) & (rows <= hi))
        m = t if m is None else (m | t)
    if m is None:                     # empty class: never matches
        m = torch.zeros_like(rows, dtype=torch.bool)
    return ~m if negate else m


class _WalkState:
    """Per-row cursor/match/capture state threaded through the emitter.
    Everything is a [B, 1] column; capture columns start as concrete
    defaults (offset 0, length -1 = absent), so branch merging is a pure
    element-wise select.  `ok` is carried as int32 0/1."""

    __slots__ = ("cur", "ok", "cap_off", "cap_len", "cap_start")

    def __init__(self, cur, ok, ncaps, init_caps: bool = True):
        self.cur = cur
        self.ok = ok
        if init_caps:
            zero = torch.zeros_like(cur)
            absent = torch.full_like(cur, -1)
            self.cap_off = [zero] * ncaps
            self.cap_len = [absent] * ncaps
            self.cap_start = [zero] * ncaps
        else:
            self.cap_off = []
            self.cap_len = []
            self.cap_start = []

    def copy(self) -> "_WalkState":
        st = _WalkState(self.cur, self.ok, 0, init_caps=False)
        st.cap_off = list(self.cap_off)
        st.cap_len = list(self.cap_len)
        st.cap_start = list(self.cap_start)
        return st

    def select(self, mask, taken: "_WalkState", other: "_WalkState") -> None:
        """self := taken where mask else other (element-wise per row)."""
        self.cur = torch.where(mask, taken.cur, other.cur)
        self.ok = torch.where(mask, taken.ok, other.ok)
        self.cap_off = [torch.where(mask, a, b)
                        for a, b in zip(taken.cap_off, other.cap_off)]
        self.cap_len = [torch.where(mask, a, b)
                        for a, b in zip(taken.cap_len, other.cap_len)]
        self.cap_start = [torch.where(mask, a, b)
                          for a, b in zip(taken.cap_start, other.cap_start)]


def _any_row(mask: torch.Tensor) -> torch.Tensor:
    return mask.any(dim=1, keepdim=True)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dim=1, keepdim=True, dtype=torch.int32)


def walk_masks(program: SegmentProgram):
    """Which class masks and literal-shift masks the walk needs."""
    span_classes: set = set()
    count_classes: set = set()
    literals: set = set()

    def collect(ops, reverse=False):
        for op in ops:
            if isinstance(op, Span):
                span_classes.add(op.class_id)
            elif isinstance(op, FixedSpan):
                count_classes.add(op.class_id)
            elif isinstance(op, Lit):
                # reverse-walk literals are stored reversed; the lit_ok map
                # is keyed by the forward spelling (match starting at l)
                literals.add(op.data[::-1] if reverse else op.data)
            elif isinstance(op, Optional_):
                collect(op.body, reverse)
            elif isinstance(op, Alt):
                for b in op.branches:
                    collect(b, reverse)
    collect(list(program.ops))
    if program.suffix_ops:
        collect(list(program.suffix_ops), reverse=True)
    if program.mid_ops:
        collect(list(program.mid_ops))
    if program.pivot is not None:
        count_classes.add(program.pivot.class_id)
    if program.pivot2 is not None:
        count_classes.add(program.pivot2.class_id)
    return span_classes, count_classes, literals


def build_extract_core(program: SegmentProgram):
    """Returns core(rows u8 [B,L], lens i32 [B,1]) ->
    (ok bool [B,1], cap_off i32 [B,C], cap_len i32 [B,C])."""

    ncaps = max(program.num_caps, 1)
    intervals = [c.intervals() for c in program.classes]
    comp_intervals = [c.negated().intervals() for c in program.classes]
    top_ops = list(program.ops)
    suffix_ops = list(program.suffix_ops) if program.suffix_ops else None
    pivot = program.pivot
    pivot2 = program.pivot2
    mid_ops = list(program.mid_ops) if program.mid_ops else None
    mid_end_caps = list(program.mid_end_caps)
    split_caps = list(program.split_caps)
    span_classes, count_classes, literals = walk_masks(program)
    if mid_ops is not None:
        mid_lit = next(op for op in mid_ops if isinstance(op, Lit))
        mid_fixed = len(mid_lit.data)

    def core(rows: torch.Tensor, lens: torch.Tensor):
        B, L = rows.shape
        i32 = torch.int32
        pos = torch.arange(L, dtype=i32, device=rows.device)[None, :]
        valid = pos < lens

        member: Dict[int, torch.Tensor] = {}
        for cid in sorted(span_classes | count_classes):
            member[cid] = _membership(rows, intervals[cid],
                                      comp_intervals[cid]) & valid

        true_col = lens >= 0              # always true
        cur0 = torch.zeros_like(lens)

        lit_ok: Dict[bytes, torch.Tensor] = {}
        for lit in sorted(literals):
            data = np.frombuffer(lit, dtype=np.uint8)
            m = None
            for i, ch in enumerate(data):
                shifted = rows if i == 0 else torch.cat(
                    [rows[:, i:], torch.zeros((B, min(i, L)), dtype=rows.dtype,
                                              device=rows.device)],
                    dim=1)[:, :L]
                t = shifted == int(ch)
                m = t if m is None else (m & t)
            lit_ok[lit] = m if m is not None else (rows == rows)

        def emit(ops, st: _WalkState, active) -> None:
            """Apply ops to st for rows where `active` (bool [B,1])."""
            for op in ops:
                if isinstance(op, Lit):
                    k = len(op.data)
                    hit = _any_row((pos == st.cur) & lit_ok[op.data])
                    new_ok = (st.ok != 0) & hit & (st.cur + k <= lens)
                    st.ok = torch.where(active, new_ok.to(i32), st.ok)
                    st.cur = torch.where(active,
                                         torch.clamp(st.cur + k, max=L),
                                         st.cur)
                elif isinstance(op, Span):
                    m = member[op.class_id]
                    cand = torch.where(~m & (pos >= st.cur), pos, L)
                    end = cand.amin(dim=1, keepdim=True)
                    end = torch.maximum(torch.minimum(end, lens), st.cur)
                    run = end - st.cur
                    new_ok = (st.ok != 0) & (run >= op.min_len)
                    if op.max_len != INF:
                        new_ok = new_ok & (run <= op.max_len)
                    st.ok = torch.where(active, new_ok.to(i32), st.ok)
                    st.cur = torch.where(active, end, st.cur)
                elif isinstance(op, FixedSpan):
                    new_ok = (st.ok != 0) & (st.cur + op.n <= lens)
                    if op.n > 0:
                        inside = (pos >= st.cur) & (pos < st.cur + op.n)
                        cnt = _count(member[op.class_id] & inside)
                        new_ok = new_ok & (cnt == op.n)
                    st.ok = torch.where(active, new_ok.to(i32), st.ok)
                    st.cur = torch.where(active,
                                         torch.clamp(st.cur + op.n, max=L),
                                         st.cur)
                elif isinstance(op, CapStart):
                    st.cap_start[op.cap_id] = torch.where(
                        active, st.cur, st.cap_start[op.cap_id])
                elif isinstance(op, CapEnd):
                    start = st.cap_start[op.cap_id]
                    st.cap_off[op.cap_id] = torch.where(
                        active, start, st.cap_off[op.cap_id])
                    st.cap_len[op.cap_id] = torch.where(
                        active, st.cur - start, st.cap_len[op.cap_id])
                elif isinstance(op, Optional_):
                    before = st.copy()
                    emit(op.body, st, active)
                    take = active & (st.ok != 0)
                    # greedy preference: keep the body where it matched,
                    # revert (skip the group) where it failed
                    merged = _WalkState(st.cur, st.ok, 0, init_caps=False)
                    merged.select(take, st, before)
                    st.cur, st.ok = merged.cur, merged.ok
                    st.cap_off, st.cap_len = merged.cap_off, merged.cap_len
                    st.cap_start = merged.cap_start
                elif isinstance(op, Alt):
                    before = st.copy()
                    chosen_any = cur0
                    result = before.copy()
                    remaining = active & (st.ok != 0)
                    for branch in op.branches:
                        trial = before.copy()
                        emit(branch, trial, remaining)
                        chosen = remaining & (trial.ok != 0)
                        merged = _WalkState(result.cur, result.ok, 0,
                                            init_caps=False)
                        merged.select(chosen, trial, result)
                        result = merged
                        chosen_any = chosen_any | chosen.to(i32)
                        remaining = remaining & ~chosen
                    st.cur = torch.where(active, result.cur, before.cur)
                    st.ok = torch.where(active, chosen_any, before.ok)
                    st.cap_off = result.cap_off
                    st.cap_len = result.cap_len
                    st.cap_start = result.cap_start
                else:  # pragma: no cover
                    raise AssertionError(op)

        def emit_reverse(ops, st: _WalkState, active, floor) -> None:
            """Right-to-left walk: st.cur is the EXCLUSIVE end boundary and
            moves toward 0.  Ops arrive pre-reversed (literal bytes too);
            the original CapEnd (seen first) records the group's right edge
            into cap_start, and CapStart closes it."""
            for op in ops:
                if isinstance(op, Lit):
                    k = len(op.data)
                    fwd = op.data[::-1]
                    start = st.cur - k
                    hit = _any_row((pos == start) & lit_ok[fwd]) & (start >= 0)
                    st.ok = torch.where(active,
                                        ((st.ok != 0) & hit).to(i32), st.ok)
                    st.cur = torch.where(active, torch.clamp(start, min=0),
                                         st.cur)
                elif isinstance(op, Span):
                    m = member[op.class_id]
                    # last non-member strictly below cur → run starts after it
                    cand = torch.where(~m & (pos < st.cur), pos, -1)
                    start = cand.amax(dim=1, keepdim=True) + 1
                    if op.max_len != INF:
                        # bounded-maximal: a finite repeat takes at most
                        # max_len; the bytes below belong to what precedes
                        start = torch.maximum(start, st.cur - op.max_len)
                    # the suffix may not reach below the pivot's minimal end
                    start = torch.maximum(start, floor)
                    start = torch.minimum(torch.clamp(start, min=0), st.cur)
                    run = st.cur - start
                    new_ok = (st.ok != 0) & (run >= op.min_len)
                    st.ok = torch.where(active, new_ok.to(i32), st.ok)
                    st.cur = torch.where(active, start, st.cur)
                elif isinstance(op, FixedSpan):
                    start = st.cur - op.n
                    new_ok = (st.ok != 0) & (start >= 0)
                    if op.n > 0:
                        inside = (pos >= start) & (pos < st.cur)
                        cnt = _count(member[op.class_id] & inside)
                        new_ok = new_ok & (cnt == op.n)
                    st.ok = torch.where(active, new_ok.to(i32), st.ok)
                    st.cur = torch.where(active, torch.clamp(start, min=0),
                                         st.cur)
                elif isinstance(op, CapEnd):
                    # right edge of the group (encountered first in reverse)
                    st.cap_start[op.cap_id] = torch.where(
                        active, st.cur, st.cap_start[op.cap_id])
                elif isinstance(op, CapStart):
                    end = st.cap_start[op.cap_id]
                    st.cap_off[op.cap_id] = torch.where(
                        active, st.cur, st.cap_off[op.cap_id])
                    st.cap_len[op.cap_id] = torch.where(
                        active, end - st.cur, st.cap_len[op.cap_id])
                elif isinstance(op, Optional_):
                    before = st.copy()
                    emit_reverse(op.body, st, active, floor)
                    take = active & (st.ok != 0)
                    merged = _WalkState(st.cur, st.ok, 0, init_caps=False)
                    merged.select(take, st, before)
                    st.cur, st.ok = merged.cur, merged.ok
                    st.cap_off, st.cap_len = merged.cap_off, merged.cap_len
                    st.cap_start = merged.cap_start
                elif isinstance(op, Alt):
                    before = st.copy()
                    chosen_any = cur0
                    result = before.copy()
                    remaining = active & (st.ok != 0)
                    for branch in op.branches:
                        trial = before.copy()
                        emit_reverse(branch, trial, remaining, floor)
                        chosen = remaining & (trial.ok != 0)
                        merged = _WalkState(result.cur, result.ok, 0,
                                            init_caps=False)
                        merged.select(chosen, trial, result)
                        result = merged
                        chosen_any = chosen_any | chosen.to(i32)
                        remaining = remaining & ~chosen
                    st.cur = torch.where(active, result.cur, before.cur)
                    st.ok = torch.where(active, chosen_any, before.ok)
                    st.cap_off = result.cap_off
                    st.cap_len = result.cap_len
                    st.cap_start = result.cap_start
                else:  # pragma: no cover
                    raise AssertionError(op)

        def finish(ok, final: _WalkState):
            off = torch.cat(final.cap_off, dim=1)
            length = torch.cat(final.cap_len, dim=1)
            length = torch.where(ok, length, -1)
            off = torch.where(ok, off, 0)
            return ok, off, length

        all_rows = true_col
        st = _WalkState(cur0, true_col.to(i32), ncaps)
        emit(top_ops, st, all_rows)

        if pivot2 is not None:
            # double pivot: prefix | pivot1 | MID-LITERAL | pivot2 | suffix.
            # Locate the boundary literal inside the gap with a min/max
            # reduce, then verify both pivot regions by masked counts
            fwd_starts = {k: st.cap_start[k] for k in split_caps}
            rst = st.copy()
            rst.cur = lens
            floor = st.cur + pivot.min_len + mid_fixed + pivot2.min_len
            emit_reverse(suffix_ops, rst, all_rows, floor)
            lo1 = st.cur                  # pivot1 start
            hi2 = rst.cur                 # pivot2 exclusive end
            p_lo = lo1 + pivot.min_len
            p_hi = hi2 - mid_fixed - pivot2.min_len
            feasible = lit_ok[mid_lit.data] & (pos >= p_lo) & (pos <= p_hi)
            if pivot.lazy:                # both lazy: first occurrence
                cand = torch.where(feasible, pos, L)
                p = cand.amin(dim=1, keepdim=True)
                found = p < L
            else:                         # both greedy: last occurrence
                cand = torch.where(feasible, pos, -1)
                p = cand.amax(dim=1, keepdim=True)
                found = p >= 0
            p = torch.clamp(p, 0, L)
            # middle ops run on the shared forward state at cur = p: the
            # literal advances the cursor, cap markers record edges
            st.cur = torch.where(found, p, lo1)
            st.ok = st.ok & found.to(i32)
            emit(mid_ops, st, all_rows)
            lo2 = st.cur                  # pivot2 start (= p + |L|)
            run1 = p - lo1
            cnt1 = _count(member[pivot.class_id] & (pos >= lo1) & (pos < p))
            run2 = hi2 - lo2
            cnt2 = _count(member[pivot2.class_id] & (pos >= lo2)
                          & (pos < hi2))
            ok = ((st.ok != 0) & (rst.ok != 0) & found & (hi2 >= lo2)
                  & (cnt1 == run1) & (run1 >= pivot.min_len)
                  & (cnt2 == run2) & (run2 >= pivot2.min_len))
            final = rst
            # caps closed in the MIDDLE were recorded into st after the
            # reverse state was copied — pull them over
            for k in mid_end_caps:
                final.cap_off[k] = st.cap_off[k]
                final.cap_len[k] = st.cap_len[k]
            # split caps: open in prefix/middle (forward left edge), close
            # in the suffix (reverse right edge)
            for k in split_caps:
                left = torch.where(found, st.cap_start[k], fwd_starts[k])
                final.cap_off[k] = left
                final.cap_len[k] = rst.cap_start[k] - left
            return finish(ok, final)

        if pivot is not None:
            # snapshot the forward left edges of split captures BEFORE the
            # reverse walk (its CapEnd reuses cap_start for right edges)
            fwd_starts = {k: st.cap_start[k] for k in split_caps}
            rst = st.copy()
            rst.cur = lens
            emit_reverse(suffix_ops, rst, all_rows, st.cur + pivot.min_len)
            # pivot covers [st.cur, rst.cur): all pivot-class bytes within
            # the span's length bounds
            lo = st.cur
            hi = rst.cur
            run = hi - lo
            cnt = _count(member[pivot.class_id] & (pos >= lo) & (pos < hi))
            ok = (st.ok != 0) & (rst.ok != 0) & (hi >= lo) & (cnt == run)
            ok = ok & (run >= pivot.min_len)
            if pivot.max_len != INF:
                ok = ok & (run <= pivot.max_len)
            final = rst
            for k in split_caps:
                final.cap_off[k] = fwd_starts[k]
                final.cap_len[k] = rst.cap_start[k] - fwd_starts[k]
            return finish(ok, final)

        ok = (st.ok != 0) & (st.cur == lens)
        return finish(ok, st)

    return core


def build_extract_fn(program: SegmentProgram):
    """Returns f(rows u8 [B,L], lengths i32 [B]) ->
    (ok bool [B], cap_off i32 [B,C], cap_len i32 [B,C])."""
    core = build_extract_core(program)

    def extract(rows: torch.Tensor, lengths: torch.Tensor):
        ok, off, length = core(rows, lengths.to(torch.int32)[:, None])
        return ok[:, 0], off, length

    return extract


def plain_counts(ok: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """K8's counts of one shard, i64 [3]: matched (rows with ``ok``,
    padding rows included, as the reference's ``jnp.sum(ok)``), events
    (rows with a length above 0) and bytes (the sum of the lengths)."""
    return torch.stack([ok.sum(dtype=torch.int64),
                        (lengths > 0).sum(dtype=torch.int64),
                        lengths.sum(dtype=torch.int64)])


def extract_stats_plain(rows: torch.Tensor, lengths: torch.Tensor,
                        program) -> Tuple[torch.Tensor, ...]:
    """K8's plain version (reference ``parallel/mesh.py:90-98`` on one
    shard): the plain extraction of ``program`` (a SegmentProgram, or the
    function ``build_extract_fn`` made of one), then ``torch.sum`` for each
    of the three counts.  Returns (ok, cap_off, cap_len, counts i64 [3])."""
    extract = program if callable(program) else build_extract_fn(program)
    ok, off, length = extract(rows, lengths)
    return ok, off, length, plain_counts(ok, lengths)


def plain_pieces(ok: torch.Tensor, lengths: torch.Tensor,
                 shard_rows: int) -> torch.Tensor:
    """K8's pieces, i64 [pieces, 3], from the plain extraction's ``ok``:
    each piece's ``plain_counts``, as differences of running sums."""
    B = ok.shape[0]
    vals = torch.stack([ok.to(torch.int64), (lengths > 0).to(torch.int64),
                        lengths.to(torch.int64)], dim=1)
    run = torch.cat([vals.new_zeros((1, 3)), vals.cumsum(dim=0)])
    ends = torch.from_numpy(np.append(piece_starts(B, shard_rows), B)
                            ).to(ok.device)
    return run[ends[1:]] - run[ends[:-1]]


def fold_pieces(pieces, B: int, shard_rows: int) -> torch.Tensor:
    """The shards' counts, i64 [B / shard_rows, 3], from K8's pieces (a
    host tensor or array [pieces, 3]): each shard's pieces summed."""
    pieces = np.asarray(pieces, np.int64).reshape(-1, 3)
    shard = piece_starts(B, shard_rows) // shard_rows
    out = np.zeros((B // shard_rows, 3), np.int64)
    np.add.at(out, shard, pieces)
    return torch.from_numpy(out)


class ExtractKernel:
    """One compiled program's extraction, dispatched by tensor device.

    ``kernel(rows, lengths)`` with CPU tensors runs the plain version
    (``plain``); with CUDA tensors it launches the hand-written CUDA kernel
    (``field_extract_cuda``) on the current stream and counts the launch in
    ``launches`` — it never falls back.  ``with_stats`` is the same choice
    for K8 (counted in ``stats_launches``).  Several runner workers share
    one engine's kernel, so the counts are taken under a lock.  Device time
    comes from the dispatch timeline (``ops/xprof.py``), not from here."""

    # the wrapper records the exec leg's events right around its launch
    brackets_launch = True

    def __init__(self, program: SegmentProgram, kernel_program=None):
        from . import field_extract_cuda as fxc
        self.program = program
        self.plain = build_extract_fn(program)
        # packed IR (the kernel's input); raises KernelUnsupported when the
        # program exceeds the kernel's build-time limits
        self.kernel_program = (kernel_program if kernel_program is not None
                               else fxc.program_arrays(program))
        self.launches = 0
        self.stats_launches = 0
        self._count_lock = threading.Lock()
        self._device_prog: Dict[torch.device, torch.Tensor] = {}

    @property
    def num_caps(self) -> int:
        return self.program.num_caps

    def reset_counts(self) -> None:
        with self._count_lock:
            self.launches = 0
            self.stats_launches = 0

    def warm(self, device: torch.device) -> None:
        """Build the kernel library and upload the program ahead of the
        first batch (no-op for the CPU)."""
        if device.type == "cuda":
            from . import field_extract_cuda as fxc
            fxc.build()
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self.device_program(device)

    def device_program(self, device: torch.device) -> torch.Tensor:
        prog = self._device_prog.get(device)
        if prog is None:
            prog = torch.from_numpy(self.kernel_program.blob).to(device)
            self._device_prog[device] = prog
        return prog

    def __call__(self, rows: torch.Tensor, lengths: torch.Tensor,
                 events=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``events`` (CUDA only): a (start, end) pair of CUDA events
        recorded right around the launch, the timeline's exec leg."""
        if rows.device.type == "cpu":
            return self.plain(rows, lengths)
        if rows.device.type != "cuda":
            raise ValueError(f"no field_extract kernel for {rows.device}")
        from . import field_extract_cuda as fxc
        out = fxc.launch(rows, lengths, self.device_program(rows.device),
                         self.kernel_program, events)
        with self._count_lock:
            self.launches += 1
        return out

    def with_stats(self, rows: torch.Tensor, lengths: torch.Tensor,
                   events=None, shard_rows: int = 0
                   ) -> Tuple[torch.Tensor, ...]:
        """K8 over shards of ``shard_rows`` rows (0: one shard): (ok,
        cap_off, cap_len, pieces i64 [pieces, 3]), the pieces'
        counts (``fold_pieces`` sums them per shard).  CPU tensors take
        the plain extraction and ``plain_pieces``; CUDA tensors launch
        ``lct_sharded_extract_*`` on the current stream of the current
        device (which must be the rows' device), counted in
        ``stats_launches``."""
        if rows.device.type == "cpu":
            ok, off, length = self.plain(rows, lengths)
            return ok, off, length, plain_pieces(
                ok, lengths, shard_rows or max(rows.shape[0], 1))
        if rows.device.type != "cuda":
            raise ValueError(f"no sharded_extract kernel for {rows.device}")
        from . import field_extract_cuda as fxc
        out = fxc.launch_stats(rows, lengths,
                               self.device_program(rows.device),
                               self.kernel_program, events, shard_rows)
        with self._count_lock:
            self.stats_launches += 1
        return out
