"""Tier-2 DFA execution (K2, K3 and K4): plain PyTorch versions and their
kernel wrappers.

The JAX package runs these as XLA programs (``loongcollector_tpu/ops/
kernels/dfa_scan.py``): K2 ``build_dfa_match_fn`` (one DFA, bool per row),
K3 ``build_dfa_span_match_fn`` (K2 over a row-relative span of each row)
and K4 ``build_fused_scan_fn`` (a fused multi-accept DFA, a u32 accept-tag
mask per row carried as i32).  Each computes one table walk per row,
``state = start; for p < length: state = δ(state, class(row[p]))``, and
reads ``accepting[state]`` or ``accept_tags[state]``; positions at or past
the length leave the state alone, so a padding row gives the start
state's value.  K3 walks only the positions of ``[start, start + spanlen)``
below the length (the reference's ``inside``) and never matches a row whose
``spanlen`` is negative (an absent capture): it is the span condition of
the fused stage program (K7, ``ops/fused_pipeline.py``) and that
condition's per-stage twin.

``automaton_arrays_from_reference`` folds an automaton's
``byte_class``/``transitions`` (the port's ``DFA``/``FusedDFA`` or the
reference's, as numpy) into the kernel inputs: the byte-indexed table
``t256`` u8 ``[S, 256]`` and ``accept`` i32 ``[S]``, with the states
renumbered so that the *settled* ones (``settled_states``: every state
reachable from them has their accept value, so no later byte can change a
walk's result) take the highest ids, from ``first_settled`` on.  The
kernels stop a walk at the first settled state; state ids never leave a
kernel, so the result is the same under any numbering.  ``walk_plain`` is
the lockstep gather over the ``L`` columns (the reference's
``fuse._scan_numpy`` on tensors), with no exit: what the tests and
``--cpu`` run.

``DFAMatchKernel``, ``DFASpanMatchKernel`` (and ``LazySpanMatchKernel``,
built at its first call) and ``FusedScanKernel`` are the surfaces callers
use: a CPU tensor takes the plain version, a CUDA tensor launches the
hand-written kernel (``dfa_scan_cuda``, source ``csrc/dfa_scan.cu``) and
counts it in ``launches`` — or raises.  ``run_chunks`` is the synchronous
chunked dispatch the engine's ``match_batch`` and ``FusedSetExec.classify``
share:
rows packed by ``device_batch.pack_rows`` into pinned buffers of its own
(not ring slots), copied on the worker's current stream, and the host
waiting on its own event only, never on the whole device.  While the
dispatch timeline (``ops/xprof.py``) is on, each batch is a dispatch of its
own there, program ``dfa_match`` or ``fused_scan``, with h2d, exec and d2h
legs; the exec events are recorded by the kernel's entry point right
around the launch.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import xprof
from ..device_batch import (LENGTH_BUCKETS, MAX_BATCH, pack_rows, pad_batch,
                            pick_length_bucket)


TABLE_MAX_STATES = 256        # u8 state ids in t256; the kernel takes 128
MAX_ESCAPES = 4               # escape bytes of a skip state (K4's scan)


@dataclass(frozen=True)
class AutomatonArrays:
    """The kernel's inputs for one automaton."""

    t256: np.ndarray          # u8 [S, 256]: next state by (state, byte)
    accept: np.ndarray        # i32 [S]: 0/1 (K2) or the u32 tags as i32 (K4)
    start: int
    first_settled: int        # states from here up are settled (S: none)
    # u32 [S]: a skip state's escape bytes (K4); i32 [S]: how many, 0 for
    # a state that is not one (none given: no skip state)
    escapes: Optional[np.ndarray] = None
    n_escapes: Optional[np.ndarray] = None

    def __post_init__(self):
        S = self.t256.shape[0]
        if self.escapes is None:
            object.__setattr__(self, "escapes", np.zeros(S, np.uint32))
        if self.n_escapes is None:
            object.__setattr__(self, "n_escapes", np.zeros(S, np.int32))

    @property
    def num_states(self) -> int:
        return self.t256.shape[0]

    def skip_table(self) -> np.ndarray:
        """u64 [S], what K4 reads a state's skip from: ``n_escapes << 32
        | escapes`` (0 for a state that is not a skip state)."""
        return (self.n_escapes.astype(np.uint64) << np.uint64(32)) \
            | self.escapes.astype(np.uint64)


def settled_states(t256: np.ndarray, accept: np.ndarray) -> np.ndarray:
    """bool [S]: the states from which every reachable state (the state
    itself included) has the state's accept value — for K4 the same u32 tag
    mask.  The greatest fixed point of "every successor has my value and
    is settled"."""
    succ = np.asarray(t256, dtype=np.int64)
    acc = np.asarray(accept)
    same = (acc[succ] == acc[:, None]).all(axis=1)
    settled = same
    while True:
        nxt = same & settled[succ].all(axis=1)
        if (nxt == settled).all():
            return settled
        settled = nxt


def skip_escapes(t256: np.ndarray, first_settled: int):
    """(escapes u32 [S], n_escapes i32 [S]) of K4's skip: the escape set
    of a state s is ``E(s) = {b : t256[s, b] != s}``; a state below
    ``first_settled`` with 1 to ``MAX_ESCAPES`` escape bytes is a skip
    state, and gets them packed lowest byte first (the first repeated into
    the unused bytes, so four compares match escape bytes alone whatever
    the count) and their count.  Every other state gets 0 and 0.  A walk in a skip state
    leaves it only on an escape byte, so K4 may scan for the next one."""
    t = np.asarray(t256, dtype=np.int64)
    S = t.shape[0]
    moves = t != np.arange(S)[:, None]
    count = moves.sum(axis=1)
    skip = (np.arange(S) < first_settled) & (count >= 1) \
        & (count <= MAX_ESCAPES)
    escapes = np.zeros(S, np.uint32)
    for s in np.nonzero(skip)[0]:
        esc = np.nonzero(moves[s])[0].tolist()
        esc += esc[:1] * (MAX_ESCAPES - len(esc))
        escapes[s] = sum(b << (8 * k) for k, b in enumerate(esc))
    return escapes, np.where(skip, count, 0).astype(np.int32)


def settled_last(t256: np.ndarray, accept: np.ndarray,
                 start: int) -> AutomatonArrays:
    """The automaton with its settled states renumbered to the highest ids
    (the others keep their order, then the settled ones theirs), and
    ``first_settled`` the first of them; its skip states' escape bytes
    (``skip_escapes``) under the new ids."""
    settled = settled_states(t256, accept)
    order = np.concatenate([np.nonzero(~settled)[0], np.nonzero(settled)[0]])
    new_id = np.empty(len(order), np.int64)
    new_id[order] = np.arange(len(order))
    t256 = np.ascontiguousarray(new_id[t256[order]].astype(np.uint8))
    first_settled = int((~settled).sum())
    return AutomatonArrays(t256, np.ascontiguousarray(accept[order]),
                           int(new_id[start]), first_settled,
                           *skip_escapes(t256, first_settled))


def automaton_arrays_from_reference(byte_class, transitions, start,
                                    accept) -> AutomatonArrays:
    """Kernel inputs from an automaton's arrays (either package's ``DFA``
    — ``accept`` its bool ``accepting`` — or ``FusedDFA`` — ``accept`` its
    u32 ``accept_tags``), its settled states last (``settled_last``).  The
    kernel's own cap on states (``dfa_scan_cuda.MAX_STATES``) is checked at
    launch."""
    byte_class = np.asarray(byte_class, dtype=np.int64)
    transitions = np.asarray(transitions, dtype=np.int64)
    accept = np.asarray(accept)
    S = transitions.shape[0]
    if byte_class.shape != (256,) or not 1 <= S <= TABLE_MAX_STATES \
            or accept.shape != (S,) or not 0 <= int(start) < S \
            or transitions.min() < 0 or transitions.max() >= S:
        raise ValueError(f"dfa_scan: automaton of {S} states outside the "
                         f"table's 1..{TABLE_MAX_STATES} or malformed")
    t256 = np.ascontiguousarray(transitions[:, byte_class].astype(np.uint8))
    if accept.dtype == bool:
        acc = accept.astype(np.int32)
    else:
        acc = accept.astype(np.uint32).view(np.int32)
    return settled_last(t256, acc, int(start))


def settle_points(arrays: AutomatonArrays, rows: np.ndarray,
                  lengths: np.ndarray) -> np.ndarray:
    """i64 [B]: the bytes each row's walk needs with the settled exit —
    the position after which its state is first settled, else its length
    (clamped to ``[0, L]``).  What a bound counts as the row bytes these
    inputs need."""
    B, L = rows.shape
    lens = np.clip(np.asarray(lengths, np.int64), 0, L)
    state = np.full(B, arrays.start, np.int64)
    need = lens.copy()
    done = np.full(B, arrays.start >= arrays.first_settled)
    need[done] = 0
    for p in range(int(lens.max(initial=0))):
        live = ~done & (lens > p)
        if not live.any():
            break
        state[live] = arrays.t256[state[live], rows[live, p]]
        hit = live & (state >= arrays.first_settled)
        need[hit] = p + 1
        done |= hit
    return need


def _step_graph(t256: np.ndarray) -> np.ndarray:
    """bool [S, S]: some byte leads from state s to state t."""
    t = np.asarray(t256, dtype=np.int64)
    S = t.shape[0]
    g = np.zeros((S, S), bool)
    g[np.repeat(np.arange(S), t.shape[1]), t.reshape(-1)] = True
    return g


def accepted_lengths(arrays: AutomatonArrays, n_max: int) -> np.ndarray:
    """bool [n_max + 1]: whether some walk of exactly n bytes from the
    start ends in a state whose accept value is not 0 — the span lengths
    K3's walk can accept.  Layer by layer: the states n bytes reach, a
    matrix step a layer, and once a layer repeats an earlier one the rest
    repeats with its period."""
    g = _step_graph(arrays.t256).astype(np.int32)
    acc = np.asarray(arrays.accept) != 0
    S = g.shape[0]
    out = np.zeros(n_max + 1, bool)
    reach = np.zeros(S, bool)
    reach[arrays.start] = True
    seen = {}
    for n in range(n_max + 1):
        key = reach.tobytes()
        if key in seen:
            first = seen[key]
            period = n - first
            idx = first + (np.arange(n, n_max + 1) - first) % period
            out[n:] = out[idx]
            return out
        seen[key] = n
        out[n] = (reach & acc).any()
        reach = (reach.astype(np.int32) @ g) > 0
    return out


@dataclass(frozen=True)
class LengthGate:
    """K3's length gate for spans of up to ``n_max`` bytes: a walked
    length n can be accepted only if ``lo <= n <= hi`` (the least and the
    greatest accepted length up to ``n_max``; ``lo > hi`` where none is)
    and, where not every length between them is accepted, bit n of
    ``bits`` (u32 words, bit n of word n // 32) is set; ``bits`` is None
    when the hull is exact."""

    lo: int
    hi: int
    n_max: int
    bits: Optional[np.ndarray]

    def passes(self, n: np.ndarray) -> np.ndarray:
        n = np.asarray(n, np.int64)
        ok = (n >= self.lo) & (n <= self.hi)
        if self.bits is not None:
            word = self.bits[np.clip(n, 0, self.n_max) >> 5]
            ok &= ((word >> (n & 31).astype(np.uint32)) & 1).astype(bool)
        return ok


def length_gate(arrays: AutomatonArrays, n_max: int) -> LengthGate:
    """The gate of ``arrays`` for walked lengths ``0..n_max``: the hull of
    ``accepted_lengths`` and, unless every length inside it is accepted,
    their bitmap."""
    lengths = accepted_lengths(arrays, n_max)
    got = np.nonzero(lengths)[0]
    if not len(got):
        return LengthGate(n_max + 1, -1, n_max, None)
    lo, hi = int(got[0]), int(got[-1])
    if lengths[lo:hi + 1].all():
        return LengthGate(lo, hi, n_max, None)
    padded = np.zeros(-(-(n_max + 1) // 32) * 32, bool)
    padded[:n_max + 1] = lengths
    bits = np.packbits(padded, bitorder="little").view(np.uint32)
    return LengthGate(lo, hi, n_max, bits.copy())


def walk_plain(t256: torch.Tensor, accept: torch.Tensor, start: int,
               rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """accept[final state] per row, i32 [B]: every row advances one byte
    column per step while the column is below its length."""
    B, L = rows.shape
    table = t256.to(torch.int64).reshape(-1)
    lens = lengths.to(torch.int64).clamp(0, L)
    state = torch.full((B,), int(start), dtype=torch.int64,
                       device=rows.device)
    steps = int(lens.max()) if B else 0
    for p in range(steps):
        nxt = table[state * 256 + rows[:, p].to(torch.int64)]
        state = torch.where(lens > p, nxt, state)
    return accept[state]


def span_walk_plain(t256: torch.Tensor, accept: torch.Tensor, start: int,
                    rows: torch.Tensor, lengths: torch.Tensor,
                    starts: torch.Tensor, spanlens: torch.Tensor
                    ) -> torch.Tensor:
    """K3: bool [B], ``accept[final state] != 0`` after the positions of
    ``[starts, starts + max(spanlens, 0))`` below each row's length, and
    ``spanlens >= 0``."""
    B, L = rows.shape
    table = t256.to(torch.int64).reshape(-1)
    lens = lengths.to(torch.int64).clamp(0, L)
    lo = starts.to(torch.int64).clamp(min=0)
    span = spanlens.to(torch.int64)
    hi = torch.minimum(starts.to(torch.int64) + span.clamp(min=0), lens)
    state = torch.full((B,), int(start), dtype=torch.int64,
                       device=rows.device)
    steps = int(hi.max()) if B else 0
    for p in range(steps):
        nxt = table[state * 256 + rows[:, p].to(torch.int64)]
        state = torch.where((lo <= p) & (hi > p), nxt, state)
    return (accept[state] != 0) & (span >= 0)


class _TableWalkKernel:
    """One automaton's walk, dispatched by tensor device (see the module
    docstring).  Runner workers share a wrapper, so the counts are taken
    under a lock."""

    mode = ""
    program = ""              # the dispatch timeline's program name

    def __init__(self, arrays: AutomatonArrays):
        self.arrays = arrays
        self.launches = 0
        self._count_lock = threading.Lock()
        self._tables: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def reset_counts(self) -> None:
        with self._count_lock:
            self.launches = 0

    def tables(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """(t256, accept) on ``device``, uploaded once."""
        got = self._tables.get(device)
        if got is None:
            got = (torch.from_numpy(self.arrays.t256).to(device),
                   torch.from_numpy(self.arrays.accept).to(device))
            got = self._tables.setdefault(device, got)
        return got

    def warm(self, device: torch.device) -> None:
        """Build the kernel library and upload the tables ahead of the
        first batch (no-op for the CPU)."""
        if device.type == "cuda":
            from . import dfa_scan_cuda
            dfa_scan_cuda.build()
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self.tables(device)

    def _epilogue(self, values: torch.Tensor) -> torch.Tensor:
        return values

    def plain(self, rows: torch.Tensor, lengths: torch.Tensor
              ) -> torch.Tensor:
        t256, accept = self.tables(rows.device)
        return self._epilogue(walk_plain(t256, accept, self.arrays.start,
                                         rows, lengths))

    def __call__(self, rows: torch.Tensor, lengths: torch.Tensor,
                 events=None) -> torch.Tensor:
        """``events`` (CUDA only): a (start, end) pair of timing CUDA
        events, recorded right around the kernel."""
        if rows.device.type == "cpu":
            return self.plain(rows, lengths)
        if rows.device.type != "cuda":
            raise ValueError(f"no dfa_scan kernel for {rows.device}")
        t256, accept = self.tables(rows.device)
        out = self._launch(rows, lengths, t256, accept, events)
        with self._count_lock:
            self.launches += 1
        return out

    def _launch(self, rows, lengths, t256, accept, events):
        from . import dfa_scan_cuda
        return dfa_scan_cuda.launch(self.mode, rows, lengths, t256, accept,
                                    self.arrays.start,
                                    self.arrays.first_settled, events)


class DFAMatchKernel(_TableWalkKernel):
    """K2: bool [B], the row fully matches ``dfa``."""

    mode = "match"
    program = "dfa_match"

    def __init__(self, dfa):
        self.dfa = dfa
        super().__init__(automaton_arrays_from_reference(
            dfa.byte_class, dfa.transitions, dfa.start, dfa.accepting))

    def _epilogue(self, values: torch.Tensor) -> torch.Tensor:
        return values != 0


class DFASpanMatchKernel(_TableWalkKernel):
    """K3: bool [B], the row-relative span ``[starts, starts + spanlens)``
    of each row fully matches ``dfa``; a negative ``spanlens`` never
    matches.  The per-stage twin of the fused program's span condition."""

    mode = "span"
    program = "dfa_span_match"

    def __init__(self, dfa):
        self.dfa = dfa
        super().__init__(automaton_arrays_from_reference(
            dfa.byte_class, dfa.transitions, dfa.start, dfa.accepting))

    def plain(self, rows: torch.Tensor, lengths: torch.Tensor,
              starts: torch.Tensor, spanlens: torch.Tensor) -> torch.Tensor:
        t256, accept = self.tables(rows.device)
        return span_walk_plain(t256, accept, self.arrays.start, rows,
                               lengths, starts, spanlens)

    def gate(self, device: torch.device, L: int):
        """(lo, hi, bits) of the length gate (``length_gate``) for spans
        cut at rows of ``L`` bytes: bits a u32 ``[ceil((n_max + 1) / 32)]``
        tensor (as i32) on ``device``, or None where the hull is exact;
        computed once for ``n_max`` = the largest length bucket (or ``L``
        when larger), uploaded once per device."""
        n_max = max(L, LENGTH_BUCKETS[-1])
        key = ("gate", device, n_max)
        got = self._tables.get(key)
        if got is None:
            g = length_gate(self.arrays, n_max)
            bits = None if g.bits is None else torch.from_numpy(
                g.bits.view(np.int32)).to(device)
            got = self._tables.setdefault(key, (g.lo, g.hi, bits))
        return got

    def __call__(self, rows: torch.Tensor, lengths: torch.Tensor,
                 starts: torch.Tensor, spanlens: torch.Tensor,
                 events=None) -> torch.Tensor:
        if rows.device.type == "cpu":
            return self.plain(rows, lengths, starts, spanlens)
        if rows.device.type != "cuda":
            raise ValueError(f"no dfa_scan kernel for {rows.device}")
        from . import dfa_scan_cuda
        t256, accept = self.tables(rows.device)
        out = dfa_scan_cuda.launch(self.mode, rows, lengths, t256, accept,
                                   self.arrays.start,
                                   self.arrays.first_settled, events,
                                   spans=(starts, spanlens),
                                   gate=self.gate(rows.device,
                                                  rows.shape[1]))
        with self._count_lock:
            self.launches += 1
        return out


class LazySpanMatchKernel:
    """A ``DFASpanMatchKernel`` built at its first call: the fused planner
    keeps one as a span condition's per-stage twin, so pipeline init does
    not fold a table that only ``FusedProgramKernel.staged_run`` reads."""

    __slots__ = ("dfa", "_k", "_lock")

    def __init__(self, dfa):
        self.dfa = dfa
        self._k = None
        self._lock = threading.Lock()

    @property
    def kernel(self) -> DFASpanMatchKernel:
        if self._k is None:
            with self._lock:
                if self._k is None:
                    self._k = DFASpanMatchKernel(self.dfa)
        return self._k

    @property
    def launches(self) -> int:
        return self._k.launches if self._k is not None else 0

    def reset_counts(self) -> None:
        if self._k is not None:
            self._k.reset_counts()

    def __call__(self, rows, lengths, starts, spanlens) -> torch.Tensor:
        return self.kernel(rows, lengths, starts, spanlens)


class FusedScanKernel(_TableWalkKernel):
    """K4: i32 [B], the u32 accept-tag mask of each row (view it as u32).
    Its kernel also reads the skip table (``AutomatonArrays.skip_table``)."""

    mode = "tags"
    program = "fused_scan"

    def __init__(self, fdfa):
        super().__init__(automaton_arrays_from_reference(
            fdfa.byte_class, fdfa.transitions, fdfa.start, fdfa.accept_tags))

    def skips(self, device: torch.device) -> torch.Tensor:
        """The skip table, u64 as i64 ``[S]``, on ``device``, uploaded
        once."""
        key = ("skips", device)
        got = self._tables.get(key)
        if got is None:
            got = torch.from_numpy(
                self.arrays.skip_table().view(np.int64)).to(device)
            got = self._tables.setdefault(key, got)
        return got

    def warm(self, device: torch.device) -> None:
        super().warm(device)
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self.skips(device)

    def _launch(self, rows, lengths, t256, accept, events):
        from . import dfa_scan_cuda
        return dfa_scan_cuda.launch(self.mode, rows, lengths, t256, accept,
                                    self.arrays.start,
                                    self.arrays.first_settled, events,
                                    skips=self.skips(rows.device))


def _run_batch(kern: _TableWalkKernel, arena: np.ndarray,
               offsets: np.ndarray, lengths: np.ndarray, L: int,
               device: torch.device) -> np.ndarray:
    """One packed batch through ``kern`` on ``device``; the first
    ``len(offsets)`` results as numpy."""
    n = len(offsets)
    B = pad_batch(n)
    if device.type == "cpu":
        batch = pack_rows(arena, offsets, lengths, L, B)
        return kern(torch.from_numpy(batch.rows),
                    torch.from_numpy(batch.lengths)).numpy()[:n]
    rows_h = torch.empty((B, L), dtype=torch.uint8, pin_memory=True)
    lens_h = torch.empty(B, dtype=torch.int32, pin_memory=True)
    pack_rows(arena, offsets, lengths, L, B,
              out=(rows_h.numpy(), lens_h.numpy(), np.empty(B, np.int32)))
    stream = torch.cuda.current_stream(device)
    xid = xprof.begin_dispatch(rows_h.numel() + 4 * B)
    ev = None
    if xid:
        xprof.annotate(xid, kern.program, f"{B}x{L}")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record(stream)
    rows_d = rows_h.to(device, non_blocking=True)
    lens_d = lens_h.to(device, non_blocking=True)
    if xid:
        ev[1].record(stream)
    out_d = kern(rows_d, lens_d, None if ev is None else ev[2:4])
    out_h = torch.empty(B, dtype=out_d.dtype, pin_memory=True)
    out_h.copy_(out_d, non_blocking=True)
    done = ev[4] if xid else torch.cuda.Event()
    done.record(stream)
    done.synchronize()
    if xid:
        xprof.event_leg(xid, "h2d", ev[0], ev[1])
        xprof.event_leg(xid, "exec", ev[2], ev[3])
        xprof.event_leg(xid, "d2h", ev[3], done)
        xprof.close_dispatch(xid)
    return out_h.numpy()[:n].copy()


def run_chunks(kern: _TableWalkKernel, arena: np.ndarray,
               offsets: np.ndarray, lengths: np.ndarray, idx: np.ndarray,
               device: torch.device, out: np.ndarray) -> int:
    """Rows ``idx`` (each within the largest length bucket) through
    ``kern`` in chunks of ``MAX_BATCH``, each at the smallest bucket that
    holds its longest row; results into ``out[idx]`` (i32 tags land as
    their u32 bit patterns).  Returns the number of batches."""
    batches = 0
    for i in range(0, len(idx), MAX_BATCH):
        chunk = idx[i: i + MAX_BATCH]
        d_len = lengths[chunk]
        L = pick_length_bucket(int(d_len.max())) or LENGTH_BUCKETS[-1]
        res = _run_batch(kern, arena, offsets[chunk], d_len, L, device)
        out[chunk] = res.view(np.uint32) if res.dtype == np.int32 else res
        batches += 1
    return batches
