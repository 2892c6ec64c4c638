"""Regex engine: tier selection + async batch orchestration.

The single entry point processors use.  Given a pattern and a device, it
picks the execution tier as the reference does (``engine.py:301-331``):
the Tier-1 SEGMENT kernel (K1), else the Tier-2 DFA kernel (K2, when
``compile_dfa`` takes the pattern), else Python ``re``.  It owns geometry
bucketing and row packing, and returns arena-absolute capture spans so
downstream stays zero-copy.

Routes to ``re``, all part of the reference's semantics: rows longer than
``LENGTH_BUCKETS[-1]``; patterns with no device tier; and every
``parse_batch`` of a DFA-tier pattern (K2 gives no captures; logged as the
reference's "capture-needing Tier-2" demotion when the pattern has
groups).  A Tier-1 program over the CUDA kernel's build-time limits also
runs on ``re`` here.  Each is decided once, when the engine is built, and
logged and counted by ``fuse.note_demotion``.  The engine counts the rows
of each route (``re_oversize_rows``, ``re_tier_rows``, ``dfa_re_rows``)
and its device batches (K1's ``device_batches``, K2's ``dfa_batches``),
under a lock: runner workers share one cached engine.

``match_batch`` (reference ``engine.py:587-636``) is the boolean full
match filters and gates call: SEGMENT through ``parse_batch(...).ok``; DFA
through K2 in synchronous chunks of at most ``MAX_BATCH`` rows, with rows
over the largest bucket on ``re``; CPU on ``re``.  The reference's
latency-probe routing of small batches to a host scanner is not ported:
every chunk within the buckets goes to the device.

``parse_batch_async`` (reference ``engine.py:487-551, 637-920``) packs each
chunk of at most ``MAX_BATCH`` rows into a leased ring slot and submits it
through the ``DevicePlane`` under the in-flight byte budget, keeping at
most ``depth`` chunks in flight; ``PendingParse.result()`` consumes them in
order and copies each chunk's spans into the engine's arrays before its
slot returns to the ring.  ``parse_batch`` is
``parse_batch_async(...).result()``.  A kernel failure raises from
``DeviceFuture.result()`` and from here: nothing re-runs a chunk on the
plain version or on ``re``, and every in-flight future and slot is released
on the way out.
"""

from __future__ import annotations

import re
import threading
from collections import OrderedDict
from typing import Optional, Union

import numpy as np
import torch

from ...utils.device import resolve_device
from ...utils.logger import get_logger
from .. import xprof
from ..device_batch import (LENGTH_BUCKETS, MAX_BATCH, pad_batch,
                            pick_length_bucket)
from ..device_plane import DevicePlane
from ..device_stream import (StagedKernel, auto_tuner, batch_ring,
                             stream_depth)
from ..kernels.dfa_scan import DFAMatchKernel, run_chunks
from ..kernels.field_extract import ExtractKernel
from .dfa import DFAUnsupported, compile_dfa
from .fuse import demotions, note_demotion  # noqa: F401 — re-exported
from .native_exec import NativeUnsupported
from .program import PatternTier, Tier1Unsupported, compile_tier1

log = get_logger("regex")


def _chunks(idx: np.ndarray, size: int):
    for i in range(0, len(idx), size):
        yield idx[i: i + size]


class BatchParseResult:
    """ok: bool [N]; cap_off/cap_len: int32 [N, C] arena-absolute spans
    (len -1 ⇒ no capture / failed parse)."""

    __slots__ = ("ok", "cap_off", "cap_len")

    def __init__(self, ok, cap_off, cap_len):
        self.ok = ok
        self.cap_off = cap_off
        self.cap_len = cap_len


_engine_cache: "OrderedDict" = OrderedDict()
_engine_cache_lock = threading.Lock()
_ENGINE_CACHE_MAX = 512


def cached_engines():
    with _engine_cache_lock:
        return list(_engine_cache.values())


def get_engine(pattern: Union[str, bytes],
               device: Union[str, torch.device, None] = None
               ) -> "RegexEngine":
    """Process-wide engine cache keyed by (pattern, device).  ``device``
    defaults to CUDA and raises when no CUDA device exists."""
    if isinstance(pattern, bytes):
        pattern = pattern.decode("latin-1")
    dev = resolve_device(device)
    key = (pattern, str(dev))
    with _engine_cache_lock:
        eng = _engine_cache.get(key)
        if eng is not None:
            _engine_cache.move_to_end(key)  # LRU touch
            return eng
    eng = RegexEngine(pattern, dev)
    with _engine_cache_lock:
        eng = _engine_cache.setdefault(key, eng)
        while len(_engine_cache) > _ENGINE_CACHE_MAX:
            _engine_cache.popitem(last=False)  # evict least-recently used
    return eng


class RegexEngine:
    def __init__(self, pattern: Union[str, bytes],
                 device: Union[str, torch.device, None] = None):
        if isinstance(pattern, bytes):
            pattern = pattern.decode("latin-1")
        self.pattern = pattern
        self.device = resolve_device(device)
        self._re = re.compile(pattern.encode("latin-1"))
        self.num_caps = self._re.groups
        self.group_names = {v - 1: k for k, v in self._re.groupindex.items()}
        self.kernel: Optional[ExtractKernel] = None
        self.dfa_kernel: Optional[DFAMatchKernel] = None
        self.tier = PatternTier.CPU
        self.device_batches = 0
        self.re_oversize_rows = 0
        self.re_tier_rows = 0
        # match_batch on the DFA tier: K2 batches, and rows over the
        # largest bucket matched on re
        self.dfa_batches = 0
        self.dfa_re_rows = 0
        self._count_lock = threading.Lock()
        self._kernel_override = None
        self._staged: Optional[StagedKernel] = None
        try:
            self.kernel = ExtractKernel(compile_tier1(pattern))
            self.tier = PatternTier.SEGMENT
            self.kernel.warm(self.device)
            self._staged = StagedKernel(self.kernel, self.device)
        except Tier1Unsupported:
            try:
                self.dfa_kernel = DFAMatchKernel(compile_dfa(pattern))
                self.tier = PatternTier.DFA
                self.dfa_kernel.warm(self.device)
            except DFAUnsupported:
                note_demotion(pattern, "no device tier (Tier-1 and DFA "
                              "compile both refused)")
        except NativeUnsupported as e:
            note_demotion(pattern, f"over the kernel's limits: {e}")
        if self.tier is PatternTier.DFA and self.num_caps > 0:
            note_demotion(pattern, "capture-needing Tier-2 (device gates "
                          "the match; captures extract on host)")

    def reset_counts(self) -> None:
        with self._count_lock:
            self.device_batches = 0
            self.re_oversize_rows = 0
            self.re_tier_rows = 0
            self.dfa_batches = 0
            self.dfa_re_rows = 0
        for k in (self.kernel, self.dfa_kernel):
            if k is not None:
                k.reset_counts()

    def _count(self, name: str, n: int) -> None:
        with self._count_lock:
            setattr(self, name, getattr(self, name) + n)

    def set_device_kernel_override(self, kern) -> None:
        """Route this engine's device dispatches through ``kern`` (e.g. a
        ``LatencyInjectedKernel`` around ``_device_kernel()``); None
        restores the staged kernel."""
        self._kernel_override = kern

    def _device_kernel(self):
        """What a chunk's dispatch calls: ``kern(slot, C)``."""
        if self._kernel_override is not None:
            return self._kernel_override
        return self._staged

    def parse_batch(self, arena: np.ndarray, offsets: np.ndarray,
                    lengths: np.ndarray) -> BatchParseResult:
        """Full-match + captures for N events over a shared arena."""
        return self.parse_batch_async(arena, offsets, lengths).result()

    def parse_batch_async(self, arena: np.ndarray, offsets: np.ndarray,
                          lengths: np.ndarray,
                          depth: Optional[int] = None) -> "PendingParse":
        """Dispatch the parse; ``result()`` on the returned handle consumes
        it.  The device works on chunk N while the host packs N+1; callers
        that hold the PendingParse (the runner's lanes) overlap the device
        with their neighbouring groups too.  At most ``depth`` (default
        ``LOONG_STREAM_DEPTH``) chunks stay in flight; ``depth=1`` is the
        synchronous round trip."""
        offsets = np.asarray(offsets, dtype=np.int64)
        lengths = np.asarray(lengths, dtype=np.int32)
        n = len(offsets)
        C = max(self.num_caps, 1)
        ok = np.zeros(n, dtype=bool)
        cap_off = np.zeros((n, C), dtype=np.int32)
        cap_len = np.full((n, C), -1, dtype=np.int32)
        if n == 0:
            return PendingParse.ready(BatchParseResult(ok, cap_off, cap_len))

        if self.kernel is None:
            cpu_idx = np.arange(n)
            device_idx = cpu_idx[:0]
            self._count("re_tier_rows", n)
        else:
            over = lengths > LENGTH_BUCKETS[-1]
            device_idx = np.nonzero(~over)[0]
            cpu_idx = np.nonzero(over)[0]
            self._count("re_oversize_rows", len(cpu_idx))

        pending = PendingParse(self, arena, offsets, lengths,
                               ok, cap_off, cap_len, cpu_idx, depth=depth)
        if len(device_idx):
            pending.dispatch(device_idx)
        return pending

    def _cpu_fallback_rows(self, arena, offsets, lengths, cpu_idx,
                           ok, cap_off, cap_len) -> None:
        for i in cpu_idx:
            o, ln = int(offsets[i]), int(lengths[i])
            m = self._re.fullmatch(bytes(arena[o: o + ln].tobytes()))
            if m is not None:
                ok[i] = True
                for g in range(self.num_caps):
                    s, e = m.span(g + 1)
                    if s >= 0:
                        cap_off[i, g] = o + s
                        cap_len[i, g] = e - s


    def _re_match(self, arena, offsets, lengths, idx, ok) -> None:
        for i in idx:
            o, ln = int(offsets[i]), int(lengths[i])
            ok[i] = self._re.fullmatch(
                bytes(arena[o: o + ln].tobytes())) is not None

    def match_batch(self, arena: np.ndarray, offsets: np.ndarray,
                    lengths: np.ndarray) -> np.ndarray:
        """Full-match boolean only (filters, gates): can use the DFA
        tier."""
        offsets = np.asarray(offsets, dtype=np.int64)
        lengths = np.asarray(lengths, dtype=np.int32)
        n = len(offsets)
        if n == 0:
            return np.zeros(0, dtype=bool)
        if self.tier is PatternTier.SEGMENT:
            return self.parse_batch(arena, offsets, lengths).ok
        ok = np.zeros(n, dtype=bool)
        if self.tier is PatternTier.CPU:
            self._count("re_tier_rows", n)
            self._re_match(arena, offsets, lengths, range(n), ok)
            return ok
        over = lengths > LENGTH_BUCKETS[-1]
        batches = run_chunks(self.dfa_kernel, arena, offsets, lengths,
                             np.nonzero(~over)[0], self.device, ok)
        self._count("dfa_batches", batches)
        over_idx = np.nonzero(over)[0]
        self._count("dfa_re_rows", len(over_idx))
        self._re_match(arena, offsets, lengths, over_idx, ok)
        return ok


class PendingParse:
    """A parse whose device chunks are in flight.

    ``dispatch()`` packs each device chunk into a leased ring slot and
    submits it through the DevicePlane, keeping at most ``depth`` chunks in
    flight: a full window first consumes the oldest chunk, so the host
    packs chunk N+1 while the device executes N.  When the byte budget
    would block a submit, the oldest owned chunk is drained first (never
    wait in submit while owning the budget waited for).  ``result()`` runs
    the ``re`` rows (host work, overlapping the device), then consumes the
    remaining chunks in order.  Any failure releases every in-flight future
    and slot and raises."""

    __slots__ = ("engine", "arena", "offsets", "lengths", "ok", "cap_off",
                 "cap_len", "cpu_idx", "_chunks_pending", "_result", "depth")

    def __init__(self, engine, arena, offsets, lengths, ok, cap_off, cap_len,
                 cpu_idx, depth=None):
        self.engine = engine
        self.arena = arena
        self.offsets = offsets
        self.lengths = lengths
        self.ok = ok
        self.cap_off = cap_off
        self.cap_len = cap_len
        self.cpu_idx = cpu_idx
        # [(chunk_idx, DeviceBatch, BatchSlot, DeviceFuture)]
        self._chunks_pending = []
        self._result = None
        self.depth = max(1, depth if depth is not None else stream_depth())

    @classmethod
    def ready(cls, result: BatchParseResult) -> "PendingParse":
        p = cls.__new__(cls)
        p._result = result
        p._chunks_pending = []
        p.cpu_idx = ()
        return p

    @property
    def done(self) -> bool:
        return self._result is not None

    def dispatch(self, device_idx: np.ndarray) -> None:
        plane = DevicePlane.instance()
        ring = batch_ring()
        tuner = auto_tuner()
        eng = self.engine
        kern = eng._device_kernel()
        pinned = eng.device.type == "cuda"
        C = max(eng.num_caps, 1)
        max_bucket = LENGTH_BUCKETS[-1]
        try:
            for chunk in _chunks(device_idx, MAX_BATCH):
                # a full window consumes its oldest chunk before packing
                while len(self._chunks_pending) >= self.depth:
                    self._drain_one()
                d_off = self.offsets[chunk]
                d_len = self.lengths[chunk]
                L = pick_length_bucket(int(d_len.max())) or max_bucket
                B = pad_batch(len(chunk), min_batch=tuner.min_batch_for(L))
                slot = ring.lease(B, L, pinned=pinned)
                try:
                    batch = slot.pack(self.arena, d_off, d_len)
                    fut = plane.submit(kern, (slot, C),
                                       batch.rows.nbytes,
                                       on_wait=self._drain_if_pending)
                except BaseException:
                    slot.release()
                    raise
                eng._count("device_batches", 1)
                xprof.note_dispatch(fut, "regex", f"{B}x{L}",
                                    slot.pack_t0, slot.pack_dur)
                self._chunks_pending.append((chunk, batch, slot, fut))
        except BaseException:
            # the caller abandons this parse: release what is in flight
            self._abandon(consume=False)
            raise

    def _abandon(self, consume: bool) -> None:
        """Release every chunk still pending.  With ``consume`` each future
        is waited on first (its error, if any, is dropped: the caller is
        already raising one); a slot whose copies may still run is kept out
        of its pool by the ring until they complete."""
        for _chunk, _batch, slot, fut in self._chunks_pending:
            if consume:
                try:
                    fut.result()
                except Exception:  # noqa: BLE001 — releasing, not consuming
                    pass
            else:
                fut.release()
            slot.release()
        self._chunks_pending.clear()

    def _drain_if_pending(self) -> bool:
        """Budget-wait hook: consume our oldest chunk so the bytes we hold
        are released while we wait."""
        if not self._chunks_pending:
            return False
        self._drain_one()
        return True

    def _drain_one(self) -> None:
        chunk, batch, slot, fut = self._chunks_pending.pop(0)
        try:
            k_ok, k_off, k_len = fut.result()
            n = batch.n_real
            self.ok[chunk] = k_ok[:n]
            # row-relative -> arena-absolute
            self.cap_off[chunk] = k_off[:n] + batch.origins[:n, None]
            self.cap_len[chunk] = k_len[:n]
        finally:
            # the slot may be repacked once it is back: its spans were
            # copied out above
            slot.release()

    def result(self) -> BatchParseResult:
        if self._result is not None:
            return self._result
        # re rows first: host work that overlaps the in-flight chunks
        if len(self.cpu_idx):
            self.engine._cpu_fallback_rows(
                self.arena, self.offsets, self.lengths, self.cpu_idx,
                self.ok, self.cap_off, self.cap_len)
        try:
            while self._chunks_pending:
                self._drain_one()
        except BaseException:
            self._abandon(consume=True)
            raise
        self._result = BatchParseResult(self.ok, self.cap_off, self.cap_len)
        return self._result
