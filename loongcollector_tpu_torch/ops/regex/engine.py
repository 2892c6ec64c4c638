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

Several devices (reference ``engine.py:252-276, 338-409``):

* ``LOONG_SHARDED`` (``_maybe_sharded``): ``1`` forces the sharded parse
  plane (``parallel/mesh.ShardedKernel``: each chunk's rows split over the
  mesh, one K8 launch a shard), ``0`` turns it off, and unset it is on
  when the mesh (``make_mesh`` for the engine's device) has more than one
  shard.  Its chunks are counted as ``device_batches``, as K1's.
* Chip lanes (``ops/chip_lanes.py``): a dispatch from a worker bound to a
  lane runs on a ``_LanePlacedKernel``, the staged K1 on the lane's
  device; each chunk is accounted against the lane's share of the plane's
  budget (``note_pack`` / ``note_dispatch`` / ``note_done``), and a lane
  over its share drains its own oldest chunk first.  The tuner's floors
  are kept per lane (``chip:<i>``).

Neither degrades quietly: a mesh that cannot be built, or a lane kernel
that fails, raises (the reference falls back to one device, and pins a
failing path off).  Left out with the lane breaker: the respill of an open
lane's chunks to host parsing and the chip-lane chaos points.
"""

from __future__ import annotations

import os
import re
import threading
from collections import OrderedDict
from typing import Optional, Union

import numpy as np
import torch

from ...utils.device import resolve_device
from ...utils.logger import get_logger
from .. import chip_lanes, xprof
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


def clear_engine_cache() -> None:
    """Drop every cached engine (tests, and a change of the mesh or lane
    settings)."""
    with _engine_cache_lock:
        _engine_cache.clear()


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


class _LanePlacedKernel(StagedKernel):
    """The staged K1 placed on one chip lane's device: a lane-bound
    worker's chunks run there, on that device's streams, so distinct
    workers drive distinct devices with nothing shared on the batch path
    (reference ``_LanePlacedKernel``).  The program is uploaded to the
    device when the kernel is made."""

    def __init__(self, kernel: ExtractKernel, lane):
        kernel.warm(lane.device)
        super().__init__(kernel, lane.device)
        self.lane = lane


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
        self._sharded = None                # None = unresolved, False = off
        self._lane_kernels = {}     # (lane, device) -> _LanePlacedKernel
        self._select_lock = threading.Lock()
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

    def _maybe_sharded(self):
        """The sharded parse plane, when on (see the module docstring);
        built once, on first use.  A mesh that cannot be built raises."""
        if self._sharded is not None:
            return self._sharded or None
        with self._select_lock:
            if self._sharded is not None:
                return self._sharded or None
            env = os.environ.get("LOONG_SHARDED", "").strip()
            if env == "0" or self.kernel is None:
                self._sharded = False
                return None
            from ...parallel.mesh import ShardedKernel, make_mesh
            mesh = make_mesh(device=self.device)
            if mesh.size <= 1 and env != "1":
                self._sharded = False
                return None
            self._sharded = ShardedKernel(self.kernel.program, mesh,
                                          kernel=self.kernel)
            return self._sharded

    def _device_kernel(self, lane=None):
        """What a chunk's dispatch calls: ``kern(slot, C)``.  A lane-bound
        dispatch gets the staged K1 placed on its lane's device; an
        unbound one the sharded plane when it is on, else the staged K1 on
        the engine's device."""
        if self._kernel_override is not None:
            return self._kernel_override
        if lane is not None:
            key = (lane.index, lane.device)
            k = self._lane_kernels.get(key)
            if k is None:
                with self._select_lock:
                    k = self._lane_kernels.get(key)
                    if k is None:
                        k = _LanePlacedKernel(self.kernel, lane)
                        self._lane_kernels[key] = k
            return k
        sharded = self._maybe_sharded()
        if sharded is not None:
            return sharded
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
    and slot and raises.  A chunk of a lane-bound worker is accounted
    against its lane: ``note_pack`` / ``note_dispatch`` when it is
    submitted, ``note_done`` when it is consumed or released (reference
    ``engine.py:699-815``)."""

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
        # [(chunk_idx, DeviceBatch, BatchSlot, DeviceFuture, ChipLane)]
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
        # a lane-bound worker dispatches on its lane's device; an unbound
        # one on the sharded plane or the engine's device
        lane = chip_lanes.current_lane()
        lane_count = chip_lanes.router().lane_count() if lane is not None \
            else 0
        kern = eng._device_kernel(lane)
        call = getattr(kern, "donated_call", None) or kern
        multiple = getattr(kern, "batch_multiple", 1)
        lane_key = f"chip:{lane.index}" if lane is not None else None
        device = lane.device if lane is not None else eng.device
        pinned = device.type == "cuda"
        C = max(eng.num_caps, 1)
        max_bucket = LENGTH_BUCKETS[-1]
        try:
            # whole mesh multiples a chunk: every slot splits evenly
            for chunk in _chunks(device_idx,
                                 MAX_BATCH - MAX_BATCH % multiple):
                # a full window consumes its oldest chunk before packing
                while len(self._chunks_pending) >= self.depth:
                    self._drain_one()
                # a lane past its share of the budget drains its own
                # oldest chunk first: one slow device backs up its lane
                while lane is not None \
                        and lane.over_share(plane, lane_count) \
                        and self._chunks_pending:
                    self._drain_one()
                d_off = self.offsets[chunk]
                d_len = self.lengths[chunk]
                L = pick_length_bucket(int(d_len.max())) or max_bucket
                B = pad_batch(len(chunk),
                              min_batch=tuner.min_batch_for(L, lane_key),
                              multiple_of=multiple)
                slot = ring.lease(B, L, pinned=pinned)
                try:
                    batch = slot.pack(self.arena, d_off, d_len,
                                      lane=lane_key)
                    fut = plane.submit(call, (slot, C),
                                       batch.rows.nbytes,
                                       on_wait=self._drain_if_pending)
                except BaseException:
                    slot.release()
                    raise
                eng._count("device_batches", 1)
                xprof.note_dispatch(fut, "regex", f"{B}x{L}",
                                    slot.pack_t0, slot.pack_dur)
                if lane is not None:
                    lane.note_pack(B, batch.n_real)
                    lane.note_dispatch(batch.rows.nbytes)
                self._chunks_pending.append((chunk, batch, slot, fut, lane))
        except BaseException:
            # the caller abandons this parse: release what is in flight
            self._abandon(consume=False)
            raise

    def _abandon(self, consume: bool) -> None:
        """Release every chunk still pending.  With ``consume`` each future
        is waited on first (its error, if any, is dropped: the caller is
        already raising one); a slot whose copies may still run is kept out
        of its pool by the ring until they complete."""
        for _chunk, batch, slot, fut, lane in self._chunks_pending:
            if consume:
                try:
                    fut.result()
                except Exception:  # noqa: BLE001 — releasing, not consuming
                    pass
            else:
                fut.release()
            if lane is not None:
                lane.note_done(batch.rows.nbytes)
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
        chunk, batch, slot, fut, lane = self._chunks_pending.pop(0)
        try:
            k_ok, k_off, k_len = fut.result()
            n = batch.n_real
            self.ok[chunk] = k_ok[:n]
            # row-relative -> arena-absolute
            self.cap_off[chunk] = k_off[:n] + batch.origins[:n, None]
            self.cap_len[chunk] = k_len[:n]
        finally:
            if lane is not None:
                lane.note_done(batch.rows.nbytes)
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
