"""Resident stage fusion: a pipeline's consecutive device stages as one
program a chunk (K7).

Reference: loongcollector_tpu/ops/fused_pipeline.py.  A run of two or more
consecutive device-capable stages (a Tier-1 parse, a multi-pattern
classify scan, a filter, a structural index) is described by
``StageSpec``s and ``StageCond``s (``pipeline/fused_chain.py`` plans them
from each processor's ``fused_stage_spec``), and ``FusedProgramKernel``
runs the whole list as one dispatch per chunk: the rows are packed and
copied once, a filter condition on a field the run's own parse captured
reads that capture's span where it was computed, and every stage's
outputs come back in one copy.

* ``build_fused_fn`` is the plain version, in torch: the member stages'
  plain kernels (K1 ``build_extract_fn``, K2 ``DFAMatchKernel.plain``, K3
  ``DFASpanMatchKernel.plain``, K4 ``FusedScanKernel.plain``, K5
  ``struct_index.build_index_fn``) composed as the reference composes its
  jitted cores, returning the flat tuple of stage outputs.  It is what a
  CPU tensor runs.
* ``FusedProgramKernel`` owns one stage list: for a CUDA tensor it
  launches the hand-written CUDA kernel (``kernels/fused_program_cuda.py``,
  source ``kernels/csrc/fused_program.cu``) and counts it in ``launches``,
  or raises; ``dispatch_count`` counts fused dispatches on either device.
  ``staged_run`` runs each member's own kernel, one dispatch a stage (K1,
  K2, K3, K4 on the card): the on-card oracle of ``chip_smoke.py`` and the
  per-stage twin of the program, never a route a failure falls back to
  (a ``struct_index`` stage runs on K5).
* ``FusedDispatch`` is one group's fused run in flight on the port's
  ``DevicePlane``: each chunk is packed into a leased ``BatchRing`` slot,
  its B floor comes from the ``WidthAutoTuner`` keyed per program
  (``fused:<signature>``), and one dispatch copies the rows in, launches
  K7 and copies the flat output back into the slot's pinned buffer.
  ``result()`` consumes the chunks in order; a K7 failure raises from it,
  and every slot and byte of budget is released on the way out.  A
  ``struct_index`` stage's packed words stay per chunk (their width
  follows the chunk's ``L``) and are unpacked into ``[n, Lmax]`` bool
  arrays at the end, as the reference's ``_finish_struct`` does.  No
  planner emits that stage, in the port as in the reference.
* Programs are cached in memory, keyed by the sha256 of the stage
  identities (``get_fused_program``).

A worker bound to a chip lane (``ops/chip_lanes.py``) runs its fused
chunks on the lane's device (``FusedProgramKernel.for_lane``), accounted
against the lane's share of the budget, with the lane's tuner floors, as
the engines' chunks (reference ``fused_pipeline.py:296-305, 680-681``).

Left out, as in the port's plane: the lane breaker's respill, the chaos
fault point, the demotion of a failed chunk to the per-stage path, and the
on-disk plan cache (which waits for tail mode).  ``LOONG_FUSED`` is the
reference's switch: ``1`` forces fusion, ``0`` disables it, and unset it is
on exactly when the pipeline's device is CUDA.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import chip_lanes, xprof
from .device_batch import (LENGTH_BUCKETS, MAX_BATCH, pad_batch,
                           pick_length_bucket)
from .device_plane import DevicePlane, mem_note_alloc, mem_note_free
from .device_stream import StagedKernel, auto_tuner, batch_ring, stream_depth
from .kernels import fused_program_cuda as fpc

CACHE_VERSION = 1
ENV_FUSED = "LOONG_FUSED"

#: flat-output width per stage kind
_STAGE_WIDTH = {"extract": 3, "scan": 1, "struct_index": 4, "keep": 1}


def fusion_enabled(device: Optional[torch.device] = None) -> bool:
    """``LOONG_FUSED=1`` forces fusion and ``=0`` disables it; unset, it is
    on exactly when the engines' device (``device``, else the default
    device) is CUDA.  On the CPU the per-stage plain versions do the same
    work without the copies fusion exists to save."""
    env = os.environ.get(ENV_FUSED)
    if env is not None:
        return env != "0"
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


class FusedUnsupported(fpc.FusedUnsupported):
    """The stage list holds a stage the port's K7 does not run."""


# ---------------------------------------------------------------------------
# stage model


class StageCond:
    """One condition of a ``keep`` stage (a filter Include/Exclude entry).

    kind: ``match`` (a DFA full match over the run's source rows, ``payload``
    a DFA), ``extract_ok`` (a Tier-1 program's ok bit over the source rows,
    ``payload`` a SegmentProgram), ``span_match`` (a DFA full match over
    capture ``cap`` of the earlier extract stage ``prod``,
    ``binding=(prod, cap)``).  ``staged`` is the condition's own kernel
    (``ExtractKernel``, ``DFAMatchKernel``, ``LazySpanMatchKernel``)."""

    __slots__ = ("kind", "payload", "binding", "negate", "staged", "ident")

    def __init__(self, kind: str, payload, ident,
                 binding: Optional[Tuple[int, int]] = None,
                 negate: bool = False, staged: Optional[Callable] = None):
        self.kind = kind
        self.payload = payload
        self.binding = binding
        self.negate = negate
        self.staged = staged
        self.ident = ident


class StageSpec:
    """One device-capable stage: ``extract`` (``payload`` a SegmentProgram:
    ok and capture spans), ``scan`` (a FusedDFA: the accept-tag mask),
    ``keep`` (a list of StageConds: the filter mask), or ``struct_index``
    (``payload`` a (mode, separator byte) pair: K5's four packed masks).

    ``ident`` is the content identity the program cache hashes; ``staged``
    is the stage's own kernel; ``terminal`` marks a stage that rebuilds the
    rows (the multiline classify) and so ends a run."""

    __slots__ = ("kind", "payload", "ident", "staged", "terminal", "label")

    def __init__(self, kind: str, payload, ident, staged=None,
                 terminal: bool = False, label: str = ""):
        self.kind = kind
        self.payload = payload
        self.ident = ident
        self.staged = staged
        self.terminal = terminal
        self.label = label or kind

    @property
    def width(self) -> int:
        return _STAGE_WIDTH[self.kind]


def _span_kernel(dfa):
    from .kernels.dfa_scan import DFASpanMatchKernel
    return DFASpanMatchKernel(dfa)


def build_fused_fn(specs: Sequence[StageSpec]):
    """The plain version: f(rows u8 [B, L], lengths i32 [B]) -> the flat
    tuple of stage outputs (extract: ok bool [B], cap_off, cap_len i32
    [B, C]; scan: tags i32 [B]; keep: bool [B]; struct_index: the four
    packed masks i32 [B, ceil(L/16)]), the member stages' plain kernels
    composed as the reference composes its cores."""
    from .kernels.dfa_scan import DFAMatchKernel, FusedScanKernel
    from .kernels.field_extract import build_extract_fn
    from .kernels.struct_index import build_index_fn
    stage_fns: List = []
    for spec in specs:
        if spec.kind == "extract":
            stage_fns.append(build_extract_fn(spec.payload))
        elif spec.kind == "scan":
            stage_fns.append(FusedScanKernel(spec.payload).plain)
        elif spec.kind == "struct_index":
            stage_fns.append(build_index_fn(*spec.payload))
        elif spec.kind == "keep":
            fns = []
            for cond in spec.payload:
                if cond.kind == "match":
                    fns.append(DFAMatchKernel(cond.payload).plain)
                elif cond.kind == "span_match":
                    fns.append(_span_kernel(cond.payload).plain)
                elif cond.kind == "extract_ok":
                    fns.append(build_extract_fn(cond.payload))
                else:
                    raise FusedUnsupported(f"condition kind {cond.kind!r}")
            stage_fns.append(fns)
        else:
            raise FusedUnsupported(f"stage kind {spec.kind!r}")

    def fused(rows: torch.Tensor, lengths: torch.Tensor) -> Tuple:
        stage_outs: List[Tuple] = []
        flat: List = []
        for spec, fn in zip(specs, stage_fns):
            if spec.kind in ("extract", "struct_index"):
                outs = tuple(fn(rows, lengths))
            elif spec.kind == "scan":
                outs = (fn(rows, lengths),)
            else:
                keep = None
                for cond, cfn in zip(spec.payload, fn):
                    if cond.kind == "match":
                        # an absent named source (length -1) never matches
                        ok = cfn(rows, lengths) & (lengths >= 0)
                    elif cond.kind == "extract_ok":
                        ok = cfn(rows, lengths)[0] & (lengths >= 0)
                    else:
                        prod, cap = cond.binding
                        _p_ok, p_off, p_len = stage_outs[prod]
                        ok = cfn(rows, lengths, p_off[:, cap], p_len[:, cap])
                    if cond.negate:
                        ok = ~ok
                    keep = ok if keep is None else (keep & ok)
                outs = (keep,)
            stage_outs.append(outs)
            flat.extend(outs)
        return tuple(flat)

    return fused


def kernel_stages(specs: Sequence[StageSpec]) -> List[fpc.KernelStage]:
    """The stage list in the kernel's form (``fused_program_cuda``): Tier-1
    programs packed for the walker, automata folded into byte tables."""
    from .kernels.dfa_scan import automaton_arrays_from_reference
    from .kernels.field_extract_cuda import program_arrays

    def kprog(spec_or_cond):
        kp = getattr(spec_or_cond.staged, "kernel_program", None)
        return kp if kp is not None else program_arrays(spec_or_cond.payload)

    def dfa_arrays(dfa):
        return automaton_arrays_from_reference(
            dfa.byte_class, dfa.transitions, dfa.start, dfa.accepting)

    out = []
    for spec in specs:
        if spec.kind == "extract":
            out.append(fpc.KernelStage("extract", kprog(spec)))
        elif spec.kind == "struct_index":
            out.append(fpc.KernelStage("struct_index", tuple(spec.payload)))
        elif spec.kind == "scan":
            f = spec.payload
            out.append(fpc.KernelStage("scan", automaton_arrays_from_reference(
                f.byte_class, f.transitions, f.start, f.accept_tags)))
        else:
            conds = []
            for c in spec.payload:
                if c.kind == "extract_ok":
                    conds.append(fpc.KernelCond("extract_ok", kprog(c),
                                                c.negate))
                else:
                    prod, cap = c.binding if c.kind == "span_match" \
                        else (-1, -1)
                    conds.append(fpc.KernelCond(c.kind, dfa_arrays(c.payload),
                                                c.negate, prod, cap))
            out.append(fpc.KernelStage("keep", conds=tuple(conds)))
    return out


# ---------------------------------------------------------------------------
# the program


class FusedProgramKernel:
    """One stage list's program, dispatched by tensor device.

    ``program(rows, lengths)`` returns a 1-tuple, the flat output (u8
    ``[descriptor.flat_bytes(B, L)]``, ``split`` views it): on the CPU the
    plain version's outputs packed into it, on CUDA the K7 launch's own
    buffer (counted in ``launches``).  ``dispatch_count`` counts fused dispatches on either
    device; the single-dispatch-per-chunk check reads it."""

    # the wrapper records the exec leg's events right around its launch
    brackets_launch = True

    def __init__(self, specs: Sequence[StageSpec], signature: str):
        self.specs = list(specs)
        self.signature = signature
        self.plain = build_fused_fn(self.specs)
        self.descriptor = fpc.pack_descriptor(kernel_stages(self.specs))
        self.layout: List[Tuple[int, int]] = []
        i = 0
        for spec in self.specs:
            self.layout.append((i, spec.width))
            i += spec.width
        self.n_outputs = i
        self.dispatch_count = 0
        self.launches = 0
        self.geometries: set = set()
        self._lock = threading.Lock()
        self._blobs: Dict[torch.device, torch.Tensor] = {}
        self._staged: Dict[torch.device, StagedKernel] = {}

    def reset_counts(self) -> None:
        with self._lock:
            self.dispatch_count = 0
            self.launches = 0
        for kern in self.member_kernels():
            kern.reset_counts()

    def member_kernels(self) -> List:
        """The members' own kernels (what ``staged_run`` launches)."""
        out = [s.staged for s in self.specs if s.staged is not None]
        for s in self.specs:
            if s.kind == "keep":
                out += [c.staged for c in s.payload if c.staged is not None]
        return out

    def span_launches(self) -> int:
        """K3 launches of this program's span conditions."""
        return sum(c.staged.launches for s in self.specs if s.kind == "keep"
                   for c in s.payload
                   if c.kind == "span_match" and c.staged is not None)

    def note_geometry(self, B: int, L: int) -> None:
        with self._lock:
            self.geometries.add((B, L))

    # -- device state ---------------------------------------------------------

    def device_blob(self, device: torch.device) -> torch.Tensor:
        blob = self._blobs.get(device)
        if blob is None:
            blob = torch.from_numpy(self.descriptor.blob).to(device)
            blob = self._blobs.setdefault(device, blob)
        return blob

    def warm(self, device: torch.device) -> None:
        """Build the kernel library and upload the descriptor ahead of the
        first chunk (no-op for the CPU)."""
        if device.type == "cuda":
            fpc.build()
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self.device_blob(device)

    def staged_kernel(self, device: torch.device) -> StagedKernel:
        """The plane's call for one packed slot on ``device``."""
        got = self._staged.get(device)
        if got is None:
            got = self._staged.setdefault(device, StagedKernel(self, device))
        return got

    def for_lane(self, lane) -> StagedKernel:
        """The plane's call on a chip lane's device, the descriptor
        uploaded there first."""
        self.warm(lane.device)
        return self.staged_kernel(lane.device)

    def host_outputs(self, slot) -> Tuple[torch.Tensor]:
        """The slot's buffer the flat output is copied back into."""
        return (slot.flat_output(
            self.descriptor.flat_bytes(slot.B, slot.L)),)

    # -- the call -------------------------------------------------------------

    def __call__(self, rows: torch.Tensor, lengths: torch.Tensor,
                 events=None) -> Tuple[torch.Tensor]:
        """``events`` (CUDA only): a (start, end) pair of timing CUDA events
        recorded by the kernel's entry point right around the launch."""
        B, L = rows.shape
        if rows.device.type == "cpu":
            flat = torch.empty(self.descriptor.flat_bytes(B, L),
                               dtype=torch.uint8)
            for view, out in zip(self.split(flat, B),
                                 self.plain(rows, lengths)):
                view.copy_(out.reshape(view.shape))
            with self._lock:
                self.dispatch_count += 1
            return (flat,)
        if rows.device.type != "cuda":
            raise ValueError(f"no fused_program kernel for {rows.device}")
        flat = fpc.launch(rows, lengths, self.device_blob(rows.device),
                          self.descriptor, events)
        with self._lock:
            self.dispatch_count += 1
            self.launches += 1
        return (flat,)

    def split(self, flat, B: int) -> list:
        """The flat output's arrays in layout order (views)."""
        return fpc.split_flat(flat, B, self.descriptor)

    # -- the per-stage twin ---------------------------------------------------

    def staged_run(self, rows: torch.Tensor, lengths: torch.Tensor
                   ) -> List[Tuple[torch.Tensor, ...]]:
        """Each member stage on its own kernel, one dispatch a stage, in
        order (a span condition reads its producer's returned spans): K1,
        K2, K3, K4 and K5 launches for CUDA tensors.  Per stage a tuple of
        tensors, as the plain version lays them out."""
        from .kernels.dfa_scan import DFAMatchKernel, FusedScanKernel
        from .kernels.field_extract import ExtractKernel
        from .kernels.struct_index import StructIndexKernel
        outs: List[Tuple[torch.Tensor, ...]] = []
        for spec in self.specs:
            if spec.kind == "extract":
                kern = spec.staged or ExtractKernel(spec.payload)
                outs.append(tuple(kern(rows, lengths)))
            elif spec.kind == "struct_index":
                kern = spec.staged or StructIndexKernel(*spec.payload)
                outs.append(tuple(kern(rows, lengths)))
            elif spec.kind == "scan":
                kern = spec.staged or FusedScanKernel(spec.payload)
                outs.append((kern(rows, lengths),))
            else:
                keep = None
                for c in spec.payload:
                    if c.kind == "match":
                        kern = c.staged or DFAMatchKernel(c.payload)
                        ok = kern(rows, lengths) & (lengths >= 0)
                    elif c.kind == "extract_ok":
                        kern = c.staged or ExtractKernel(c.payload)
                        ok = kern(rows, lengths)[0] & (lengths >= 0)
                    else:
                        prod, cap = c.binding
                        _ok, p_off, p_len = outs[prod]
                        kern = c.staged or _span_kernel(c.payload)
                        ok = kern(rows, lengths, p_off[:, cap].contiguous(),
                                  p_len[:, cap].contiguous())
                    if c.negate:
                        ok = ~ok
                    keep = ok if keep is None else (keep & ok)
                outs.append((keep,))
        return outs

    def status(self) -> dict:
        d = self.descriptor
        return {
            "signature": self.signature,
            "stages": [s.label for s in self.specs],
            "dispatches": self.dispatch_count,
            "launches": self.launches,
            "span_launches": self.span_launches(),
            "instantiation": d.instantiation,
            "descriptor_words": len(d.blob),
            "shared_words": d.shared_words,
            "placement": dict(d.placement),
            "geometries": sorted(f"{b}x{l}" for b, l in self.geometries),
        }


# ---------------------------------------------------------------------------
# in-memory program cache


_mem_cache: "OrderedDict[str, FusedProgramKernel]" = OrderedDict()
_mem_cache_lock = threading.Lock()
_MEM_CACHE_MAX = 64
_counts = {"fused_program_cache_hit_total": 0,
           "fused_program_cache_miss_total": 0,
           "fused_dispatch_total": 0}


def _count(name: str, delta: int = 1) -> None:
    with _mem_cache_lock:
        _counts[name] += delta


def program_signature(specs: Sequence[StageSpec]) -> str:
    blob = json.dumps([CACHE_VERSION] + [_jsonable(s.ident) for s in specs],
                      ensure_ascii=False)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:20]


def _jsonable(ident):
    if isinstance(ident, (list, tuple)):
        return [_jsonable(x) for x in ident]
    return ident


def get_fused_program(specs: Sequence[StageSpec]) -> FusedProgramKernel:
    """The program of ``specs``, from the in-memory LRU keyed by
    ``program_signature``; on a concurrent miss the first one cached wins,
    so every caller shares one program and its counts."""
    signature = program_signature(specs)
    with _mem_cache_lock:
        got = _mem_cache.get(signature)
        if got is not None:
            _mem_cache.move_to_end(signature)
            _counts["fused_program_cache_hit_total"] += 1
            return got
    program = FusedProgramKernel(specs, signature)
    with _mem_cache_lock:
        _counts["fused_program_cache_miss_total"] += 1
        existing = _mem_cache.get(signature)
        if existing is not None:
            program = existing
        else:
            _mem_cache[signature] = program
        _mem_cache.move_to_end(signature)
        while len(_mem_cache) > _MEM_CACHE_MAX:
            _mem_cache.popitem(last=False)
    return program


def cached_programs() -> List[FusedProgramKernel]:
    with _mem_cache_lock:
        return list(_mem_cache.values())


def stage_fusion_status() -> dict:
    """Per-program rows and the cache and dispatch counters."""
    with _mem_cache_lock:
        programs = [p.status() for p in _mem_cache.values()]
        doc = dict(_counts)
    doc.update(enabled=fusion_enabled(), programs=programs)
    return doc


def reset_counts() -> None:
    """Zero every cached program's counts and the dispatch counter (the
    start of a measured run)."""
    for p in cached_programs():
        p.reset_counts()
    with _mem_cache_lock:
        _counts["fused_dispatch_total"] = 0


def reset_for_testing() -> None:
    with _mem_cache_lock:
        _mem_cache.clear()
        for k in _counts:
            _counts[k] = 0


# ---------------------------------------------------------------------------
# the dispatch handle


class FusedBatchResult:
    """Per-stage outputs in the group's row order: extract → (ok bool [n],
    cap_off i32 [n, C] arena-absolute, cap_len i32 [n, C]); scan → (tags
    u32 [n],); keep → (keep bool [n],); struct_index → the four masks as
    bool [n, Lmax] (Lmax the largest chunk's L)."""

    __slots__ = ("stages", "n")

    def __init__(self, stages: List[Tuple[np.ndarray, ...]], n: int):
        self.stages = stages
        self.n = n


class FusedDispatch:
    """One group's fused run in flight (the fused plane's PendingParse).

    ``dispatch()`` packs each chunk of at most ``MAX_BATCH`` rows into a
    leased ring slot and submits one K7 dispatch a chunk under the
    ``DevicePlane`` budget, at most ``depth`` chunks in flight (a full
    window consumes its oldest first; a budget wait drains our own oldest).
    ``result()`` consumes the chunks in order and assembles the stage
    outputs.  While a chunk is in flight its rows' bytes stand in the
    memory ledger's ``resident_columns`` family.  Any failure releases
    every in-flight future, slot and ledger entry and raises."""

    __slots__ = ("program", "device", "arena", "offsets", "lengths", "depth",
                 "_pending", "_stage_bufs", "_struct_parts", "_result", "_n",
                 "_plane")

    def __init__(self, program: FusedProgramKernel, arena: np.ndarray,
                 offsets: np.ndarray, lengths: np.ndarray,
                 device: torch.device, depth: Optional[int] = None):
        self.program = program
        self.device = device
        self.arena = arena
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.lengths = np.asarray(lengths, dtype=np.int32)
        self.depth = max(1, depth if depth is not None else stream_depth())
        self._n = len(self.offsets)
        # [(chunk_idx, DeviceBatch, BatchSlot, DeviceFuture, ChipLane)]
        self._pending: List = []
        self._stage_bufs = self._alloc_stage_bufs()
        # struct_index stage -> [(chunk, packed masks, L)]
        self._struct_parts: Dict[int, List] = {}
        self._result: Optional[FusedBatchResult] = None
        self._plane = DevicePlane.instance()

    def _alloc_stage_bufs(self) -> List:
        n = self._n
        bufs: List = []
        for spec in self.program.specs:
            if spec.kind == "extract":
                C = max(spec.payload.num_caps, 1)
                bufs.append((np.zeros(n, dtype=bool),
                             np.zeros((n, C), dtype=np.int32),
                             np.full((n, C), -1, dtype=np.int32)))
            elif spec.kind == "scan":
                bufs.append((np.zeros(n, dtype=np.uint32),))
            elif spec.kind == "keep":
                bufs.append((np.zeros(n, dtype=bool),))
            else:  # struct_index: ragged per-chunk widths, assembled late
                bufs.append(None)
        return bufs

    def dispatch(self) -> "FusedDispatch":
        ring = batch_ring()
        tuner = auto_tuner()
        program = self.program
        chip = chip_lanes.current_lane()
        lane_count = chip_lanes.router().lane_count() if chip is not None \
            else 0
        if chip is None:
            staged = program.staged_kernel(self.device)
            pinned = self.device.type == "cuda"
            lane = f"fused:{program.signature[:8]}"
        else:
            staged = program.for_lane(chip)
            pinned = chip.device.type == "cuda"
            lane = f"chip:{chip.index}"
        max_bucket = LENGTH_BUCKETS[-1]
        idx = np.arange(self._n)
        try:
            for start in range(0, self._n, MAX_BATCH):
                chunk = idx[start:start + MAX_BATCH]
                while len(self._pending) >= self.depth:
                    self._drain_one()
                while chip is not None \
                        and chip.over_share(self._plane, lane_count) \
                        and self._pending:
                    self._drain_one()
                d_off = self.offsets[chunk]
                d_len = self.lengths[chunk]
                L = pick_length_bucket(max(int(d_len.max()), 1)) \
                    or max_bucket
                B = pad_batch(len(chunk),
                              min_batch=tuner.min_batch_for(L, lane))
                program.note_geometry(B, L)
                slot = ring.lease(B, L, pinned=pinned)
                try:
                    batch = slot.pack(self.arena, d_off, d_len, lane=lane)
                    fut = self._plane.submit(
                        staged, (slot, 0), batch.rows.nbytes,
                        on_wait=self._drain_if_pending)
                except BaseException:
                    slot.release()
                    raise
                _count("fused_dispatch_total")
                xprof.note_dispatch(fut, "fused", f"{B}x{L}", slot.pack_t0,
                                    slot.pack_dur)
                # the chunk's stage columns live on the device while it is
                # in flight, booked at its rows' bytes
                mem_note_alloc("resident_columns", batch.rows.nbytes)
                if chip is not None:
                    chip.note_pack(B, batch.n_real)
                    chip.note_dispatch(batch.rows.nbytes)
                self._pending.append((chunk, batch, slot, fut, chip))
        except BaseException:
            self._abandon(consume=False)
            raise
        return self

    def abandon(self) -> None:
        """Release a dispatch that will not be consumed (its caller is
        raising): every chunk's future is waited on, then its slot and
        ledger entry released."""
        self._abandon(consume=True)

    def _abandon(self, consume: bool) -> None:
        """Release every chunk still pending; with ``consume`` each future
        is waited on first (its error dropped: the caller raises one)."""
        for _c, batch, slot, fut, chip in self._pending:
            if consume:
                try:
                    fut.result()
                except Exception:  # noqa: BLE001 — releasing, not consuming
                    pass
            else:
                fut.release()
            mem_note_free("resident_columns", batch.rows.nbytes)
            if chip is not None:
                chip.note_done(batch.rows.nbytes)
            slot.release()
        self._pending.clear()

    def _drain_if_pending(self) -> bool:
        if not self._pending:
            return False
        self._drain_one()
        return True

    def _drain_one(self) -> None:
        chunk, batch, slot, fut, chip = self._pending.pop(0)
        try:
            (flat,) = fut.result()
            self._assemble(chunk, batch, flat)
        finally:
            mem_note_free("resident_columns", batch.rows.nbytes)
            if chip is not None:
                chip.note_done(batch.rows.nbytes)
            slot.release()

    def _assemble(self, chunk: np.ndarray, batch, flat) -> None:
        n_real = batch.n_real
        B = batch.rows.shape[0]
        arrays = self.program.split(np.asarray(flat), B)
        for si, spec in enumerate(self.program.specs):
            start, width = self.program.layout[si]
            outs = arrays[start:start + width]
            if spec.kind == "extract":
                ok_b, off_b, len_b = self._stage_bufs[si]
                ok_b[chunk] = outs[0][:n_real]
                # row-relative -> arena-absolute via the pack origins
                off_b[chunk] = outs[1][:n_real] + batch.origins[:n_real, None]
                len_b[chunk] = outs[2][:n_real]
            elif spec.kind == "scan":
                self._stage_bufs[si][0][chunk] = \
                    outs[0][:n_real].view(np.uint32)
            elif spec.kind == "keep":
                self._stage_bufs[si][0][chunk] = outs[0][:n_real]
            else:  # struct_index: keep the packed words, unpack late
                self._struct_parts.setdefault(si, []).append(
                    (chunk, [o[:n_real].copy() for o in outs],
                     batch.rows.shape[1]))

    def result(self) -> FusedBatchResult:
        if self._result is not None:
            return self._result
        try:
            while self._pending:
                self._drain_one()
        except BaseException:
            self._abandon(consume=True)
            raise
        stages = [self._finish_struct(si) if spec.kind == "struct_index"
                  else self._stage_bufs[si]
                  for si, spec in enumerate(self.program.specs)]
        self._result = FusedBatchResult(stages, self._n)
        self.arena = None
        return self._result

    def _finish_struct(self, si: int) -> Tuple[np.ndarray, ...]:
        from .kernels.struct_index import unpack16
        parts = self._struct_parts.get(si, [])
        Lmax = max((L for _c, _m, L in parts), default=0)
        out = tuple(np.zeros((self._n, Lmax), dtype=bool) for _ in range(4))
        for chunk, masks, L in parts:
            for mi in range(4):
                out[mi][chunk, :L] = unpack16(masks[mi], L)
        return out
