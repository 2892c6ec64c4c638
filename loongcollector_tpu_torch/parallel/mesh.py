"""Several devices behind one parse step: the sharded parse plane (K8).

Reference: loongcollector_tpu/parallel/mesh.py.  Events are independent,
so the batch dimension shards cleanly: ``ShardedParsePlane`` splits a
batch of ``B`` rows into ``m`` contiguous row ranges ``[i·B/m,
(i+1)·B/m)``, one per device of a 1-D ``("dp",)`` mesh (the reference's
``shard_map`` with ``P(axis, None)``), and gives each device one K8
launch over its shards (a mesh that repeats a device, as a mesh of four
shards on one card does, holds several; ``DeviceMesh.runs``): K1's
extraction plus each shard's three counts, ``matched = Σ ok`` (padding
rows included), ``events = Σ (len > 0)`` and ``bytes = Σ len``
(``ExtractKernel.with_stats``; plain version ``extract_stats_plain``).

The reference adds the counts across chips with ``psum`` inside the
program (``mesh.py:93-97``).  Here one process owns every device, as the
JAX single controller does, so no process group or collective is needed:
each launch's count pieces (``field_extract_cuda.stat_pieces``) are
copied back with its outputs, folded into one i64 [3] vector a shard
(``ShardCounts``), and the ``m`` vectors are summed on the host when the
telemetry queue is folded — the ``psum``'s counterpart.

* ``DeviceMesh`` stands in for ``jax.sharding.Mesh``: an ordered tuple of
  ``torch.device``s and the axis name ``"dp"``.  ``make_mesh`` takes the
  CUDA devices (capped by ``LOONG_MESH_CHIPS``), or on the CPU
  ``LOONG_MESH_CHIPS`` shards of the one CPU device (default 1), standing
  in for the reference's virtual CPU devices.  An explicit device list may
  repeat a device: the tests and ``chip_smoke.py`` run a four-shard mesh
  on one card that way.
* ``ShardedKernel`` is what the regex engine dispatches (``LOONG_SHARDED``,
  ``ops/regex/engine.py``).  Staged, as ``StagedKernel``: ``kern(slot,
  C)`` copies each device's rows and lengths to it on that device's H2D
  stream (``thread_streams``), one copy an input, launches K8 once on the
  device's compute stream, copies its outputs back into the slot's pinned
  buffers at its first shard's offset and its count pieces into pinned
  host memory; the slot's fence covers every device's last event, and
  nothing synchronises the host.  Direct, as the reference: ``kern(rows,
  lengths) -> (ok, off, len)`` on host arrays, synchronous, through a
  kernel-private pad buffer when ``B % m != 0`` (counted in
  ``pad_fallbacks``).  ``batch_multiple`` (= m) feeds
  ``pad_batch(multiple_of=)``, so the engine's slots arrive aligned.
* Telemetry: each dispatch queues its counts; the queue is folded into
  the ``mesh_*_total`` counters (``MetricsRecord`` category
  ``device_plane``, component ``mesh``, label ``chips``) off the hot path
  — at ``status()``, at ``materialize_stats()``, or when it holds more
  than ``STATS_QUEUE_MAX`` dispatches (the oldest, long finished, is
  folded).  Per-chip row occupancy is counted on the host from the
  lengths.  ``mesh_status()`` gathers every live kernel's status.
* The staging copies are booked to the ``sharded_staging`` memory family
  for the duration of the dispatch call.  ``donated_call`` keeps the
  reference's name: PyTorch has no donation, and each dispatch's device
  copies are transient already.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import xprof
from ..ops.device_plane import mem_note_alloc, mem_note_free
from ..ops.device_stream import BatchSlot
from ..ops.kernels.field_extract import ExtractKernel, fold_pieces
from ..ops.regex.program import SegmentProgram
from ..utils.device import resolve_device


class DeviceMesh:
    """A 1-D mesh: an ordered tuple of devices and its axis name."""

    def __init__(self, devices: Sequence, axis: str = "dp"):
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (axis,)

    @property
    def size(self) -> int:
        return len(self.devices)

    def groups(self) -> List[Tuple[torch.device, List[int]]]:
        """Each distinct device, in mesh order, with its shards' indices."""
        out: Dict[torch.device, List[int]] = {}
        for i, d in enumerate(self.devices):
            out.setdefault(d, []).append(i)
        return list(out.items())

    def runs(self) -> List[Tuple[torch.device, int, int]]:
        """(device, first shard, shards): each device's consecutive shards,
        the rows of one K8 launch — one a device, whenever each device's
        shards are consecutive in the mesh (as ``make_mesh`` builds it)."""
        out = []
        for dev, shards in self.groups():
            first = shards[0]
            for prev, i in zip(shards, shards[1:] + [None]):
                if i != prev + 1:
                    out.append((dev, first, prev - first + 1))
                    first = i
        return out

    def __repr__(self) -> str:
        return f"DeviceMesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None, devices: Optional[list] = None,
              device=None) -> DeviceMesh:
    """The mesh over ``devices`` when given (it may repeat a device), else
    over the default device's kind: the CUDA devices, or shards of the one
    CPU device when ``device`` is ``"cpu"``.  ``n_devices`` (default
    ``LOONG_MESH_CHIPS``) caps the CUDA devices and counts the CPU shards
    (default 1).  Without CUDA and without ``device="cpu"`` it raises, as
    every entry point does."""
    from ..ops.chip_lanes import mesh_chip_cap
    if devices is not None:
        devices = list(devices)
        if n_devices is not None:
            devices = devices[:n_devices]
        return DeviceMesh(devices)
    dev = resolve_device(device)
    if n_devices is None:
        n_devices = mesh_chip_cap()
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devs = devs[:n_devices]
        return DeviceMesh(devs)
    return DeviceMesh([torch.device("cpu")] * (n_devices or 1))


class ShardCounts:
    """A dispatch's counts: each K8 launch's pieces (host i64 [pieces, 3],
    filled once the dispatch's fence has completed), folded into one i64
    [3] vector a shard on demand (``fold``)."""

    __slots__ = ("m", "s", "runs")

    def __init__(self, m: int, shard_rows: int):
        self.m, self.s = m, shard_rows
        self.runs: List[Tuple[int, int, torch.Tensor]] = []

    def add(self, first: int, shards: int, pieces: torch.Tensor) -> None:
        self.runs.append((first, shards, pieces))

    def fold(self) -> torch.Tensor:
        """i64 [m, 3]: each shard's matched, events and bytes."""
        out = torch.zeros((self.m, 3), dtype=torch.int64)
        for first, k, pieces in self.runs:
            out[first:first + k] = fold_pieces(pieces, k * self.s, self.s)
        return out


class _Fence:
    """The last events of a dispatch on several devices, waited on and
    queried as one (a slot's ``fence``, a ``HostOutput``'s ``done``)."""

    __slots__ = ("events",)

    def __init__(self, events):
        self.events = tuple(events)

    def query(self) -> bool:
        return all(e.query() for e in self.events)

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()


class ShardedParsePlane:
    """The parse step over a device mesh (reference ``ShardedParsePlane``).

    ``plane(rows [B, L], lengths [B])`` on host arrays returns (ok bool
    [B], cap_off i32 [B, C], cap_len i32 [B, C], counts i64 [m, 3]) as host
    tensors, synchronously; ``plane.staged(slot, C)`` is the streaming
    dispatch (see the module's docstring).  ``B`` must be a multiple of the
    mesh size."""

    def __init__(self, program: SegmentProgram,
                 mesh: Optional[DeviceMesh] = None,
                 kernel: Optional[ExtractKernel] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.program = program
        self.kernel = kernel if kernel is not None else ExtractKernel(program)
        for dev, _ in self.mesh.groups():
            self.kernel.warm(dev)

    @property
    def num_devices(self) -> int:
        return self.mesh.size

    def _shard_rows(self, B: int) -> int:
        m = self.mesh.size
        if B % m:
            raise ValueError(f"sharded parse: B={B} is not a multiple of the "
                             f"mesh size {m}")
        return B // m

    def __call__(self, rows, lengths):
        rows = torch.as_tensor(rows)
        lengths = torch.as_tensor(lengths)
        s = self._shard_rows(rows.shape[0])
        counts = ShardCounts(self.mesh.size, s)
        parts = []
        for dev, first, k in self.mesh.runs():
            r = rows[first * s:(first + k) * s]
            n = lengths[first * s:(first + k) * s]
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    out = self.kernel.with_stats(r.to(dev), n.to(dev),
                                                 shard_rows=s)
                out = [t.cpu() for t in out]
            else:
                out = self.kernel.with_stats(r.contiguous(), n.contiguous(),
                                             shard_rows=s)
            parts.append((first, out[:3]))
            counts.add(first, k, out[3])
        parts.sort(key=lambda p: p[0])
        ok, off, length = (torch.cat([p[1][j] for p in parts])
                           for j in range(3))
        return ok, off, length, counts.fold()

    def staged(self, slot: BatchSlot, C: int):
        """One dispatch of a packed slot: (outputs, ``ShardCounts``, fence
        or None).  On CUDA the outputs are ``HostOutput``s of the slot's
        buffers and the counts' pieces are filled once the fence has
        completed; on the CPU everything is filled on return."""
        s = self._shard_rows(slot.B)
        outs = slot.outputs(C)
        m = self.mesh.size
        counts = ShardCounts(m, s)
        xid = xprof.current_dispatch()
        runs = self.mesh.runs()
        if self.mesh.devices[0].type == "cpu":
            slot.fence = None
            t0 = time.perf_counter()
            results = [self.kernel.with_stats(
                slot.rows[first * s:(first + k) * s],
                slot.lengths[first * s:(first + k) * s], shard_rows=s)
                for _, first, k in runs]
            t1 = time.perf_counter()
            for (_, first, k), res in zip(runs, results):
                for dst, src in zip(outs, res[:3]):
                    dst[first * s:(first + k) * s].copy_(src)
                counts.add(first, k, res[3])
            if xid:
                xprof.leg(xid, "exec", t0, t1 - t0)
                xprof.leg(xid, "d2h", t1, time.perf_counter() - t1)
            return outs, counts, None
        from ..ops.device_plane import HostOutput, thread_streams
        timed = bool(xid)
        # each device's rows and lengths to it, one copy an input, on the
        # device's H2D stream; then its one launch on its compute stream,
        # once the copies are in, and the copies back
        dones = []
        for dev, first, k in runs:
            lo, hi = first * s, (first + k) * s
            streams = thread_streams(dev)
            e0 = torch.cuda.Event(enable_timing=timed)
            e1 = torch.cuda.Event(enable_timing=timed)
            with torch.cuda.stream(streams.h2d):
                e0.record(streams.h2d)
                rows = slot.rows[lo:hi].to(dev, non_blocking=True)
                lengths = slot.lengths[lo:hi].to(dev, non_blocking=True)
                e1.record(streams.h2d)
            if xid:
                xprof.event_leg(xid, "h2d", e0, e1, shard=first, device=dev)
            streams.compute.wait_event(e1)
            x0 = torch.cuda.Event(enable_timing=timed)
            x1 = torch.cuda.Event(enable_timing=timed)
            done = torch.cuda.Event(enable_timing=timed)
            with torch.cuda.stream(streams.compute):
                # allocated on the H2D stream, read on the compute one
                rows.record_stream(streams.compute)
                lengths.record_stream(streams.compute)
                # the exec leg, recorded by the wrapper right around the
                # entry point, as K1's is
                res = self.kernel.with_stats(rows, lengths, (x0, x1),
                                             shard_rows=s)
                for dst, src in zip(outs, res[:3]):
                    dst[lo:hi].copy_(src, non_blocking=True)
                pieces = torch.empty(res[3].shape, dtype=torch.int64,
                                     pin_memory=True)
                pieces.copy_(res[3], non_blocking=True)
                done.record(streams.compute)
            counts.add(first, k, pieces)
            dones.append(done)
            if xid:
                xprof.event_leg(xid, "exec", x0, x1, device=dev)
                xprof.event_leg(xid, "d2h", x1, done, device=dev)
        fence = dones[0] if len(dones) == 1 else _Fence(dones)
        slot.fence = fence
        return tuple(HostOutput(t, fence) for t in outs), counts, fence


# ---------------------------------------------------------------------------
# mesh telemetry: the counts folded off the hot path


_mesh_records: Dict[int, object] = {}
_mesh_records_lock = threading.Lock()


def _mesh_record(chips: int):
    rec = _mesh_records.get(chips)
    if rec is None:
        with _mesh_records_lock:
            rec = _mesh_records.get(chips)
            if rec is None:
                from ..monitor.metrics import MetricsRecord
                rec = MetricsRecord(
                    category="device_plane",
                    labels={"component": "mesh", "chips": str(chips)})
                _mesh_records[chips] = rec
    return rec


_live_kernels: "weakref.WeakSet" = weakref.WeakSet()


def mesh_status() -> Optional[dict]:
    """Every live ShardedKernel's status (folding its queued counts
    first), or None when the process built none."""
    kernels = list(_live_kernels)
    if not kernels:
        return None
    return {"kernels": [k.status() for k in kernels]}


class ShardedKernel:
    """The engine's side of the sharded plane: shaped like the staged
    single-device kernel (``kern(slot, C)``), with the reference's direct
    call (``kern(rows, lengths)``) beside it.  See the module docstring."""

    #: fold queued counts once the backlog exceeds this many dispatches —
    #: deeper than any stream depth, so the fold finds them finished
    STATS_QUEUE_MAX = 8

    def __init__(self, program: SegmentProgram,
                 mesh: Optional[DeviceMesh] = None,
                 kernel: Optional[ExtractKernel] = None):
        self.plane = ShardedParsePlane(program, mesh, kernel)
        # one dispatch's host staging (pad buffer, per-chip counts) at a
        # time: unbound workers share this kernel through the engine
        self._dispatch_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats_pending: deque = deque()
        self._record = _mesh_record(self.plane.num_devices)
        self._matched_total = self._record.counter("mesh_matched_total")
        self._events_total = self._record.counter("mesh_events_total")
        self._bytes_total = self._record.counter("mesh_bytes_total")
        self._dispatches_total = self._record.counter(
            "mesh_dispatches_total")
        self._pad_fallback_total = self._record.counter(
            "mesh_pad_fallback_total")
        m = self.plane.num_devices
        self._chip_real_rows = np.zeros(m, dtype=np.int64)
        self._chip_rows = np.zeros(m, dtype=np.int64)
        # private pad buffers for unaligned direct calls, keyed (B, L)
        self._pad_buffers: Dict[tuple, tuple] = {}
        _live_kernels.add(self)

    @property
    def batch_multiple(self) -> int:
        """Pack batches whose B is a multiple of this (the mesh size)."""
        return self.plane.num_devices

    @property
    def launches(self) -> int:
        """K8 launches of this kernel's program (one a device a dispatch;
        ``DeviceMesh.runs``)."""
        return self.plane.kernel.stats_launches

    # -- padding (direct calls only: the engine's slots arrive aligned) ----

    def _pad_to_mesh(self, rows: np.ndarray, lengths: np.ndarray):
        m = self.plane.num_devices
        b = rows.shape[0]
        if b % m == 0:
            return rows, lengths
        self._pad_fallback_total.add(1)
        B = b + (m - b % m)
        L = rows.shape[1]
        buf = self._pad_buffers.get((B, L))
        if buf is None:
            buf = (np.zeros((B, L), rows.dtype), np.zeros(B, lengths.dtype))
            self._pad_buffers[(B, L)] = buf
        prows, plens = buf
        prows[:b] = rows
        prows[b:] = 0
        plens[:b] = lengths
        plens[b:] = 0
        return prows, plens

    # -- telemetry -----------------------------------------------------------

    def _note_per_chip(self, lengths: np.ndarray) -> None:
        per = np.asarray(lengths).reshape(self.plane.num_devices, -1)
        self._chip_real_rows += (per > 0).sum(axis=1)
        self._chip_rows += per.shape[1]

    def _queue_stats(self, counts: ShardCounts, fence) -> None:
        with self._stats_lock:
            self._stats_pending.append((counts, fence))
            overflow = len(self._stats_pending) > self.STATS_QUEUE_MAX
        if overflow:
            self.materialize_stats(max_entries=1)

    def materialize_stats(self, max_entries: Optional[int] = None) -> dict:
        """Fold queued counts into the ``mesh_*_total`` counters: the sum
        over the shards of each dispatch (waiting on its fence, which the
        queue's depth makes a formality).  Returns the running totals."""
        while True:
            with self._stats_lock:
                if not self._stats_pending or max_entries == 0:
                    break
                counts, fence = self._stats_pending.popleft()
            if max_entries is not None:
                max_entries -= 1
            if fence is not None:
                fence.synchronize()
            if isinstance(counts, ShardCounts):
                counts = counts.fold()
            matched, events, nbytes = (int(v) for v in counts.sum(dim=0))
            self._matched_total.add(matched)
            self._events_total.add(events)
            self._bytes_total.add(nbytes)
        return {"matched": self._matched_total.value,
                "events": self._events_total.value,
                "bytes": self._bytes_total.value}

    def status(self) -> dict:
        totals = self.materialize_stats()
        occ = np.divide(self._chip_real_rows,
                        np.maximum(self._chip_rows, 1)).round(4)
        return {
            "chips": self.plane.num_devices,
            "devices": [str(d) for d in self.plane.mesh.devices],
            "dispatches": self._dispatches_total.value,
            "launches": self.launches,
            "pad_fallbacks": self._pad_fallback_total.value,
            "totals": totals,
            "per_chip_row_occupancy": occ.tolist(),
            "per_chip_padding_fraction": (1.0 - occ).round(4).tolist(),
        }

    # -- dispatch ------------------------------------------------------------

    def _staged(self, slot: BatchSlot, C: int):
        self.plane._shard_rows(slot.B)      # raises unless B splits evenly
        with self._dispatch_lock:
            self._note_per_chip(slot.lengths.numpy())
            self._dispatches_total.add(1)
            staged = slot.rows.nbytes + slot.lengths.nbytes
            mem_note_alloc("sharded_staging", staged)
            try:
                outs, counts, fence = self.plane.staged(slot, C)
            finally:
                mem_note_free("sharded_staging", staged)
        self._queue_stats(counts, fence)
        return outs

    def _direct(self, rows, lengths):
        rows = np.asarray(rows)
        lengths = np.asarray(lengths)
        with self._dispatch_lock:
            rows, lengths = self._pad_to_mesh(rows, lengths)
            self._note_per_chip(lengths)
            self._dispatches_total.add(1)
            staged = rows.nbytes + lengths.nbytes
            mem_note_alloc("sharded_staging", staged)
            try:
                ok, off, length, counts = self.plane(
                    torch.from_numpy(rows), torch.from_numpy(lengths))
            finally:
                mem_note_free("sharded_staging", staged)
        self._queue_stats(counts, None)
        return ok, off, length

    def __call__(self, a, b):
        """``kern(slot, C)``: the staged dispatch, returning the slot's
        outputs; ``kern(rows, lengths)``: the direct call on host arrays,
        returning (ok, off, len) host tensors of the padded batch."""
        if isinstance(a, BatchSlot):
            return self._staged(a, b)
        return self._direct(a, b)

    def donated_call(self, slot: BatchSlot, C: int):
        """The streaming path's dispatch (the reference's name: there its
        staging copies were donated to the outputs)."""
        return self._staged(slot, C)
