"""The dispatch timeline: every device dispatch decomposed into its legs.

Reference: loongcollector_tpu/ops/xprof.py.  A dispatch id is minted in
``DevicePlane.submit`` and carried by its ``DeviceFuture``, or minted by a
synchronous K2/K4 batch for itself (``kernels/dfa_scan.py``); the dispatch
loops attach the legs they time.  Programs: ``regex`` (K1 chunks of the
engines), ``fused`` (K7 chunks of a fused run, ``ops/fused_pipeline.py``),
``dfa_match`` and ``fused_scan`` (K2, K4 batches) and ``stream``
(``DeviceStream``).  The legs:

  * ``pack``   — packing the rows into the leased ring slot (host
    ``perf_counter`` time);
  * ``submit`` — the dispatch call itself (host time);
  * ``h2d``    — the copy of the slot's rows and lengths to the device;
  * ``exec``   — the kernel;
  * ``d2h``    — the copy of the kernel's outputs back to the slot.

On CUDA the h2d, exec and d2h legs are pairs of CUDA events recorded on
the streams that do the work (``device_stream.StagedKernel``).  They are
read with ``Event.elapsed_time`` only when the dispatch settles
(``close_dispatch``, after its final event has completed), so the timeline
adds no synchronisation; an event pair that has not completed by then (a
dispatch released on an error path) is dropped and counted in
``unresolved``.  Device leg starts are relative to a CUDA event recorded
when the timeline is enabled, one on each CUDA device.  On the CPU the
legs are host stopwatches, relative to the host epoch.

A sharded dispatch (``parallel/mesh.ShardedKernel``) records an h2d leg
for each device's run of shards (one copy an input), tagged with the
run's first shard, and one exec leg (and one d2h leg) for each device of
the mesh, right around its one K8 launch: the exec legs stay one a
dispatch on one device, so the busy share stays the union of the device's
exec intervals.  The shard-
tagged legs are also kept per shard (``shard_leg_summary``).

Settled legs feed the decomposition: per (program, geometry, leg) samples
(``decomposition``), per-leg counts, sums and medians (``leg_summary``),
the union of the exec intervals (``exec_union_seconds``, the device-busy
time) and the count of dispatches whose h2d overlapped the previous
dispatch's exec (``overlapped_dispatches``).

The timeline is off until ``enable()``; every hook is then one global read
and a return.
"""

from __future__ import annotations

import contextlib
import itertools
import statistics
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

_DISPATCH_CAP = 50_000        # bounded like the reference's span ring
_MAX_LEGS_PER_DISPATCH = 48   # a sharded dispatch: a leg a shard

#: the decomposition legs in pipeline order
LEGS = ("pack", "submit", "h2d", "exec", "d2h")

HOST, DEVICE = "host", "device"


class DispatchRecord:
    """One dispatch: identity, program, geometry and its settled legs
    ``(leg, start_s, dur_s, clock)``; device legs wait in ``events`` as
    ``(leg, start_event, end_event)`` until the dispatch settles."""

    __slots__ = ("id", "nbytes", "program", "geometry", "legs", "events",
                 "closed", "shard_legs")

    def __init__(self, xid: int, nbytes: int):
        self.id = xid
        self.nbytes = nbytes
        self.program: Optional[str] = None
        self.geometry: Optional[str] = None
        self.legs: List[Tuple[str, float, float, str]] = []
        self.events: list = []
        self.closed = False
        # (leg, shard, start_s, dur_s) of the shard-tagged device legs
        self.shard_legs: List[Tuple[str, int, float, float]] = []

    def leg(self, name: str) -> Optional[Tuple[float, float, str]]:
        for leg, t0, dur, clock in self.legs:
            if leg == name:
                return t0, dur, clock
        return None


class DeviceTimeline:
    """Process-wide dispatch store: one lock, short critical sections,
    bounded buffers."""

    def __init__(self, device: Optional[torch.device] = None) -> None:
        self._lock = threading.Lock()
        self._records: Dict[int, DispatchRecord] = {}
        self._order: List[int] = []
        self._ids = itertools.count(1)
        self._dropped = 0
        self._closed_total = 0
        self._unresolved = 0
        # (program, geometry, leg) -> settled durations
        self._samples: Dict[Tuple[str, str, str], List[float]] = {}
        self.epoch = time.perf_counter()
        self.device_epoch = None
        # an epoch on every CUDA device: a mesh's or a lane's legs are
        # timed against their own device's epoch
        self._device_epochs: Dict[int, object] = {}
        if device is not None and device.type == "cuda":
            for i in range(torch.cuda.device_count()):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(i))
                self._device_epochs[i] = ev
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self.device_epoch = self._device_epochs[device.index]

    # -- recording ----------------------------------------------------------

    def begin(self, nbytes: int) -> int:
        xid = next(self._ids)
        rec = DispatchRecord(xid, nbytes)
        with self._lock:
            if len(self._order) < _DISPATCH_CAP:
                self._records[xid] = rec
                self._order.append(xid)
            else:
                self._dropped += 1
        return xid

    def annotate(self, xid: int, program: Optional[str] = None,
                 geometry: Optional[str] = None) -> None:
        with self._lock:
            rec = self._records.get(xid)
            if rec is None:
                return
            if program is not None:
                rec.program = program
            if geometry is not None:
                rec.geometry = geometry

    def leg(self, xid: int, name: str, t_start: float, dur_s: float) -> None:
        """A host leg: ``t_start`` is an absolute ``perf_counter()``."""
        with self._lock:
            rec = self._records.get(xid)
            if rec is None or rec.closed \
                    or len(rec.legs) >= _MAX_LEGS_PER_DISPATCH:
                return
            rec.legs.append((name, t_start - self.epoch, dur_s, HOST))

    def event_leg(self, xid: int, name: str, start, end,
                  shard: Optional[int] = None,
                  device: Optional[torch.device] = None) -> None:
        """A device leg between two CUDA events (read at settle), on
        ``device`` (default: the timeline's), of shard ``shard`` of a
        sharded dispatch when given."""
        with self._lock:
            rec = self._records.get(xid)
            if rec is None or rec.closed \
                    or len(rec.events) >= _MAX_LEGS_PER_DISPATCH:
                return
            rec.events.append((name, start, end, shard,
                               None if device is None else device.index))

    def _epoch(self, device_index: Optional[int]):
        if device_index is None:
            return self.device_epoch
        return self._device_epochs.get(device_index, self.device_epoch)

    def close(self, xid: int) -> None:
        """The dispatch settled: resolve its device legs and fold every
        leg into the decomposition, once."""
        with self._lock:
            rec = self._records.get(xid)
            if rec is None or rec.closed:
                return
            rec.closed = True
            events, rec.events = rec.events, []
        resolved, unresolved, by_shard = [], 0, []
        for name, start, end, shard, dev in events:
            epoch = self._epoch(dev)
            if epoch is None or not (start.query() and end.query()):
                unresolved += 1
                continue
            leg = (name, epoch.elapsed_time(start) / 1e3,
                   start.elapsed_time(end) / 1e3, DEVICE)
            resolved.append(leg)
            if shard is not None:
                by_shard.append((name, shard, leg[1], leg[2]))
        with self._lock:
            rec.legs.extend(resolved)
            rec.shard_legs.extend(by_shard)
            self._closed_total += 1
            self._unresolved += unresolved
            key = (rec.program or "unattributed", rec.geometry or "-")
            for leg, _t0, dur, _clock in rec.legs:
                self._samples.setdefault(key + (leg,), []).append(dur)

    # -- retrieval ----------------------------------------------------------

    def dispatches(self) -> List[DispatchRecord]:
        with self._lock:
            return [self._records[x] for x in self._order]

    def _closed(self) -> List[DispatchRecord]:
        return [r for r in self.dispatches() if r.closed]

    def decomposition(self) -> Dict[str, dict]:
        """Per (program, geometry): leg sums, counts and medians in ms."""
        with self._lock:
            samples = {k: list(v) for k, v in self._samples.items()}
        out: Dict[str, dict] = {}
        for (program, geometry, leg), durs in sorted(samples.items()):
            row = out.setdefault(f"{program}:{geometry}", {
                "legs_ms": {}, "legs_count": {}, "legs_median_ms": {}})
            row["legs_ms"][leg] = sum(durs) * 1e3
            row["legs_count"][leg] = len(durs)
            row["legs_median_ms"][leg] = statistics.median(durs) * 1e3
        return out

    def leg_summary(self) -> Dict[str, dict]:
        """Per leg over every settled dispatch: count, sum and median
        seconds, and the clock that timed it."""
        out: Dict[str, dict] = {}
        by_leg: Dict[Tuple[str, str], List[float]] = {}
        for rec in self._closed():
            for leg, _t0, dur, clock in rec.legs:
                by_leg.setdefault((leg, clock), []).append(dur)
        for (leg, clock), durs in sorted(by_leg.items()):
            out[leg] = {"count": len(durs), "sum_s": sum(durs),
                        "median_s": statistics.median(durs), "clock": clock}
        return out

    def shard_leg_summary(self) -> Dict[str, Dict[str, dict]]:
        """Per shard-tagged leg and shard, over every settled dispatch:
        count, sum and median seconds (device clock)."""
        by: Dict[Tuple[str, int], List[float]] = {}
        for rec in self._closed():
            for leg, shard, _t0, dur in rec.shard_legs:
                by.setdefault((leg, shard), []).append(dur)
        out: Dict[str, Dict[str, dict]] = {}
        for (leg, shard), durs in sorted(by.items()):
            out.setdefault(leg, {})[str(shard)] = {
                "count": len(durs), "sum_s": sum(durs),
                "median_s": statistics.median(durs)}
        return out

    def leg_seconds(self, leg: str, clock: Optional[str] = None) -> float:
        """Summed duration of one leg over every settled dispatch."""
        return sum(self.leg_durations(leg, clock))

    def leg_durations(self, leg: str, clock: Optional[str] = None,
                      program: Optional[str] = None) -> List[float]:
        """Durations of one leg over every settled dispatch (of one
        program, when given), in dispatch order."""
        return [dur for rec in self._closed()
                if program is None or rec.program == program
                for name, _t0, dur, c in rec.legs
                if name == leg and (clock is None or c == clock)]

    def exec_union_seconds(self, clock: str = DEVICE) -> float:
        """Seconds during which at least one exec leg ran: the device-busy
        time when several workers' kernels overlap."""
        spans = sorted((t0, t0 + dur) for rec in self._closed()
                       for name, t0, dur, c in rec.legs
                       if name == "exec" and c == clock)
        total, end = 0.0, None
        for a, b in spans:
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total

    def overlapped_dispatches(self) -> int:
        """Dispatches whose h2d interval intersects the exec interval of the
        dispatch minted just before them (both timed on one clock)."""
        recs = sorted(self._closed(), key=lambda r: r.id)
        n = 0
        for prev, cur in zip(recs, recs[1:]):
            h2d, ex = cur.leg("h2d"), prev.leg("exec")
            if h2d is None or ex is None or h2d[2] != ex[2]:
                continue
            if h2d[0] < ex[0] + ex[1] and h2d[0] + h2d[1] > ex[0]:
                n += 1
        return n

    def stats(self) -> dict:
        with self._lock:
            return {"dispatches": len(self._order),
                    "closed": self._closed_total,
                    "dropped": self._dropped,
                    "unresolved_legs": self._unresolved}


_timeline: Optional[DeviceTimeline] = None

_tls = threading.local()


def is_active() -> bool:
    return _timeline is not None


def active_timeline() -> Optional[DeviceTimeline]:
    return _timeline


def status() -> Optional[dict]:
    """The /debug/status ``xprof`` section (JAX package ``xprof.py:317``):
    the timeline's counts and its per-(program, geometry) decomposition;
    None while no timeline is recording."""
    t = _timeline
    if t is None:
        return None
    doc = t.stats()
    doc["decomposition"] = t.decomposition()
    return doc


def enable(device: Optional[torch.device] = None) -> DeviceTimeline:
    """Start a fresh timeline; on a CUDA device its epoch event is recorded
    on that device's current stream."""
    global _timeline
    t = DeviceTimeline(device)
    _timeline = t
    return t


def disable() -> None:
    global _timeline
    _timeline = None


@contextlib.contextmanager
def active(device: Optional[torch.device] = None):
    """Scoped activation: ``with xprof.active() as t: ...``."""
    t = enable(device)
    try:
        yield t
    finally:
        disable()


# -- hot-path hooks: one global read and a branch when disabled -------------


def begin_dispatch(nbytes: int) -> int:
    """Mint a dispatch id (``DevicePlane.submit``); 0 while off."""
    t = _timeline
    if t is None:
        return 0
    return t.begin(nbytes)


def leg(xid: int, name: str, t_start: float, dur_s: float) -> None:
    t = _timeline
    if t is None or not xid:
        return
    t.leg(xid, name, t_start, dur_s)


def event_leg(xid: int, name: str, start, end, shard: Optional[int] = None,
              device: Optional[torch.device] = None) -> None:
    t = _timeline
    if t is None or not xid:
        return
    t.event_leg(xid, name, start, end, shard, device)


def annotate(xid: int, program: str, geometry: str) -> None:
    t = _timeline
    if t is None or not xid:
        return
    t.annotate(xid, program=program, geometry=geometry)


def close_dispatch(xid: int) -> None:
    t = _timeline
    if t is None or not xid:
        return
    t.close(xid)


def note_dispatch(fut, program: str, geometry: str,
                  pack_t0: Optional[float] = None,
                  pack_dur: Optional[float] = None) -> None:
    """Attribute the future's dispatch to a program and geometry and attach
    the pack leg the caller timed."""
    t = _timeline
    if t is None:
        return
    xid = getattr(fut, "dispatch_id", 0)
    if not xid:
        return
    t.annotate(xid, program=program, geometry=geometry)
    if pack_dur is not None and pack_t0 is not None:
        t.leg(xid, "pack", pack_t0, pack_dur)


# -- current-dispatch TLS: code running inside the submitted kernel call
#    attaches its legs to the enclosing dispatch ---------------------------


def set_current_dispatch(xid: int) -> None:
    _tls.xid = xid


def current_dispatch() -> int:
    """The dispatch id of the enclosing ``DevicePlane.submit``, 0 outside
    one or while the timeline is off."""
    if _timeline is None:
        return 0
    return getattr(_tls, "xid", 0)
