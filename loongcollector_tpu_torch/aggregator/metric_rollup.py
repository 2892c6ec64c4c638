"""aggregator_metric_rollup — columnar windowed metric rollups (loongagg).

The first real streaming aggregator (ROADMAP item 5): tumbling/sliding
event-time windows keyed per row by (metric name, configured label set),
folding sum/count/min/max/last plus the metrics.py-shaped log2-bucket
histogram — columnar end to end.  A batch's fold runs as ONE substrate
call (native ``lct_group_reduce`` — SIMD span hashing + hash segment
identity + row-order f64 reduce; numpy twin bit-identical; device twin
``ops/kernels/segment_reduce.SegmentReduceKernel`` — one dispatch per
``device_batch`` slot), so the per-row work is zero Python on every tier.
Only per-ROLLUP-KEY work (dict merge of batch partials into window state)
runs in the host language, and key cardinality is capped.

Windowing (slot granularity = SlideSecs, windows = WindowSecs wide,
``WindowSecs % SlideSecs == 0``; tumbling is SlideSecs == WindowSecs):

* the **watermark** is max event time seen minus AllowedLatenessSecs; a
  window [w0, w0+W) closes when the watermark passes its end — closed
  windows emit as fresh **columnar groups** (span columns over a new
  arena: name + labels + window bounds + aggregate columns) that ride the
  existing zero-copy serializers to any sink, including the
  remote-write-shaped payload on the prometheus http flusher;
* rows whose slot can no longer reach any open window are **late** —
  counted, reason-tagged in the ledger (``drop`` tag ``agg_late``), never
  silently absorbed;
* the key population across open windows is bounded by MaxKeys: inserting
  past the cap **evicts** the oldest open partial by emitting it early
  (split rollup, not data loss) — counted, alarmed
  (``AGG_WINDOW_EVICTION``).

Conservation (loongledger): the fold is an N→M contraction, which gets
its own boundaries instead of riding the generic aggregator delta —
``agg_in`` (rows entering), ``agg_fold`` (rows consumed by the fold: a
residual SINK), ``agg_emit`` (rollup rows minted at window close: a
residual SOURCE).  Open windows count as live occupancy
(``open_window_rows`` → ledger.live_inflight), so the auditor never
evaluates a residual while rollups are still pending, and
``flush()`` (pipeline drain, enable_full_drain_mode) force-closes every
window so drain always reaches a clean quiesce.

The port's copy of the JAX package's ``aggregator/metric_rollup.py``,
without the chaos point ``aggregator.flush`` (the port has no chaos
plane): every add and timeout tick may close windows.  The eviction alarm
``AGG_WINDOW_EVICTION`` is raised (and logged) once, as the reference
raises it.  Under ``Substrate: device`` the fold runs on the
pipeline's device (``context.device``): on CUDA every fold with a valid
row is one K6 launch (``ops/kernels/segment_reduce_cuda.py``), on the CPU
the kernel's plain version.  ``fold_counts`` counts the folds by the
substrate that ran them, ``fold_seconds`` their host seconds.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import ColumnarLogs, PipelineEventGroup, columnar_enabled
from ..models.event_group import SourceBuffer
from ..models.events import LogEvent, MetricEvent
from ..monitor import ledger
from ..monitor.metrics import MetricsRecord
from ..ops.kernels import segment_reduce as sr
from ..utils.device import resolve_device
from ..utils.logger import get_logger
from .base import Aggregator

log = get_logger("loongagg")

_SUBSTRATES = ("auto", "native", "numpy", "device")


class _Partial:
    """One (slot, key)'s folded state.  Merging happens batch-partial →
    window-partial on BOTH the columnar and the dict path (the dict path
    builds the same per-add() batch partials first), so the two-level f64
    summation order is identical and the bench's value-identity assert is
    exact, not approximate."""

    __slots__ = ("sum", "count", "min", "max", "last", "hist")

    def __init__(self, hist_slots: int = 0):
        self.sum = 0.0
        self.count = 0
        self.min = 0.0
        self.max = 0.0
        self.last = 0.0
        self.hist = (np.zeros(hist_slots, dtype=np.int64)
                     if hist_slots else None)

    def merge(self, b_sum: float, b_count: int, b_min: float, b_max: float,
              b_last: float, b_hist) -> None:
        if b_count <= 0:
            return
        if self.count == 0:
            self.min = b_min
            self.max = b_max
        else:
            if b_min < self.min:
                self.min = b_min
            if b_max > self.max:
                self.max = b_max
        self.sum += b_sum
        self.count += b_count
        self.last = b_last
        if self.hist is not None and b_hist is not None:
            self.hist += b_hist

    def merge_partial(self, other: "_Partial") -> None:
        self.merge(other.sum, other.count, other.min, other.max,
                   other.last, other.hist)


class AggregatorMetricRollup(Aggregator):
    """See module docstring.  Config:

    WindowSecs / SlideSecs / AllowedLatenessSecs — window geometry;
    MetricNameKey (default ``__name__``) / ValueKey (default ``value``) /
    LabelKeys — the per-row key and value columns; MaxKeys — open-key
    cardinality cap (counted eviction past it); EmitHistogram + HistBase —
    the log2-bucket histogram column; IdleFlushSecs — wall-clock TTL that
    force-closes windows when the event-time watermark stalls (idle
    source); Substrate — auto|native|numpy|device (also
    ``LOONG_AGG_SUBSTRATE``).  The device substrate runs on the
    pipeline's device, or on CUDA when the context names none."""

    name = "aggregator_metric_rollup"
    supports_columnar = True
    #: loongledger: this aggregator books its own agg_in/agg_fold/agg_emit
    #: boundaries — the pipeline's generic aggregator delta accounting
    #: must not double-book the contraction
    ledger_self_accounting = True

    def __init__(self) -> None:
        super().__init__()
        self.window_s = 10
        self.slide_s = 10
        self.lateness_s = 0
        self.name_key = "__name__"
        self.value_key = "value"
        self.label_keys: List[str] = []
        self.max_keys = 65536
        self.emit_histogram = True
        self.hist_base = sr.HIST_BASE
        self.idle_flush_s = 5.0
        self.substrate = "auto"
        self._pipeline_name = ""
        self._lock = threading.Lock()
        # slot -> {key fields tuple -> _Partial}; every mutation below
        # keeps _n_keys in sync — the MaxKeys cap + counted eviction is
        # what the unbounded-window loonglint rule requires of any window
        # state in aggregator/
        self._windows: Dict[int, Dict[Tuple, _Partial]] = {}
        self._n_keys = 0
        self._next_close: Optional[int] = None
        self._max_ts = None  # type: Optional[int]
        self._last_event_wall = 0.0
        self._evict_alarmed = False
        self._device_kern = None
        self._device: Optional[torch.device] = None
        # folds by the substrate that ran them, and their host seconds
        self.fold_counts: Dict[str, int] = {}
        self.fold_seconds = 0.0
        # fold→merge key interning (BENCH_r11 device-cliff satellite):
        # the numpy/device substrates hand back the representatives' raw
        # key-matrix rows (BatchFold.rep_key_blob) — steady-state batches
        # look their merge key tuple up by those hash-key bytes instead
        # of re-slicing the arena and re-minting bytes per group per
        # batch.  Bounded: cleared past 4×MaxKeys (churned label sets).
        self._key_intern: Dict[bytes, Tuple] = {}
        # evicted partials staged between _merge_locked and the group
        # build at the end of the same add() call
        self._pending_evicted: List[Tuple[int, int, Tuple, _Partial]] = []
        self.metrics = MetricsRecord(
            category="plugin",
            labels={"plugin_type": self.name, "plugin_id": self.name})
        self._m_folded = self.metrics.counter("agg_folded_rows_total")
        self._m_invalid = self.metrics.counter("agg_invalid_rows_total")
        self._m_late = self.metrics.counter("agg_late_rows_total")
        self._m_emitted = self.metrics.counter("agg_emitted_rows_total")
        self._m_evicted = self.metrics.counter("agg_window_evictions_total")
        self._m_idle_flush = self.metrics.counter("agg_idle_flushes_total")
        self._g_open_keys = self.metrics.gauge("agg_open_keys")
        self._g_open_windows = self.metrics.gauge("agg_open_windows")
        self._g_lag = self.metrics.gauge("agg_window_lag_seconds")

    # ------------------------------------------------------------------

    def init(self, config: Dict[str, Any], context) -> bool:
        super().init(config, context)
        self.window_s = int(config.get("WindowSecs", 10))
        self.slide_s = int(config.get("SlideSecs", self.window_s))
        self.lateness_s = int(config.get("AllowedLatenessSecs", 0))
        self.name_key = str(config.get("MetricNameKey", "__name__"))
        self.value_key = str(config.get("ValueKey", "value"))
        self.label_keys = [str(k) for k in config.get("LabelKeys", [])]
        self.max_keys = int(config.get("MaxKeys", 65536))
        self.emit_histogram = bool(config.get("EmitHistogram", True))
        self.hist_base = float(config.get("HistBase", sr.HIST_BASE))
        self.idle_flush_s = float(config.get("IdleFlushSecs", 5.0))
        self.substrate = str(os.environ.get(
            "LOONG_AGG_SUBSTRATE", config.get("Substrate", "auto"))).lower()
        if self.substrate not in _SUBSTRATES:
            log.error("unknown Substrate %r", self.substrate)
            self.metrics.mark_deleted()   # failed init: nobody owns it
            return False
        if self.window_s <= 0 or self.slide_s <= 0 \
                or self.window_s % self.slide_s != 0 \
                or self.lateness_s < 0 or self.max_keys < 1:
            log.error("bad window geometry: window=%s slide=%s lateness=%s",
                      self.window_s, self.slide_s, self.lateness_s)
            self.metrics.mark_deleted()
            return False
        self._pipeline_name = getattr(context, "pipeline_name", "") or ""
        if self.substrate == "device":
            self._device = resolve_device(getattr(context, "device", None))
        pipeline = getattr(context, "pipeline", None)
        if pipeline is not None:
            # record ownership: the pipeline retires it on release()
            pipeline._metric_records.append(self.metrics)
        return True

    # -- occupancy probe (ledger.live_inflight) -------------------------

    def open_window_rows(self) -> int:
        """Open (slot, key) partials across all windows, plus evicted
        partials staged for the next emission: nonzero while rollups are
        pending (the reference's auditor defers its audit on it)."""
        with self._lock:
            return self._n_keys + len(self._pending_evicted)

    # -- substrate fold -------------------------------------------------

    def _fold(self, arena, slots, key_offs, key_lens, val_offs, val_lens):
        t0 = time.perf_counter()
        out, used = self._fold_on(arena, slots, key_offs, key_lens,
                                  val_offs, val_lens)
        self.fold_seconds += time.perf_counter() - t0
        self.fold_counts[used] = self.fold_counts.get(used, 0) + 1
        return out

    def _fold_on(self, arena, slots, key_offs, key_lens, val_offs,
                 val_lens):
        """(fold, substrate that ran it)."""
        n_hist = sr.N_HIST if self.emit_histogram else 1
        sub = self.substrate
        if sub in ("auto", "native"):
            out = sr.fold_batch_native(arena, slots, key_offs, key_lens,
                                       val_offs, val_lens,
                                       hist_base=self.hist_base,
                                       n_hist=n_hist)
            if out is not None:
                return out, "native"
            if sub == "native":
                log.warning("native substrate unavailable; numpy fold")
        if sub == "device":
            # per-instance kernel: swapping the module-global on an
            # n_hist mismatch would discard the jit cache every batch
            # when two pipelines disagree on EmitHistogram
            kern = self._device_kern
            if kern is None:
                kern = (sr.device_kernel() if n_hist == sr.N_HIST
                        else sr.SegmentReduceKernel(n_hist))
                self._device_kern = kern
            return kern.fold_batch(arena, slots, key_offs, key_lens,
                                   val_offs, val_lens,
                                   hist_base=self.hist_base,
                                   device=self._device), "device"
        return sr.fold_batch_numpy(arena, slots, key_offs, key_lens,
                                   val_offs, val_lens,
                                   hist_base=self.hist_base,
                                   n_hist=n_hist), "numpy"

    # -- add ------------------------------------------------------------

    def add(self, group: PipelineEventGroup) -> List[PipelineEventGroup]:
        cols = group.columns
        out: List[PipelineEventGroup] = []
        with self._lock:
            if cols is not None and not group._events and columnar_enabled():
                self._add_columnar(group, cols)
            else:
                self._add_rows(group)
            self._last_event_wall = time.monotonic()
            out = self._close_ready_locked()
            self._export_gauges_locked()
        return out

    def _ledger_rows(self, boundary: str, n: int, nbytes: int = 0,
                     tag: str = "") -> None:
        if n and ledger.is_on():
            ledger.record(self._pipeline_name, boundary, n, nbytes, tag=tag)

    def _add_columnar(self, group: PipelineEventGroup,
                      cols: ColumnarLogs) -> None:
        n = len(cols)
        if n == 0:
            return
        self._ledger_rows(ledger.B_AGG_IN, n, cols.total_bytes)
        arena = group.source_buffer.as_array()
        ts = np.asarray(cols.timestamps, dtype=np.int64)
        slots = ts // self.slide_s
        absent_o = np.zeros(n, dtype=np.int64)
        absent_l = np.full(n, -1, dtype=np.int32)

        def col(key):
            pair = cols.fields.get(key)
            if pair is None:
                return absent_o, absent_l
            return (np.asarray(pair[0], dtype=np.int64),
                    np.asarray(pair[1], dtype=np.int32))

        key_cols = [col(self.name_key)] + [col(k) for k in self.label_keys]
        key_offs = np.stack([c[0] for c in key_cols], axis=1)
        key_lens = np.stack([c[1] for c in key_cols], axis=1)
        voffs, vlens = col(self.value_key)
        # a row without a metric name is not a metric: force it onto the
        # counted invalid path (value len -1) before the fold
        vlens = np.where(key_lens[:, 0] < 0, np.int32(-1), vlens)
        fold = self._fold(arena, slots, key_offs, key_lens, voffs, vlens)
        n_invalid = fold.n_invalid
        n_late = 0
        buf = memoryview(np.ascontiguousarray(arena))
        K = 1 + len(self.label_keys)
        # one .tolist() per column: the per-GROUP merge loop then runs on
        # plain Python scalars (numpy scalar extraction per group was the
        # dominant cost at batch-cardinality ~ batch-size)
        rep = fold.rep_row
        rep_slots = slots[rep].tolist()
        rep_offs = key_offs[rep].tolist()
        rep_lens = key_lens[rep].tolist()
        sums_l = fold.sum.tolist()
        cnts_l = fold.count.tolist()
        mins_l = fold.min.tolist()
        maxs_l = fold.max.tolist()
        lasts_l = fold.last.tolist()
        hist = fold.hist if self.emit_histogram else None
        next_close = self._next_close
        merge = self._merge_locked
        intern = self._key_intern
        blob = fold.rep_key_blob
        if blob is not None and len(intern) > 4 * self.max_keys:
            self._key_intern.clear()
        for g in range(fold.n_groups):
            slot = rep_slots[g]
            cnt = cnts_l[g]
            if next_close is not None and slot < next_close:
                # every window this slot could feed has closed: late
                n_late += cnt
                continue
            key = None
            bkey = None
            if blob is not None:
                # reuse the fold's hash-key bytes: the blob row carries
                # (slot, lens, key bytes) — strip the 8-byte slot prefix
                # so one metric series interns to ONE tuple across
                # slots.  The per-key padded widths are part of the key:
                # blob bytes alone are ambiguous across batches whose
                # column widths differ (zero padding moves).
                bkey = (fold.key_widths, blob[g, 8:].tobytes())
                key = intern.get(bkey)
            if key is None:
                ko = rep_offs[g]
                kl = rep_lens[g]
                key = tuple(
                    (bytes(buf[ko[k]:ko[k] + kl[k]]) if kl[k] >= 0
                     else None)
                    for k in range(K))
                if bkey is not None:
                    intern[bkey] = key
            merge(slot, key, sums_l[g], cnt, mins_l[g], maxs_l[g],
                  lasts_l[g], hist[g] if hist is not None else None)
        self._note_rows_locked(int(ts.max()) if n else None,
                               n - n_invalid - n_late, n_invalid, n_late)

    def _add_rows(self, group: PipelineEventGroup) -> None:
        """Per-event dict path (dict mode / already-materialized groups):
        identical two-level fold — batch partials first, merged into the
        window state with the same merge the columnar path uses."""
        events = group.events
        if not events:
            return
        self._ledger_rows(ledger.B_AGG_IN, len(events), group.data_size())
        name_b = self.name_key.encode()
        value_b = self.value_key.encode()
        label_bs = [k.encode() for k in self.label_keys]
        hist_slots = sr.N_HIST if self.emit_histogram else 0
        batch: Dict[Tuple[int, Tuple], _Partial] = {}
        n_invalid = 0
        n_late = 0
        max_ts = None
        for ev in events:
            ts = int(ev.timestamp)
            max_ts = ts if max_ts is None else max(max_ts, ts)
            slot = ts // self.slide_s
            if isinstance(ev, MetricEvent):
                nm = bytes(ev.name) if ev.name is not None else None
                v = (None if ev.value.is_multi()
                     else float(ev.value.value or 0.0))
                labels = tuple(
                    bytes(t) if (t := ev.get_tag(k)) is not None else None
                    for k in label_bs)
            elif isinstance(ev, LogEvent):
                nv = ev.get_content(name_b)
                nm = bytes(nv) if nv is not None else None
                vv = ev.get_content(value_b)
                v = None
                if vv is not None:
                    tok = bytes(vv).strip(b" \t")
                    if sr._VALUE_RE.match(tok):
                        v = float(tok)
                labels = tuple(
                    bytes(c) if (c := ev.get_content(k)) is not None
                    else None for k in label_bs)
            else:
                nm, v, labels = None, None, ()
            if v is None or nm is None:
                n_invalid += 1
                continue
            if self._next_close is not None and slot < self._next_close:
                n_late += 1
                continue
            key = (slot, (nm,) + labels)
            p = batch.get(key)
            if p is None:
                p = batch[key] = _Partial(hist_slots)
            if self.emit_histogram:
                bh = np.zeros(hist_slots, dtype=np.int64)
                bh[sr.hist_bucket_scalar(v, self.hist_base, hist_slots)] = 1
            else:
                bh = None
            p.merge(v, 1, v, v, v, bh)
        for (slot, key), p in batch.items():
            self._merge_locked(slot, key, p.sum, p.count, p.min, p.max,
                               p.last, p.hist)
        self._note_rows_locked(max_ts, len(events) - n_invalid - n_late,
                               n_invalid, n_late)

    def _note_rows_locked(self, max_ts: Optional[int], folded: int,
                          invalid: int, late: int) -> None:
        if max_ts is not None:
            self._max_ts = (max_ts if self._max_ts is None
                            else max(self._max_ts, max_ts))
        if folded:
            self._m_folded.add(folded)
            self._ledger_rows(ledger.B_AGG_FOLD, folded)
        if invalid:
            self._m_invalid.add(invalid)
            # rows without a parseable (name, value) shape are terminally
            # dropped, reason-tagged — never silently absorbed
            log.debug("dropping %d invalid metric rows", invalid)
            self._ledger_rows(ledger.B_DROP, invalid, tag="agg_invalid")
        if late:
            self._m_late.add(late)
            log.debug("dropping %d late metric rows (watermark passed)",
                      late)
            self._ledger_rows(ledger.B_DROP, late, tag="agg_late")

    def _merge_locked(self, slot: int, key: Tuple, b_sum: float,
                      b_count: int, b_min: float, b_max: float,
                      b_last: float, b_hist) -> None:
        d = self._windows.get(slot)
        p = d.get(key) if d is not None else None
        if p is None:
            if self._n_keys >= self.max_keys:
                # evict FIRST (it may retire the slot's whole dict), then
                # re-resolve the slot so the insert lands in live state
                self._evict_one_locked()
            d = self._windows.setdefault(slot, {})
            p = d[key] = _Partial(
                sr.N_HIST if self.emit_histogram else 0)
            self._n_keys += 1
        p.merge(b_sum, b_count, b_min, b_max, b_last, b_hist)

    # -- eviction (bounded cardinality) ---------------------------------

    def _evict_one_locked(self) -> None:
        """Emit the oldest open partial early — a split rollup, counted
        and alarmed, never a loss."""
        slot = min(self._windows)
        d = self._windows[slot]
        key, p = next(iter(d.items()))
        del d[key]
        if not d:
            del self._windows[slot]
        self._n_keys -= 1
        self._m_evicted.add(1)
        self._pending_evicted.append((slot * self.slide_s,
                                      slot * self.slide_s + self.window_s,
                                      key, p))
        if not self._evict_alarmed:
            self._evict_alarmed = True
            log.warning("pipeline %s: rollup key cardinality hit MaxKeys=%d: "
                        "open partials are being emitted early (split "
                        "rollups)", self._pipeline_name, self.max_keys)
            from ..monitor.alarms import (AlarmLevel, AlarmManager,
                                          AlarmType)
            AlarmManager.instance().send_alarm(
                AlarmType.AGG_WINDOW_EVICTION,
                f"rollup key cardinality hit MaxKeys={self.max_keys}: "
                "open partials are being emitted early (split rollups)",
                AlarmLevel.WARNING, pipeline=self._pipeline_name)

    # -- window close ---------------------------------------------------

    def _close_ready_locked(self) -> List[PipelineEventGroup]:
        """Emit every window whose end the watermark passed, plus any
        partials evicted during this call."""
        rows: List[Tuple[int, int, Tuple, _Partial]] = []
        if self._pending_evicted:
            rows.extend(self._pending_evicted)
            self._pending_evicted = []
        if self._max_ts is not None and self._windows:
            wm = self._max_ts - self.lateness_s
            per_slot = self.window_s // self.slide_s
            # first window start the watermark has NOT yet closed:
            # w0 closes iff w0*S + W <= wm
            first_open = (wm - self.window_s) // self.slide_s + 1
            if self._next_close is None:
                # cold start: the earliest window containing any open
                # slot (sliding windows emit partially filled)
                self._next_close = min(self._windows) - per_slot + 1
            while self._windows and self._next_close < first_open:
                # fast-forward over stretches with no open slots in one
                # step — but never past the watermark horizon, or rows
                # inside the lateness allowance after an event-time gap
                # would be spuriously declared late
                earliest = min(self._windows) - per_slot + 1
                if earliest > self._next_close:
                    self._next_close = min(earliest, first_open)
                    continue
                rows.extend(self._emit_window_locked(self._next_close))
                self._next_close += 1
        if not rows:
            return []
        return [self._build_group(rows)]

    def _emit_window_locked(self, w0: int
                            ) -> List[Tuple[int, int, Tuple, _Partial]]:
        """Merge the slots covering window starting at slot w0 and retire
        slot w0 (the oldest slot no future window needs)."""
        per_slot = self.window_s // self.slide_s
        merged: Dict[Tuple, _Partial] = {}
        for s in range(w0, w0 + per_slot):
            d = self._windows.get(s)
            if not d:
                continue
            for key, p in d.items():
                m = merged.get(key)
                if m is None:
                    m = merged[key] = _Partial(
                        sr.N_HIST if self.emit_histogram else 0)
                m.merge_partial(p)
        d = self._windows.pop(w0, None)
        if d:
            self._n_keys -= len(d)
        start = w0 * self.slide_s
        end = start + self.window_s
        return [(start, end, key, p) for key, p in merged.items()]

    # -- emission -------------------------------------------------------

    _AGG_FIELDS = ("window_start", "window_end", "sum", "count", "min",
                   "max", "last")

    @staticmethod
    def _fmt(v: float) -> bytes:
        # repr() is the shortest round-trip spelling — identical on the
        # columnar and dict paths because both format the same f64.
        # Non-finite first: the value grammar admits "inf", and inf+-inf
        # inside one key makes sum NaN — int(v) would raise AFTER the
        # window state was popped, losing the whole close
        if v != v:
            return b"nan"
        if v == float("inf"):
            return b"inf"
        if v == float("-inf"):
            return b"-inf"
        if v == int(v) and abs(v) < 1e16:
            return b"%d" % int(v)
        return repr(v).encode()

    def _build_group(self, rows: List[Tuple[int, int, Tuple, _Partial]]
                     ) -> PipelineEventGroup:
        """Closed-window rollup rows as ONE columnar group over a fresh
        arena — field span columns only, riding every zero-copy
        serializer downstream.  The metric-name column always emits
        under the CANONICAL ``__name__`` (MetricNameKey configures the
        INPUT column; downstream consumers — the prometheus flusher —
        must not have to know it).  Rows arriving split (an eviction
        followed by the same window's normal close) coalesce back into
        one row per (window, key) so a single payload never carries two
        same-timestamp samples of one series."""
        merged: Dict[Tuple, _Partial] = {}
        order: List[Tuple] = []
        for start, end, key, p in rows:
            mk = (start, end, key)
            m = merged.get(mk)
            if m is None:
                merged[mk] = p
                order.append(mk)
            else:
                m.merge_partial(p)
        rows = [(mk[0], mk[1], mk[2], merged[mk]) for mk in order]
        field_names = (["__name__"] + self.label_keys
                       + list(self._AGG_FIELDS)
                       + (["hist"] if self.emit_histogram else []))
        F = len(field_names)
        M = len(rows)
        blob = bytearray()
        offs = np.zeros((M, F), dtype=np.int32)
        lens = np.full((M, F), -1, dtype=np.int32)
        timestamps = np.zeros(M, dtype=np.int64)
        row_off = np.zeros(M, dtype=np.int32)
        row_len = np.zeros(M, dtype=np.int32)

        def put(i, f, data) -> None:
            if data is None:
                return
            offs[i, f] = len(blob)
            lens[i, f] = len(data)
            blob.extend(data)

        for i, (start, end, key, p) in enumerate(rows):
            row_off[i] = len(blob)
            timestamps[i] = end
            for k, kb in enumerate(key):
                put(i, k, kb)
            base = len(key)
            put(i, base + 0, b"%d" % start)
            put(i, base + 1, b"%d" % end)
            put(i, base + 2, self._fmt(p.sum))
            put(i, base + 3, b"%d" % p.count)
            put(i, base + 4, self._fmt(p.min))
            put(i, base + 5, self._fmt(p.max))
            put(i, base + 6, self._fmt(p.last))
            if self.emit_histogram:
                nz = np.nonzero(p.hist)[0]
                put(i, base + 7, b",".join(
                    b"%d:%d" % (int(b), int(p.hist[b])) for b in nz))
            row_len[i] = len(blob) - row_off[i]
        sb = SourceBuffer(max(len(blob), 16))
        off0 = sb.allocate(len(blob))
        sb.write_at(off0, bytes(blob))
        if off0:
            offs += off0
            row_off += off0
        cols = ColumnarLogs(row_off, row_len, timestamps)
        cols.content_consumed = True
        cols.set_fields_matrix(field_names, offs, lens)
        out = PipelineEventGroup(sb)
        out.set_columns(cols)
        out.set_tag(b"__rollup__", self.name.encode())
        self._m_emitted.add(M)
        self._ledger_rows(ledger.B_AGG_EMIT, M, len(blob))
        return out

    # -- gauges ---------------------------------------------------------

    def _export_gauges_locked(self) -> None:
        self._g_open_keys.set(float(self._n_keys))
        self._g_open_windows.set(float(len(self._windows)))
        if self._windows and self._max_ts is not None:
            lag = self._max_ts - min(self._windows) * self.slide_s
            self._g_lag.set(float(max(lag, 0)))
        else:
            self._g_lag.set(0.0)

    # -- timeout / drain ------------------------------------------------

    def flush_timeout(self) -> List[PipelineEventGroup]:
        """TimeoutFlushManager cadence: close what the watermark allows;
        when the event-time watermark has stalled for IdleFlushSecs of
        wall-clock (idle source), force-close everything."""
        with self._lock:
            out = self._close_ready_locked()
            if self._windows and self._last_event_wall and \
                    time.monotonic() - self._last_event_wall \
                    >= self.idle_flush_s:
                self._m_idle_flush.add(1)
                out.extend(self._force_flush_locked())
            self._export_gauges_locked()
        return out

    def flush(self) -> List[PipelineEventGroup]:
        """Pipeline drain: force-close every open window."""
        with self._lock:
            out = self._force_flush_locked()
            self._export_gauges_locked()
        return out

    def _force_flush_locked(self) -> List[PipelineEventGroup]:
        rows: List[Tuple[int, int, Tuple, _Partial]] = []
        if self._pending_evicted:
            rows.extend(self._pending_evicted)
            self._pending_evicted = []
        while self._windows:
            if self._next_close is None or \
                    self._next_close < min(self._windows) - \
                    (self.window_s // self.slide_s) + 1:
                self._next_close = min(self._windows) - \
                    (self.window_s // self.slide_s) + 1
            rows.extend(self._emit_window_locked(self._next_close))
            self._next_close += 1
        if not rows:
            return []
        return [self._build_group(rows)]
