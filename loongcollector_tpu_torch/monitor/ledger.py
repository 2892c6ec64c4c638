"""loongledger: end-to-end event-conservation accounting.

The zero-loss guarantee the chaos storms assert post-hoc becomes
an always-on observability plane: every hand-off on the event path records
into a per-(pipeline, boundary) ledger of event/byte totals, so the
conservation residual

    residual = (ingest + process_expand + fanout + replay)
             - (send_ok + process_drop + spill + quarantine + drop)
             - inflight

is computable at any instant from one snapshot.  At a QUIESCED instant —
two identical consecutive snapshots and zero observed live occupancy —
``inflight`` is zero and a nonzero residual means an event crossed into
the agent and vanished without a ledger entry: a silent loss (or a code
path that discards without ``ledger.record`` — loonglint's
``unledgered-drop`` checker is the static side of the same contract).

Boundary catalogue (docs/observability.md#event-conservation-ledger):

  ingest               input read (file reader, test/bench harnesses)
  enqueue / dequeue    watermark process queues (enqueue at queue admit,
                       dequeue at queue pop); the dequeue→process_in gap
                       covers the dispatch hop + per-worker inboxes,
                       whose occupancy live_inflight() observes directly
  process_in           events entering the processor chain
  process_expand       events CREATED mid-chain (split 1 raw -> N lines;
                       also drain re-entry of held multiline carries)
  process_drop         events retired mid-chain, attributed to the
                       dropping plugin (includes events HELD across
                       groups by stateful processors — the matching
                       release records process_expand tag="drain")
  process_out          events leaving the chain toward the flushers
  device_submit /      group enters / leaves a worker lane's overlapped
  device_materialize   device ring (loongstream), tagged per lane
  serialize            events serialized into a sink payload
  send_ok / send_fail  terminal delivery / one failed attempt (partial-ack
                       aware: a Kafka ack-window cut ledgers the acked
                       prefix as send_ok, the unacked tail as send_fail
                       and retries it — never double-counted)
  spill / replay /     disk buffer traffic (breaker spill-on-open, exit
  quarantine           drain, corrupt-at-rest quarantine)
  fanout               extra copies minted when the router matches more
                       than one flusher
  drop                 explicit terminal discard, reason-tagged
  agg_in / agg_fold /  the loongagg windowed rollup contraction: rows in,
  agg_emit             rows consumed by the fold (sink), rollup rows
                       minted at window close (source); open windows are
                       live occupancy via the aggregator's
                       open_window_rows probe

The ledger is OFF by default and every hook is one module-global read
(``ledger.is_on()``) + branch.  ``LOONG_LEDGER=1`` turns the accounting
on; ``LOONG_LEDGER_AUDIT=1`` additionally runs the ConservationAuditor
continuously (every ``LOONG_LEDGER_AUDIT_INTERVAL`` seconds), raising
``CONSERVATION_RESIDUAL_ALARM`` whenever a quiesced snapshot shows a
nonzero residual.

The port's copy of the JAX package's ``monitor/ledger.py``, whole: the
boundaries, the ledger, the module hooks, the residual math, the
live-occupancy probe (``live_inflight``: process queues, in-process
groups, open rollup windows, worker inboxes and lanes, groups in a
worker's hand, the flusher runner's retry heap and sender queues, the
batchers), the lag watermarks, ``wait_quiesced`` / ``assert_conserved``,
``device_memory_residual`` (the port's own ``ring_slots`` accounting),
the auditor, the export records and ``/debug/ledger``.  The port records
at the boundaries its paths cross (ingest at the process-queue admit,
enqueue and dequeue, process_in / out / drop / expand per plugin and per
fused run, device_submit / device_materialize at the runner's lanes,
serialize and send_ok at the flushers, the send path's send_fail / spill /
replay / quarantine / drops, and the rollup's agg_in / agg_fold / agg_emit
/ drop).  The port has no flight recorder: an auditor alarm is not
mirrored there, and the occupancy probe's failures are logged once and
counted (``monitor/fail_soft.py``) besides reading as "not quiesced".
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

ENV_LEDGER = "LOONG_LEDGER"
ENV_AUDIT = "LOONG_LEDGER_AUDIT"
ENV_AUDIT_INTERVAL = "LOONG_LEDGER_AUDIT_INTERVAL"

_PKG = __name__.split(".")[0]

# -- boundary names ---------------------------------------------------------

B_INGEST = "ingest"
B_ENQUEUE = "enqueue"
B_DEQUEUE = "dequeue"
B_PROCESS_IN = "process_in"
B_PROCESS_OUT = "process_out"
B_PROCESS_DROP = "process_drop"
B_PROCESS_EXPAND = "process_expand"
B_DEVICE_SUBMIT = "device_submit"
B_DEVICE_MATERIALIZE = "device_materialize"
B_SERIALIZE = "serialize"
B_SEND_OK = "send_ok"
B_SEND_FAIL = "send_fail"
B_SPILL = "spill"
B_REPLAY = "replay"
B_QUARANTINE = "quarantine"
B_FANOUT = "fanout"
B_DROP = "drop"
# loongagg: the windowed fold is an N→M contraction with its own counted,
# attributed boundaries — agg_in (rows entering the rollup aggregator,
# informational like process_in), agg_fold (rows CONSUMED by the fold: a
# residual sink — the events are accounted for, their content now lives
# in open-window partials the auditor counts as live occupancy), agg_emit
# (rollup rows MINTED at window close: a residual source that then flows
# to the normal serialize/send_ok exits)
B_AGG_IN = "agg_in"
B_AGG_FOLD = "agg_fold"
B_AGG_EMIT = "agg_emit"

BOUNDARIES = (B_INGEST, B_ENQUEUE, B_DEQUEUE, B_PROCESS_IN, B_PROCESS_OUT,
              B_PROCESS_DROP, B_PROCESS_EXPAND, B_DEVICE_SUBMIT,
              B_DEVICE_MATERIALIZE, B_SERIALIZE, B_SEND_OK, B_SEND_FAIL,
              B_SPILL, B_REPLAY, B_QUARANTINE, B_FANOUT, B_DROP,
              B_AGG_IN, B_AGG_FOLD, B_AGG_EMIT)

#: residual = sum(sources) - sum(sinks) - inflight
SOURCE_BOUNDARIES = (B_INGEST, B_PROCESS_EXPAND, B_FANOUT, B_REPLAY,
                     B_AGG_EMIT)
SINK_BOUNDARIES = (B_SEND_OK, B_PROCESS_DROP, B_SPILL, B_QUARANTINE, B_DROP,
                   B_AGG_FOLD)


class EventLedger:
    """Per-(pipeline, boundary[, tag]) event/byte totals.

    One short lock around two integer adds per record() — the counters are
    process-lifetime absolutes (never drained), so a snapshot is directly
    comparable across time and the residual needs no delta bookkeeping."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (pipeline, boundary, tag) -> [events, bytes]
        self._cells: Dict[Tuple[str, str, str], List[int]] = {}

    def record(self, pipeline: str, boundary: str, events: int,
               nbytes: int = 0, tag: str = "") -> None:
        key = (pipeline or "", boundary, tag)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = [0, 0]
            cell[0] += events
            cell[1] += nbytes

    def total(self, pipeline: str, boundary: str) -> int:
        """Event total at one boundary, summed over tags."""
        with self._lock:
            return sum(c[0] for (p, b, _t), c in self._cells.items()
                       if p == pipeline and b == boundary)

    def pipelines(self) -> List[str]:
        with self._lock:
            return sorted({p for (p, _b, _t) in self._cells})

    def snapshot(self) -> dict:
        """{pipeline: {boundary: {"events", "bytes", "tags"?}}} — plain
        nested dicts, directly comparable (two equal snapshots == no
        boundary crossed in between)."""
        with self._lock:
            cells = dict(self._cells)
        out: Dict[str, dict] = {}
        for (p, b, t), (ev, by) in sorted(cells.items()):
            brow = out.setdefault(p, {}).setdefault(
                b, {"events": 0, "bytes": 0})
            brow["events"] += ev
            brow["bytes"] += by
            if t:
                brow.setdefault("tags", {})[t] = {"events": ev, "bytes": by}
        return out

    def reset(self) -> None:
        """Tests only: forget every total."""
        with self._lock:
            self._cells.clear()


# ---------------------------------------------------------------------------
# module-global hook (chaos-plane idiom: one global read when off)

_ledger: Optional[EventLedger] = None
_auditor: Optional["ConservationAuditor"] = None


def is_on() -> bool:
    return _ledger is not None


def active_ledger() -> Optional[EventLedger]:
    return _ledger


def record(pipeline: str, boundary: str, events: int,
           nbytes: int = 0, tag: str = "") -> None:
    """Record one boundary crossing.  No-op (one global read + branch)
    while the ledger is disabled; hot paths with non-trivial argument
    expressions guard with ``if ledger.is_on():`` so the disabled cost
    stays one branch."""
    led = _ledger
    if led is None:
        return
    led.record(pipeline, boundary, events, nbytes, tag)


def enable() -> EventLedger:
    global _ledger
    if _ledger is None:
        _ledger = EventLedger()
    return _ledger


def disable() -> None:
    """Turn accounting off and retire the export records (a disabled
    ledger must not keep exporting stale totals)."""
    global _ledger
    stop_auditor()
    _ledger = None
    _retire_export_records()


def install_from_env(env=os.environ) -> bool:
    """``LOONG_LEDGER=1`` enables accounting; ``LOONG_LEDGER_AUDIT=1``
    enables accounting AND starts the continuous auditor.  Returns True
    when the ledger came on."""
    audit = env.get(ENV_AUDIT, "") not in ("", "0")
    on = audit or env.get(ENV_LEDGER, "") not in ("", "0")
    if not on:
        return False
    enable()
    if audit:
        try:
            interval = float(env.get(ENV_AUDIT_INTERVAL, "1.0"))
        except ValueError:
            interval = 1.0
        start_auditor(interval_s=interval)
    return True


# ---------------------------------------------------------------------------
# residual math

def residual_of(pipe_snap: dict, inflight: int = 0) -> int:
    """Conservation residual for one pipeline's snapshot row."""
    ev = lambda b: pipe_snap.get(b, {}).get("events", 0)  # noqa: E731
    sources = sum(ev(b) for b in SOURCE_BOUNDARIES)
    sinks = sum(ev(b) for b in SINK_BOUNDARIES)
    return sources - sinks - inflight


def residuals(snap: dict) -> Dict[str, int]:
    """Per-pipeline QUIESCED residuals over a full snapshot (inflight is
    provably zero at quiesce, the only instant residuals are evaluated).
    The "" pipeline row (boundary traffic with no pipeline attribution)
    is skipped — it has no entry boundary to conserve against."""
    return {p: residual_of(rows) for p, rows in snap.items() if p}


def record_delta(pipeline: str, n_in: int, n_out: int, tag: str) -> None:
    """A stage that changed the event population either minted events
    (split: process_expand) or retired or held them (filter, multiline
    carry: process_drop), attributed to ``tag`` (the plugin).  The
    reference books this on its ``ProcessorInstance`` (``_ledger_delta``);
    the port's pipeline and fused runs call it around each stage."""
    delta = n_out - n_in
    if delta > 0:
        record(pipeline, B_PROCESS_EXPAND, delta, tag=tag)
    elif delta < 0:
        record(pipeline, B_PROCESS_DROP, -delta, tag=tag)


# ---------------------------------------------------------------------------
# live occupancy (observe-only, fail-soft — the exposition idiom)

def live_inflight() -> Optional[int]:
    """Approximate count of groups/items currently resident inside the
    agent (process queues, worker inboxes, device lanes, in-process
    groups, batchers, sender queues, retry heap, flusher-local queues).
    Units are deliberately mixed (groups vs items): the auditor only ever
    needs the ZERO test — residuals are evaluated exclusively at
    quiesce, where every term must be 0.

    Returns None when any occupancy probe raised: unknown occupancy must
    read as NOT quiesced (a partial total under-counts, and fail-soft
    here would convert a probe bug into a false CONSERVATION_RESIDUAL
    alarm — the one failure mode the auditor must never have).  The
    ``== 0`` quiesce tests treat None correctly (None != 0 → deferred)."""
    from . import fail_soft
    total = 0
    ok = True
    try:
        from ..pipeline import pipeline_manager as _pm
        mgr = _pm._active_manager
        if mgr is not None:
            pqm = mgr.process_queue_manager
            with mgr._lock:
                pipelines = list(mgr._pipelines.values())
            for p in pipelines:
                if pqm is not None:
                    q = pqm.get_queue(p.process_queue_key)
                    if q is not None:
                        total += q.size()
                total += p._in_process_cnt
                agg_probe = getattr(p.aggregator, "open_window_rows", None)
                if agg_probe is not None:
                    # loongagg: open-window partials are pending rollup
                    # rows — occupancy, so the audit defers until the
                    # windows flush (drain force-closes them)
                    total += int(agg_probe())
                for f in p.flushers:
                    probe = getattr(f, "inflight_events", None)
                    if probe is not None:
                        total += int(probe())
    except Exception as e:  # noqa: BLE001
        fail_soft.note("ledger.live_inflight.pipelines", e)
        ok = False
    try:
        from ..runner import processor_runner as _pr
        runner = _pr._active_runner
        if runner is not None:
            total += sum(runner.inbox_depths())
            total += sum(lane.pending_count() for lane in runner._lanes)
            # groups between a pop and their next counted station (a
            # descheduled worker's local variable is occupancy too)
            total += runner.in_hand_count()
    except Exception as e:  # noqa: BLE001
        fail_soft.note("ledger.live_inflight.processor_runner", e)
        ok = False
    try:
        from ..runner import flusher_runner as _fr
        fr = _fr._active_runner
        if fr is not None:
            with fr._retry_lock:
                total += len(fr._retry_heap)
            with fr.sqm._lock:
                queues = list(fr.sqm._queues.values())
            for q in queues:
                total += q.size()
    except Exception as e:  # noqa: BLE001
        fail_soft.note("ledger.live_inflight.flusher_runner", e)
        ok = False
    try:
        from ..pipeline.batch.timeout_flush_manager import TimeoutFlushManager
        with TimeoutFlushManager.instance()._reg_lock:
            hooks = list(TimeoutFlushManager.instance()._batchers)
        for h in hooks:
            probe = getattr(h, "pending_events", None)
            if probe is not None:
                total += int(probe())
    except Exception as e:  # noqa: BLE001
        fail_soft.note("ledger.live_inflight.batchers", e)
        ok = False
    return total if ok else None


# ---------------------------------------------------------------------------
# lag watermarks

def lag_snapshot() -> Dict[str, Dict[str, float]]:
    """Per-pipeline oldest-resident ages in seconds: how long the oldest
    queued group (process side) / payload (sender side) has been waiting.
    Backpressure made visible per pipeline; exported as
    ``queue_lag_seconds`` / ``sender_queue_lag_seconds`` gauges."""
    from . import fail_soft
    out: Dict[str, Dict[str, float]] = {}

    def _slot(name: str) -> Dict[str, float]:
        return out.setdefault(name, {"process_queue": 0.0,
                                     "sender_queue": 0.0})

    try:
        from ..pipeline import pipeline_manager as _pm
        mgr = _pm._active_manager
        if mgr is not None and mgr.process_queue_manager is not None:
            pqm = mgr.process_queue_manager
            with mgr._lock:
                pipelines = list(mgr._pipelines.values())
            for p in pipelines:
                q = pqm.get_queue(p.process_queue_key)
                if q is None:
                    continue
                # an empty queue reports 0.0 (not absent): the per-pipeline
                # lag series stays continuous across drains
                age = getattr(q, "oldest_age", lambda: None)() or 0.0
                slot = _slot(p.name)
                slot["process_queue"] = max(slot["process_queue"], age)
    except Exception as e:  # noqa: BLE001
        fail_soft.note("ledger.lag_snapshot.process_queue", e)
    try:
        from ..runner import flusher_runner as _fr
        fr = _fr._active_runner
        if fr is not None:
            with fr.sqm._lock:
                queues = list(fr.sqm._queues.values())
            for q in queues:
                if not q.pipeline_name:
                    continue      # unnamed queue: no pipeline to attribute
                age = getattr(q, "oldest_age", lambda: None)() or 0.0
                slot = _slot(q.pipeline_name)
                slot["sender_queue"] = max(slot["sender_queue"], age)
    except Exception as e:  # noqa: BLE001
        fail_soft.note("ledger.lag_snapshot.sender_queue", e)
    return out


def max_lag_seconds() -> float:
    """The single worst oldest-resident age across every queue (bench's
    ``extra.conservation.max_queue_lag_seconds`` samples this)."""
    worst = 0.0
    for ages in lag_snapshot().values():
        for v in ages.values():
            worst = max(worst, v)
    return worst


# ---------------------------------------------------------------------------
# quiesce helpers (tests, bench, auditor)

def wait_quiesced(timeout: float = 30.0, poll: float = 0.15,
                  settle_rounds: int = 2) -> Optional[dict]:
    """Block until `settle_rounds` consecutive identical snapshots with
    zero live occupancy, then return that snapshot (None on timeout).
    Identical snapshots prove no boundary crossed between polls; zero
    occupancy proves nothing is parked mid-segment (retry backoff,
    batcher hold) — together: inflight == 0, residual is exact."""
    led = _ledger
    if led is None:
        return None
    deadline = time.monotonic() + timeout
    prev = None
    stable = 0
    while time.monotonic() < deadline:
        snap = led.snapshot()
        if snap == prev and live_inflight() == 0:
            stable += 1
            if stable >= settle_rounds:
                return snap
        else:
            stable = 0
        prev = snap
        time.sleep(poll)
    return None


def assert_conserved(timeout: float = 30.0, label: str = "") -> dict:
    """Test/bench helper: wait for quiesce, then require every pipeline's
    residual to be zero.  ``label`` names the checkpoint in failure
    messages (e.g. "seed 42 at the mid-storm checkpoint").  Returns the
    quiesced snapshot."""
    at = f" [{label}]" if label else ""
    snap = wait_quiesced(timeout=timeout)
    assert snap is not None, (
        f"ledger never quiesced{at} within {timeout}s "
        f"(live_inflight={live_inflight()})")
    rs = residuals(snap)
    bad = {p: r for p, r in rs.items() if r != 0}
    assert not bad, (
        f"conservation residual nonzero at quiesce{at}: {bad}; "
        f"snapshot={snap}")
    return snap


def device_memory_residual() -> Optional[int]:
    """Byte-conservation probe: ``ring_slots`` live bytes when
    the batch ring holds zero leased slots, else None (not evaluable —
    bytes are legitimately live while slots are leased).  Also None when
    the device plane / stream modules were never imported: absence of the
    subsystem is not evidence of a leak."""
    _dp = sys.modules.get(f"{_PKG}.ops.device_plane")
    if _dp is None:
        return None
    _ds = sys.modules.get(f"{_PKG}.ops.device_stream")
    ring = getattr(_ds, "_ring", None) if _ds is not None else None
    if ring is not None and ring.totals().get("leased", 0) != 0:
        return None
    return int(_dp.mem_live_bytes("ring_slots"))


# ---------------------------------------------------------------------------
# continuous auditor

class ConservationAuditor:
    """Continuously audits quiesced snapshots; a nonzero residual raises
    ``AlarmType.CONSERVATION_RESIDUAL`` (once per episode per pipeline)
    with the per-boundary evidence an operator needs to start the triage
    in its details (the JAX package also writes a flight-recorder entry;
    the port has no flight recorder)."""

    def __init__(self, ledger: EventLedger, interval_s: float = 1.0):
        self.ledger = ledger
        self.interval_s = max(0.05, float(interval_s))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._prev: Optional[dict] = None
        self._alarmed: set = set()
        # nonzero residuals seen on the PREVIOUS quiesced audit: an event
        # caught mid-hop between two counted stations (popped but not yet
        # handed to its pipeline) can fake a +1 residual for one audit, so
        # the alarm requires the same imbalance on two consecutive
        # quiesced audits — a real loss persists, a hop resolves
        self._suspect: Dict[str, int] = {}
        self.audits_total = 0
        self.quiesced_audits_total = 0
        self.residual_alarms_total = 0
        # loongxprof device-memory conservation: same two-consecutive-
        # sightings discipline as event residuals (a slot freed between
        # the ring read and the ledger read fakes a one-audit residual)
        self._mem_suspect: Optional[int] = None
        self._mem_alarmed = False
        self.device_memory_alarms_total = 0

    # -- one audit step (tests drive this directly) -------------------------

    def audit_once(self) -> Dict[str, int]:
        """Take one snapshot; when it matches the previous one and live
        occupancy is zero, evaluate residuals and alarm on nonzero.
        Returns the residuals evaluated this step ({} when not
        quiesced)."""
        self.audits_total += 1
        snap = self.ledger.snapshot()
        quiesced = (snap == self._prev and live_inflight() == 0)
        self._prev = snap
        if not quiesced:
            self._suspect.clear()
            self._mem_suspect = None
            return {}
        self.quiesced_audits_total += 1
        self._audit_device_memory()
        rs = residuals(snap)
        suspects: Dict[str, int] = {}
        for pipeline, res in rs.items():
            if res == 0:
                self._alarmed.discard(pipeline)
                continue
            if pipeline in self._alarmed:
                continue
            if self._suspect.get(pipeline) != res:
                suspects[pipeline] = res      # first sighting: confirm next
                continue
            self._alarmed.add(pipeline)
            self.residual_alarms_total += 1
            self._raise(pipeline, res, snap.get(pipeline, {}))
        self._suspect = suspects
        return rs

    def _audit_device_memory(self) -> None:
        """loongxprof: byte-conservation leg of a quiesced audit — with
        the event ledger quiesced AND the batch ring holding zero leased
        slots, the device-memory ledger's ``ring_slots`` family must read
        zero live bytes (every lease was matched by a return/forget).
        Other families legitimately hold pooled/cached footprint at
        quiesce (DFA tables, staging pools), so only the ring ties."""
        res = device_memory_residual()
        if res is None:
            self._mem_suspect = None
            return
        if res == 0:
            self._mem_alarmed = False
            self._mem_suspect = None
            return
        if self._mem_alarmed:
            return
        if self._mem_suspect != res:
            self._mem_suspect = res        # first sighting: confirm next
            return
        self._mem_alarmed = True
        self.device_memory_alarms_total += 1
        from .alarms import AlarmLevel, AlarmManager, AlarmType
        AlarmManager.instance().send_alarm(
            AlarmType.CONSERVATION_RESIDUAL,
            f"device-memory conservation broken: ring_slots ledger holds "
            f"{res} live bytes at quiesce with zero leased slots (an "
            f"unledgered free path; see /debug/status device_memory)",
            AlarmLevel.CRITICAL, pipeline="__device__",
            details={"residual_bytes": str(res),
                     "family": "ring_slots"})

    def _raise(self, pipeline: str, res: int, rows: dict) -> None:
        from .alarms import AlarmLevel, AlarmManager, AlarmType
        totals = {b: r.get("events", 0) for b, r in sorted(rows.items())}
        AlarmManager.instance().send_alarm(
            AlarmType.CONSERVATION_RESIDUAL,
            f"event conservation broken: residual {res:+d} events at "
            f"quiesce (an unledgered loss path; see /debug/ledger)",
            AlarmLevel.CRITICAL, pipeline=pipeline,
            details={"residual": str(res),
                     "boundaries": repr(totals)})

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="ledger-auditor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.audit_once()
            except Exception:  # noqa: BLE001 — the auditor observes; it
                # must never take the agent down with it
                from ..utils.logger import get_logger
                get_logger("ledger").exception("conservation audit failed")


def start_auditor(interval_s: float = 1.0) -> ConservationAuditor:
    global _auditor
    if _auditor is None:
        _auditor = ConservationAuditor(enable(), interval_s=interval_s)
        _auditor.start()
    return _auditor


def stop_auditor() -> None:
    global _auditor
    if _auditor is not None:
        _auditor.stop()
        _auditor = None


def auditor() -> Optional[ConservationAuditor]:
    return _auditor


# ---------------------------------------------------------------------------
# export (Prometheus exposition + self-monitor pipeline)

_export_lock = threading.Lock()
_export_records: Dict[str, object] = {}


def _export_record(pipeline: str):
    rec = _export_records.get(pipeline)
    if rec is None:
        from .metrics import MetricsRecord
        with _export_lock:
            if _ledger is None:
                # disable() ran (or is mid-retire, which holds this same
                # lock): re-creating a record now would resurrect the
                # export and serve frozen totals forever
                return None
            rec = _export_records.get(pipeline)
            if rec is None:
                rec = _export_records[pipeline] = MetricsRecord(
                    category="ledger", labels={"pipeline": pipeline})
    return rec


def _retire_export_records() -> None:
    with _export_lock:
        for rec in _export_records.values():
            rec.mark_deleted()
        _export_records.clear()


def export_refresh() -> None:
    """Mirror ledger totals + residual + lag watermarks into per-pipeline
    gauge records (monotone gauges: the ledger's absolutes must survive
    the self-monitor's destructive counter drain).  Called by
    monitor/runtime_stats.refresh on the self-monitor cadence; no-op
    while the ledger is off."""
    led = _ledger
    if led is None:
        return
    snap = led.snapshot()
    lags = lag_snapshot()
    for pipeline in set(snap) | set(lags):
        if not pipeline:
            continue
        rec = _export_record(pipeline)
        if rec is None:      # disabled mid-refresh: stop mirroring
            return
        rows = snap.get(pipeline, {})
        for boundary, row in rows.items():
            rec.gauge("ledger_" + boundary + "_events").set(row["events"])
            rec.gauge("ledger_" + boundary + "_bytes").set(row["bytes"])
        rec.gauge("conservation_residual_events").set(
            residual_of(rows))
        ages = lags.get(pipeline, {})
        rec.gauge("queue_lag_seconds").set(ages.get("process_queue", 0.0))
        rec.gauge("sender_queue_lag_seconds").set(
            ages.get("sender_queue", 0.0))


def debug_document() -> dict:
    """The ``/debug/ledger`` page: full boundary matrix, per-pipeline
    residual, lag watermarks, live occupancy and auditor state."""
    led = _ledger
    doc: dict = {"enabled": led is not None}
    if led is None:
        return doc
    snap = led.snapshot()
    infl = live_inflight()
    doc["inflight_live"] = infl
    doc["pipelines"] = {
        p: {"boundaries": rows, "residual": residual_of(rows)}
        for p, rows in snap.items()}
    doc["lag"] = lag_snapshot()
    aud = _auditor
    if aud is not None:
        doc["auditor"] = {
            "interval_s": aud.interval_s,
            "audits_total": aud.audits_total,
            "quiesced_audits_total": aud.quiesced_audits_total,
            "residual_alarms_total": aud.residual_alarms_total,
        }
    return doc


def reset() -> None:
    """Tests only: zero totals (keeps the enabled state) and forget the
    auditor's quiesce baseline."""
    led = _ledger
    if led is not None:
        led.reset()
    if _auditor is not None:
        _auditor._prev = None
        _auditor._alarmed.clear()
        _auditor._suspect.clear()
