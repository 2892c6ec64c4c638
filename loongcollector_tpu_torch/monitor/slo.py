"""loongslo: the end-to-end freshness SLO plane.

Every event group admitted at the ledger's single B_INGEST hook
(ProcessQueueManager.push_queue) gets a monotonic-ns ingest stamp riding
its group METADATA (EventGroupMetaKey.INGEST_NS — columnar-safe: metadata
never touches the event columns).  Derived groups inherit the stamp via
``copy_meta_to``; router fanout bumps a refcount (``note_fanout``)
exactly like the loongcrash ack watermark; aggregator rollups are minted
stampless and stamped at window close (``ensure_stamp`` in
``CollectionPipeline._send_direct``).

At every terminal-ack site the ack watermark already enumerates —
delivered (``send_ok``), durably spilled (``spill``), reason-tagged
discard (``drop``) — the stamp is observed: the ingest→terminal sojourn
lands in a per-(pipeline, outcome) log2 histogram ``event_to_flush_ms``
and the stamp is released from the outstanding registry.

``pipeline_freshness_seconds`` is now − the pipeline's oldest outstanding
stamp, BY CONSTRUCTION exactly 0.0 when nothing is outstanding: a
drained/idle pipeline can never read "now − ancient stamp".  The registry
is keyed by pipeline NAME, so a hot-reload generation handoff keeps the
series continuous (old-generation stamps stay visible until their
terminals, new-generation stamps join the same series).

On top, per-pipeline SLO objectives — sojourn p99 bound, freshness bound,
delivered-fraction target — are evaluated by the Google-SRE multi-window
multi-burn-rate rule scaled to agent timescales: a fast pair (default
30 s long / 5 s short at 14.4× burn) catches cliffs, a slow pair (120 s /
30 s at 6×) catches smolder; a trip additionally fires on a freshness
breach.  A trip raises ``AlarmType.SLO_BURN_RATE`` ONCE per episode with
a stage-attributed budget breakdown — deltas of the existing queue_wait /
stage / device_roundtrip / sender_queue_wait / sink_rtt histograms since
the last healthy evaluator tick, ranked by which hop ate the budget —
attached to the alarm details and ``/debug/slo``.
The episode clears (and re-arms) once both SHORT windows are back under
their thresholds and freshness is within bound.

Chaos-plane idiom: OFF by default, and every disabled hook is one
module-global read + branch.  ``LOONG_SLO=1`` enables the plane and its
evaluator thread.

The port's copy of the JAX package's ``monitor/slo.py``: the same stamps,
refcounts, burn-rate rule, episodes, breakdown, export gauges and
``/debug/slo`` document.  The port has no flight recorder (``prof/``), so
an episode's raise and clear are not written there: the raise is the
``SLO_BURN_RATE`` alarm, and each clear is counted per pipeline (``clears``
on ``/debug/slo``).  The hop totals are the histograms' cumulative totals, which
the port's self-monitor does not reset (``monitor/metrics.py``): the JAX
package reads values its self-monitor drains, and a drain between the
last healthy tick and a trip leaves its breakdown empty.  The breakdown also counts the wait in progress (the ledger's lag
watermarks): a freshness trip lands while its stamp still waits, often in
a sender queue's backoff between two attempts, and the JAX package's
breakdown, which sees only completed waits, then names whichever hop
finished work in the last evaluator interval.  A payload spilled in the
callback of its failed send (the breaker opened on it) has its round
trip observed before the spill books the bad outcome; a healthy tick
between the two moves the baseline past the round trip, and the spilled
payload waits nowhere, so the JAX package's breakdown names no hop.  The
port's names the ``sink`` hop with those payloads' egress seconds
(``observe_spill``).  The hop totals'
fail-soft read is logged once and counted (``monitor/fail_soft.py``)
instead of passing silently.
"""

from __future__ import annotations

import heapq
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..models.event_group import EventGroupMetaKey

ENV_SLO = "LOONG_SLO"
ENV_INTERVAL = "LOONG_SLO_INTERVAL"
ENV_SOJOURN_MS = "LOONG_SLO_SOJOURN_P99_MS"
ENV_FRESHNESS_S = "LOONG_SLO_FRESHNESS_S"
ENV_TARGET = "LOONG_SLO_TARGET"

# terminal outcome taxonomy (docs/observability.md#freshness-slo-plane):
# every outcome mirrors a terminal the ack watermark already acks
OUTCOME_SEND_OK = "send_ok"
OUTCOME_SPILL = "spill"
OUTCOME_DROP = "drop"
OUTCOMES = (OUTCOME_SEND_OK, OUTCOME_SPILL, OUTCOME_DROP)

#: outstanding-stamp cap per pipeline — the same backstop shape as the ack
#: watermark's MAX_OUTSTANDING_SPANS: a terminal-starved pipeline (sink
#: down for hours) must bound registry memory; expiries are counted, and
#: an expired stamp's late terminal lands in stale_retires (not an error)
MAX_OUTSTANDING_STAMPS = 8192

#: per-second result ring horizon — must cover the longest burn window
RING_SECONDS = 600

#: hop attribution for the budget breakdown: existing histogram name →
#: budget hop.  sender_queue_wait and sink_rtt fold into one "sink" hop
#: (queue age + wire round-trips are both the egress leg's spend)
HOP_HISTOGRAMS = {
    "queue_wait_seconds": "queue",
    "stage_seconds": "stage",
    "device_roundtrip_seconds": "device",
    "sender_queue_wait_seconds": "sink",
    "sink_rtt_seconds": "sink",
}

_META_KEY = EventGroupMetaKey.INGEST_NS


class SloObjectives:
    """Per-pipeline SLO contract.  ``fast`` / ``slow`` are
    (long_window_s, short_window_s, burn_threshold) pairs — the classic
    multi-window multi-burn-rate shape, shrunk from SRE-book hours to
    agent seconds (a log agent's budget burns in minutes, not days)."""

    __slots__ = ("sojourn_p99_ms", "freshness_s", "target", "fast", "slow")

    def __init__(self, sojourn_p99_ms: float = 5000.0,
                 freshness_s: float = 30.0, target: float = 0.999,
                 fast: Tuple[float, float, float] = (30.0, 5.0, 14.4),
                 slow: Tuple[float, float, float] = (120.0, 30.0, 6.0)):
        self.sojourn_p99_ms = float(sojourn_p99_ms)
        self.freshness_s = float(freshness_s)
        self.target = min(float(target), 1.0 - 1e-9)
        self.fast = (float(fast[0]), float(fast[1]), float(fast[2]))
        self.slow = (float(slow[0]), float(slow[1]), float(slow[2]))

    def to_dict(self) -> dict:
        return {"sojourn_p99_ms": self.sojourn_p99_ms,
                "freshness_s": self.freshness_s,
                "target": self.target,
                "fast": list(self.fast), "slow": list(self.slow)}


class _PipeState:
    """Per-pipeline mutable state (all fields guarded by the plane lock
    except the firing/episode transitions' side effects, which run outside
    it)."""

    __slots__ = ("name", "heap", "ring", "ok_total", "bad_total",
                 "firing", "episodes", "clears", "stale_retires",
                 "forced_expirations", "objectives", "last_breakdown",
                 "last_stats")

    def __init__(self, name: str):
        self.name = name
        self.heap: List[int] = []          # outstanding stamp min-heap (ns)
        self.ring: Dict[int, List[int]] = {}   # second -> [ok, bad]
        self.ok_total = 0
        self.bad_total = 0
        self.firing = False
        self.episodes = 0
        self.clears = 0
        self.stale_retires = 0
        self.forced_expirations = 0
        self.objectives: Optional[SloObjectives] = None
        self.last_breakdown: Optional[dict] = None
        self.last_stats: dict = {}


class SloPlane:
    def __init__(self, objectives: Optional[SloObjectives] = None):
        self.objectives = objectives or SloObjectives()
        self.max_outstanding = MAX_OUTSTANDING_STAMPS
        self._lock = threading.Lock()
        # ns stamp -> [pipeline, refcount]; stamps are uniquified at mint
        # so one ns addresses exactly one admit
        self._refs: Dict[int, List] = {}
        self._states: Dict[str, _PipeState] = {}
        self._rec_lock = threading.Lock()
        self._retired = False
        self._hist_records: Dict[Tuple[str, str], object] = {}
        self._hists: Dict[Tuple[str, str], object] = {}
        self._gauge_records: Dict[str, object] = {}
        # budget-breakdown baseline: hop-histogram (sum, count) at the last
        # healthy evaluator tick — a trip's breakdown is the delta since
        self._hop_baseline: Dict[str, Tuple[float, int]] = {}
        # egress-leg seconds of the payloads spilled after a failed send
        # since that tick, and the spills still booking (``observe_spill``)
        self._spilled_s = 0.0
        self._spills_booking = 0

    # -- stamp registry ------------------------------------------------------

    def _state_locked(self, pipeline: str) -> _PipeState:
        st = self._states.get(pipeline)
        if st is None:
            st = self._states[pipeline] = _PipeState(pipeline)
        return st

    def stamp(self, pipeline: str, group) -> None:
        """Mint + attach an ingest stamp (B_INGEST admit).  Runs BEFORE
        the queue push so a consumer can never observe a half-stamped
        group; a refused push must cancel_group."""
        ns = time.monotonic_ns()
        with self._lock:
            while ns in self._refs:     # uniquify: one ns == one admit
                ns += 1
            self._refs[ns] = [pipeline or "", 1]
            st = self._state_locked(pipeline or "")
            heapq.heappush(st.heap, ns)
            if len(st.heap) > self.max_outstanding:
                self._force_expire_locked(st)
        group.set_metadata(_META_KEY, str(ns))

    def ensure_stamp(self, pipeline: str, group) -> None:
        """Stamp only when missing — the aggregator-rollup exemption:
        rollup groups are minted stampless and enter the egress path at
        window close, which IS their ingest instant."""
        if group.get_metadata(_META_KEY) is None:
            self.stamp(pipeline, group)

    def _force_expire_locked(self, st: _PipeState) -> None:
        # drop lazily-dead heads first; then force-expire oldest live
        # stamps down to half capacity (counted — the freshness watermark
        # deliberately forgets what it can no longer afford to track)
        refs = self._refs
        while st.heap and st.heap[0] not in refs:
            heapq.heappop(st.heap)
        while len(st.heap) > self.max_outstanding // 2:
            ns = heapq.heappop(st.heap)
            if refs.pop(ns, None) is not None:
                st.forced_expirations += 1

    @staticmethod
    def stamp_of(group) -> Optional[int]:
        v = group.get_metadata(_META_KEY)
        if v is None:
            return None
        try:
            return int(str(v))
        except ValueError:
            return None

    def stamps_of(self, groups) -> Tuple[int, ...]:
        """Stamps a serialized payload carries — erasure-proof transport
        past the group→bytes boundary (the SenderQueueItem.spans shape)."""
        out = []
        for g in groups:
            ns = self.stamp_of(g)
            if ns is not None:
                out.append(ns)
        return tuple(out)

    def cancel_group(self, group) -> None:
        """Un-admit (refused queue push rolled back by the caller): the
        stamp never entered the agent, so it must not age the watermark."""
        ns = self.stamp_of(group)
        if ns is None:
            return
        with self._lock:
            self._refs.pop(ns, None)    # heap entry dies lazily

    def note_fanout(self, group, n: int) -> None:
        """Router matched ``n`` flushers: n−1 extra copies will each reach
        their own terminal — raise the refcount BEFORE any copy can ack
        (the ack-watermark fanout contract)."""
        ns = self.stamp_of(group)
        if ns is None or n <= 1:
            return
        with self._lock:
            entry = self._refs.get(ns)
            if entry is not None:
                entry[1] += n - 1

    # -- terminal observation ------------------------------------------------

    def observe_stamps(self, pipeline: str, stamps, outcome: str,
                       retire_only: bool = False,
                       now_ns: Optional[int] = None) -> None:
        if not stamps:
            return
        now = time.monotonic_ns() if now_ns is None else now_ns
        resolved = []
        with self._lock:
            for ns in stamps:
                entry = self._refs.get(ns)
                if entry is None:
                    # already released (fanout copy past the refcount,
                    # force-expired, or a replayed payload) — still a real
                    # delivery latency, attributed via the caller's hint
                    self._state_locked(pipeline or "").stale_retires += 1
                    resolved.append((pipeline or "", ns))
                    continue
                entry[1] -= 1
                if entry[1] <= 0:
                    del self._refs[ns]
                resolved.append((entry[0], ns))
        if retire_only:
            return
        now_s = time.monotonic()
        for pipe, ns in resolved:
            self.note_result(pipe, (now - ns) / 1e6, outcome, now_s=now_s)

    def observe_groups(self, pipeline: str, groups, outcome: str) -> None:
        self.observe_stamps(pipeline, self.stamps_of(groups), outcome)

    def retire_groups(self, groups) -> None:
        """Release stamps without a sojourn sample: the group's content
        was folded elsewhere (aggregator absorb, filtered-to-empty) — its
        DELIVERY is someone else's stamp."""
        self.observe_stamps("", self.stamps_of(groups), OUTCOME_DROP,
                            retire_only=True)

    def note_result(self, pipeline: str, sojourn_ms: float, outcome: str,
                    now_s: Optional[float] = None) -> None:
        """Feed one terminal result into the burn-rate ring + sojourn
        histogram.  "Bad" for the error budget = not delivered, OR
        delivered slower than the sojourn bound."""
        now = time.monotonic() if now_s is None else now_s
        sec = int(now)
        with self._lock:
            st = self._state_locked(pipeline or "")
            obj = st.objectives or self.objectives
            bad = (outcome != OUTCOME_SEND_OK
                   or sojourn_ms > obj.sojourn_p99_ms)
            slot = st.ring.get(sec)
            if slot is None:
                slot = st.ring[sec] = [0, 0]
                if len(st.ring) > RING_SECONDS:
                    cutoff = sec - RING_SECONDS
                    for s in [s for s in st.ring if s < cutoff]:
                        del st.ring[s]
            slot[1 if bad else 0] += 1
            if bad:
                st.bad_total += 1
            else:
                st.ok_total += 1
        h = self._hist(pipeline or "", outcome)
        if h is not None:
            h.observe(max(0.0, sojourn_ms))

    # -- freshness watermark -------------------------------------------------

    def _freshness_locked(self, st: _PipeState,
                          now_ns: Optional[int] = None) -> float:
        heap, refs = st.heap, self._refs
        while heap and heap[0] not in refs:
            heapq.heappop(heap)
        if not heap:
            return 0.0      # quiesced: hard zero by construction
        now = time.monotonic_ns() if now_ns is None else now_ns
        return max(0.0, (now - heap[0]) / 1e9)

    def freshness(self, pipeline: str) -> float:
        with self._lock:
            st = self._states.get(pipeline or "")
            if st is None:
                return 0.0
            return self._freshness_locked(st)

    def outstanding(self, pipeline: str) -> int:
        with self._lock:
            st = self._states.get(pipeline or "")
            if st is None:
                return 0
            heap, refs = st.heap, self._refs
            while heap and heap[0] not in refs:
                heapq.heappop(heap)
            return sum(1 for ns in heap if ns in refs)

    # -- burn-rate evaluation ------------------------------------------------

    def _window_locked(self, st: _PipeState, now_s: float,
                       window_s: float) -> Tuple[int, int]:
        lo = int(now_s) - int(window_s)
        ok = bad = 0
        for sec, slot in st.ring.items():
            if sec > lo:
                ok += slot[0]
                bad += slot[1]
        return ok, bad

    def _burn_locked(self, st: _PipeState, now_s: float, window_s: float,
                     obj: SloObjectives) -> float:
        ok, bad = self._window_locked(st, now_s, window_s)
        total = ok + bad
        if total == 0:
            return 0.0
        return (bad / total) / (1.0 - obj.target)

    def _stats_locked(self, st: _PipeState, now_s: float) -> dict:
        obj = st.objectives or self.objectives
        bf_long = self._burn_locked(st, now_s, obj.fast[0], obj)
        bf_short = self._burn_locked(st, now_s, obj.fast[1], obj)
        bs_long = self._burn_locked(st, now_s, obj.slow[0], obj)
        bs_short = self._burn_locked(st, now_s, obj.slow[1], obj)
        fresh = self._freshness_locked(st)
        ok, bad = self._window_locked(st, now_s, obj.slow[0])
        allowed = (ok + bad) * (1.0 - obj.target)
        if ok + bad == 0:
            remaining = 1.0
        elif allowed <= 0.0:
            remaining = 0.0 if bad else 1.0
        else:
            remaining = max(0.0, 1.0 - bad / allowed)
        return {"burn_fast_long": bf_long, "burn_fast_short": bf_short,
                "burn_slow_long": bs_long, "burn_slow_short": bs_short,
                "burn": max(bf_long, bs_long),
                "freshness_s": fresh,
                "budget_remaining": min(1.0, remaining),
                "window_ok": ok, "window_bad": bad}

    def evaluate_once(self, now_s: Optional[float] = None) -> Dict[str, dict]:
        """One evaluator tick: per pipeline, compute the window burns +
        freshness, run the episode state machine, refresh the exported
        gauges.  Manually drivable (tests pass ``now_s``); the alarm side
        effect runs OUTSIDE the plane lock."""
        now = time.monotonic() if now_s is None else now_s
        raises: List[Tuple[str, int, dict]] = []
        clears: List[Tuple[str, int, dict]] = []
        results: Dict[str, dict] = {}
        with self._lock:
            # the spill seconds this tick's verdict covers: none while a
            # spill is between its note and its booking
            spill_seen = 0.0 if self._spills_booking else self._spilled_s
            for name, st in self._states.items():
                if not name:
                    continue    # unattributed results have no contract
                obj = st.objectives or self.objectives
                stats = self._stats_locked(st, now)
                trip = ((stats["burn_fast_long"] > obj.fast[2]
                         and stats["burn_fast_short"] > obj.fast[2])
                        or (stats["burn_slow_long"] > obj.slow[2]
                            and stats["burn_slow_short"] > obj.slow[2])
                        or stats["freshness_s"] > obj.freshness_s)
                calm = (stats["burn_fast_short"] <= obj.fast[2]
                        and stats["burn_slow_short"] <= obj.slow[2]
                        and stats["freshness_s"] <= obj.freshness_s)
                if trip and not st.firing:
                    st.firing = True
                    st.episodes += 1
                    raises.append((name, st.episodes, stats))
                elif st.firing and calm:
                    st.firing = False
                    clears.append((name, st.episodes, stats))
                stats["firing"] = st.firing
                stats["episodes"] = st.episodes
                st.last_stats = stats
                results[name] = stats
        for name, episode, stats in raises:
            self._raise(name, episode, stats)
        for name, episode, stats in clears:
            self._note_clear(name, episode, stats)
        if not raises:
            with self._lock:
                any_firing = any(st.firing for st in self._states.values())
            if not any_firing:
                # healthy tick: the NEXT trip's breakdown is the hop spend
                # accumulated since this instant
                totals = _hop_totals()
                with self._lock:
                    self._hop_baseline = totals
                    self._spilled_s = max(0.0, self._spilled_s - spill_seen)
        self.export_gauges(results)
        return results

    # -- budget breakdown ----------------------------------------------------

    def budget_breakdown(self) -> dict:
        """Stage-attributed spend since the last healthy tick: per-hop
        delta-seconds of the existing latency histograms, ranked.  The
        dominant hop names which leg of the pipeline ate the budget.  The
        port adds the wait in progress (``inflight``: the oldest
        process-queue group's age to ``queue``, the oldest sender-queue
        payload's to ``sink``); with nothing waiting the document is the
        JAX package's."""
        cur = _hop_totals()
        base = self._hop_baseline
        hops: Dict[str, float] = {}
        hists: Dict[str, dict] = {}
        for name, (s, c) in sorted(cur.items()):
            b = base.get(name, (0.0, 0))
            ds = max(0.0, s - b[0])
            dc = max(0, c - b[1])
            hists[name] = {"delta_sum_s": round(ds, 6), "delta_count": dc}
            hop = HOP_HISTOGRAMS[name]
            hops[hop] = hops.get(hop, 0.0) + ds
        # the wait still in progress: a trip (a freshness breach above all)
        # can land while the stamp that caused it sits in a queue, which
        # no hop histogram has observed yet
        inflight = {k: v for k, v in _inflight_ages().items() if v > 0.0}
        for hop, age in inflight.items():
            hops[hop] = hops.get(hop, 0.0) + age
        dominant = ""
        if hops and any(v > 0.0 for v in hops.values()):
            dominant = max(sorted(hops), key=lambda k: hops[k])
        with self._lock:
            spilled = self._spilled_s
        from_spill = not dominant and spilled > 0.0
        if from_spill:
            # no hop spend, but a payload spilled after its failed send:
            # the healthy tick landed between that send's round trip and
            # the spill, which left nothing waiting — the egress leg the
            # spilled payloads took is the spend
            hops["sink"] = spilled
            dominant = "sink"
        doc = {"hops": {k: round(v, 6) for k, v in sorted(hops.items())},
               "histograms": hists, "dominant": dominant}
        if inflight:
            doc["inflight"] = {k: round(v, 6)
                               for k, v in sorted(inflight.items())}
        if from_spill:
            doc["spilled"] = {"sink": round(spilled, 6)}
        return doc

    def observe_spill(self, pipeline: str, stamps, egress_s: float) -> None:
        """Book the spill of a payload whose send just failed, after
        ``egress_s`` seconds on the egress leg (sender queue and sends).
        The breakdown reads those seconds only when no hop histogram moved
        since the last healthy tick.  A tick between the note and the
        booking leaves them in place: its verdict did not see the spill."""
        if not stamps:
            return
        with self._lock:
            self._spilled_s += max(0.0, float(egress_s))
            self._spills_booking += 1
        try:
            self.observe_stamps(pipeline, stamps, OUTCOME_SPILL)
        finally:
            with self._lock:
                self._spills_booking -= 1

    def _raise(self, pipeline: str, episode: int, stats: dict) -> None:
        breakdown = self.budget_breakdown()
        with self._lock:
            st = self._states.get(pipeline)
            if st is not None:
                st.last_breakdown = breakdown
        # the alarm OUTSIDE self._lock (the manager takes its own lock)
        from .alarms import AlarmLevel, AlarmManager, AlarmType
        dominant = breakdown.get("dominant", "") or "unknown"
        AlarmManager.instance().send_alarm(
            AlarmType.SLO_BURN_RATE,
            f"SLO error-budget burn: pipeline {pipeline!r} burning at "
            f"{stats['burn']:.1f}x (freshness {stats['freshness_s']:.2f}s); "
            f"budget went to the {dominant} hop — see /debug/slo",
            AlarmLevel.ERROR, pipeline=pipeline,
            details={"episode": str(episode),
                     "dominant_hop": dominant,
                     "burn_fast": f"{stats['burn_fast_long']:.2f}/"
                                  f"{stats['burn_fast_short']:.2f}",
                     "burn_slow": f"{stats['burn_slow_long']:.2f}/"
                                  f"{stats['burn_slow_short']:.2f}",
                     "freshness_s": f"{stats['freshness_s']:.3f}",
                     "budget_remaining":
                         f"{stats['budget_remaining']:.4f}",
                     "breakdown": json.dumps(breakdown, sort_keys=True)})

    def _note_clear(self, pipeline: str, episode: int, stats: dict) -> None:
        # the JAX package writes a flight-recorder entry here; the port
        # counts the clear (``clears`` on /debug/slo)
        with self._lock:
            st = self._states.get(pipeline)
            if st is not None:
                st.clears += 1

    # -- export --------------------------------------------------------------

    def _hist(self, pipeline: str, outcome: str):
        key = (pipeline, outcome)
        h = self._hists.get(key)
        if h is None:
            from .metrics import MetricsRecord
            with self._rec_lock:
                if self._retired:
                    # disable() ran: creating a record now would resurrect
                    # the export and serve a frozen histogram forever
                    return None
                h = self._hists.get(key)
                if h is None:
                    rec = MetricsRecord(
                        category="slo",
                        labels={"pipeline": pipeline, "outcome": outcome})
                    self._hist_records[key] = rec
                    h = self._hists[key] = rec.histogram("event_to_flush_ms")
        return h

    def _gauge_record(self, pipeline: str):
        rec = self._gauge_records.get(pipeline)
        if rec is None:
            from .metrics import MetricsRecord
            with self._rec_lock:
                if self._retired:
                    return None
                rec = self._gauge_records.get(pipeline)
                if rec is None:
                    rec = self._gauge_records[pipeline] = MetricsRecord(
                        category="slo", labels={"pipeline": pipeline})
        return rec

    def export_gauges(self, results: Optional[Dict[str, dict]] = None
                      ) -> None:
        """Mirror per-pipeline freshness/burn/budget into gauge records
        (monotone mirrors of plane state — they must survive the
        self-monitor's destructive counter drain)."""
        if results is None:
            now = time.monotonic()
            results = {}
            with self._lock:
                for name, st in self._states.items():
                    if not name:
                        continue
                    stats = self._stats_locked(st, now)
                    stats["firing"] = st.firing
                    stats["episodes"] = st.episodes
                    st.last_stats = stats
                    results[name] = stats
        with self._lock:
            outstanding = {}
            for name in results:
                st = self._states.get(name)
                if st is None:
                    continue
                heap, refs = st.heap, self._refs
                while heap and heap[0] not in refs:
                    heapq.heappop(heap)
                outstanding[name] = sum(1 for ns in heap if ns in refs)
        for name, stats in results.items():
            rec = self._gauge_record(name)
            if rec is None:
                return      # disabled mid-refresh: stop mirroring
            rec.gauge("pipeline_freshness_seconds").set(
                stats["freshness_s"])
            rec.gauge("slo_burn_rate").set(stats["burn"])
            rec.gauge("slo_error_budget_remaining").set(
                stats["budget_remaining"])
            rec.gauge("slo_burn_firing").set(1.0 if stats["firing"] else 0.0)
            rec.gauge("slo_burn_episodes").set(float(stats["episodes"]))
            rec.gauge("slo_outstanding_stamps").set(
                float(outstanding.get(name, 0)))

    def retire_records(self) -> None:
        with self._rec_lock:
            self._retired = True
            for rec in self._hist_records.values():
                rec.mark_deleted()
            for rec in self._gauge_records.values():
                rec.mark_deleted()
            self._hist_records.clear()
            self._hists.clear()
            self._gauge_records.clear()

    # -- config / introspection ----------------------------------------------

    def set_objectives(self, pipeline: str,
                       objectives: Optional[SloObjectives]) -> None:
        """Per-pipeline override (None restores the plane default)."""
        with self._lock:
            self._state_locked(pipeline or "").objectives = objectives

    def episode_count(self, pipeline: str) -> int:
        with self._lock:
            st = self._states.get(pipeline or "")
            return st.episodes if st is not None else 0

    def is_firing(self, pipeline: str) -> bool:
        with self._lock:
            st = self._states.get(pipeline or "")
            return st.firing if st is not None else False

    def debug_document(self) -> dict:
        now = time.monotonic()
        doc: dict = {"enabled": True,
                     "objectives": self.objectives.to_dict(),
                     "pipelines": {}}
        with self._lock:
            for name, st in sorted(self._states.items()):
                stats = self._stats_locked(st, now)
                heap, refs = st.heap, self._refs
                while heap and heap[0] not in refs:
                    heapq.heappop(heap)
                row = {
                    "freshness_s": round(stats["freshness_s"], 6),
                    "burn": {k: round(stats[k], 4)
                             for k in ("burn_fast_long", "burn_fast_short",
                                       "burn_slow_long", "burn_slow_short")},
                    "budget_remaining":
                        round(stats["budget_remaining"], 6),
                    "firing": st.firing,
                    "episodes": st.episodes,
                    "clears": st.clears,
                    "outstanding_stamps":
                        sum(1 for ns in heap if ns in refs),
                    "ok_total": st.ok_total,
                    "bad_total": st.bad_total,
                    "stale_retires": st.stale_retires,
                    "forced_expirations": st.forced_expirations,
                }
                if st.objectives is not None:
                    row["objectives"] = st.objectives.to_dict()
                if st.last_breakdown is not None:
                    row["last_breakdown"] = st.last_breakdown
                doc["pipelines"][name] = row
            doc["outstanding_total"] = len(self._refs)
        ev = _evaluator
        if ev is not None:
            doc["evaluator"] = {"interval_s": ev.interval_s,
                                "ticks_total": ev.ticks_total}
        return doc

    def reset(self) -> None:
        """Tests only: forget stamps, rings and episode state (keeps the
        enabled state and the export records)."""
        with self._lock:
            self._refs.clear()
            self._states.clear()
            self._hop_baseline = {}
            self._spilled_s = 0.0


def _hop_totals() -> Dict[str, Tuple[float, int]]:
    """Process-wide (sum_seconds, count) per budget-hop histogram name,
    merged across every live MetricsRecord (fail-soft: the breakdown is
    evidence, never a crash source; a failure is logged once and
    counted)."""
    totals: Dict[str, List] = {}
    try:
        from .metrics import WriteMetrics
        for rec in WriteMetrics.instance().records():
            for h in rec.histograms():
                if h.name not in HOP_HISTOGRAMS:
                    continue
                snap = h.snapshot()
                t = totals.setdefault(h.name, [0.0, 0])
                t[0] += snap["sum"]
                t[1] += snap["count"]
    except Exception as e:  # noqa: BLE001
        from . import fail_soft
        fail_soft.note("slo.hop_totals", e)
    return {k: (v[0], v[1]) for k, v in totals.items()}


def _inflight_ages() -> Dict[str, float]:
    """The waits in progress: the oldest queued group's age across the
    process queues (``queue`` hop) and the oldest queued payload's across
    the sender queues (``sink`` hop) — the ledger's lag watermarks.
    Fail-soft like ``_hop_totals``."""
    try:
        from . import ledger
        lags = ledger.lag_snapshot()
    except Exception as e:  # noqa: BLE001
        from . import fail_soft
        fail_soft.note("slo.inflight_ages", e)
        return {}
    return {"queue": max((a["process_queue"] for a in lags.values()),
                         default=0.0),
            "sink": max((a["sender_queue"] for a in lags.values()),
                        default=0.0)}


# ---------------------------------------------------------------------------
# evaluator thread (the ConservationAuditor shape)

class SloEvaluator:
    def __init__(self, plane: SloPlane, interval_s: float = 1.0):
        self.plane = plane
        self.interval_s = max(0.05, float(interval_s))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.ticks_total = 0

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="slo-evaluator", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.ticks_total += 1
                self.plane.evaluate_once()
            except Exception:  # noqa: BLE001 — the evaluator observes; it
                # must never take the agent down with it
                from ..utils.logger import get_logger
                get_logger("slo").exception("slo evaluation failed")


# ---------------------------------------------------------------------------
# module-global hook (chaos-plane idiom: one global read when off)

_plane: Optional[SloPlane] = None
_evaluator: Optional[SloEvaluator] = None


def is_on() -> bool:
    return _plane is not None


def active_plane() -> Optional[SloPlane]:
    return _plane


def stamp_ingest(pipeline: str, group) -> None:
    plane = _plane
    if plane is None:
        return
    plane.stamp(pipeline, group)


def ensure_stamp(pipeline: str, group) -> None:
    plane = _plane
    if plane is None:
        return
    plane.ensure_stamp(pipeline, group)


def cancel_group(group) -> None:
    plane = _plane
    if plane is None:
        return
    plane.cancel_group(group)


def note_fanout(group, n: int) -> None:
    plane = _plane
    if plane is None:
        return
    plane.note_fanout(group, n)


def stamps_of(groups) -> Tuple[int, ...]:
    plane = _plane
    if plane is None:
        return ()
    return plane.stamps_of(groups)


def observe_spill(pipeline: str, stamps, egress_s: float) -> None:
    plane = _plane
    if plane is None or not stamps:
        return
    plane.observe_spill(pipeline, stamps, egress_s)


def observe_stamps(pipeline: str, stamps, outcome: str) -> None:
    plane = _plane
    if plane is None or not stamps:
        return
    plane.observe_stamps(pipeline, stamps, outcome)


def observe_groups(pipeline: str, groups, outcome: str) -> None:
    plane = _plane
    if plane is None:
        return
    plane.observe_groups(pipeline, groups, outcome)


def retire_groups(groups) -> None:
    plane = _plane
    if plane is None:
        return
    plane.retire_groups(groups)


def freshness(pipeline: str) -> float:
    plane = _plane
    if plane is None:
        return 0.0
    return plane.freshness(pipeline)


def evaluate_once(now_s: Optional[float] = None) -> Dict[str, dict]:
    plane = _plane
    if plane is None:
        return {}
    return plane.evaluate_once(now_s)


def enable(objectives: Optional[SloObjectives] = None) -> SloPlane:
    global _plane
    if _plane is None:
        _plane = SloPlane(objectives)
    elif objectives is not None:
        _plane.objectives = objectives
    return _plane


def disable() -> None:
    """Turn the plane off and retire its export records (a disabled plane
    must not keep exporting stale freshness/burn series)."""
    global _plane
    stop_evaluator()
    plane = _plane
    _plane = None
    if plane is not None:
        plane.retire_records()


def start_evaluator(interval_s: float = 1.0) -> SloEvaluator:
    global _evaluator
    if _evaluator is None:
        _evaluator = SloEvaluator(enable(), interval_s=interval_s)
        _evaluator.start()
    return _evaluator


def stop_evaluator() -> None:
    global _evaluator
    if _evaluator is not None:
        _evaluator.stop()
        _evaluator = None


def evaluator() -> Optional[SloEvaluator]:
    return _evaluator


def install_from_env(env=os.environ) -> bool:
    """``LOONG_SLO=1`` enables the plane + evaluator; objective bounds via
    LOONG_SLO_SOJOURN_P99_MS / LOONG_SLO_FRESHNESS_S / LOONG_SLO_TARGET;
    evaluator cadence via LOONG_SLO_INTERVAL.  Returns True when the
    plane came on."""
    if env.get(ENV_SLO, "") in ("", "0"):
        return False

    def _f(key: str, default: float) -> float:
        try:
            return float(env.get(key, default))
        except ValueError:
            return default

    obj = SloObjectives(
        sojourn_p99_ms=_f(ENV_SOJOURN_MS, 5000.0),
        freshness_s=_f(ENV_FRESHNESS_S, 30.0),
        target=_f(ENV_TARGET, 0.999))
    enable(obj)
    start_evaluator(interval_s=_f(ENV_INTERVAL, 1.0))
    return True


def export_refresh() -> None:
    """Mirror plane state into the per-pipeline gauge records — called by
    monitor/runtime_stats.refresh (self-monitor cadence) and by the
    exposition renderer; no-op while the plane is off."""
    plane = _plane
    if plane is None:
        return
    plane.export_gauges()


def debug_document() -> dict:
    """The ``/debug/slo`` page."""
    plane = _plane
    if plane is None:
        return {"enabled": False}
    return plane.debug_document()


def reset() -> None:
    """Tests only: zero state (keeps the enabled state)."""
    plane = _plane
    if plane is not None:
        plane.reset()
