"""The port's freshness-SLO plane (``monitor/slo.py``) against the JAX
package's, on the CPU.

* Parity under injected clocks: both modules' ``time`` is one fake clock,
  and the same seeded sequence of stamps, fan-outs, terminals (send_ok,
  spill, drop), retires, cancels, hop-histogram observations and
  evaluator ticks runs through both planes.  Equal, exactly (the same
  Python arithmetic runs in both): every ``evaluate_once`` result, the
  ``event_to_flush_ms`` snapshots, the episode counts, each breakdown,
  the alarms raised (time fields dropped) and ``debug_document`` (the
  port's ``clears`` count, which stands where the JAX package writes
  flight-recorder entries, dropped).
* The JAX package's own cases of ``tests/test_loongslo.py``
  (``TestDisabledPlane``, ``TestStampLifecycle``, ``TestFreshness``,
  ``TestBurnRateEpisodes``, ``TestBudgetBreakdown``,
  ``TestExportLifecycle``), each run on both packages.  Where the JAX
  package reads its flight recorder (an episode's clear), the port's
  ``clears`` count is read.  The chaos-plane cases (seeded sink storms,
  prefix determinism) are not ported: the port has no chaos plane; the
  sink storm is driven end to end by ``test_torch_self_monitor.py``
  against a test server answering 503.
* With the plane off, no hook calls into it: every ``SloPlane`` method is
  patched to raise, and a port agent runs a pipeline with a
  ``flusher_file`` and the flusher runner's terminals (a 503 sink and its
  spill) without reaching one.
* Two faults of the reference, on purpose not copied: the port's budget
  breakdown survives a self-monitor drain between its baseline and a
  trip (the JAX package's reads nothing then), and counts the wait still
  in progress at a trip (the JAX package's sees only completed waits).
"""

import json
import time
import types

import numpy as np
import pytest

from loongcollector_tpu.models import PipelineEventGroup as RefGroup
from loongcollector_tpu.models import SourceBuffer as RefSB
from loongcollector_tpu.monitor import alarms as ref_alarms
from loongcollector_tpu.monitor import exposition as ref_expo
from loongcollector_tpu.monitor import ledger as ref_ledger
from loongcollector_tpu.monitor import metrics as ref_metrics
from loongcollector_tpu.monitor import self_monitor as ref_sm
from loongcollector_tpu.monitor import slo as ref_slo
from loongcollector_tpu.pipeline.queue import \
    process_queue_manager as ref_pqm
from loongcollector_tpu.prof import flight as ref_flight
from loongcollector_tpu_torch.models import PipelineEventGroup, SourceBuffer
from loongcollector_tpu_torch.monitor import alarms as port_alarms
from loongcollector_tpu_torch.monitor import exposition as port_expo
from loongcollector_tpu_torch.monitor import ledger as port_ledger
from loongcollector_tpu_torch.monitor import metrics as port_metrics
from loongcollector_tpu_torch.monitor import self_monitor as port_sm
from loongcollector_tpu_torch.monitor import slo as port_slo
from loongcollector_tpu_torch.pipeline.queue import \
    process_queue_manager as port_pqm
from loongcollector_tpu_torch.pipeline.queue import sender_queue as port_sq
from loongcollector_tpu_torch.runner import disk_buffer as port_db
from loongcollector_tpu_torch.runner import flusher_runner as port_fr

from conftest import wait_for
from test_torch_alarms import TIME_FIELDS, reset_planes

SIDES = {
    "reference": dict(slo=ref_slo, metrics=ref_metrics, alarms=ref_alarms,
                      expo=ref_expo, pqm=ref_pqm, sm=ref_sm, group=RefGroup,
                      sb=RefSB),
    "port": dict(slo=port_slo, metrics=port_metrics, alarms=port_alarms,
                 expo=port_expo, pqm=port_pqm, sm=port_sm,
                 group=PipelineEventGroup, sb=SourceBuffer),
}


@pytest.fixture(autouse=True)
def _clean_planes():
    reset_planes()
    yield
    reset_planes()


@pytest.fixture(params=["reference", "port"])
def side(request):
    return SIDES[request.param] | {"name": request.param}


class FakeClock:
    """One clock for both modules' ``time``: monotonic seconds and ns move
    only when the test says so."""

    def __init__(self, t0_ns: int = 10_000 * 10**9):
        self.ns = t0_ns

    def advance_ms(self, ms: float) -> None:
        self.ns += int(ms * 1e6)

    def monotonic_ns(self) -> int:
        return self.ns

    def monotonic(self) -> float:
        return self.ns / 1e9

    def time(self) -> float:
        return self.ns / 1e9


def _group(side, data: bytes = b""):
    sb = side["sb"](len(data) + 64)
    g = side["group"](sb)
    if data:
        g.add_raw_event(1).set_content(sb.copy_string(data))
    return g


def _hist_count(side, pipeline, outcome):
    for rec in side["metrics"].WriteMetrics.instance().records():
        if rec.category == "slo" and rec.labels.get("pipeline") == pipeline \
                and rec.labels.get("outcome") == outcome:
            for h in rec.histograms():
                return h.snapshot()["count"]
    return 0


def _strip_alarms(docs):
    return sorted(({k: v for k, v in d.items() if k not in TIME_FIELDS}
                   for d in docs), key=lambda d: json.dumps(d, sort_keys=True))


# ---------------------------------------------------------------------------
# parity under one injected clock


HOPS = ("queue_wait_seconds", "stage_seconds", "device_roundtrip_seconds",
        "sender_queue_wait_seconds", "sink_rtt_seconds")
OUTCOMES = ("send_ok", "spill", "drop")


def _script(seed, n=500):
    """A seeded op list over pipelines a, b: stamps, fan-outs, terminals,
    retires, cancels, hop observations, clock steps and ticks."""
    rng = np.random.default_rng(seed)
    ops = []
    live = []
    owed = {}                       # gid -> terminals its stamp still owes
    gid = 0
    for i in range(n):
        r = rng.random()
        if r < 0.25 or not live:
            ops.append(("stamp", "ab"[int(rng.integers(0, 2))], gid))
            live.append(gid)
            owed[gid] = 1
            gid += 1
        elif r < 0.30:
            g = live[int(rng.integers(0, len(live)))]
            fan = int(rng.integers(2, 4))
            ops.append(("fanout", g, fan))
            owed[g] += fan - 1
        elif r < 0.55:
            g = live.pop(int(rng.integers(0, len(live))))
            owed[g] -= 1
            # bursts of bad outcomes trip episodes; most are deliveries
            bad = (i // 100) % 2 == 1 and rng.random() < 0.6
            outcome = OUTCOMES[int(rng.integers(1, 3))] if bad else "send_ok"
            ops.append(("observe", g, outcome))
        elif r < 0.60:
            g = live.pop(int(rng.integers(0, len(live))))
            ops.append(("retire", g))
            owed[g] -= 1
        elif r < 0.62:
            g = live.pop(int(rng.integers(0, len(live))))
            ops.append(("cancel", g))
            owed[g] = 0                 # un-admitted: the stamp is gone
        elif r < 0.75:
            ops.append(("hop", HOPS[int(rng.integers(0, len(HOPS)))],
                        float(rng.integers(1, 4000)) / 1000.0))
        elif r < 0.90:
            # sojourns from a few ms to past the 5 s bound, and gaps long
            # enough for the 5 s / 30 s short windows to drain
            ms = float(rng.choice([3, 40, 700, 6000, 45000]))
            ops.append(("advance", ms))
        else:
            ops.append(("eval",))
    for g, n_owed in owed.items():  # every stamp reaches its terminals
        ops.extend([("observe", g, "send_ok")] * max(n_owed, 0))
    ops.append(("advance", 200_000.0))
    ops.append(("eval",))
    return ops


def _run_script(side, ops, monkeypatch, clock):
    slo, metrics = side["slo"], side["metrics"]
    monkeypatch.setattr(slo, "time", clock)
    plane = slo.enable()
    slo.reset()
    rec = metrics.MetricsRecord(category="hops", labels={"t": "1"})
    hists = {h: rec.histogram(h) for h in HOPS}
    groups = {}
    out = {"evals": [], "breakdowns": []}
    try:
        for op in ops:
            kind = op[0]
            if kind == "stamp":
                g = groups[op[2]] = _group(side)
                plane.stamp(op[1], g)
            elif kind == "fanout":
                plane.note_fanout(groups[op[1]], op[2])
            elif kind == "observe":
                g = groups[op[1]]
                slo.observe_groups(_pipe_of(ops, op[1]), [g], op[2])
            elif kind == "retire":
                slo.retire_groups([groups[op[1]]])
            elif kind == "cancel":
                slo.cancel_group(groups[op[1]])
            elif kind == "hop":
                hists[op[1]].observe(op[2])
            elif kind == "advance":
                clock.advance_ms(op[1])
            else:
                out["evals"].append(plane.evaluate_once())
                out["breakdowns"].append(plane.budget_breakdown())
        doc = plane.debug_document()
        for row in doc["pipelines"].values():
            row.pop("clears", None)
        out["doc"] = doc
        out["hists"] = {(p, o): _hist_snapshot(side, p, o)
                        for p in "ab" for o in OUTCOMES}
        out["episodes"] = {p: plane.episode_count(p) for p in "ab"}
        out["alarms"] = _strip_alarms(
            side["alarms"].AlarmManager.instance().flush())
        out["freshness"] = {p: slo.freshness(p) for p in "ab"}
    finally:
        rec.mark_deleted()
    return out


def _hist_snapshot(side, pipeline, outcome):
    for rec in side["metrics"].WriteMetrics.instance().records():
        if rec.category == "slo" and rec.labels.get("pipeline") == pipeline \
                and rec.labels.get("outcome") == outcome:
            return rec.histograms()[0].snapshot()
    return None


def _pipe_of(ops, gid):
    for op in ops:
        if op[0] == "stamp" and op[2] == gid:
            return op[1]
    raise KeyError(gid)


@pytest.mark.parametrize("seed", [3, 11, 42, 1337])
def test_planes_agree_under_one_clock(seed, monkeypatch):
    ops = _script(seed)
    res = {}
    for name in ("reference", "port"):
        res[name] = _run_script(SIDES[name], ops, monkeypatch, FakeClock())
        reset_planes()
    ref, port = res["reference"], res["port"]
    assert port["evals"] == ref["evals"]
    assert port["breakdowns"] == ref["breakdowns"]
    assert port["hists"] == ref["hists"]
    assert port["episodes"] == ref["episodes"]
    assert port["alarms"] == ref["alarms"]
    assert port["doc"] == ref["doc"]
    assert port["freshness"] == ref["freshness"]
    # the script exercises what it claims: episodes raised and cleared,
    # every outcome observed
    assert sum(ref["episodes"].values()) >= 2
    assert all(ref["hists"][(p, "send_ok")] for p in "ab")
    assert any(ref["hists"][(p, o)] for p in "ab" for o in ("spill", "drop"))
    assert not any(r["firing"] for r in ref["evals"][-1].values())


def test_clears_are_counted_where_the_reference_writes_flight(monkeypatch):
    clock = FakeClock()
    obj = dict(sojourn_p99_ms=100.0, target=0.99)
    got = {}
    for name in ("reference", "port"):
        slo = SIDES[name]["slo"]
        monkeypatch.setattr(slo, "time", clock)
        plane = slo.enable(slo.SloObjectives(**obj))
        slo.reset()
        t0 = clock.monotonic()
        for _ in range(50):
            plane.note_result("p", 500.0, slo.OUTCOME_SEND_OK, now_s=t0)
        plane.evaluate_once(now_s=t0 + 1)
        plane.evaluate_once(now_s=t0 + 40)
        if name == "reference":
            got[name] = len(ref_flight.recorder().events_by_kind().get(
                "slo.burn_clear", []))
        else:
            got[name] = plane.debug_document()["pipelines"]["p"]["clears"]
        reset_planes()
    assert got == {"reference": 1, "port": 1}


# ---------------------------------------------------------------------------
# the JAX package's cases, on both packages


class TestDisabledPlane:
    def test_every_hook_is_inert(self, side):
        slo = side["slo"]
        assert not slo.is_on()
        assert slo.active_plane() is None
        g = _group(side)
        slo.stamp_ingest("p", g)
        slo.ensure_stamp("p", g)
        assert g.get_metadata(_meta_key(side)) is None
        assert slo.stamps_of([g]) == ()
        slo.note_fanout(g, 3)
        slo.cancel_group(g)
        slo.observe_stamps("p", (1, 2), slo.OUTCOME_SEND_OK)
        slo.observe_groups("p", [g], slo.OUTCOME_DROP)
        slo.retire_groups([g])
        slo.export_refresh()
        assert slo.freshness("p") == 0.0
        assert slo.evaluate_once() == {}
        assert slo.debug_document() == {"enabled": False}
        assert slo.evaluator() is None

    def test_env_activation(self, side):
        slo = side["slo"]
        assert not slo.install_from_env({})
        assert not slo.install_from_env({"LOONG_SLO": "0"})
        assert slo.install_from_env({
            "LOONG_SLO": "1", "LOONG_SLO_INTERVAL": "0.05",
            "LOONG_SLO_SOJOURN_P99_MS": "250",
            "LOONG_SLO_FRESHNESS_S": "7",
            "LOONG_SLO_TARGET": "0.99"})
        assert slo.is_on()
        plane = slo.active_plane()
        assert plane.objectives.sojourn_p99_ms == 250.0
        assert plane.objectives.freshness_s == 7.0
        assert plane.objectives.target == 0.99
        ev = slo.evaluator()
        assert ev is not None and ev.interval_s == 0.05
        assert wait_for(lambda: ev.ticks_total >= 1, timeout=5)
        slo.disable()
        assert slo.evaluator() is None and not slo.is_on()

    def test_env_bad_values_fall_back_to_defaults(self, side):
        slo = side["slo"]
        assert slo.install_from_env({"LOONG_SLO": "1",
                                     "LOONG_SLO_TARGET": "bogus",
                                     "LOONG_SLO_INTERVAL": "bogus"})
        assert slo.active_plane().objectives.target == 0.999
        assert slo.evaluator().interval_s == 1.0


def _meta_key(side):
    from loongcollector_tpu.models.event_group import \
        EventGroupMetaKey as RefKey
    from loongcollector_tpu_torch.models.event_group import EventGroupMetaKey
    return RefKey.INGEST_NS if side["name"] == "reference" \
        else EventGroupMetaKey.INGEST_NS


class TestStampLifecycle:
    def test_admit_hook_mints_and_refused_push_cancels(self, side):
        slo = side["slo"]
        slo.enable()
        slo.reset()
        pqm = side["pqm"].ProcessQueueManager()
        pqm.create_or_reuse_queue(1, capacity=2, pipeline_name="p")
        admitted = []
        for _ in range(2):
            g = _group(side, b"x\n")
            assert pqm.push_queue(1, g)
            admitted.append(g)
        refused = _group(side, b"x\n")
        assert not pqm.push_queue(1, refused)
        plane = slo.active_plane()
        stamps = slo.stamps_of(admitted)
        assert len(stamps) == len(set(stamps)) == 2
        assert plane.outstanding("p") == 2
        slo.observe_groups("p", admitted, slo.OUTCOME_SEND_OK)
        assert plane.outstanding("p") == 0

    def test_stamps_are_unique_under_burst(self, side):
        slo = side["slo"]
        plane = slo.enable()
        slo.reset()
        groups = [_group(side) for _ in range(64)]
        for g in groups:
            plane.stamp("p", g)
        assert len(set(slo.stamps_of(groups))) == 64
        assert plane.outstanding("p") == 64

    def test_derived_group_inherits_stamp(self, side):
        slo = side["slo"]
        plane = slo.enable()
        slo.reset()
        parent = _group(side, b"line\n")
        plane.stamp("p", parent)
        child = side["group"](parent.source_buffer)
        parent.copy_meta_to(child)
        assert plane.stamp_of(child) == plane.stamp_of(parent)
        slo.observe_groups("p", [child], slo.OUTCOME_SEND_OK)
        assert plane.outstanding("p") == 0

    def test_ensure_stamp_only_stamps_when_missing(self, side):
        plane = side["slo"].enable()
        side["slo"].reset()
        g = _group(side)
        plane.ensure_stamp("p", g)
        first = plane.stamp_of(g)
        assert first is not None
        plane.ensure_stamp("p", g)
        assert plane.stamp_of(g) == first

    def test_fanout_refcounts_like_the_ack_watermark(self, side):
        slo = side["slo"]
        plane = slo.enable()
        slo.reset()
        g = _group(side)
        plane.stamp("p", g)
        plane.note_fanout(g, 3)
        for i in range(3):
            assert plane.outstanding("p") == 1, f"released after {i} acks"
            slo.observe_groups("p", [g], slo.OUTCOME_SEND_OK)
        assert plane.outstanding("p") == 0
        assert plane.debug_document()["pipelines"]["p"]["ok_total"] == 3

    def test_retire_releases_without_a_sojourn_sample(self, side):
        slo = side["slo"]
        plane = slo.enable()
        slo.reset()
        g = _group(side)
        plane.stamp("p", g)
        slo.retire_groups([g])
        assert plane.outstanding("p") == 0
        row = plane.debug_document()["pipelines"]["p"]
        assert row["ok_total"] == 0 and row["bad_total"] == 0

    def test_stale_terminal_is_counted_not_crashed(self, side):
        slo = side["slo"]
        plane = slo.enable()
        slo.reset()
        ns = time.monotonic_ns() - 1_000_000
        plane.observe_stamps("p", (ns,), slo.OUTCOME_SEND_OK,
                             now_ns=ns + 2_000_000)
        row = plane.debug_document()["pipelines"]["p"]
        assert row["stale_retires"] == 1
        assert row["ok_total"] == 1

    def test_force_expiry_bounds_the_registry(self, side):
        slo = side["slo"]
        plane = slo.enable()
        slo.reset()
        plane.max_outstanding = 8
        for _ in range(9):
            plane.stamp("p", _group(side))
        assert plane.outstanding("p") <= 8 // 2
        assert plane.debug_document()["pipelines"]["p"][
            "forced_expirations"] >= 4


class TestFreshness:
    def test_idle_pipeline_reads_exactly_zero(self, side):
        side["slo"].enable()
        side["slo"].reset()
        assert side["slo"].freshness("never_seen") == 0.0

    def test_drained_pipeline_returns_to_exactly_zero(self, side):
        slo = side["slo"]
        plane = slo.enable()
        slo.reset()
        g = _group(side)
        plane.stamp("p", g)
        time.sleep(0.01)
        assert slo.freshness("p") > 0.0
        slo.observe_groups("p", [g], slo.OUTCOME_SEND_OK)
        assert slo.freshness("p") == 0.0
        assert _hist_count(side, "p", slo.OUTCOME_SEND_OK) == 1

    def test_freshness_survives_queue_handoff(self, side):
        """Generation 1's in-flight stamp stays on the name-keyed series
        while a new queue of the same pipeline admits another."""
        slo = side["slo"]
        plane = slo.enable()
        slo.reset()
        pqm = side["pqm"].ProcessQueueManager()
        pqm.create_or_reuse_queue(1, capacity=8, pipeline_name="p")
        assert pqm.push_queue(1, _group(side, b"gen1\n"))
        _, g1 = pqm.pop_item(timeout=0)
        pqm.delete_queue(1)
        pqm.create_or_reuse_queue(2, capacity=8, pipeline_name="p")
        assert pqm.push_queue(2, _group(side, b"gen2\n"))
        _, g2 = pqm.pop_item(timeout=0)
        assert plane.outstanding("p") == 2
        slo.observe_groups("p", [g1], slo.OUTCOME_SEND_OK)
        assert plane.outstanding("p") == 1
        slo.observe_groups("p", [g2], slo.OUTCOME_SEND_OK)
        assert slo.freshness("p") == 0.0

    def test_queue_deletion_is_a_terminal_for_queued_groups(self, side):
        slo = side["slo"]
        plane = slo.enable()
        slo.reset()
        pqm = side["pqm"].ProcessQueueManager()
        pqm.create_or_reuse_queue(1, capacity=8, pipeline_name="p")
        assert pqm.push_queue(1, _group(side, b"doomed\n"))
        pqm.delete_queue(1)
        assert plane.outstanding("p") == 0
        assert slo.freshness("p") == 0.0
        assert plane.debug_document()["pipelines"]["p"]["bad_total"] == 1


def _feed(plane, pipeline, n, sojourn_ms, outcome, now_s):
    for _ in range(n):
        plane.note_result(pipeline, sojourn_ms, outcome, now_s=now_s)


class TestBurnRateEpisodes:
    OBJ = dict(sojourn_p99_ms=100.0, freshness_s=30.0, target=0.99,
               fast=(30.0, 5.0, 14.4), slow=(120.0, 30.0, 6.0))

    def _plane(self, side):
        plane = side["slo"].enable(side["slo"].SloObjectives(**self.OBJ))
        side["slo"].reset()
        return plane, time.monotonic() + 10_000.0

    def _burn_alarms(self, side):
        typ = side["alarms"].AlarmType.SLO_BURN_RATE.value
        return [a for a in side["alarms"].AlarmManager.instance().flush()
                if a["alarm_type"] == typ]

    def test_healthy_traffic_never_trips(self, side):
        plane, t0 = self._plane(side)
        _feed(plane, "p", 200, 10.0, "send_ok", t0)
        res = plane.evaluate_once(now_s=t0 + 1)["p"]
        assert not res["firing"] and res["episodes"] == 0
        assert res["budget_remaining"] == 1.0
        assert side["alarms"].AlarmManager.instance().empty()

    def test_trip_raises_exactly_once_per_episode(self, side):
        plane, t0 = self._plane(side)
        _feed(plane, "p", 200, 10.0, "send_ok", t0)
        _feed(plane, "p", 100, 500.0, "send_ok", t0 + 2)
        res = plane.evaluate_once(now_s=t0 + 3)["p"]
        assert res["firing"] and res["episodes"] == 1
        assert res["burn_fast_long"] > 14.4
        plane.evaluate_once(now_s=t0 + 4)
        plane.evaluate_once(now_s=t0 + 5)
        alarms = self._burn_alarms(side)
        assert len(alarms) == 1 and alarms[0]["alarm_count"] == "1"
        assert alarms[0]["episode"] == "1"
        assert alarms[0]["alarm_level"] == "error"
        assert "breakdown" in alarms[0]
        assert plane.episode_count("p") == 1

    def test_clear_rearm_and_second_episode(self, side):
        plane, t0 = self._plane(side)
        _feed(plane, "p", 100, 500.0, "send_ok", t0)
        plane.evaluate_once(now_s=t0 + 1)
        assert plane.is_firing("p")
        side["alarms"].AlarmManager.instance().flush()
        res = plane.evaluate_once(now_s=t0 + 40)["p"]
        assert not res["firing"] and res["episodes"] == 1
        _feed(plane, "p", 100, 0.0, "drop", t0 + 50)
        res = plane.evaluate_once(now_s=t0 + 51)["p"]
        assert res["firing"] and res["episodes"] == 2
        alarms = self._burn_alarms(side)
        assert len(alarms) == 1 and alarms[0]["episode"] == "2"

    def test_budget_remaining_hits_zero_under_sustained_burn(self, side):
        plane, t0 = self._plane(side)
        _feed(plane, "p", 200, 10.0, "send_ok", t0)
        _feed(plane, "p", 200, 0.0, "drop", t0 + 1)
        assert plane.evaluate_once(now_s=t0 + 2)["p"][
            "budget_remaining"] == 0.0

    def test_freshness_breach_trips_without_traffic(self, side):
        slo = side["slo"]
        plane = slo.enable(slo.SloObjectives(**self.OBJ))
        slo.reset()
        plane.set_objectives("f", slo.SloObjectives(freshness_s=0.0))
        g = _group(side)
        plane.stamp("f", g)
        time.sleep(0.005)
        res = plane.evaluate_once()["f"]
        assert res["firing"] and res["episodes"] == 1
        slo.observe_groups("f", [g], slo.OUTCOME_SEND_OK)
        assert not plane.evaluate_once()["f"]["firing"]

    def test_unattributed_results_have_no_contract(self, side):
        plane, t0 = self._plane(side)
        _feed(plane, "", 100, 0.0, "drop", t0)
        assert plane.evaluate_once(now_s=t0 + 1) == {}
        assert side["alarms"].AlarmManager.instance().empty()


class TestBudgetBreakdown:
    def test_dominant_hop_is_the_one_that_ate_the_budget(self, side):
        plane = side["slo"].enable()
        side["slo"].reset()
        rec = side["metrics"].MetricsRecord(category="test",
                                            labels={"pipeline": "p"})
        try:
            sink_h = rec.histogram("sink_rtt_seconds")
            stage_h = rec.histogram("stage_seconds")
            plane.evaluate_once()
            sink_h.observe(0.5)
            sink_h.observe(0.4)
            stage_h.observe(0.05)
            bd = plane.budget_breakdown()
            assert bd["dominant"] == "sink"
            assert bd["hops"]["sink"] == pytest.approx(0.9, abs=1e-6)
            assert bd["hops"]["stage"] == pytest.approx(0.05, abs=1e-6)
            assert bd["histograms"]["sink_rtt_seconds"]["delta_count"] == 2
        finally:
            rec.mark_deleted()

    def test_baseline_refreshes_on_healthy_ticks_only(self, side):
        slo = side["slo"]
        plane = slo.enable(slo.SloObjectives(sojourn_p99_ms=100.0,
                                             target=0.99))
        slo.reset()
        rec = side["metrics"].MetricsRecord(category="test",
                                            labels={"pipeline": "p"})
        t0 = time.monotonic() + 20_000.0
        try:
            h = rec.histogram("device_roundtrip_seconds")
            plane.evaluate_once(now_s=t0)
            h.observe(1.0)
            _feed(plane, "p", 50, 0.0, "drop", t0 + 1)
            plane.evaluate_once(now_s=t0 + 2)
            h.observe(1.0)
            assert plane.budget_breakdown()["hops"]["device"] == \
                pytest.approx(2.0, abs=1e-6)
        finally:
            rec.mark_deleted()

    def test_port_breakdown_survives_a_self_monitor_drain(self):
        """A self-monitor send between the baseline and the trip: the
        reference's send drains the histograms and its breakdown reads no
        spend; the port's send resets nothing (it ships deltas of the
        cumulative instruments), so its breakdown reads the spend."""
        got = {}
        for name in ("reference", "port"):
            s = SIDES[name]
            plane = s["slo"].enable()
            s["slo"].reset()
            rec = s["metrics"].MetricsRecord(category="test",
                                             labels={"pipeline": "p"})
            try:
                h = rec.histogram("sink_rtt_seconds")
                h.observe(0.25)
                plane.evaluate_once()           # baseline: 0.25 s spent
                h.observe(2.0)
                s["sm"].SelfMonitorServer.instance()._metrics_group()
                got[name] = plane.budget_breakdown()
            finally:
                rec.mark_deleted()
            reset_planes()
        assert got["reference"]["hops"]["sink"] == 0.0
        assert got["reference"]["dominant"] == ""
        assert got["port"]["hops"]["sink"] == pytest.approx(2.0)
        assert got["port"]["dominant"] == "sink"


    def test_port_breakdown_counts_the_wait_in_progress(self, monkeypatch):
        """A trip while its payload still waits in a sender queue (a
        freshness breach between two attempts): the reference names the
        hop that finished work in the last interval, the port the sink
        holding the wait (the ledger's lag watermarks)."""
        got = {}
        for name in ("reference", "port"):
            s = SIDES[name]
            ledger = (port_ledger if name == "port" else ref_ledger)
            monkeypatch.setattr(ledger, "lag_snapshot", lambda: {
                "p": {"process_queue": 0.1, "sender_queue": 2.5}})
            plane = s["slo"].enable()
            s["slo"].reset()
            rec = s["metrics"].MetricsRecord(category="test",
                                             labels={"pipeline": "p"})
            try:
                plane.evaluate_once()
                rec.histogram("stage_seconds").observe(0.2)
                got[name] = plane.budget_breakdown()
            finally:
                rec.mark_deleted()
            reset_planes()
        assert got["reference"]["dominant"] == "stage"
        assert "inflight" not in got["reference"]
        assert got["port"]["dominant"] == "sink"
        assert got["port"]["inflight"] == {"queue": 0.1, "sink": 2.5}
        assert got["port"]["hops"] == {"queue": 0.1, "sink": 2.5,
                                       "stage": 0.2}
        assert got["port"]["histograms"] == got["reference"]["histograms"]


    @staticmethod
    def _spill_rig(tmp_path, on_send_done=None, http_sink=None,
                   cooldown_s=5.0):
        """The flusher runner with a disk buffer, no thread, one stamped
        payload taken from its sender queue, and the flusher's
        ``on_send_done``; the breaker trips on one failure."""
        plane = port_slo.enable()
        port_slo.reset()
        sqm = port_sq.SenderQueueManager()
        q = sqm.create_or_reuse_queue(7, pipeline_name="p")
        buf = port_db.DiskBufferWriter(str(tmp_path / "buffer"))
        runner = port_fr.FlusherRunner(sqm, http_sink, disk_buffer=buf,
                                       breaker_failure_threshold=1,
                                       breaker_cooldown_s=cooldown_s)

        class Flusher:
            name = "flusher_http"
            queue_key = 7
            sender_queue = q

            def spill_identity(self):
                return {"pipeline": "p", "flusher_type": self.name,
                        "plugin_id": "flusher_http/0"}

            def build_request(self, item):
                return types.SimpleNamespace(body=item.data)

        if on_send_done is not None:
            Flusher.on_send_done = staticmethod(on_send_done)
        g = _group(SIDES["port"])
        plane.stamp("p", g)
        item = port_sq.SenderQueueItem(
            b"payload", 7, flusher=Flusher(), queue_key=7, event_cnt=1,
            stamps=port_slo.stamps_of([g]))
        q.push(item)
        q.get_available_items(1)
        runner._running = True      # the live runner's state, no thread
        return types.SimpleNamespace(plane=plane, q=q, buf=buf,
                                     runner=runner, item=item,
                                     breaker=runner.breaker_for(item))

    @staticmethod
    def _trip(rig):
        """Stop the rig, run the tick that trips, and return the row."""
        try:
            rig.runner._running = False
            assert rig.buf.spilled == 1 and rig.q.empty()
            rig.plane.evaluate_once()
            row = rig.plane.debug_document()["pipelines"]["p"]
        finally:
            rig.runner._running = False
            rig.runner.stop(drain=False)
            rig.runner.metrics.mark_deleted()
            rig.breaker.mark_deleted()
        assert row["episodes"] == 1
        return row["last_breakdown"]

    def test_spill_after_a_healthy_tick_names_the_sink(self, tmp_path):
        """The outage interleaving, driven in one thread: the flusher
        runner observes a 503's round trip, a healthy evaluator tick moves
        the baseline past it (run from inside the flusher's callback,
        which sits between the two), then the open breaker spills the
        payload, so nothing waits in a sender queue.  The trip's
        breakdown names the sink hop."""
        ticks = []

        def on_send_done(item, status, body):
            ticks.append(rig.plane.evaluate_once())
            return "retry"

        rig = self._spill_rig(tmp_path, on_send_done)
        rig.item.in_flight = True
        rig.item.last_send_time = time.monotonic() - 0.05
        try:
            rig.runner._on_done(rig.item, 503, b"")
        finally:
            bd = self._trip(rig)
        assert not ticks[0]["p"]["firing"]  # the tick was healthy
        # the round trip is in the baseline: no hop histogram moved
        assert bd["histograms"]["sink_rtt_seconds"]["delta_count"] == 0
        assert bd["dominant"] == "sink", bd
        assert bd["hops"]["sink"] == bd["spilled"]["sink"] > 0.0
        assert "inflight" not in bd

    def test_spill_at_an_open_breaker_names_no_hop(self, tmp_path):
        """The breakdown the repair leaves as it was: a payload that
        meets a breaker already open is spilled at dispatch without a send
        of its own, so after a healthy tick no hop spent anything on it and
        the trip names no hop, as in the JAX package (the outage from the
        first POST, ``test_torch_self_monitor.py``)."""
        rig = self._spill_rig(tmp_path, http_sink=object())
        rig.breaker.on_failure()
        try:
            assert not rig.plane.evaluate_once()["p"]["firing"]
            rig.runner._dispatch(rig.item)
        finally:
            bd = self._trip(rig)
        assert bd["dominant"] == "" and not any(bd["hops"].values()), bd
        assert "spilled" not in bd

    @pytest.mark.parametrize("tick_between", [True, False],
                             ids=["tick_between", "no_tick"])
    def test_failed_probe_spill(self, tmp_path, tick_between):
        """The half-open variant of the outage, driven in one thread
        through ``_dispatch``: the breaker is open and its cooldown has
        elapsed, so the stamped payload goes out as the probe; the send
        fails (503), the probe re-opens the breaker, and the same callback
        spills the payload.  With a healthy evaluator tick between the
        probe's round trip and the spill (run from inside the flusher's
        callback) this is the repaired interleaving: the breakdown names
        the sink from the spilled egress seconds and carries ``spilled``.
        With the last healthy tick before the dispatch, the probe's queue
        wait and round trip are the sink hop's spend, and the breakdown is
        the one it was before the repair (no ``spilled``)."""
        ticks = []

        class Sink:
            def add_request(self, request, done):
                done(503, b"")

        def on_send_done(item, status, body):
            if tick_between:
                ticks.append(rig.plane.evaluate_once())
            return "retry"

        rig = self._spill_rig(tmp_path, on_send_done, Sink(), 60.0)
        rig.item.enqueue_time = time.monotonic() - 0.05  # 50 ms queued
        rig.breaker.on_failure()            # open ...
        rig.breaker._opened_at -= 60.0      # ... and its cooldown elapsed
        try:
            if not tick_between:
                assert not rig.plane.evaluate_once()["p"]["firing"]
            rig.runner._dispatch(rig.item)
            assert rig.breaker.transitions[-2:] == ["half_open", "open"]
        finally:
            bd = self._trip(rig)
        assert [t["p"]["firing"] for t in ticks] == (
            [False] if tick_between else [])
        rtt = bd["histograms"]["sink_rtt_seconds"]["delta_count"]
        assert bd["dominant"] == "sink", bd
        assert "inflight" not in bd
        if tick_between:
            # the probe's round trip is in the baseline: no hop moved
            assert rtt == 0
            assert bd["hops"]["sink"] == bd["spilled"]["sink"] >= 0.05
            assert not any(v for k, v in bd["hops"].items() if k != "sink")
        else:
            assert rtt == 1
            assert "spilled" not in bd and bd["hops"]["sink"] >= 0.05


class TestExportLifecycle:
    def test_disable_retires_every_slo_record(self, side):
        slo = side["slo"]
        plane = slo.enable()
        slo.reset()
        g = _group(side)
        plane.stamp("p", g)
        slo.observe_groups("p", [g], slo.OUTCOME_SEND_OK)
        slo.export_refresh()
        assert _hist_count(side, "p", slo.OUTCOME_SEND_OK) == 1
        slo.disable()
        assert _hist_count(side, "p", slo.OUTCOME_SEND_OK) == 0
        for rec in side["metrics"].WriteMetrics.instance().records():
            assert rec.category != "slo"
        assert "loong_pipeline_freshness_seconds{" not in \
            side["expo"].render()

    def test_gauges_mirror_outstanding_and_freshness(self, side):
        slo = side["slo"]
        plane = slo.enable()
        slo.reset()
        g = _group(side)
        plane.stamp("p", g)
        plane.note_result("p", 1.0, slo.OUTCOME_SEND_OK)
        slo.export_refresh()
        gauges = {}
        for rec in side["metrics"].WriteMetrics.instance().records():
            if rec.category == "slo" and rec.labels.get("pipeline") == "p" \
                    and "outcome" not in rec.labels:
                gauges.update(rec.snapshot()["gauges"])
        assert gauges["slo_outstanding_stamps"] == 1.0
        assert gauges["pipeline_freshness_seconds"] >= 0.0
        assert gauges["slo_burn_firing"] == 0.0


# ---------------------------------------------------------------------------
# the plane off: no hook reaches it


def test_disabled_plane_is_never_called(tmp_path, monkeypatch):
    """Port agent runs with the SLO plane off never enter a ``SloPlane``
    method (each is patched to raise): the Apache main path to a file
    sink, and the rollup through ``flusher_prometheus`` to a receiver
    answering 503 for its first second (retries, the breaker's spill and
    the replay)."""
    import chip_smoke
    from loongcollector_tpu_torch import application
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.runner import flusher_runner as port_fr
    monkeypatch.setattr(port_fr, "RETRY_BASE_S", 0.02)
    monkeypatch.setattr(port_fr, "RETRY_MAX_S", 0.25)

    def boom(*a, **k):
        raise AssertionError("the SLO plane was reached while off")

    for name in ("stamp", "ensure_stamp", "cancel_group", "note_fanout",
                 "observe_stamps", "observe_groups", "retire_groups",
                 "stamps_of", "note_result", "evaluate_once",
                 "export_gauges", "freshness"):
        monkeypatch.setattr(port_slo.SloPlane, name, boom)
    monkeypatch.delenv("LOONG_SLO", raising=False)
    log = tmp_path / "a.log"
    log.write_bytes(b"\n".join(td.gen_lines(300, seed=2)) + b"\n")
    out = tmp_path / "out.json"
    cfg = tmp_path / "cfg"
    cfg.mkdir()
    (cfg / "apache.yaml").write_text(td.apache_config(str(log), str(out)))
    assert application.main(["--config", str(cfg), "--once", "--cpu"]) == 0
    assert len(out.read_bytes().splitlines()) == 300
    lines = td.gen_metrics_jsonl(800, seed=5)
    mlog = tmp_path / "m.jsonl"
    mlog.write_bytes(b"\n".join(lines) + b"\n")
    recv = chip_smoke.RemoteWriteReceiver(
        lambda t: 503 if t < 1.0 else 200).start()
    try:
        rcfg = tmp_path / "rcfg"
        rcfg.mkdir()
        (rcfg / "rollup.yaml").write_text(
            td.metric_rollup_remote_write_config(str(mlog), recv.url))
        stats = tmp_path / "s.json"
        assert application.main([
            "--config", str(rcfg), "--once", "--cpu", "--data-dir",
            str(tmp_path / "data"), "--stats", str(stats)]) == 0
    finally:
        recv.stop()
    send = json.loads(stats.read_text())["send"]
    assert recv.answers.get(503) and send["spilled"] >= 1
    assert send["replayed"] == send["spilled"]
    assert not port_slo.is_on()
