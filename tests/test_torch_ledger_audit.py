"""The rest of the port's ledger (``monitor/ledger.py``): the auditor,
the occupancy probe, the lag watermarks, quiesce helpers and the export,
against the JAX package's.

* Parity: the same seeded sequence of boundary records, occupancy
  readings and audit ticks goes through both packages' ledgers and
  ``ConservationAuditor``s; every tick's residuals, the auditors' counts,
  the snapshots and the ``CONSERVATION_RESIDUAL`` alarms (time fields
  dropped) are equal.  A muted disk-buffer spill record (the JAX
  package's ``TestMutedSpillRecordTripsAuditor``) trips both auditors
  alike; the control run with the record live stays silent in both.
* The JAX package's cases of ``tests/test_loongledger.py`` for these
  parts (accounting, lag watermarks, the auditor, the disk buffer's
  conservation), each run on both packages; its Kafka case waits for the
  port's Kafka sink.
* End to end on the port: a real pipeline (process queue, regex parse on
  the plain K1, ``flusher_file``) with two workers balances to zero at
  quiesce (``assert_conserved``), ``live_inflight`` reads 0 then,
  ``/debug/ledger`` and the export records tell the same story, and the
  continuous auditor quiesces on it without an alarm.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from loongcollector_tpu.models import PipelineEventGroup as RefGroup
from loongcollector_tpu.models import SourceBuffer as RefSB
from loongcollector_tpu.monitor import alarms as ref_alarms
from loongcollector_tpu.monitor import ledger as ref_ledger
from loongcollector_tpu.pipeline.queue import bounded_queue as ref_bq
from loongcollector_tpu.pipeline.queue import sender_queue as ref_sq
from loongcollector_tpu.runner import disk_buffer as ref_db
from loongcollector_tpu_torch.models import PipelineEventGroup, SourceBuffer
from loongcollector_tpu_torch.monitor import alarms as port_alarms
from loongcollector_tpu_torch.monitor import exposition as port_expo
from loongcollector_tpu_torch.monitor import ledger as port_ledger
from loongcollector_tpu_torch.pipeline.queue import bounded_queue as port_bq
from loongcollector_tpu_torch.pipeline.queue import sender_queue as port_sq
from loongcollector_tpu_torch.runner import disk_buffer as port_db

from conftest import wait_for
from test_torch_alarms import TIME_FIELDS, reset_planes

SIDES = {
    "reference": dict(ledger=ref_ledger, alarms=ref_alarms, bq=ref_bq,
                      sq=ref_sq, db=ref_db, group=RefGroup, sb=RefSB),
    "port": dict(ledger=port_ledger, alarms=port_alarms, bq=port_bq,
                 sq=port_sq, db=port_db, group=PipelineEventGroup,
                 sb=SourceBuffer),
}


@pytest.fixture(autouse=True)
def _clean_planes():
    reset_planes()
    yield
    reset_planes()


@pytest.fixture(params=["reference", "port"])
def side(request):
    return SIDES[request.param] | {"name": request.param}


def _group(side, payload: bytes, source: bytes = b""):
    sb = side["sb"](len(payload) + 64)
    g = side["group"](sb)
    g.add_raw_event(1).set_content(sb.copy_string(payload))
    if source:
        g.set_tag(b"__source__", source)
    return g


def _alarms(side):
    return sorted(({k: v for k, v in d.items() if k not in TIME_FIELDS}
                   for d in side["alarms"].AlarmManager.instance().flush()),
                  key=lambda d: json.dumps(d, sort_keys=True))


def _audit_n(aud, n):
    rs = None
    for _ in range(n):
        rs = aud.audit_once()
    return rs


# ---------------------------------------------------------------------------
# parity: one seeded record / occupancy / tick sequence through both


BOUNDARIES = ("ingest", "process_expand", "fanout", "replay", "agg_emit",
              "send_ok", "process_drop", "spill", "quarantine", "drop",
              "agg_fold", "enqueue", "dequeue", "serialize", "send_fail")


def _ledger_script(seed, n=400):
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        r = rng.random()
        if r < 0.55:
            ops.append(("record", "pq"[int(rng.integers(0, 2))],
                        BOUNDARIES[int(rng.integers(0, len(BOUNDARIES)))],
                        int(rng.integers(0, 9)), int(rng.integers(0, 999)),
                        "" if rng.random() < 0.6 else
                        "t%d" % rng.integers(0, 3)))
        elif r < 0.65:
            ops.append(("inflight", [0, 0, 0, 2, None][
                int(rng.integers(0, 5))]))
        else:
            ops.append(("audit",))
    return ops


@pytest.mark.parametrize("seed", [5, 19, 77])
def test_auditors_agree_on_one_sequence(seed, monkeypatch):
    ops = _ledger_script(seed)
    res = {}
    for name in ("reference", "port"):
        s = SIDES[name]
        ledger = s["ledger"]
        occupancy = [0]
        monkeypatch.setattr(ledger, "live_inflight", lambda: occupancy[0])
        led = ledger.enable()
        aud = ledger.ConservationAuditor(led, interval_s=0.01)
        ticks = []
        for op in ops:
            if op[0] == "record":
                ledger.record(*op[1:])
            elif op[0] == "inflight":
                occupancy[0] = op[1]
            else:
                ticks.append(aud.audit_once())
        res[name] = dict(
            ticks=ticks, snap=led.snapshot(),
            counts=(aud.audits_total, aud.quiesced_audits_total,
                    aud.residual_alarms_total),
            alarms=_alarms(s))
        monkeypatch.undo()
        reset_planes()
    assert res["port"] == res["reference"]
    assert res["port"]["counts"][1] > 0      # some audits were quiesced
    assert res["port"]["counts"][2] > 0      # and some found a residual


class _SpillFlusher:
    name = "flusher_fake"
    plugin_id = "flusher_fake/0"

    def spill_identity(self):
        return {"pipeline": "px", "flusher_type": self.name,
                "plugin_id": self.plugin_id}


@pytest.mark.parametrize("muted", [True, False])
def test_muted_spill_record_trips_both_auditors_alike(tmp_path, monkeypatch,
                                                      muted):
    res = {}
    for name in ("reference", "port"):
        s = SIDES[name]
        ledger = s["ledger"]
        led = ledger.enable()
        monkeypatch.setattr(ledger, "live_inflight", lambda: 0)
        if muted:
            real = ledger.record

            def mute(pipeline, boundary, events, nbytes=0, tag="",
                     real=real, ledger=ledger):
                if boundary == ledger.B_SPILL:
                    return      # the deliberately commented-out record
                real(pipeline, boundary, events, nbytes, tag)
            monkeypatch.setattr(ledger, "record", mute)
        ledger.record("px", ledger.B_INGEST, 3, 30)
        db = s["db"].DiskBufferWriter(str(tmp_path / name))
        item = s["sq"].SenderQueueItem(b"payload-xyz", 11,
                                       flusher=_SpillFlusher(), queue_key=1,
                                       event_cnt=3)
        assert db.spill(item, _SpillFlusher().spill_identity())
        aud = ledger.ConservationAuditor(led, interval_s=0.01)
        rs = _audit_n(aud, 3)
        res[name] = (rs, aud.residual_alarms_total, _alarms(s))
        monkeypatch.undo()
        reset_planes()
    assert res["port"] == res["reference"]
    rs, n_alarms, alarms = res["port"]
    if muted:
        assert rs == {"px": 3} and n_alarms == 1
        assert [(a["alarm_type"], a["alarm_level"], a["pipeline"],
                 a["residual"]) for a in alarms] == [
            ("CONSERVATION_RESIDUAL_ALARM", "critical", "px", "3")]
    else:
        assert rs == {"px": 0} and n_alarms == 0 and alarms == []


# ---------------------------------------------------------------------------
# the JAX package's cases, on both packages


class TestEventLedger:
    def test_residual_formula(self, side):
        ledger = side["ledger"]
        led = ledger.EventLedger()
        for b, n in (("ingest", 100), ("process_expand", 20),
                     ("replay", 5), ("fanout", 10), ("send_ok", 110),
                     ("process_drop", 15), ("spill", 5), ("quarantine", 2),
                     ("drop", 3), ("enqueue", 999), ("dequeue", 999),
                     ("serialize", 999), ("send_fail", 999),
                     ("device_submit", 999)):
            led.record("p", b, n)
        snap = led.snapshot()
        assert ledger.residual_of(snap["p"]) == 0
        assert ledger.residuals(snap) == {"p": 0}

    def test_disabled_hooks_are_noops(self, side):
        ledger = side["ledger"]
        assert not ledger.is_on()
        ledger.record("p", ledger.B_INGEST, 5)
        assert ledger.active_ledger() is None
        assert ledger.wait_quiesced(timeout=0.05) is None
        assert ledger.debug_document() == {"enabled": False}

    def test_install_from_env(self, side):
        ledger = side["ledger"]
        assert not ledger.install_from_env({})
        assert not ledger.install_from_env({"LOONG_LEDGER": "0"})
        assert ledger.install_from_env({"LOONG_LEDGER": "1"})
        assert ledger.is_on() and ledger.auditor() is None
        ledger.disable()
        assert ledger.install_from_env({"LOONG_LEDGER_AUDIT": "1",
                                        "LOONG_LEDGER_AUDIT_INTERVAL": "0.05"})
        aud = ledger.auditor()
        assert aud is not None and aud.interval_s == 0.05
        ledger.disable()
        assert ledger.auditor() is None

    def test_reset_forgets_totals_and_the_auditor_baseline(self, side,
                                                           monkeypatch):
        ledger = side["ledger"]
        monkeypatch.setattr(ledger, "live_inflight", lambda: 0)
        led = ledger.enable()
        aud = ledger.start_auditor(interval_s=60)
        ledger.record("p", ledger.B_INGEST, 2)
        aud.audit_once()
        ledger.reset()
        assert led.snapshot() == {} and aud._prev is None
        ledger.stop_auditor()


class TestLagWatermarks:
    def test_process_queue_oldest_age_follows_head(self, side):
        q = side["bq"].BoundedProcessQueue(1, capacity=10, pipeline_name="p")
        assert q.oldest_age() is None
        q.push(_group(side, b"a"))
        time.sleep(0.12)
        q.push(_group(side, b"b"))
        age = q.oldest_age()
        assert age is not None and age >= 0.12
        q.pop()
        age2 = q.oldest_age()
        assert age2 is not None and age2 < age

    def test_sender_queue_oldest_age(self, side):
        sq = side["sq"]
        q = sq.SenderQueue(1, capacity=10, pipeline_name="p")
        assert q.oldest_age() is None
        q.push(sq.SenderQueueItem(b"x", 1, queue_key=1))
        time.sleep(0.1)
        assert q.oldest_age() >= 0.1

    def test_max_lag_covers_both_families(self, side, monkeypatch):
        ledger = side["ledger"]
        monkeypatch.setattr(ledger, "lag_snapshot", lambda: {
            "p1": {"process_queue": 0.25, "sender_queue": 0.0},
            "p2": {"process_queue": 0.0, "sender_queue": 0.75}})
        assert ledger.max_lag_seconds() == 0.75


class TestConservationAuditor:
    def _auditor(self, side, monkeypatch, led):
        monkeypatch.setattr(side["ledger"], "live_inflight", lambda: 0)
        return side["ledger"].ConservationAuditor(led, interval_s=0.01)

    def test_balanced_ledger_never_alarms(self, side, monkeypatch):
        ledger = side["ledger"]
        led = ledger.enable()
        led.record("p", ledger.B_INGEST, 8)
        led.record("p", ledger.B_SEND_OK, 8)
        aud = self._auditor(side, monkeypatch, led)
        assert _audit_n(aud, 4) == {"p": 0}
        assert aud.quiesced_audits_total == 3
        assert aud.residual_alarms_total == 0
        assert _alarms(side) == []

    def test_persistent_residual_alarms_once(self, side, monkeypatch):
        ledger = side["ledger"]
        led = ledger.enable()
        led.record("p", ledger.B_INGEST, 5)
        led.record("p", ledger.B_SEND_OK, 3)
        aud = self._auditor(side, monkeypatch, led)
        aud.audit_once()
        aud.audit_once()
        assert aud.residual_alarms_total == 0     # a first sighting
        aud.audit_once()
        assert aud.residual_alarms_total == 1
        _audit_n(aud, 3)
        assert aud.residual_alarms_total == 1
        [alarm] = _alarms(side)
        assert alarm["alarm_type"] == "CONSERVATION_RESIDUAL_ALARM"
        assert alarm["residual"] == "2" and alarm["pipeline"] == "p"

    def test_alarm_rearms_after_residual_clears(self, side, monkeypatch):
        ledger = side["ledger"]
        led = ledger.enable()
        led.record("p", ledger.B_INGEST, 5)
        led.record("p", ledger.B_SEND_OK, 3)
        aud = self._auditor(side, monkeypatch, led)
        _audit_n(aud, 3)
        assert aud.residual_alarms_total == 1
        led.record("p", ledger.B_DROP, 2, tag="found_and_ledgered")
        _audit_n(aud, 3)
        led.record("p", ledger.B_INGEST, 1)
        _audit_n(aud, 3)
        assert aud.residual_alarms_total == 2

    def test_movement_between_snapshots_defers_audit(self, side,
                                                     monkeypatch):
        ledger = side["ledger"]
        led = ledger.enable()
        led.record("p", ledger.B_INGEST, 5)
        aud = self._auditor(side, monkeypatch, led)
        aud.audit_once()
        led.record("p", ledger.B_SEND_OK, 2)
        assert aud.audit_once() == {}
        assert aud.quiesced_audits_total == 0

    def test_live_occupancy_defers_audit(self, side, monkeypatch):
        ledger = side["ledger"]
        led = ledger.enable()
        led.record("p", ledger.B_INGEST, 5)
        monkeypatch.setattr(ledger, "live_inflight", lambda: 3)
        aud = ledger.ConservationAuditor(led, interval_s=0.01)
        assert _audit_n(aud, 3) == {}
        assert aud.quiesced_audits_total == 0

    def test_unknown_occupancy_defers_audit(self, side, monkeypatch):
        ledger = side["ledger"]
        led = ledger.enable()
        led.record("p", ledger.B_INGEST, 5)
        monkeypatch.setattr(ledger, "live_inflight", lambda: None)
        aud = ledger.ConservationAuditor(led, interval_s=0.01)
        assert _audit_n(aud, 3) == {}

    def test_auditor_thread_lifecycle(self, side, monkeypatch):
        ledger = side["ledger"]
        monkeypatch.setattr(ledger, "live_inflight", lambda: 0)
        led = ledger.enable()
        led.record("p", ledger.B_INGEST, 2)
        led.record("p", ledger.B_SEND_OK, 2)
        aud = ledger.start_auditor(interval_s=0.01)
        assert ledger.start_auditor() is aud
        assert wait_for(lambda: aud.quiesced_audits_total >= 2, timeout=10)
        ledger.stop_auditor()
        assert ledger.auditor() is None


class TestDiskBufferConservation:
    def test_spill_replay_restores_event_units(self, side, tmp_path):
        ledger, sq = side["ledger"], side["sq"]
        ledger.enable()
        ledger.record("px", ledger.B_INGEST, 4, 40)
        db = side["db"].DiskBufferWriter(str(tmp_path / "buf"))
        flusher = _SpillFlusher()

        class _Q:
            pushed = []

            def push(self, item):
                self.pushed.append(item)
                return True

        flusher.sender_queue = _Q()
        flusher.queue_key = 1
        item = sq.SenderQueueItem(b"payload", 7, flusher=flusher,
                                  queue_key=1, event_cnt=4)
        assert db.spill(item, flusher.spill_identity())
        led = ledger.active_ledger()
        assert led.total("px", ledger.B_SPILL) == 4
        assert ledger.residuals(led.snapshot()) == {"px": 0}
        assert db.replay(lambda identity: flusher) == 1
        assert led.total("px", ledger.B_REPLAY) == 4
        assert _Q.pushed[0].event_cnt == 4
        ledger.record("px", ledger.B_SEND_OK, 4)
        assert ledger.residuals(led.snapshot()) == {"px": 0}

    def test_quarantine_settles_spilled_balance(self, side, tmp_path):
        ledger, sq = side["ledger"], side["sq"]
        ledger.enable()
        ledger.record("px", ledger.B_INGEST, 2, 20)
        db = side["db"].DiskBufferWriter(str(tmp_path / "buf"))
        item = sq.SenderQueueItem(b"to-corrupt", 10, flusher=_SpillFlusher(),
                                  queue_key=1, event_cnt=2)
        assert db.spill(item, _SpillFlusher().spill_identity())
        with open(db.pending()[0], "r+b") as f:
            f.write(b"\xff\xff\xff\xff")
        assert db.replay(lambda identity: _SpillFlusher()) == 0
        assert len(db.quarantined()) == 1
        led = ledger.active_ledger()
        assert led.total("px", ledger.B_QUARANTINE) == 2
        assert ledger.residuals(led.snapshot()) == {"px": 0}
        assert [a["alarm_type"] for a in _alarms(side)] == \
            ["SECONDARY_READ_WRITE_ALARM"]

    def test_export_records_and_disable(self, side):
        ledger = side["ledger"]
        ledger.enable()
        ledger.record("gone", ledger.B_INGEST, 1)
        ledger.record("gone", ledger.B_SEND_OK, 1)
        ledger.export_refresh()
        rec = ledger._export_records["gone"]
        assert rec.gauge("ledger_send_ok_events").value == 1
        assert rec.gauge("conservation_residual_events").value == 0
        ledger.disable()
        assert rec._deleted and ledger._export_records == {}


# ---------------------------------------------------------------------------
# end to end on the port


def _port_pipeline(tmp_path, name, threads=2):
    from loongcollector_tpu_torch.pipeline.pipeline_manager import \
        CollectionPipelineManager
    from loongcollector_tpu_torch.pipeline.queue.process_queue_manager \
        import ProcessQueueManager
    from loongcollector_tpu_torch.runner.processor_runner import \
        ProcessorRunner
    pqm = ProcessQueueManager()
    mgr = CollectionPipelineManager(pqm, torch.device("cpu"))
    out = tmp_path / f"{name}.jsonl"
    mgr.update_pipelines([(name, {
        "inputs": [{"Type": "input_file", "FilePaths": ["/nonexistent"]}],
        "processors": [{"Type": "processor_parse_regex_tpu",
                        "Regex": r"(\w+):(\d+)", "Keys": ["src", "seq"]}],
        "flushers": [{"Type": "flusher_file", "FilePath": str(out)}],
    })])
    runner = ProcessorRunner(pqm, mgr, thread_count=threads,
                             device=torch.device("cpu"))
    runner.init()
    return pqm, mgr, runner, mgr.find_pipeline(name), out


def _push(pqm, p, g):
    deadline = time.monotonic() + 20
    while not pqm.push_queue(p.process_queue_key, g):
        assert time.monotonic() < deadline
        time.sleep(0.002)


def test_real_pipeline_balances_to_zero(tmp_path):
    port_ledger.enable()
    pqm, mgr, runner, p, out = _port_pipeline(tmp_path, "e2e")
    side = SIDES["port"]
    try:
        total = 0
        for i in range(30):
            lines = b"\n".join(b"s%d:%d" % (i % 3, i * 10 + j)
                               for j in range(8))
            g = _group(side, lines, source=b"s%d" % (i % 3))
            from loongcollector_tpu_torch.processor.split_log_string import \
                ProcessorSplitLogString
            split = ProcessorSplitLogString()
            split.init({}, p.context)
            split.process(g)
            _push(pqm, p, g)
            total += 8
        snap = port_ledger.assert_conserved(timeout=30)
        row = snap["e2e"]
        assert row["ingest"]["events"] == total
        assert row["send_ok"]["events"] == total
        assert row["enqueue"]["events"] == row["dequeue"]["events"] == total
        assert "drop" not in row
        assert port_ledger.live_inflight() == 0
        doc = port_ledger.debug_document()
        assert doc["inflight_live"] == 0
        assert doc["pipelines"]["e2e"]["residual"] == 0
        assert doc["lag"]["e2e"] == {"process_queue": 0.0,
                                     "sender_queue": 0.0}
        port_ledger.export_refresh()
        rec = port_ledger._export_records["e2e"]
        assert rec.gauge("ledger_send_ok_events").value == total
        assert rec.gauge("conservation_residual_events").value == 0
        status = port_expo.collect_status()
        assert status["pipelines"]["e2e"]["conservation_residual"] == 0
        assert status["ledger"]["residuals"] == {"e2e": 0}
        assert status["workers"]["count"] == 2
    finally:
        runner.stop()
        mgr.stop_all()
    assert len(out.read_text().splitlines()) == total


def test_occupancy_probe_sees_a_held_group(tmp_path):
    """A group parked in the process queue (the runner not started) is
    live occupancy, and the audit waits for it."""
    from loongcollector_tpu_torch.pipeline.pipeline_manager import \
        CollectionPipelineManager
    from loongcollector_tpu_torch.pipeline.queue.process_queue_manager \
        import ProcessQueueManager
    led = port_ledger.enable()
    pqm = ProcessQueueManager()
    mgr = CollectionPipelineManager(pqm, torch.device("cpu"))
    mgr.update_pipelines([("held", {
        "inputs": [{"Type": "input_file", "FilePaths": ["/nonexistent"]}],
        "flushers": [{"Type": "flusher_file",
                      "FilePath": str(tmp_path / "o.json")}]})])
    try:
        p = mgr.find_pipeline("held")
        assert pqm.push_queue(p.process_queue_key,
                              _group(SIDES["port"], b"x"))
        assert port_ledger.live_inflight() == 1
        aud = port_ledger.ConservationAuditor(led, interval_s=0.01)
        assert _audit_n(aud, 3) == {}
        assert port_ledger.lag_snapshot()["held"]["process_queue"] > 0.0
        assert port_ledger.wait_quiesced(timeout=0.3) is None
    finally:
        mgr.stop_all()
    assert port_ledger.live_inflight() == 0


def test_auditor_quiesces_on_live_pipeline(tmp_path):
    port_ledger.enable()
    pqm, mgr, runner, p, out = _port_pipeline(tmp_path, "live", threads=1)
    aud = port_ledger.start_auditor(interval_s=0.05)
    try:
        for i in range(10):
            _push(pqm, p, _group(SIDES["port"], b"x:%d" % i, source=b"s"))
        assert wait_for(lambda: aud.quiesced_audits_total >= 3, timeout=30)
        assert aud.residual_alarms_total == 0
        assert _alarms(SIDES["port"]) == []
    finally:
        runner.stop()
        mgr.stop_all()


def test_debug_ledger_http_route():
    port_ledger.enable()
    port_ledger.record("p1", port_ledger.B_INGEST, 4, 64)
    port_ledger.record("p1", port_ledger.B_SEND_OK, 4, 64)
    srv = port_expo.ExpositionServer(port=0)
    assert srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        doc = json.load(urllib.request.urlopen(base + "/debug/ledger",
                                               timeout=5))
        assert doc["enabled"] is True
        assert doc["pipelines"]["p1"]["residual"] == 0
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=5).read().decode()
        assert "loong_ledger_ingest_events{" in text
        assert "loong_conservation_residual_events{" in text
    finally:
        srv.stop()
