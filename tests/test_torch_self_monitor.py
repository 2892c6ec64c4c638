"""The port's self-monitor (``monitor/self_monitor.py``), its internal
inputs (``input/internal.py``) and runtime gauges
(``monitor/runtime_stats.py``) against the JAX package's, on the CPU.

* ``send_once``: the same metric records and alarms in both packages'
  registries become the same groups (one multi-value metric event a
  record, named by its category, labels as tags, histograms flattened;
  one log event an aggregated alarm; ``__source__: self_monitor``); the
  destructive drains run only into a queue that takes the group.
* ``input_internal_metrics`` / ``input_internal_alarms``: registered under
  those names, ``IntervalSeconds`` sets the cadence, ``start`` binds the
  pipeline's queue and starts the server, ``stop`` unbinds; the groups
  the server pushed are the input's ``groups_pushed``.
* ``runtime_stats.refresh`` after a port agent run fills the gauges of the
  planes the port has.
* End to end: the same YAML (the shipped rollup config's remote-write
  outage through ``flusher_prometheus``, as ``test_torch_send_e2e.py``
  drives it, here a receiver answering 503 for 3.5 s from its first
  POST, beside ``input_internal_metrics`` and
  ``input_internal_alarms`` pipelines) runs through both agents in tail
  mode with ``LOONG_SLO=1`` and the auditor.  The alarms NDJSON matches
  record by record on type, level, count and message (the JAX burn
  alarm's hop aside when its breakdown named none); the metrics
  NDJSON's SLO and ledger records match on category and labels (the SLO
  records on their value names too); both agents show one episode and
  equal ok / bad totals, the port's with ``sink`` dominant (the JAX
  package's names ``sink`` or, in its spill race, no hop), and every
  sample arrives once at both.  The port's ``--stats`` send totals (items sent, items
  spilled) equal the receiver's and the disk buffer's counts: the
  self-monitor's sends reset no counter.  The JAX package's chaos-plane storm is not needed: the
  outage is the test server's 503s.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

import chip_smoke
from conftest import wait_for
from loongcollector_tpu.monitor import alarms as ref_alarms
from loongcollector_tpu.monitor import metrics as ref_metrics
from loongcollector_tpu.monitor import runtime_stats as ref_runtime_stats
from loongcollector_tpu.monitor import self_monitor as ref_sm
from loongcollector_tpu.pipeline.queue import \
    process_queue_manager as ref_pqm
from loongcollector_tpu_torch import native as port_native
from loongcollector_tpu_torch import testdata as td
from loongcollector_tpu_torch.input.internal import (InputInternalAlarms,
                                                     InputInternalMetrics)
from loongcollector_tpu_torch.monitor import alarms as port_alarms
from loongcollector_tpu_torch.monitor import metrics as port_metrics
from loongcollector_tpu_torch.monitor import runtime_stats
from loongcollector_tpu_torch.monitor import self_monitor as port_sm
from loongcollector_tpu_torch.pipeline.plugin.interface import PluginContext
from loongcollector_tpu_torch.pipeline.plugin.registry import PluginRegistry
from loongcollector_tpu_torch.pipeline.queue import \
    process_queue_manager as port_pqm

from test_torch_alarms import TIME_FIELDS, reset_planes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIDES = {
    "reference": dict(sm=ref_sm, metrics=ref_metrics, alarms=ref_alarms,
                      pqm=ref_pqm, rs=ref_runtime_stats),
    "port": dict(sm=port_sm, metrics=port_metrics, alarms=port_alarms,
                 pqm=port_pqm, rs=runtime_stats),
}


@pytest.fixture(autouse=True)
def _clean_planes():
    reset_planes()
    yield
    reset_planes()


def _as_docs(group):
    from loongcollector_tpu.pipeline.serializer.json_serializer import \
        JsonSerializer as RefJson
    from loongcollector_tpu_torch.pipeline.serializer.json_serializer import \
        JsonSerializer
    ser = JsonSerializer() if isinstance(group, port_sm.PipelineEventGroup) \
        else RefJson()
    return [json.loads(x) for x in ser.serialize([group]).split(b"\n")
            if x.strip()]


def _fill(metrics, seed):
    rng = np.random.default_rng(seed)
    for i in range(4):
        rec = metrics.MetricsRecord(category=("slo", "ledger")[i % 2],
                                    labels={"pipeline": f"p{i}"})
        rec.counter("n_total").add(int(rng.integers(0, 1000)))
        rec.gauge("lag_seconds").set(float(rng.integers(0, 9)) / 4)
        h = rec.histogram("event_to_flush_ms")
        for v in rng.integers(1, 5000, size=int(rng.integers(1, 50))):
            h.observe(float(v))


@pytest.mark.parametrize("seed", [2, 8])
def test_send_once_builds_the_reference_groups(seed, monkeypatch):
    docs = {}
    for name, s in SIDES.items():
        monkeypatch.setattr(s["metrics"].WriteMetrics, "_instance", None)
        _fill(s["metrics"], seed)
        mgr = s["alarms"].AlarmManager.instance()
        mgr.send_alarm(s["alarms"].AlarmType.SEND_FAIL, "send failed (503)")
        mgr.send_alarm(s["alarms"].AlarmType.SEND_FAIL, "send failed (503)")
        mgr.send_alarm(s["alarms"].AlarmType.SLO_BURN_RATE, "burn",
                       s["alarms"].AlarmLevel.ERROR, pipeline="p0",
                       details={"dominant_hop": "sink"})
        pqm = s["pqm"].ProcessQueueManager()
        pqm.create_or_reuse_queue(1, pipeline_name="m")
        pqm.create_or_reuse_queue(2, pipeline_name="a")
        server = s["sm"].SelfMonitorServer()
        server.process_queue_manager = pqm
        server.set_metrics_pipeline(1)
        server.set_alarms_pipeline(2)
        # the runtime gauges are each package's own: only the records of
        # this test are compared
        monkeypatch.setattr(s["rs"], "refresh", lambda: None)
        server.send_once()
        _, metrics_group = pqm.pop_item(timeout=0)
        _, alarms_group = pqm.pop_item(timeout=0)
        assert pqm.pop_item(timeout=0) is None
        docs[name] = (
            sorted((json.dumps({k: v for k, v in d.items()
                                if k != "__time__"}, sort_keys=True)
                    for d in _as_docs(metrics_group))),
            sorted((json.dumps({k: v for k, v in d.items()
                                if k not in TIME_FIELDS + ("__time__",)},
                               sort_keys=True)
                    for d in _as_docs(alarms_group))))
        if name == "port":
            assert server.groups_pushed(1) == server.groups_pushed(2) == 1
    assert docs["port"] == docs["reference"]
    assert len(docs["port"][0]) == 4 and len(docs["port"][1]) == 2


def _observe_round(records, rng):
    for rec in records:
        rec.counter("n_total").add(int(rng.integers(0, 1000)))
        rec.gauge("lag_seconds").set(float(rng.integers(0, 9)) / 4)
        h = rec.histogram("event_to_flush_ms")
        # some rounds observe nothing: the window's max and percentiles
        # are then 0, as after the reference's reset
        for v in rng.integers(1, 5000, size=int(rng.integers(0, 30))):
            h.observe(float(v))


@pytest.mark.parametrize("seed", [3, 5, 9])
def test_successive_sends_equal_the_reference_deltas(seed, monkeypatch):
    """Three sends with observations between them: each of the port's
    groups (deltas of cumulative instruments, the window's max) equals the
    reference's (a draining snapshot), and the port's instruments still
    hold the totals afterwards."""
    sent = {}
    for name, s in SIDES.items():
        monkeypatch.setattr(s["metrics"].WriteMetrics, "_instance", None)
        monkeypatch.setattr(s["rs"], "refresh", lambda: None)
        rng = np.random.default_rng(seed)
        records = [s["metrics"].MetricsRecord(
            category="slo", labels={"pipeline": f"p{i}"}) for i in range(3)]
        pqm = s["pqm"].ProcessQueueManager()
        pqm.create_or_reuse_queue(1, pipeline_name="m")
        server = s["sm"].SelfMonitorServer()
        server.process_queue_manager = pqm
        server.set_metrics_pipeline(1)
        sent[name] = []
        for _ in range(3):
            _observe_round(records, rng)
            server.send_once()
            _, group = pqm.pop_item(timeout=0)
            # this test's records (the queue-wait histogram of the pops
            # above times this process)
            sent[name].append(sorted(json.dumps(
                {k: v for k, v in d.items() if k != "__time__"},
                sort_keys=True) for d in _as_docs(group)
                if d["__name__"] == "slo"))
        if name == "port":
            n_sent = sum(json.loads(d)["__values__"]["n_total"]
                         for docs in sent[name] for d in docs)
            assert sum(r.counter("n_total").value for r in records) \
                == n_sent
            assert sum(r.histogram("event_to_flush_ms").count
                       for r in records) == sum(
                json.loads(d)["__values__"]["event_to_flush_ms_count"]
                for docs in sent[name] for d in docs)
    assert sent["port"] == sent["reference"]


def test_drains_only_into_a_queue_that_takes_the_group(monkeypatch):
    monkeypatch.setattr(runtime_stats, "refresh", lambda: None)
    pqm = port_pqm.ProcessQueueManager()
    q = pqm.create_or_reuse_queue(1, capacity=1, pipeline_name="m")
    from loongcollector_tpu_torch.models import PipelineEventGroup
    assert q.push(PipelineEventGroup())           # full: not valid to push
    rec = port_metrics.MetricsRecord(category="t", labels={"x": "1"})
    try:
        rec.counter("n_total").add(7)
        port_alarms.AlarmManager.instance().send_alarm(
            port_alarms.AlarmType.SEND_FAIL, "x")
        server = port_sm.SelfMonitorServer()
        server.process_queue_manager = pqm
        server.set_metrics_pipeline(1)
        server.set_alarms_pipeline(1)
        server.send_once()
        # nothing read: the deltas wait for the queue to reopen
        assert not port_alarms.AlarmManager.instance().empty()
        assert server.groups_pushed(1) == 0
        pqm.pop_item(timeout=0)

        def sent_n_total():
            server.send_once()
            _, group = pqm.pop_item(timeout=0)
            ev, = [ev for ev in group.events if str(ev.name) == "t"]
            return ev.value.values[b"n_total"]
        assert sent_n_total() == 7.0
        assert server.groups_pushed(1) == 1
        # the send ships the delta and resets nothing: --stats and
        # /metrics still read the total
        assert rec.counter("n_total").value == 7
        rec.counter("n_total").add(2)
        assert sent_n_total() == 2.0
        assert rec.counter("n_total").value == 9
    finally:
        rec.mark_deleted()


def test_internal_inputs_bind_the_server():
    reg = PluginRegistry.instance()
    reg.load_static_plugins()
    assert isinstance(reg.create_input("input_internal_metrics"),
                      InputInternalMetrics)
    assert isinstance(reg.create_input("input_internal_alarms"),
                      InputInternalAlarms)
    server = port_sm.SelfMonitorServer.instance()
    m, a = InputInternalMetrics(), InputInternalAlarms()
    assert m.init({"IntervalSeconds": 2}, PluginContext(
        pipeline_name="m", process_queue_key=11))
    assert a.init({}, PluginContext(pipeline_name="a", process_queue_key=12))
    assert server.interval_s == 2.0
    try:
        assert m.start() and a.start()
        assert server._metrics_queue_key == 11
        assert server._alarms_queue_key == 12
        assert server._running and server._thread.is_alive()
        server._pushed[11] = 3
        assert m.groups_pushed == 3 and a.groups_pushed == 0
    finally:
        assert m.stop() and a.stop()
        server.stop()
    assert server._metrics_queue_key is None
    assert server._alarms_queue_key is None
    assert server._thread is None


def test_runtime_gauges_after_an_agent_run(tmp_path):
    from loongcollector_tpu_torch import application
    log = tmp_path / "a.log"
    log.write_bytes(b"\n".join(td.gen_lines(200, seed=4)) + b"\n")
    cfg = tmp_path / "cfg"
    cfg.mkdir()
    (cfg / "a.yaml").write_text(td.apache_config(str(log),
                                                 str(tmp_path / "o.json")))
    assert application.main(["--config", str(cfg), "--once", "--cpu"]) == 0
    runtime_stats.refresh()
    snaps = {(r["category"], tuple(sorted(r["labels"].items()))): r
             for r in port_metrics.ReadMetrics.snapshot()}
    plane = snaps[("device_plane", (("component", "device_plane"),))]
    assert plane["gauges"]["dispatched_total"] > 0
    assert plane["gauges"]["inflight_bytes"] == 0
    xp = snaps[("device_xprof", (("component", "loongxprof"),))]
    assert "device_mem_live_bytes_total" in xp["gauges"]


# ---------------------------------------------------------------------------
# end to end: the outage through both agents


OUTAGE_S = 3.5
PATH_ALARMS = ("SEND_DATA_FAIL_ALARM", "SINK_CIRCUIT_OPEN_ALARM",
               "SLO_BURN_RATE_ALARM", "CONSERVATION_RESIDUAL_ALARM",
               "DISCARD_DATA_ALARM")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _slo_row(port, pipeline="rollup"):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/slo",
                                    timeout=5) as r:
            return json.loads(r.read())["pipelines"].get(pipeline, {})
    except OSError:
        return {}


def _read(path):
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        return [json.loads(x) for x in f.read().split(b"\n") if x.strip()]


def test_outage_agents_agree_end_to_end(tmp_path):
    assert port_native.ensure_built()
    lines = td.gen_metrics_jsonl(3200, seed=17)   # one rollup window
    log = tmp_path / "metrics.jsonl"
    log.write_bytes(b"\n".join(lines) + b"\n")
    oracle, _ = td.metrics_oracle(lines)
    runs = {}
    for who in ("ref", "port"):
        recv = chip_smoke.RemoteWriteReceiver(
            lambda t: 503 if t < OUTAGE_S else 200).start()
        cfg = tmp_path / f"cfg_{who}"
        cfg.mkdir()
        (cfg / "rollup.yaml").write_text(
            td.metric_rollup_remote_write_config(str(log), recv.url))
        # a 20 s cadence: the first send (metrics and alarms) comes after
        # the trip, so no drain falls between its baseline and the trip
        sinks = {k: tmp_path / f"{k}_{who}.json" for k in ("m", "a")}
        (cfg / "self_metrics.yaml").write_text(
            "inputs:\n  - Type: input_internal_metrics\n"
            "    IntervalSeconds: 20\nflushers:\n  - Type: flusher_file\n"
            f"    FilePath: {sinks['m']}\n")
        (cfg / "self_alarms.yaml").write_text(
            "inputs:\n  - Type: input_internal_alarms\nflushers:\n"
            f"  - Type: flusher_file\n    FilePath: {sinks['a']}\n")
        port = _free_port()
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                   LOONG_SLO="1", LOONG_SLO_INTERVAL="0.25",
                   LOONG_LEDGER_AUDIT="1", LOONG_EXPO_PORT=str(port),
                   LOONG_PROCESS_THREADS="1")
        env.pop("LOONG_AGG_SUBSTRATE", None)
        pkg = "loongcollector_tpu_torch" if who == "port" \
            else "loongcollector_tpu"
        # the port's --stats: its send totals must survive the sends
        stats = ["--stats", str(tmp_path / "stats.json")] \
            if who == "port" else []
        proc = subprocess.Popen(
            [sys.executable, "-m", pkg, "--config", str(cfg), "--data-dir",
             str(tmp_path / f"data_{who}"), "--cpu"] + stats,
            cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE)
        runs[who] = dict(recv=recv, proc=proc, port=port, sinks=sinks)
    try:
        for who, run in runs.items():
            assert wait_for(
                lambda: run["proc"].poll() is not None
                or ("SLO_BURN_RATE_ALARM" in {
                    a["alarm_type"] for a in _read(run["sinks"]["a"])}
                    and len(run["recv"].samples) >= len(oracle) * 5),
                timeout=90), who
            assert run["proc"].poll() is None, \
                run["proc"].stderr.read().decode(errors="replace")[-3000:]
            run["slo"] = _slo_row(run["port"])
        for who, run in runs.items():
            run["proc"].send_signal(signal.SIGTERM)
            _out, err = run["proc"].communicate(timeout=60)
            assert run["proc"].returncode == 0, \
                err.decode(errors="replace")[-3000:]
    finally:
        for run in runs.values():
            if run["proc"].poll() is None:
                run["proc"].kill()
                run["proc"].wait()
            run["recv"].stop()
    # the self-monitor sent deltas and reset nothing: the port's --stats
    # totals are the run's (the receiver's 200s, the disk buffer's spills)
    with open(tmp_path / "stats.json") as f:
        snd = json.load(f)["send"]
    assert _read(runs["port"]["sinks"]["m"])
    assert snd["out_items"] == runs["port"]["recv"].answers[200], snd
    assert snd["spilled_items"] == snd["spilled"] >= 1, snd
    rows = {who: td.rollup_sample_rows(run["recv"].samples)
            for who, run in runs.items()}
    assert td.rollup_mismatches(rows["port"], rows["ref"]) == []
    assert len(rows["port"]) == len(oracle)
    for who, run in runs.items():
        slo = run["slo"]
        assert slo["episodes"] == 1, (who, slo)
    assert runs["port"]["slo"]["last_breakdown"]["dominant"] == "sink", \
        runs["port"]["slo"]
    # the reference shares a race the port repaired: a healthy evaluator
    # tick between a 503's round trip (loongcollector_tpu/runner/
    # flusher_runner.py:408-411) and its spill (:256-280) moves the
    # baseline past the round trip, and the spilled payload waits in no
    # queue, so its breakdown (monitor/slo.py:430-450) can name no hop
    # (test_torch_slo.py::TestBudgetBreakdown::
    # test_spill_after_a_healthy_tick_names_the_sink drives it)
    assert runs["ref"]["slo"]["last_breakdown"]["dominant"] in (
        "sink", ""), runs["ref"]["slo"]
    assert (runs["port"]["slo"]["ok_total"], runs["port"]["slo"][
        "bad_total"]) == (runs["ref"]["slo"]["ok_total"],
                          runs["ref"]["slo"]["bad_total"])

    def alarm_docs(who):
        return sorted((a["alarm_type"], a["alarm_level"],
                       int(a["alarm_count"]), a["alarm_message"])
                      for a in _read(runs[who]["sinks"]["a"])
                      if a["alarm_type"] in PATH_ALARMS)
    ref_alarms = alarm_docs("ref")
    if runs["ref"]["slo"]["last_breakdown"]["dominant"] == "":
        # the race above, on this run: the reference's burn alarm is
        # worded from its breakdown (loongcollector_tpu/monitor/
        # slo.py:460-465), so it names no hop ("unknown") where the port's
        # names the sink.  Only that phrase of those alarms is mapped;
        # every other word and every other alarm must agree
        burns = [m for t, _, _, m in ref_alarms
                 if t == "SLO_BURN_RATE_ALARM"]
        assert burns and all("to the unknown hop" in m for m in burns), \
            burns
        ref_alarms = sorted(
            (t, lvl, n, msg.replace("to the unknown hop", "to the sink hop")
             if t == "SLO_BURN_RATE_ALARM" else msg)
            for t, lvl, n, msg in ref_alarms)
    assert alarm_docs("port") == ref_alarms
    assert {t for t, *_ in alarm_docs("port")} == {
        "SEND_DATA_FAIL_ALARM", "SINK_CIRCUIT_OPEN_ALARM",
        "SLO_BURN_RATE_ALARM"}
    burn = [a for a in _read(runs["port"]["sinks"]["a"])
            if a["alarm_type"] == "SLO_BURN_RATE_ALARM"]
    assert burn[0]["dominant_hop"] == "sink"

    def metric_records(who, category):
        out = set()
        for r in _read(runs[who]["sinks"]["m"]):
            if r.get("__name__") != category:
                continue
            keys = tuple(sorted(r["__values__"])) if category == "slo" \
                else ()
            out.add((tuple(sorted(r.get("__labels__", {}).items())), keys))
        return out
    for category in ("slo", "ledger"):
        assert metric_records("port", category) == \
            metric_records("ref", category), category
        assert metric_records("port", category), category
    for r in _read(runs["port"]["sinks"]["m"]):
        if r.get("__name__") == "ledger":
            assert r["__values__"]["conservation_residual_events"] == 0


def test_outage_at_the_first_post_names_no_hop(tmp_path):
    """The known gap, the same in both agents: an outage from the first
    POST of a rollup whose windows the watermark closes.  Those rows are
    minted in ``send`` without an ingest stamp, so only the last window
    (closed by the idle timer) is stamped; it is delivered late, and the
    episode's breakdown finds no hop spend and names no hop.  (Phase 32 (a)
    with the planes arms its outage after those rows are delivered, so
    that the stamped payload meets it.)  The stamped payload meets the open
    breaker and is spilled at dispatch, with no send of its own.  Under
    load it can instead go out as the breaker's half-open probe and fail.
    When a healthy evaluator tick falls between that probe's round trip
    and its spill, this is the interleaving the port repaired: its
    breakdown names the sink from the spilled egress seconds
    (``SloPlane.observe_spill``), carries ``spilled`` and counts no round
    trip since the tick, where the JAX agent's names no hop.
    ``test_torch_slo.py::TestBudgetBreakdown::test_failed_probe_spill``
    drives both orders in one thread; ``spilled`` appears only in that
    one.  A failed probe with no tick between names the sink through its
    round trip in both agents, and fails this test on either side, as it
    did before the repair."""
    assert port_native.ensure_built()
    lines = td.gen_metrics_jsonl(48000, seed=17)   # three closed windows
    log = tmp_path / "metrics.jsonl"
    log.write_bytes(b"\n".join(lines) + b"\n")
    oracle, _ = td.metrics_oracle(lines)
    runs = {}
    for who in ("ref", "port"):
        recv = chip_smoke.RemoteWriteReceiver(
            lambda t: 503 if t < 4.0 else 200).start()
        cfg = tmp_path / f"cfg_{who}"
        cfg.mkdir()
        (cfg / "rollup.yaml").write_text(
            td.metric_rollup_remote_write_config(str(log), recv.url))
        port = _free_port()
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                   LOONG_SLO="1", LOONG_SLO_INTERVAL="0.25",
                   LOONG_SLO_FRESHNESS_S="3", LOONG_EXPO_PORT=str(port),
                   LOONG_PROCESS_THREADS="1")
        env.pop("LOONG_AGG_SUBSTRATE", None)
        pkg = "loongcollector_tpu_torch" if who == "port" \
            else "loongcollector_tpu"
        proc = subprocess.Popen(
            [sys.executable, "-m", pkg, "--config", str(cfg), "--data-dir",
             str(tmp_path / f"data_{who}"), "--cpu"],
            cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE)
        runs[who] = dict(recv=recv, proc=proc, port=port)
    try:
        for who, run in runs.items():
            assert wait_for(
                lambda: run["proc"].poll() is not None
                or (_slo_row(run["port"]).get("episodes", 0) >= 1
                    and len(run["recv"].samples) >= len(oracle) * 5),
                timeout=90), who
            assert run["proc"].poll() is None, \
                run["proc"].stderr.read().decode(errors="replace")[-3000:]
            run["slo"] = _slo_row(run["port"])
            run["proc"].send_signal(signal.SIGTERM)
        for who, run in runs.items():
            _out, err = run["proc"].communicate(timeout=60)
            assert run["proc"].returncode == 0, \
                err.decode(errors="replace")[-3000:]
    finally:
        for run in runs.values():
            if run["proc"].poll() is None:
                run["proc"].kill()
                run["proc"].wait()
            run["recv"].stop()
    rows = {who: td.rollup_sample_rows(run["recv"].samples)
            for who, run in runs.items()}
    assert td.rollup_mismatches(rows["port"], rows["ref"]) == []
    assert len(rows["port"]) == len(oracle)
    for who, run in runs.items():
        slo = run["slo"]
        assert run["recv"].answers.get(503, 0) >= 1, who
        assert (slo["episodes"], slo["ok_total"], slo["bad_total"]) == \
            (1, 0, 1), (who, slo)
        bd = slo["last_breakdown"]
        if who == "port" and "spilled" in bd:
            # the repaired interleaving (docstring): no hop spend and no
            # round trip since the tick, the spilled seconds named sink
            others = [v for k, v in bd["hops"].items() if k != "sink"]
            assert bd["dominant"] == "sink" and not any(others), (who, slo)
            assert bd["histograms"].get("sink_rtt_seconds", {}).get(
                "delta_count", 0) == 0, (who, slo)
            assert bd["hops"]["sink"] == bd["spilled"]["sink"] > 0.0, \
                (who, slo)
            continue
        assert bd["dominant"] == "" and not any(bd["hops"].values()), \
            (who, slo)
