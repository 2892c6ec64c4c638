"""The port's ``/metrics`` and ``/debug`` endpoint (``monitor/exposition.py``)
against the JAX package's, on the CPU.

* ``render()``: the same seeded metric records (counters, gauges,
  histograms with log2 buckets, labels that need escaping, names that
  need sanitizing) in each package's own registry render to the same
  text, byte for byte, and the text parses as exposition format 0.0.4
  (``chip_smoke.parse_prometheus_text``, the parser the card's phase 33
  uses).
* Every route answers over HTTP on port 0, with the JAX package's status
  codes and content types: ``/metrics``, ``/healthz``, ``/debug/status``,
  ``/debug/ledger``, ``/debug/slo``, ``/debug/timeline`` (the port's
  dispatch timeline as Chrome-trace JSON), ``/debug/pprof`` (the JAX
  package's answer with its profiler off), ``/`` and 404 for the rest;
  ``/debug/flight`` is left out with the flight recorder.
* The fail-soft evidence paths: a refresh that raises inside ``render``
  or a status section that raises is skipped as in the JAX package, and
  logged once and counted (``evidence_faults`` on ``/debug/status``).
* ``start_from_env``: ``LOONG_EXPO_PORT`` and ``LOONG_EXPO_HOST``.
"""

import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest

import chip_smoke
from loongcollector_tpu.monitor import exposition as ref_expo
from loongcollector_tpu.monitor import metrics as ref_metrics
from loongcollector_tpu_torch.monitor import exposition as port_expo
from loongcollector_tpu_torch.monitor import fail_soft
from loongcollector_tpu_torch.monitor import ledger as port_ledger
from loongcollector_tpu_torch.monitor import metrics as port_metrics
from loongcollector_tpu_torch.monitor import slo as port_slo
from loongcollector_tpu_torch.ops import xprof

from test_torch_alarms import reset_planes

SIDES = {"reference": (ref_expo, ref_metrics),
         "port": (port_expo, port_metrics)}


@pytest.fixture(autouse=True)
def _clean_planes():
    reset_planes()
    yield
    xprof.disable()
    reset_planes()


@pytest.fixture
def private_registries(monkeypatch):
    """Each package renders only this test's records: a fresh
    ``WriteMetrics`` in both, the live ones restored after."""
    for _expo, metrics in SIDES.values():
        monkeypatch.setattr(metrics.WriteMetrics, "_instance", None)


def _fill(metrics, seed):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(6):
        labels = {"pipeline": f"p{i % 3}",
                  "plugin_id": f'flusher_"http"/{i}\\x\n'}
        if i % 2:
            labels["odd-label.key"] = "v"
        rec = metrics.MetricsRecord(category=("component", "plugin",
                                              "slo")[i % 3], labels=labels)
        rec.counter("events_total").add(int(rng.integers(0, 10**6)))
        rec.gauge("queue_depth").set(float(rng.integers(0, 100)))
        rec.gauge("ratio").set(float(rng.random()))
        if i == 0:
            rec.gauge("nan_gauge").set(math.nan)
            rec.gauge("inf_gauge").set(math.inf)
            rec.gauge("big_gauge").set(1e17)
        h = rec.histogram("stage_seconds")
        for v in rng.exponential(0.01, size=int(rng.integers(0, 200))):
            h.observe(float(v))
        recs.append(rec)
    return recs


@pytest.mark.parametrize("seed", [0, 9, 314])
def test_render_equal_and_valid(seed, private_registries):
    texts = {}
    for side, (expo, metrics) in SIDES.items():
        _fill(metrics, seed)
        texts[side] = expo.render()
    assert texts["port"] == texts["reference"]
    series = chip_smoke.parse_prometheus_text(texts["port"])
    assert any(name == "loong_stage_seconds_bucket" for name, _l, _v in
               series)
    assert ("loong_events_total" in
            {name for name, _l, _v in series})


def test_render_is_read_only(private_registries):
    rec = port_metrics.MetricsRecord(category="component",
                                     labels={"component": "x"})
    rec.counter("n_total").add(5)
    rec.histogram("stage_seconds").observe(0.5)
    first = port_expo.render()
    assert port_expo.render() == first
    assert rec.counter("n_total").value == 5


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=5) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_every_route_answers(tmp_path):
    port_ledger.enable()
    port_ledger.record("p", port_ledger.B_INGEST, 2)
    port_ledger.record("p", port_ledger.B_SEND_OK, 2)
    port_slo.enable()
    t = xprof.enable()
    xid = xprof.begin_dispatch(4096)
    xprof.annotate(xid, "regex", "8192x128")
    xprof.leg(xid, "pack", t.epoch + 0.001, 0.0005)
    xprof.leg(xid, "exec", t.epoch + 0.002, 0.001)
    xprof.close_dispatch(xid)
    servers = {name: expo.ExpositionServer(port=0)
               for name, (expo, _m) in SIDES.items()}
    try:
        for srv in servers.values():
            assert srv.start()
        base = {n: f"http://127.0.0.1:{s.port}" for n, s in servers.items()}
        port = base["port"]
        for path in ("/metrics", "/healthz", "/debug/status",
                     "/debug/ledger", "/debug/slo", "/debug/timeline",
                     "/debug/pprof", "/", "/nope", "/metrics/x"):
            got = _get(port, path)
            want = _get(base["reference"], path)
            assert got[0] == want[0], path
            if got[0] == 200:
                assert got[1] == want[1], path
        assert _get(port, "/debug/flight")[0] == 404
        code, ctype, body = _get(port, "/metrics")
        assert ctype == "text/plain; version=0.0.4; charset=utf-8"
        chip_smoke.parse_prometheus_text(body.decode())
        assert b"loong_ledger_ingest_events{" in body
        health = json.loads(_get(port, "/healthz")[2])
        assert health["status"] == "ok" and "uptime_s" in health
        status = json.loads(_get(port, "/debug/status")[2])
        assert set(status) <= set(port_expo.STATUS_SECTIONS)
        assert status["ledger"]["residuals"] == {"p": 0}
        assert status["xprof"]["dispatches"] == 1
        assert status["evidence_faults"] == {}
        ledger_doc = json.loads(_get(port, "/debug/ledger")[2])
        assert ledger_doc["pipelines"]["p"]["residual"] == 0
        assert json.loads(_get(port, "/debug/slo")[2])["enabled"] is True
        trace = json.loads(_get(port, "/debug/timeline")[2])
        legs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
        assert [(e["name"], e["args"]["dispatch_id"], e["args"]["program"],
                 e["dur"]) for e in legs] == [
            ("pack", xid, "regex", 500.0), ("exec", xid, "regex", 1000.0)]
        assert _get(port, "/debug/pprof")[2] == \
            _get(base["reference"], "/debug/pprof")[2]
        index = _get(port, "/")[2]
        for route in (b"/metrics", b"/healthz", b"/debug/status",
                      b"/debug/ledger", b"/debug/slo", b"/debug/timeline"):
            assert route in index
    finally:
        for srv in servers.values():
            srv.stop()


def test_fail_soft_paths_are_logged_once_and_counted(monkeypatch):
    import logging
    port_ledger.enable()

    def boom():
        raise RuntimeError("refresh broke")

    monkeypatch.setattr(port_ledger, "export_refresh", boom)
    monkeypatch.setattr(port_ledger, "lag_snapshot", boom)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger(fail_soft.log.name)
    logger.addHandler(handler)
    try:
        for _ in range(3):
            text = port_expo.render()
        chip_smoke.parse_prometheus_text(text)
        status = port_expo.collect_status()
    finally:
        logger.removeHandler(handler)
    assert fail_soft.counts() == {"render.ledger": 3, "status.ledger": 1}
    assert status["evidence_faults"] == {"render.ledger": 3,
                                         "status.ledger": 1}
    assert [(r.args[0], r.exc_info is not None) for r in records] == [
        ("render.ledger", True), ("status.ledger", True)]


def test_hop_totals_fault_is_counted_and_breakdown_survives(monkeypatch):
    plane = port_slo.enable()

    def boom():
        raise RuntimeError("registry broke")

    monkeypatch.setattr(port_metrics.WriteMetrics, "instance", boom)
    assert plane.budget_breakdown()["dominant"] == ""
    assert fail_soft.counts() == {"slo.hop_totals": 1}


def test_start_from_env():
    assert port_expo.start_from_env({}) is None
    assert port_expo.start_from_env({"LOONG_EXPO_PORT": "bogus"}) is None
    srv = port_expo.start_from_env({"LOONG_EXPO_PORT": "0",
                                    "LOONG_EXPO_HOST": "127.0.0.1"})
    try:
        assert srv is not None and srv.port > 0
        assert _get(f"http://127.0.0.1:{srv.port}", "/healthz")[0] == 200
    finally:
        srv.stop()


@pytest.mark.parametrize("bad", [
    "loong_x{a=\"1\"} notanumber\n",
    "# TYPE loong_x wrong\nloong_x 1\n",
    "loong_x{a=1} 2\n",
    "loong x 1\n",
])
def test_text_parser_refuses_malformed(bad):
    with pytest.raises(ValueError):
        chip_smoke.parse_prometheus_text(bad)
