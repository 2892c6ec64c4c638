"""Flusher routing: the port's ``pipeline/route/router.py`` and its send
path against the JAX package's, on the CPU.

* ``Condition`` and ``Router`` of both packages give the same flusher
  indexes for groups of every event type, with and without tags.
* Two pipelines (``testdata.route_config``), each with two ``flusher_file``
  sinks whose ``Match`` is a tag an aggregator set (``__logstore__`` from
  ``aggregator_logstore_router``) or an event type, through both
  packages' ``--once`` agents: the four sink files hold the same record
  lines (the read time aside), every record is where its ``Match`` sends it, the
  groups no flusher matched are dropped and counted (``--stats``
  ``routing``), and with the ledger on every pipeline balances.
"""

import json
import os
import re
import subprocess
import sys

import pytest

from loongcollector_tpu.models import PipelineEventGroup as RefGroup
from loongcollector_tpu.pipeline.route import router as ref_router
from loongcollector_tpu_torch import testdata as td
from loongcollector_tpu_torch.models import PipelineEventGroup
from loongcollector_tpu_torch.pipeline import pipeline as port_pipeline
from loongcollector_tpu_torch.pipeline.route import router as port_router
from test_torch_alarms import alarms_left_empty  # noqa: F401
from test_torch_container import containers_left_empty  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TIME = re.compile(rb'"__time__": \d+')

MATCHES = [None, {"Type": "always"}, {"Type": "event_type", "Value": "log"},
           {"Type": "event_type", "Value": "METRIC"},
           {"Type": "event_type", "Value": "trace"},
           {"Type": "event_type", "Value": "span"},
           {"Type": "event_type", "Value": "raw"},
           {"Type": "event_type", "Value": "bogus"},
           {"Type": "tag", "Key": "__logstore__", "Value": "gets"},
           {"Type": "tag", "Key": "env", "Value": "prod"},
           {"Type": "unknown"}]


def _groups(Group):
    out = []
    for kind in ("log", "metric", "span", "raw"):
        for tags in ({}, {"__logstore__": "gets"}, {"env": "prod"},
                     {"__logstore__": "posts", "env": "dev"}):
            g = Group()
            getattr(g, f"add_{kind}_event")(1)
            for k, v in tags.items():
                g.set_tag(k, v)
            out.append(g)
    return out


def test_router_routes_as_the_reference():
    cfgs = list(enumerate(MATCHES))
    ref, port = ref_router.Router(), port_router.Router()
    assert ref.init(cfgs) and port.init(cfgs)
    got = [port.route(g) for g in _groups(PipelineEventGroup)]
    want = [ref.route(g) for g in _groups(RefGroup)]
    assert got == want
    # the tag and event-type conditions both hold and fail on these groups
    for idx in (2, 3, 5, 6, 8, 9):
        assert 0 < sum(idx in r for r in got) < len(got), MATCHES[idx]


def _run_ref(cfg_dir, data_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-m", "loongcollector_tpu", "--config",
                    str(cfg_dir), "--once", "--data-dir", str(data_dir)],
                   cwd=str(cfg_dir), env=env, check=True,
                   capture_output=True, timeout=600)


def _run_port(cfg_dir, stats):
    from loongcollector_tpu_torch.application import main
    assert main(["--config", str(cfg_dir), "--once", "--cpu",
                 "--data-dir", str(stats) + "_data",
                 "--stats", str(stats)]) == 0
    with open(stats) as f:
        return json.load(f)


def test_match_routes_like_the_reference_agent(tmp_path, monkeypatch):
    lines = td.gen_lines(4000, seed=23)
    logs = [tmp_path / "only.log", tmp_path / "fan.log"]
    for log in logs:
        log.write_bytes(b"\n".join(lines) + b"\n")
    outs = {}
    for who in ("ref", "port"):
        cfg_dir = tmp_path / f"cfg_{who}"
        cfg_dir.mkdir()
        outs[who] = {k: tmp_path / f"{who}_{k}.json" for k in "abcd"}
        for name, text in td.route_config([str(x) for x in logs], outs[who]).items():
            (cfg_dir / name).write_text(text)
        if who == "ref":
            _run_ref(cfg_dir, tmp_path / "ref_data")
        else:
            monkeypatch.setenv("LOONG_LEDGER", "1")
            stats = _run_port(cfg_dir, tmp_path / "stats.json")
    sinks = {}
    for k in "abcd":
        got = outs["port"][k]
        want = outs["ref"][k]
        assert got.exists() == want.exists(), k
        data = got.read_bytes() if got.exists() else b""
        # the same record lines (the JAX package's flusher_file batches
        # groups by tag set, so groups of different tags may interleave
        # in another order)
        assert sorted(_TIME.sub(b"", data).splitlines()) == sorted(
            _TIME.sub(b"", want.read_bytes() if want.exists() else b""
                      ).splitlines()), k
        sinks[k] = [json.loads(x) for x in data.splitlines()]
    oracle = td.apache_oracle(lines)
    methods = [r["method"] for r in oracle]
    n_get = methods.count("GET")
    # a: the gets groups; b: no metric ever; c: every log; d: gets again
    assert [r["method"] for r in sinks["a"]] == ["GET"] * n_get
    assert sinks["b"] == []
    assert sorted(r["method"] for r in sinks["c"]) == sorted(methods)
    assert sinks["d"] == sinks["a"]
    # pipeline "only" dropped every group but the gets ones
    assert stats["routing"]["no_route_events"] == len(lines) - n_get
    assert stats["routing"]["no_route_groups"] > 0
    assert stats["ledger"]["residuals"] == {"only": 0, "fan": 0}
    assert stats["events"] == n_get + len(lines)


def test_no_route_and_fanout_ack_and_book(monkeypatch):
    """A group no flusher takes is acked (forced) and booked as a
    ``no_route`` drop; a group two flushers take raises its ack count to
    two before the first send."""
    calls = []
    monkeypatch.setattr(port_pipeline.ack_watermark, "ack_groups",
                        lambda gs, force=False: calls.append(
                            ("ack", len(gs), force)))
    monkeypatch.setattr(port_pipeline.ack_watermark, "note_fanout",
                        lambda g, n: calls.append(("fanout", n)))

    class Sink:
        name = "sink"
        ledger_terminal = False

        def __init__(self, tag):
            self.tag = tag

        def send(self, g):
            calls.append(("send", self.tag))
            return True

    p = port_pipeline.CollectionPipeline.__new__(
        port_pipeline.CollectionPipeline)
    p.name = "p"
    p.flushers = [Sink("x"), Sink("y")]
    p.router = port_router.Router()
    p.router.init([(0, {"Type": "tag", "Key": "k", "Value": "v"}),
                   (1, {"Type": "tag", "Key": "k", "Value": "v"})])
    p.no_route_groups = p.no_route_events = p.events_sent = 0
    import threading
    p._stats_lock = threading.Lock()
    p.stage_seconds, p._stage_records, p._stage_hists = {}, {}, {}
    matched, dropped = PipelineEventGroup(), PipelineEventGroup()
    matched.set_tag("k", "v")
    for g in (matched, dropped):
        g.add_log_event(1)
        g.add_log_event(2)
    p._flush_groups([dropped, matched])
    assert calls == [("ack", 1, True), ("fanout", 2), ("send", "x"),
                     ("send", "y")]
    assert (p.no_route_groups, p.no_route_events, p.events_sent) == (1, 2, 2)
    for rec in p._stage_records.values():
        rec.mark_deleted()


@pytest.mark.parametrize("match", MATCHES, ids=lambda m: json.dumps(m))
def test_condition_matches_the_reference(match):
    ref, port = ref_router.Condition(match), port_router.Condition(match)
    got = [port.check(g) for g in _groups(PipelineEventGroup)]
    want = [ref.check(g) for g in _groups(RefGroup)]
    assert got == want
