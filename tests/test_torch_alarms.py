"""The port's alarm plane (``monitor/alarms.py``) against the JAX package's.

* The taxonomy: every ``AlarmType`` member, with its wire name, and every
  ``AlarmLevel``, equal in both packages.
* ``send_alarm`` / ``flush`` / ``empty``: the same seeded sequence of
  alarms (types, levels, messages past the 128-byte key, pipelines,
  details colliding with the fixed keys) goes into both managers, and the
  ``flush()`` documents are equal once the two time fields are dropped;
  the port's lifetime ``totals()`` survive the flush.
* The sites the port now raises at, each driven in both packages on the
  same input, raise the same alarm (type, level, message, pipeline): a
  corrupt checkpoint file, an unclean shutdown, a sustained parse
  fallback, a rollup over its key cap, and a pattern demoted off the
  device tier (the port only: the reference's fused-set path differs).

``reset_planes`` is the teardown every observability test file of the port
uses: it leaves both packages' alarm managers, self-monitor servers, SLO
planes, ledgers and auditors, flight ring and the port's fail-soft counts
as a fresh process would have them.  ``alarms_left_empty`` is the
module-scoped teardown every other port test file that drives the JAX
package imports: the alarm singletons are process-wide, so an alarm a
file's reference runs raise would otherwise reach the self-monitor of a
later file on the same xdist worker (``tests/test_monitor.py`` reads the
first alarm a send ships).
"""

import numpy as np
import pytest

from loongcollector_tpu.monitor import alarms as ref_alarms
from loongcollector_tpu.monitor import ledger as ref_ledger
from loongcollector_tpu.monitor import slo as ref_slo
from loongcollector_tpu.monitor.metrics import WriteMetrics as RefWriteMetrics
from loongcollector_tpu.monitor.self_monitor import \
    SelfMonitorServer as RefSelfMonitor
from loongcollector_tpu.pipeline import pipeline_manager as _rpm
from loongcollector_tpu.prof import flight as ref_flight
from loongcollector_tpu.runner import flusher_runner as _rfr
from loongcollector_tpu.runner import processor_runner as _rpr
from loongcollector_tpu_torch.monitor import alarms as port_alarms
from loongcollector_tpu_torch.monitor import fail_soft
from loongcollector_tpu_torch.monitor import ledger as port_ledger
from loongcollector_tpu_torch.monitor import slo as port_slo
from loongcollector_tpu_torch.monitor.metrics import WriteMetrics
from loongcollector_tpu_torch.monitor.self_monitor import SelfMonitorServer
from loongcollector_tpu_torch.pipeline import pipeline_manager as _ppm
from loongcollector_tpu_torch.runner import flusher_runner as _pfr
from loongcollector_tpu_torch.runner import processor_runner as _ppr

SIDES = {"reference": ref_alarms, "port": port_alarms}

TIME_FIELDS = ("first_time", "last_time")


def reset_planes() -> None:
    """Both packages' observability singletons and planes back to off."""
    for server_cls in (RefSelfMonitor, SelfMonitorServer):
        inst = server_cls._instance
        if inst is not None:
            inst.stop()
        server_cls._instance = None
    for slo in (ref_slo, port_slo):
        slo.disable()
    for ledger in (ref_ledger, port_ledger):
        ledger.stop_auditor()
        ledger.disable()
    for alarms in (ref_alarms, port_alarms):
        alarms.AlarmManager._instance = None
    for wm in (RefWriteMetrics, WriteMetrics):
        wm.instance().gc_deleted()
    # the observe-only handles of a manager or runner a test left live
    for mod in (_rpm, _rpr, _rfr, _ppm, _ppr, _pfr):
        for name in ("_active_manager", "_active_runner"):
            if hasattr(mod, name):
                setattr(mod, name, None)
    ref_flight.recorder().reset()
    fail_soft.reset()


@pytest.fixture(autouse=True, scope="module")
def alarms_left_empty():
    """At the end of the module that imports it: both packages' alarm
    managers dropped, with whatever the module's runs raised."""
    yield
    for alarms in (ref_alarms, port_alarms):
        alarms.AlarmManager._instance = None


@pytest.fixture(autouse=True)
def _clean_planes():
    reset_planes()
    yield
    reset_planes()


def _strip(docs):
    return [{k: v for k, v in d.items() if k not in TIME_FIELDS}
            for d in docs]


def test_taxonomy_is_the_reference_one():
    assert [(m.name, m.value) for m in port_alarms.AlarmType] == \
        [(m.name, m.value) for m in ref_alarms.AlarmType]
    assert [(m.name, int(m)) for m in port_alarms.AlarmLevel] == \
        [(m.name, int(m)) for m in ref_alarms.AlarmLevel]


def _sequence(seed, n=300):
    """A seeded ``send_alarm`` sequence: (type name, level name, message,
    pipeline, details or None)."""
    rng = np.random.default_rng(seed)
    types = [m.name for m in ref_alarms.AlarmType]
    levels = [m.name for m in ref_alarms.AlarmLevel]
    out = []
    for _ in range(n):
        typ = types[int(rng.integers(0, 12))]          # few keys: aggregate
        # messages that differ only past the 128-byte key share a record
        msg = "m%d " % rng.integers(0, 3) + "x" * int(rng.integers(0, 200))
        details = None
        if rng.random() < 0.3:
            details = {"k%d" % rng.integers(0, 3): str(rng.integers(0, 9))}
            if rng.random() < 0.2:
                details["alarm_count"] = "collides"    # fixed keys win
        out.append((typ, levels[int(rng.integers(0, 3))], msg,
                    "p%d" % rng.integers(0, 2) if rng.random() < 0.7 else "",
                    details))
    return out


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_flush_documents_equal(seed):
    docs = {}
    for side, mod in SIDES.items():
        mgr = mod.AlarmManager.instance()
        assert mgr.empty()
        for typ, level, msg, pipeline, details in _sequence(seed):
            mgr.send_alarm(mod.AlarmType[typ], msg, mod.AlarmLevel[level],
                           pipeline=pipeline, details=details)
        assert not mgr.empty()
        docs[side] = _strip(mgr.flush())
        assert mgr.empty() and mgr.flush() == []
    assert docs["port"] == docs["reference"]
    assert sum(int(d["alarm_count"]) for d in docs["port"]) == 300


def test_totals_survive_flush_and_reset_clears():
    mgr = port_alarms.AlarmManager.instance()
    for _ in range(3):
        mgr.send_alarm(port_alarms.AlarmType.SEND_FAIL, "x")
    mgr.send_alarm(port_alarms.AlarmType.SLO_BURN_RATE, "y",
                   port_alarms.AlarmLevel.ERROR, pipeline="p")
    assert mgr.totals() == {"SEND_FAIL": 3, "SLO_BURN_RATE": 1}
    assert len(mgr.flush()) == 2
    assert mgr.totals() == {"SEND_FAIL": 3, "SLO_BURN_RATE": 1}
    mgr.reset()
    assert mgr.totals() == {} and mgr.empty()


def _raised(side):
    mod = SIDES[side]
    return sorted((d["alarm_type"], d["alarm_level"], d["pipeline"],
                   d["alarm_message"]) for d in
                  mod.AlarmManager.instance().flush())


def test_corrupt_checkpoint_raises_checkpoint_fail(tmp_path):
    from loongcollector_tpu.input.file.checkpoint import \
        CheckPointManager as Ref
    from loongcollector_tpu_torch.input.file.checkpoint import \
        CheckPointManager as Port
    got = {}
    for side, cls in (("reference", Ref), ("port", Port)):
        path = tmp_path / side / "checkpoints.json"
        path.parent.mkdir()
        path.write_bytes(b"{not json")
        cls(str(path)).load()
        got[side] = [(t, lvl, p, m.replace(str(tmp_path / side), "<d>"))
                     for t, lvl, p, m in _raised(side)]
    assert got["port"] == got["reference"]
    assert got["port"][0][:2] == ("CHECKPOINT_ALARM", "error")


def test_unclean_shutdown_raises_agent_restart(tmp_path):
    from loongcollector_tpu import recovery as ref_recovery
    from loongcollector_tpu_torch import recovery as port_recovery
    from loongcollector_tpu.runner import ack_watermark as ref_ack
    from loongcollector_tpu_torch.runner import ack_watermark as port_ack
    got = {}
    try:
        for side, rec, ack in (("reference", ref_recovery, ref_ack),
                               ("port", port_recovery, port_ack)):
            data = tmp_path / side
            data.mkdir()
            rec.begin(str(data))             # a clean start writes the
            rec.reset()                      # marker; no clean exit, so
            ack.tracker().reset()
            rec.begin(str(data))             # the next start is unclean
            got[side] = _raised(side)
            rec.mark_clean_exit()
            rec.reset()
            ack.tracker().reset()
    finally:
        ref_recovery.reset()
        port_recovery.reset()
        ref_ack.tracker().reset()
        port_ack.tracker().reset()
    assert got["port"] == got["reference"]
    assert [r[:2] for r in got["port"]] == [("LOGTAIL_CRASH_ALARM", "error")]


def test_sustained_parse_fallback_raises_once():
    from loongcollector_tpu.processor import parse_telemetry as ref_pt
    from loongcollector_tpu_torch.processor import parse_telemetry as port_pt
    try:
        ref_pt.reset_for_testing()
        port_pt.reset()
        for pt in (ref_pt, port_pt):
            for _ in range(6):        # 1200 rows: past MIN_ROWS (1024)
                pt.note_rows("processor_parse_json_native", "pj",
                             total=200, fallback=150)
        ref_docs = ref_alarms.AlarmManager.instance().flush()
        port_docs = port_alarms.AlarmManager.instance().flush()
        assert _strip(port_docs) == _strip(ref_docs)
        assert [d["alarm_type"] for d in port_docs] == \
            ["PARSE_FALLBACK_DEGRADED_ALARM"]
        assert port_docs[0]["alarm_count"] == "1"
    finally:
        ref_pt.reset_for_testing()
        port_pt.reset()


def test_rollup_over_its_key_cap_raises_eviction():
    import torch
    from loongcollector_tpu.aggregator.metric_rollup import \
        AggregatorMetricRollup as RefAgg
    from loongcollector_tpu.models import PipelineEventGroup as RefGroup
    from loongcollector_tpu.pipeline.plugin.interface import \
        PluginContext as RefContext
    from loongcollector_tpu_torch.aggregator.metric_rollup import \
        AggregatorMetricRollup as PortAgg
    from loongcollector_tpu_torch.models import PipelineEventGroup
    from loongcollector_tpu_torch.pipeline.plugin.interface import \
        PluginContext
    cfg = {"WindowSecs": 60, "MetricNameKey": "__name__",
           "ValueKey": "value", "LabelKeys": ["host"], "MaxKeys": 4,
           "Substrate": "numpy"}
    sides = (("reference", RefAgg, RefGroup,
              RefContext(pipeline_name="agg")),
             ("port", PortAgg, PipelineEventGroup,
              PluginContext(pipeline_name="agg", device=torch.device("cpu"))))
    got = {}
    for side, agg_cls, group_cls, ctx in sides:
        agg = agg_cls()
        assert agg.init(dict(cfg), ctx)
        g = group_cls()
        sb = g.source_buffer
        for i in range(10):
            ev = g.add_log_event(1_700_000_000)
            ev.set_content(b"__name__", sb.copy_string(b"m"))
            ev.set_content(b"host", sb.copy_string(b"h%d" % i))
            ev.set_content(b"value", sb.copy_string(b"1"))
        agg.add(g)
        agg.flush()
        agg.metrics.mark_deleted()
        got[side] = _raised(side)
    assert got["port"] == got["reference"]
    assert [r[:3] for r in got["port"]] == [
        ("AGG_WINDOW_EVICTION_ALARM", "warning", "agg")]


def test_demoted_pattern_raises_once():
    from loongcollector_tpu_torch.ops.regex import fuse
    fuse.reset_for_testing()
    try:
        fuse.note_demotion("a(b", "unsupported construct")
        fuse.note_demotion("a(b", "unsupported construct")
        docs = port_alarms.AlarmManager.instance().flush()
        assert [(d["alarm_type"], d["alarm_count"], d["alarm_message"])
                for d in docs] == [(
                    "REGEX_TIER_DEMOTED_ALARM", "1",
                    "regex demoted off device tier (unsupported construct): "
                    "a(b")]
    finally:
        fuse.reset_for_testing()
