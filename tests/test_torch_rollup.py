"""The windowed metric rollup: the port's ``AggregatorMetricRollup``
against the JAX package's, on the same columnar groups.

Each scenario (the cases of ``tests/test_loongagg.py`` that need no chaos
plane, SLO or acks: tumbling and sliding windows, allowed lateness, late
and invalid rows, idle and drain flushes, the histogram's shape, the
eviction cap, a custom name key, coalescing after eviction, plus
``EmitHistogram: false`` and a seeded multi-batch stream) runs through
both aggregators step by step, for each substrate: numpy, native, and
device — the port's plain K6 on the CPU against the reference's JAX fold
on the CPU.  Every step must emit the same rows in the same order: on the
numpy and native substrates byte for byte; on the device substrate byte
for byte but for the sums, which both fold in f32 in different orders and
are held to rtol = atol = 1e-5 (``scripts/agg_equivalence.py:163``).  The
ledger's boundaries for the aggregator (agg_in, agg_fold, agg_emit, the
reason-tagged drops) must equal the reference's, and the port's open
window rows must too.

The end-to-end case runs a 3,000-line ``testdata.gen_metrics_jsonl``
corpus through both packages' ``--once`` agents with
``testdata.metric_rollup_config`` (the reference under ``JAX_PLATFORMS=cpu``
with ``Substrate: device``, the port with ``--cpu``): the rollup rows must
be equal keyed by window and series (sums at the same tolerance), equal
the corpus's own f64 fold, and the port's ledger residual must be 0 on
this path and on the Apache path.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from loongcollector_tpu import models as ref_models  # noqa: E402
from loongcollector_tpu.aggregator.metric_rollup import (  # noqa: E402
    AggregatorMetricRollup as RefRollup)
from loongcollector_tpu.monitor import ledger as ref_ledger  # noqa: E402
from loongcollector_tpu.pipeline.plugin.interface import (  # noqa: E402
    PluginContext as RefContext)
from loongcollector_tpu_torch import models as port_models  # noqa: E402
from loongcollector_tpu_torch import testdata as td  # noqa: E402
from loongcollector_tpu_torch.aggregator.metric_rollup import (  # noqa: E402
    AggregatorMetricRollup as PortRollup)
from loongcollector_tpu_torch.monitor import ledger as port_ledger  # noqa: E402
from loongcollector_tpu_torch.ops.kernels import segment_reduce as sr  # noqa: E402
from loongcollector_tpu_torch.pipeline.plugin.interface import (  # noqa: E402
    PluginContext as PortContext)
from test_torch_alarms import alarms_left_empty  # noqa: F401

TOL = 1e-5    # rtol = atol: scripts/agg_equivalence.py:163
PIPE = "agg-test"


@pytest.fixture(autouse=True)
def _reference_state_cleared():
    """The JAX package's alarm buffer and ledger are process-wide: what the
    reference code run here leaves in them must not reach a later test in
    the same worker."""
    yield
    from loongcollector_tpu.monitor import ledger as _ref_ledger
    from loongcollector_tpu.monitor.alarms import AlarmManager
    from loongcollector_tpu_torch.monitor import ledger as _port_ledger
    AlarmManager.instance().flush()
    _ref_ledger.disable()
    _port_ledger.disable()


def make_group(models, rows, label_keys=("host",), name_key="__name__"):
    """rows: (name bytes|None, labels tuple, value bytes|None, ts)."""
    sb = models.SourceBuffer(4096)
    n = len(rows)
    fields = {k: ([0] * n, [-1] * n)
              for k in [name_key, "value"] + list(label_keys)}
    tss = [0] * n

    def put(field, i, data):
        if data is None:
            return
        off = sb.allocate(len(data))
        sb.write_at(off, data)
        fields[field][0][i] = off
        fields[field][1][i] = len(data)

    for i, (nm, labels, v, ts) in enumerate(rows):
        put(name_key, i, nm)
        for k, lb in zip(label_keys, labels):
            put(k, i, lb)
        put("value", i, v)
        tss[i] = ts
    cols = models.ColumnarLogs(np.zeros(n, np.int32), np.zeros(n, np.int32),
                               np.array(tss, np.int64))
    cols.content_consumed = True
    for k, (o, ln) in fields.items():
        cols.set_field(k, np.array(o, np.int32), np.array(ln, np.int32))
    g = models.PipelineEventGroup(sb)
    g.set_columns(cols)
    return g


def rows_of(groups):
    out = []
    for g in groups:
        cols = g.columns
        raw = g.source_buffer.raw
        for r in range(len(cols)):
            row = {}
            for f, (o, ln) in cols.fields.items():
                if ln[r] >= 0:
                    row[f] = bytes(raw[int(o[r]):int(o[r]) + int(ln[r])])
            row["__ts__"] = int(cols.timestamps[r])
            out.append(row)
    return out


def _stream(seed):
    rng = np.random.default_rng(seed)
    steps = []
    t = 0
    for _ in range(6):
        rows = []
        for _ in range(200):
            t += int(rng.integers(0, 2))
            ts = t - int(rng.integers(0, 15)) if rng.random() < 0.05 else t
            v = (b"bad" if rng.random() < 0.02 else
                 f"{rng.uniform(-50, 5000):.4f}".encode())
            rows.append((b"m%d" % rng.integers(3),
                         (b"h%d" % rng.integers(4),), v, ts))
        steps.append(("add", rows))
    return steps + [("flush",)]


SCENARIOS = {
    "tumbling": ({}, [
        ("add", [(b"reqs", (b"h1",), b"1", 1), (b"reqs", (b"h1",), b"2", 9)]),
        ("add", [(b"reqs", (b"h1",), b"5", 10)]), ("flush",)]),
    "sliding": ({"SlideSecs": 5}, [
        ("add", [(b"m", (b"h",), b"4", 7)]),
        ("add", [(b"m", (b"h",), b"1", 25)]), ("flush",)]),
    "lateness": ({"AllowedLatenessSecs": 5}, [
        ("add", [(b"m", (b"h",), b"1", 3)]),
        ("add", [(b"m", (b"h",), b"1", 12)]),
        ("add", [(b"m", (b"h",), b"1", 15)]), ("flush",)]),
    "late_rows": ({}, [
        ("add", [(b"m", (b"h",), b"1", 5)]),
        ("add", [(b"m", (b"h",), b"9", 25)]),
        ("add", [(b"m", (b"h",), b"7", 2)]), ("flush",)]),
    "invalid_rows": ({}, [
        ("add", [(b"m", (b"h",), b"junk", 1), (None, (b"h",), b"2", 1),
                 (b"m", (b"h",), None, 1), (b"m", (b"h",), b"3", 1)]),
        ("flush",)]),
    "idle_flush": ({"IdleFlushSecs": 0.0}, [
        ("add", [(b"m", (b"h",), b"1", 5)]), ("flush_timeout",),
        ("flush",)]),
    "drain_flush": ({"SlideSecs": 5}, [
        ("add", [(b"a", (b"h",), b"1", 3), (b"b", (b"h",), b"2", 8)]),
        ("flush",)]),
    "histogram": ({}, [
        ("add", [(b"m", (b"h",), b"0.5", 1), (b"m", (b"h",), b"3", 2),
                 (b"m", (b"h",), b"1000", 3)]), ("flush",)]),
    "no_histogram": ({"EmitHistogram": False}, [
        ("add", [(b"m", (b"h",), b"0.5", 1), (b"m", (b"h",), b"3", 2),
                 (b"n", (b"h",), b"1e3", 13)]), ("flush",)]),
    "gap_jump": ({"AllowedLatenessSecs": 60}, [
        ("add", [(b"m", (b"h",), b"1", 5)]),
        ("add", [(b"m", (b"h",), b"1", 1000)]),
        ("add", [(b"m", (b"h",), b"2", 945)]),
        ("add", [(b"m", (b"h",), b"9", 3)]), ("flush",)]),
    "nonfinite": ({}, [
        ("add", [(b"m", (b"h",), b"inf", 1), (b"m", (b"h",), b"-inf", 2)]),
        ("flush",)]),
    "eviction_cap": ({"MaxKeys": 4}, [
        ("add", [(b"m%d" % i, (b"h",), b"1", 1) for i in range(7)]),
        ("flush",)]),
    "custom_name_key": ({"LabelKeys": [], "MetricNameKey": "metric"}, [
        ("add", [(b"reqs", (), b"3", 1)]), ("flush",)]),
    # a's slot-0 partial is evicted (MaxKeys) while its slot-1 partial
    # stays: the window [0, 10) close merges slot 1 and the staged
    # eviction in one group, which must coalesce into one row
    "coalesce_after_eviction": ({"SlideSecs": 5, "MaxKeys": 2}, [
        ("add", [(b"a", (b"h",), b"1", 1), (b"a", (b"h",), b"4", 7),
                 (b"z", (b"h",), b"1", 30)]), ("flush",)]),
    "stream": ({"AllowedLatenessSecs": 3}, _stream(7)),
}


def _config(overrides, substrate):
    cfg = {"WindowSecs": 10, "LabelKeys": ["host"], "Substrate": substrate}
    cfg.update(overrides)
    return cfg


def _run(which, cfg, steps):
    if which == "ref":
        agg, models, ctx = RefRollup(), ref_models, RefContext(PIPE)
    else:
        agg, models = PortRollup(), port_models
        ctx = PortContext(PIPE, device=torch.device("cpu"))
    assert agg.init(dict(cfg), ctx)
    label_keys = cfg["LabelKeys"]
    name_key = cfg.get("MetricNameKey", "__name__")
    outs = []
    for step in steps:
        if step[0] == "add":
            got = agg.add(make_group(models, step[1], label_keys, name_key))
        elif step[0] == "flush_timeout":
            time.sleep(0.01)
            got = agg.flush_timeout()
        else:
            got = agg.flush()
        outs.append((rows_of(got), agg.open_window_rows()))
    agg.metrics.mark_deleted()
    return outs, agg


def _agg_ledger(snap):
    row = snap.get(PIPE, {})
    keep = ("agg_in", "agg_fold", "agg_emit", "drop")
    return {b: {"events": v["events"], "tags": {
        t: c["events"] for t, c in v.get("tags", {}).items()}}
        for b, v in row.items() if b in keep}


@pytest.fixture
def ledgers():
    ref = ref_ledger.enable()
    port = port_ledger.enable()
    ref.reset()
    port.reset()
    yield ref, port
    ref_ledger.disable()
    port_ledger.disable()


@pytest.mark.parametrize("substrate", ["numpy", "native", "device"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_rollup_matches_reference(scenario, substrate, ledgers, monkeypatch):
    monkeypatch.delenv("LOONG_AGG_SUBSTRATE", raising=False)
    overrides, steps = SCENARIOS[scenario]
    cfg = _config(overrides, substrate)
    want, _ = _run("ref", cfg, steps)
    got, agg = _run("port", cfg, steps)
    assert len(got) == len(want)
    n_rows = 0
    for (g_rows, g_open), (w_rows, w_open) in zip(got, want):
        assert g_open == w_open
        assert len(g_rows) == len(w_rows)
        for g, w in zip(g_rows, w_rows):
            n_rows += 1
            if substrate == "device" and g != w:
                gs, ws = float(g.pop("sum")), float(w.pop("sum"))
                assert gs == ws or (np.isnan(gs) and np.isnan(ws)) or \
                    abs(gs - ws) <= TOL + TOL * abs(ws), (scenario, gs, ws)
            assert g == w, scenario
    assert n_rows > 0
    ref_led, port_led = ledgers
    assert _agg_ledger(port_led.snapshot()) == _agg_ledger(
        ref_led.snapshot())
    used = {"numpy": "numpy", "native": "native", "device": "device"}[
        substrate]
    if substrate != "native" or sr.fold_batch_native(
            *td.pack_agg_rows([(b"m", (), b"1", 0)])) is not None:
        assert set(agg.fold_counts) <= {used}


def test_coalesced_row_after_eviction():
    overrides, steps = SCENARIOS["coalesce_after_eviction"]
    outs, _ = _run("port", _config(overrides, "numpy"), steps)
    rows = [r for step_rows, _ in outs for r in step_rows]
    a0 = [r for r in rows if r["__name__"] == b"a"
          and r["window_start"] == b"0"]
    assert len(a0) == 1 and a0[0]["count"] == b"2" and a0[0]["sum"] == b"5"


def test_device_substrate_on_cuda_never_folds_on_the_host(monkeypatch):
    """``Substrate: device`` with a CUDA pipeline device sends every fold
    to the K6 launch path, never to the numpy twin, the native fold or the
    plain version."""
    from loongcollector_tpu_torch.aggregator import metric_rollup
    # the pipeline's device is CUDA; resolving it needs no card here
    monkeypatch.setattr(metric_rollup, "resolve_device",
                        lambda dev: torch.device(dev))
    monkeypatch.setattr(sr, "resolve_device", lambda dev: torch.device(dev))
    agg = PortRollup()
    assert agg.init(_config({}, "device"),
                    PortContext(PIPE, device=torch.device("cuda", 0)))

    def host_fold(*a, **k):
        raise AssertionError("a host fold ran under Substrate: device")
    monkeypatch.setattr(sr, "fold_batch_numpy", host_fold)
    monkeypatch.setattr(sr, "fold_batch_native", host_fold)
    kern = sr.SegmentReduceKernel()
    agg._device_kern = kern
    monkeypatch.setattr(kern, "plain", host_fold)
    staged = []

    def on_card(buf, B, Gq, device):
        assert device.type == "cuda"
        staged.append((B, Gq))
        z = np.zeros(Gq, np.float32)
        return (z + 3, np.ones(Gq, np.int32), z + 3, z + 3, z + 3,
                np.zeros((Gq, 41), np.int32))
    monkeypatch.setattr(kern, "_reduce_staged", on_card)
    # a pinned staging buffer needs a card: an unpinned one stands in
    monkeypatch.setattr(kern, "_lease",
                        lambda device, B: torch.zeros(13 * B,
                                                      dtype=torch.uint8))
    agg.add(make_group(port_models, [(b"m", (b"h",), b"3", 1)]))
    (r,) = rows_of(agg.flush())
    assert staged == [(256, 16)] and r["sum"] == b"3"
    assert agg.fold_counts == {"device": 1}
    agg.metrics.mark_deleted()


# -- end to end: both agents on one corpus ----------------------------------

def _run_port(cfg_dir, stats):
    from loongcollector_tpu_torch.application import main
    assert main(["--config", str(cfg_dir), "--once", "--cpu",
                 "--data-dir", os.path.splitext(str(stats))[0] + "_data",
                 "--stats", str(stats)]) == 0
    with open(stats) as f:
        return json.load(f)


def test_rollup_agents_agree_end_to_end(tmp_path, monkeypatch):
    lines = td.gen_metrics_jsonl(3000, seed=17)
    log = tmp_path / "metrics.jsonl"
    log.write_bytes(b"\n".join(lines) + b"\n")
    want_oracle, invalid = td.metrics_oracle(lines)
    outs = {}
    for who in ("ref", "port"):
        cfg_dir = tmp_path / f"cfg_{who}"
        cfg_dir.mkdir()
        out = tmp_path / f"out_{who}.json"
        (cfg_dir / "rollup.yaml").write_text(
            td.metric_rollup_config(str(log), str(out)))
        if who == "ref":
            env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
            env.pop("LOONG_AGG_SUBSTRATE", None)
            # its own data dir: the default one (~/.loongcollector_tpu) is
            # shared by every reference run, and its file checkpoints are
            # keyed by (dev, inode), so a new corpus on a recycled inode
            # would resume at the old file's end and read nothing
            subprocess.run([sys.executable, "-m", "loongcollector_tpu",
                            "--config", str(cfg_dir), "--once",
                            "--data-dir", str(tmp_path / "ref_data")],
                           cwd=str(tmp_path), env=env, check=True,
                           capture_output=True, timeout=300)
        else:
            monkeypatch.setenv("LOONG_LEDGER", "1")
            monkeypatch.delenv("LOONG_AGG_SUBSTRATE", raising=False)
            stats = _run_port(cfg_dir, tmp_path / "stats.json")
        outs[who] = td.rollup_rows(out.read_bytes())
    assert len(outs["port"]) == len(want_oracle) == 1600
    assert td.rollup_mismatches(outs["port"], outs["ref"]) == []
    assert td.rollup_mismatches(outs["port"], want_oracle,
                                f32_want=True) == []
    agg = stats["aggregation"]
    assert agg["folds"] == {"device": agg["k6_dispatches"]}
    assert agg["k6_launches"] == 0           # the CPU runs the plain K6
    assert agg["counters"]["agg_invalid_rows_total"] == invalid
    assert agg["counters"]["agg_late_rows_total"] == 0
    assert stats["parse"]["processor_parse_json_tpu/rollup"][
        "fallback_rows"] == 0
    assert stats["ledger"]["residuals"] == {"rollup": 0}
    assert stats["device_memory"]["total_live_bytes"] == 0


def test_fold_rows_rebuild_the_path_inputs(tmp_path, monkeypatch):
    """``testdata.metrics_fold_rows`` rebuilds the path's folds: keyed and
    staged (``segment_reduce.key_fold``), each group of a 12,000-line
    corpus gives byte for byte the K6 inputs that the ``--once`` agent
    staged, in the same order."""
    lines = td.gen_metrics_jsonl(12_000, seed=17)
    log = tmp_path / "metrics.jsonl"
    log.write_bytes(b"\n".join(lines) + b"\n")
    cfg_dir = tmp_path / "cfg"
    cfg_dir.mkdir()
    (cfg_dir / "rollup.yaml").write_text(
        td.metric_rollup_config(str(log), str(tmp_path / "out.json")))
    staged = []
    orig = sr.SegmentReduceKernel._reduce_staged

    def spy(self, buf, B, Gq, device):
        staged.append((B, Gq, buf.numpy()[:13 * B].tobytes()))
        return orig(self, buf, B, Gq, device)
    monkeypatch.setattr(sr.SegmentReduceKernel, "_reduce_staged", spy)
    monkeypatch.delenv("LOONG_AGG_SUBSTRATE", raising=False)
    monkeypatch.setenv("LOONG_PROCESS_THREADS", "1")
    _run_port(cfg_dir, tmp_path / "stats.json")
    want = []
    for rows in td.metrics_fold_rows(lines):
        keyed = sr.key_fold(*td.pack_agg_rows(rows))
        buf = np.empty(13 * keyed.B, np.uint8)
        keyed.stage(buf, sr.HIST_BASE, sr.N_HIST)
        want.append((keyed.B, keyed.Gq, buf.tobytes()))
    assert len(want) > 2 and staged == want


def _apache_config(log, out):
    with open(os.path.join(REPO, "example_config", "quick_start",
                           "file_regex_apache.yaml")) as f:
        text = f.read()
    text = text.replace("/tmp/loongcollector_demo/access.log", str(log))
    return text.replace("  - Type: flusher_stdout",
                        f"  - Type: flusher_file\n    FilePath: {out}")


@pytest.mark.parametrize("case", ["apache", "apache_filter_fused",
                                  "two_flushers"])
def test_apache_paths_ledger_residual_is_zero(case, tmp_path, monkeypatch):
    """The Apache main path, the Apache-filter path as one fused run (its
    filter's drops booked at the member's apply), and the main path with
    two sinks (the second copy booked as fanout) balance their ledgers."""
    log = tmp_path / "access.log"
    log.write_bytes(b"\n".join(td.gen_lines(5000, seed=11)) + b"\n")
    cfg_dir = tmp_path / "cfg"
    cfg_dir.mkdir()
    out = tmp_path / "out.json"
    if case == "apache_filter_fused":
        text = td.apache_filter_config(str(log), str(out))
        monkeypatch.setenv("LOONG_FUSED", "1")
    else:
        text = _apache_config(log, out)
    if case == "two_flushers":
        text += f"  - Type: flusher_file\n    FilePath: {tmp_path / 'b.json'}\n"
    (cfg_dir / "apache.yaml").write_text(text)
    monkeypatch.setenv("LOONG_LEDGER", "1")
    monkeypatch.setenv("LOONG_PROCESS_THREADS", "2")
    stats = _run_port(cfg_dir, tmp_path / "stats.json")
    led = stats["ledger"]
    assert led["residuals"] == {"apache": 0}
    row = led["snapshot"]["apache"]
    sinks = 2 if case == "two_flushers" else 1
    assert row["send_ok"]["events"] == sinks * stats["events"] > 0
    assert row["ingest"]["events"] == row["process_in"]["events"] > 0
    if case == "apache_filter_fused":
        assert stats["fusion"]["fused_groups"] > 0
        assert row["process_drop"]["tags"]["processor_filter_native"][
            "events"] == 5000 - stats["events"]
    if case == "two_flushers":
        assert row["fanout"]["events"] == stats["events"]
        assert (tmp_path / "b.json").read_bytes() == out.read_bytes()
