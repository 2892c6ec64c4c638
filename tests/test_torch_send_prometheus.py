"""``flusher_prometheus`` in the port against the JAX package's:
``encode_write_request`` gives the same bytes for the same series, and
the snappy-compressed WriteRequest body ``build_payload`` makes from the
rollup groups of the ``testdata`` metrics corpus is byte-equal to the JAX
package's, the port's groups folded by its numpy twin and the reference's
by its numpy fold.  The port's plain K6 fold on the CPU (the device
substrate's f32 fold) gives sums that differ in the last bits, so there
the decoded samples are compared: counts exact, min / max / last equal
to the f64 fold's through f32, sums within rtol = atol = 1e-5.  The
columnar route and the dict route (rollup rows as LogEvents) give the
same series.
"""

import time

import numpy as np
import pytest
import torch

import chip_smoke
from loongcollector_tpu import models as ref_models
from loongcollector_tpu import native as ref_native
from loongcollector_tpu.aggregator.metric_rollup import \
    AggregatorMetricRollup as RefRollup
from loongcollector_tpu.flusher import prometheus_rw as ref_prom
from loongcollector_tpu.pipeline.plugin.interface import \
    PluginContext as RefContext
from loongcollector_tpu_torch import models as port_models
from loongcollector_tpu_torch import native as port_native
from loongcollector_tpu_torch import testdata as td
from loongcollector_tpu_torch.aggregator.metric_rollup import \
    AggregatorMetricRollup as PortRollup
from loongcollector_tpu_torch.flusher import prometheus_rw as port_prom
from loongcollector_tpu_torch.pipeline.plugin.interface import \
    PluginContext as PortContext
from test_torch_alarms import alarms_left_empty  # noqa: F401

PIPE = "rollup"


def _series(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(50):
        labels = [(b"__name__", b"m%d" % int(rng.integers(9))),
                  (b"host", b"h%d" % int(rng.integers(3)))]
        if rng.random() < 0.3:
            labels.append((b"zone", "é%d".encode() % i))
        value = float(rng.normal() * 10.0 ** rng.integers(-5, 9))
        out.append((labels, value, int(rng.integers(0, 2**41))))
    out.append(([(b"__name__", b"neg")], -0.0, -5))
    out.append(([(b"__name__", b"inf")], float("inf"), 0))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_write_request_same_bytes(seed):
    series = _series(seed)
    body = port_prom.encode_write_request(series)
    assert body == ref_prom.encode_write_request(series)
    got = chip_smoke.decode_write_request(body)
    assert [lb["__name__"] for lb, _, _ in got] == \
        [dict(s[0])[b"__name__"].decode() for s in series]


def _make_group(models, rows):
    """rows: (name, (host,), value text, ts) → a parsed columnar group."""
    sb = models.SourceBuffer(4096)
    n = len(rows)
    fields = {k: ([0] * n, [-1] * n) for k in ("__name__", "value", "host")}

    def put(field, i, data):
        if data is None:
            return
        off = sb.allocate(len(data))
        sb.write_at(off, data)
        fields[field][0][i] = off
        fields[field][1][i] = len(data)

    for i, (nm, (host,), v, _ts) in enumerate(rows):
        put("__name__", i, nm)
        put("host", i, host)
        put("value", i, v)
    cols = models.ColumnarLogs(np.zeros(n, np.int32), np.zeros(n, np.int32),
                               np.array([r[3] for r in rows], np.int64))
    cols.content_consumed = True
    for k, (o, ln) in fields.items():
        cols.set_field(k, np.array(o, np.int32), np.array(ln, np.int32))
    g = models.PipelineEventGroup(sb)
    g.set_columns(cols)
    return g


def _rollup_groups(side, substrate, lines):
    if side == "reference":
        agg, models, ctx = RefRollup(), ref_models, RefContext(PIPE)
    else:
        agg, models = PortRollup(), port_models
        ctx = PortContext(PIPE, device=torch.device("cpu"))
    assert agg.init({"WindowSecs": td.METRICS_WINDOW,
                     "AllowedLatenessSecs": td.METRICS_LATENESS,
                     "LabelKeys": ["host"], "MaxKeys": 65536,
                     "Substrate": substrate}, ctx)
    out = []
    try:
        for rows in td.metrics_fold_rows(lines):
            # the event second's slot back to a second of its window
            rows = [(nm, lb, v, slot * td.METRICS_WINDOW)
                    for nm, lb, v, slot in rows]
            out.extend(agg.add(_make_group(models, rows)))
        out.extend(agg.flush())
    finally:
        agg.metrics.mark_deleted()
    return out


def _flusher(side):
    if side == "reference":
        f, ctx = ref_prom.FlusherPrometheus(), RefContext(PIPE)
    else:
        f = port_prom.FlusherPrometheus()
        ctx = PortContext(PIPE, device=torch.device("cpu"))
    assert f.init({"Type": "flusher_prometheus",
                   "Endpoint": "http://127.0.0.1:9/api/v1/write"}, ctx)
    return f


@pytest.fixture(scope="module")
def metrics():
    lines = td.gen_metrics_jsonl(4800, seed=17)
    return lines, td.metrics_oracle(lines)[0]


@pytest.fixture
def corpus(metrics, libs):
    return metrics


@pytest.fixture
def libs(monkeypatch):
    """Both packages on their native library (snappy), whatever bridge
    state this worker holds: the bridges are reset, a whole library is put
    in place through the port's locked build, and both load it within a
    deadline (the JAX package's loader may meet a file its own ``make`` in
    another process is still writing), as
    ``test_torch_parse_delimiter.py``'s ``both_native`` does."""
    monkeypatch.delenv("LOONG_DISABLE_NATIVE", raising=False)
    for mod in (ref_native, port_native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_load_attempted", False)
    assert port_native.ensure_built(), "the port's native build failed"
    deadline = time.monotonic() + 10.0
    while True:
        loaded = {name: mod.get_lib() for name, mod in
                  (("loongcollector_tpu", ref_native),
                   ("loongcollector_tpu_torch", port_native))}
        missing = sorted(name for name, lib in loaded.items()
                         if lib is None
                         or not hasattr(lib, "lct_snappy_compress"))
        if not missing or time.monotonic() > deadline:
            break
        for mod in (ref_native, port_native):
            mod._lib, mod._load_attempted = None, False
        time.sleep(0.2)
    assert not missing, f"native bridge not loaded: {missing}"
    yield
    for mod in (ref_native, port_native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_load_attempted", False)


def _bodies(side, substrate, lines):
    f = _flusher(side)
    try:
        groups = _rollup_groups(side, substrate, lines)
        body, headers = f.build_payload(groups)
        return body, headers
    finally:
        f.stop()


def test_rollup_body_byte_equal(corpus):
    lines, oracle = corpus
    ref_body, ref_headers = _bodies("reference", "numpy", lines)
    port_body, port_headers = _bodies("port", "numpy", lines)
    assert port_headers == ref_headers == {
        "Content-Encoding": "snappy",
        "X-Prometheus-Remote-Write-Version": "0.1.0"}
    assert port_body == ref_body
    samples = chip_smoke.decode_write_request(
        port_native.snappy_decompress(port_body))
    rows = td.rollup_sample_rows(samples)
    assert len(rows) == len(oracle)
    assert td.rollup_mismatches(rows, oracle) == []


def test_device_fold_samples_within_tolerance(corpus):
    """The port's plain K6 (f32) against the reference's numpy fold: the
    bodies differ where the f32 sums do; the decoded samples agree."""
    lines, oracle = corpus
    ref_body = _bodies("reference", "numpy", lines)[0]
    port_body = _bodies("port", "device", lines)[0]
    ref_rows = td.rollup_sample_rows(chip_smoke.decode_write_request(
        port_native.snappy_decompress(ref_body)))
    port_rows = td.rollup_sample_rows(chip_smoke.decode_write_request(
        port_native.snappy_decompress(port_body)))
    assert td.rollup_mismatches(port_rows, oracle, f32_want=True) == []
    assert td.rollup_mismatches(port_rows, ref_rows, f32_want=True) == []


def test_dict_route_gives_the_same_series(corpus):
    """Rollup groups materialized into LogEvents (the dict route) give
    the same samples as their columnar route."""
    lines, _ = corpus
    f = _flusher("port")
    try:
        groups = _rollup_groups("port", "numpy", lines[:1600])
        n_rows = sum(len(g) for g in groups)
        col = []
        for g in groups:
            assert f._columnar_series(g, col)
            g.materialize()
            assert g.columns is None or g._events
        dct = []
        for g in groups:
            assert f._columnar_series(g, dct)
    finally:
        f.stop()
    assert sorted(col, key=repr) == sorted(dct, key=repr)
    assert len(col) == 5 * n_rows > 0
