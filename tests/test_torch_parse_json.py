"""``processor_parse_json_tpu`` in the port against the JAX package's.

Each corpus is cut into one columnar group by each package's line split
and parsed by each package's processor; the snapshots must be equal: every
field column decoded row by row (escape-bearing values read out of the
side arena), ``parse_ok``, the NDJSON each package's serializer writes,
and the parse telemetry (rows, fallback rows, drift rows).  The corpora
are the reference's own: the golden rows of ``tests/test_struct_index.py``
(escapes, unicode escapes and surrogates, nesting, malformed rows), the
JSON corpus of ``scripts/struct_equivalence.py`` (backslash runs across
the 64-bit word boundary, seeded noise), drifting schemas, the metric
lines of the rollup path, and every corpus again under ``LOONG_STRUCT=0``
(the schema-discovery plane) and on the per-event row path.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loongcollector_tpu import models as ref_models  # noqa: E402
from loongcollector_tpu.pipeline.plugin.interface import (  # noqa: E402
    PluginContext as RefContext)
from loongcollector_tpu.pipeline.serializer.json_serializer import (  # noqa: E402
    JsonSerializer as RefSerializer)
from loongcollector_tpu.processor import parse_telemetry as ref_tel  # noqa: E402
from loongcollector_tpu.processor.parse_json import (  # noqa: E402
    ProcessorParseJson as RefParseJson)
from loongcollector_tpu.processor.split_log_string import (  # noqa: E402
    ProcessorSplitLogString as RefSplit)
from loongcollector_tpu_torch import models as port_models  # noqa: E402
from loongcollector_tpu_torch import testdata as td  # noqa: E402
from loongcollector_tpu_torch.pipeline.plugin.interface import (  # noqa: E402
    PluginContext as PortContext)
from loongcollector_tpu_torch.pipeline.serializer.json_serializer import (  # noqa: E402
    JsonSerializer as PortSerializer)
from loongcollector_tpu_torch.processor import (  # noqa: E402
    parse_telemetry as port_tel)
from loongcollector_tpu_torch.processor.parse_json import (  # noqa: E402
    ProcessorParseJson as PortParseJson)
from loongcollector_tpu_torch.processor.split_log_string import (  # noqa: E402
    ProcessorSplitLogString as PortSplit)
from test_torch_alarms import alarms_left_empty  # noqa: F401
from test_torch_parse_delimiter import both_native  # noqa: E402,F401


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
    ref_tel.reset_for_testing()
    _ref_ledger.disable()
    _port_ledger.disable()


# tests/test_struct_index.py:184-196
GOLDEN = [
    b'{"ts": 1700000000, "level": "info", "user": "u1", "msg": "hi"}',
    b'{"ts": 1, "level": "in\\nfo", "user": "u\\u00e9", "msg": "\\"q\\""}',
    b'{"ts": 2, "level": "\\u4f60\\u597d", "user": "\\ud83d\\ude00",'
    b' "msg": "\\\\net\\\\share"}',
    b'{"ts": 3, "drifted_key": "boom", "level": "x"}',
    b'{"nested": {"a": [1, 2, {"b": "c,{}"}]}, "ts": 4}',
    b'{"ts": bad}', b'not json', b'{}', b'{"a": "unterminated',
    b'{"dup": 1, "dup": 2}', b'{"a": true, "b": null, "c": false}',
    b'{"e": "' + b'\\\\' * 33 + b'"}',
    b'{"e": "' + b'x' * 55 + b'\\\\\\"' + b'"}',
    b'{"sp" :  "v"  ,  "n" : -1.5e3  }',
    b'{"a": 1} trailing', b'{"a": 01}', b'{"a"::1}',
]


def struct_equivalence_corpus():
    """scripts/struct_equivalence.py:json_corpus, rebuilt."""
    rows = [
        b'{"ts": 1700000000, "level": "info", "user": "u1", "msg": "hi"}',
        b'{"ts": 1, "level": "in\\nfo", "user": "u\\u00e9", "msg": "\\"q\\""}',
        b'{"ts": 2, "level": "ok", "user": "u", "msg": "m"}',
        b'{"ts": 1, "extra_key": "boom", "level": "x"}',
        b'{"nested": {"a": [1, 2, {"b": "c,{}"}]}, "ts": 3}',
        b'{"ts": bad}', b'not json', b'{}', b'  { } ',
        b'{"a": "unterminated', b'{"dup": 1, "dup": 2}',
        b'{"sp" :  "v"  ,  "n" : -1.5e3  }',
        b'{"surrogate": "\\ud83d\\ude00"}',
        b'{"slash": "a\\/b"}', b'{"ctl": "a\tb"}',
        b'{"a": 1} trailing', b'{"a": 1}}', b'{"a": 01}', b'{"a"::1}',
        b'{"a": 1, }', b'{"a" x: 1}', b'{"a": "x" junk "y"}',
        b'{"a": true, "b": null, "c": false}', b'[1, 2]', b'"str"', b'',
        b'{"reorder": 1, "ts": 2, "level": "z", "user": "u", "msg": "m"}',
        b'{"deep": ' + b'[' * 70 + b']' * 70 + b'}',
    ]
    for k in range(1, 12):
        pad = b'x' * (62 - k)
        rows.append(b'{"e": "' + pad + b'\\' * k + b'n", "t": 1}')
        rows.append(b'{"e": "' + pad + b'\\' * k + b'"}')
    rng = np.random.default_rng(12)
    for _ in range(300):
        L = int(rng.integers(0, 150))
        rows.append(bytes(rng.choice(
            list(b'ab\\"{}[]:, \t019.e-u'), size=L).astype(np.uint8)))
    return [r for r in rows if b"\n" not in r]


def drift_corpus():
    return [b'{"a": "x", "b": "y"}'] * 8 + [
        b'{"a": "x", "b": "y", "c%d": "z"}' % i for i in range(4)] + [
        b'{"b": "only b"}', b'{"c0": "q", "a": "\\t"}', b'{"a": 12.50}']


CORPORA = {
    "golden": lambda: [r for r in GOLDEN if b"\n" not in r],
    "struct_equivalence": struct_equivalence_corpus,
    "drift": drift_corpus,
    "metrics": lambda: td.gen_metrics_jsonl(2000, seed=3),
}


def _group(models, split_cls, ctx_cls, lines):
    data = b"\n".join(lines) + b"\n"
    sb = models.SourceBuffer(len(data) + 64)
    g = models.PipelineEventGroup(sb)
    g.add_raw_event(1700000000).set_content(sb.copy_string(data))
    sp = split_cls()
    sp.init({}, ctx_cls("t"))
    sp.process(g)
    return g


def _snapshot(g):
    cols = g.columns
    if cols is None or g._events:
        return {"events": [sorted((bytes(k), bytes(v)) for k, v in
                                  ev.contents) for ev in g.events]}
    raw = bytes(g.source_buffer.raw)
    fields = {}
    for name, (offs, lens) in cols.fields.items():
        fields[name] = [raw[int(o):int(o) + int(n)] if n >= 0 else None
                        for o, n in zip(offs, lens)]
    return {"fields": fields,
            "parse_ok": None if cols.parse_ok is None
            else cols.parse_ok.tolist()}


def _parse(which, lines, config, rows_path=False):
    if which == "ref":
        models, split, ctx, pj, ser = (ref_models, RefSplit, RefContext,
                                       RefParseJson, RefSerializer)
    else:
        models, split, ctx, pj, ser = (port_models, PortSplit, PortContext,
                                       PortParseJson, PortSerializer)
    g = _group(models, split, ctx, lines)
    if rows_path:
        g.materialize("test")
    p = pj()
    assert p.init(dict(config), ctx("pj"))
    p.process(g)
    return _snapshot(g), ser().serialize([g])


@pytest.mark.parametrize("struct", ["1", "0"])
@pytest.mark.parametrize("config", [
    {}, {"KeepingSourceWhenParseSucceed": True},
    {"KeepingSourceWhenParseFail": False, "RenamedSourceKey": "raw"}],
    ids=["default", "keep_ok", "drop_fail"])
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_parse_json_snapshot_matches_reference(corpus, config, struct,
                                               monkeypatch, both_native):
    # both packages on their native library (``both_native``): a worker
    # whose JAX bridge met a half-written library would run the reference
    # on its Python fallbacks and the port natively
    monkeypatch.setenv("LOONG_STRUCT", struct)
    lines = CORPORA[corpus]()
    ref_tel.reset_for_testing()
    port_tel.reset()
    want, want_bytes = _parse("ref", lines, config)
    got, got_bytes = _parse("port", lines, config)
    assert got == want
    assert got_bytes == want_bytes
    assert port_tel.status() == {
        k: {f: v[f] for f in ("rows", "fallback_rows", "drift_rows")}
        | {"degraded": v["degraded"]} for k, v in ref_tel.status().items()}


@pytest.mark.parametrize("corpus", ["golden", "drift"])
def test_parse_json_row_path_matches_reference(corpus):
    lines = CORPORA[corpus]()
    want, want_bytes = _parse("ref", lines, {}, rows_path=True)
    got, got_bytes = _parse("port", lines, {}, rows_path=True)
    assert got == want and got_bytes == want_bytes


def test_metric_lines_parse_on_the_structural_plane():
    """The rollup path's lines never leave the structural plane: no
    fallback row, and the rows without a name are parsed with the field
    absent."""
    lines = td.gen_metrics_jsonl(5000, seed=17)
    port_tel.reset()
    got, _ = _parse("port", lines, {})
    st = port_tel.status()["processor_parse_json_tpu/pj"]
    assert st["rows"] == 5000 and st["fallback_rows"] == 0
    names = got["fields"]["__name__"]
    assert sum(n is None for n in names) == sum(
        b'"__name__"' not in ln for ln in lines) > 0
    assert all(got["parse_ok"])
