"""``processor_parse_delimiter`` in the port against the JAX package's.

Each corpus is cut into one columnar group by each package's line split and
parsed by each package's processor; the snapshots must be equal: every
field column decoded row by row (collapsed doubled quotes read out of the
side arena or the copied strings), ``parse_ok``, the NDJSON each package's
serializer writes, and the parse telemetry (rows and fallback rows).  The
three tiers of the processor are held:

* non-quote: the Tier-1 delimiter program (K1's plain version here);
* quote mode with the native walker (``lct_delim_struct_parse``), both
  bridges reset and loaded by the ``both_native`` fixture, so the case
  does not depend on the bridge state its worker holds;
* quote mode without it, ``LOONG_DISABLE_NATIVE=1`` in both packages (the
  native bridges reset, as the reference's
  ``test_numpy_tier_matches_native`` does): the port indexes the group
  with K5 (its plain version on the CPU) where the reference uses its
  numpy twin, and both walk the deviant rows through the FSM, counted.

The corpora are the reference's ``CSV_GOLDEN_ROWS``
(``tests/test_struct_index.py:313``), a seeded quote-mode CSV log
(``testdata.gen_quoted_csv``: quoted commas, doubled quotes, unbalanced
quotes) and a pipe-delimited log; also under ``LOONG_STRUCT=0`` and on the
per-event row path.  End to end, the three configs of the slice
(quote-mode CSV in both quote tiers, the delimiter-filter path, the
shipped ``json_filter.yaml``) run through ``python -m
loongcollector_tpu_torch --once --cpu`` and through the JAX package's
agent under ``JAX_PLATFORMS=cpu``: the NDJSON bytes are equal (the read
time in ``__time__`` aside), and equal to the slice's oracles.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from loongcollector_tpu import models as ref_models
from loongcollector_tpu import native as ref_native
from loongcollector_tpu.pipeline.plugin.interface import (
    PluginContext as RefContext)
from loongcollector_tpu.pipeline.serializer.json_serializer import (
    JsonSerializer as RefSerializer)
from loongcollector_tpu.processor import parse_telemetry as ref_tel
from loongcollector_tpu.processor.parse_delimiter import (
    ProcessorParseDelimiter as RefDelimiter)
from loongcollector_tpu.processor.split_log_string import (
    ProcessorSplitLogString as RefSplit)
from loongcollector_tpu_torch import models as port_models
from loongcollector_tpu_torch import native as port_native
from loongcollector_tpu_torch import testdata as td
from loongcollector_tpu_torch.ops.kernels import struct_index as si
from loongcollector_tpu_torch.pipeline.plugin.interface import (
    PluginContext as PortContext)
from loongcollector_tpu_torch.pipeline.serializer.json_serializer import (
    JsonSerializer as PortSerializer)
from loongcollector_tpu_torch.processor import parse_telemetry as port_tel
from loongcollector_tpu_torch.processor.parse_delimiter import (
    ProcessorParseDelimiter as PortDelimiter, _csv_fsm_split)
from loongcollector_tpu_torch.processor.split_log_string import (
    ProcessorSplitLogString as PortSplit)
from test_torch_alarms import alarms_left_empty  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_struct_index.py:313
CSV_GOLDEN_ROWS = [
    b'a,b,c', b'"a,b",c,d', b'"a""b",c,x', b'a"b,c"d,e', b'"x"tail,y,z',
    b'"unterminated, z', b'', b',', b'a,,b', b'"",x,y', b'""a,b,c',
    b'"a","b","c","d"', b'"dq""""x",y,w', b'p,q,r,s,extra1,extra2',
]

CORPORA = {
    "golden": lambda: CSV_GOLDEN_ROWS,
    "csv": lambda: td.gen_quoted_csv(600, seed=19) + CSV_GOLDEN_ROWS,
    "pipe": lambda: td.gen_pipe_log(600, seed=23),
}
CONFIGS = {
    "quote3": {"Keys": ["k1", "k2", "k3"], "Mode": "quote"},
    "quote8": {"Keys": list(td.CSV_KEYS), "Mode": "quote",
               "KeepingSourceWhenParseSucceed": True},
    "quote_not_enough": {"Keys": ["a", "b", "c", "d"], "Mode": "quote",
                         "AcceptNoEnoughKeys": True},
    "plain3": {"Keys": ["k1", "k2", "k3"]},
    "pipe6": {"Keys": list(td.PIPE_KEYS), "Separator": "|"},
    "pipe6_quote": {"Keys": list(td.PIPE_KEYS), "Separator": "|",
                    "Mode": "quote", "KeepingSourceWhenParseFail": False},
}


@pytest.fixture(autouse=True)
def _clean_state():
    ref_tel.reset_for_testing()
    port_tel.reset()
    yield
    from loongcollector_tpu.monitor.alarms import AlarmManager
    AlarmManager.instance().flush()
    ref_tel.reset_for_testing()
    port_tel.reset()


@pytest.fixture
def no_native(monkeypatch):
    """Both packages without their native library, as the reference's
    ``test_numpy_tier_matches_native`` sets it up."""
    monkeypatch.setenv("LOONG_DISABLE_NATIVE", "1")
    for mod in (ref_native, port_native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_load_attempted", False)
    yield
    monkeypatch.setenv("LOONG_DISABLE_NATIVE", "")
    for mod in (ref_native, port_native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_load_attempted", False)


@pytest.fixture
def both_native(monkeypatch):
    """Both packages on their native library, whatever bridge state this
    worker holds: the bridges are reset, a whole library is put in place
    through the port's locked build, and both bridges load it.  A bridge
    that does not load fails the test by name (the JAX package's loader
    may meet a file its own ``make`` in another process is still writing,
    so it is given a few tries within a deadline)."""
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
                         or not hasattr(lib, "lct_delim_struct_parse"))
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


def _group(models, split_cls, ctx, lines):
    data = b"\n".join(lines) + b"\n"
    sb = models.SourceBuffer(len(data) + 64)
    g = models.PipelineEventGroup(sb)
    g.add_raw_event(1700000000).set_content(sb.copy_string(data))
    sp = split_cls()
    sp.init({}, ctx)
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
        models, split, pd, ser = (ref_models, RefSplit, RefDelimiter,
                                  RefSerializer)
        ctx = RefContext("csv")
    else:
        models, split, pd, ser = (port_models, PortSplit, PortDelimiter,
                                  PortSerializer)
        ctx = PortContext("csv", device="cpu")
    g = _group(models, split, ctx, lines)
    if rows_path:
        g.materialize("test")
    p = pd()
    assert p.init(dict(config), ctx)
    p.process(g)
    return _snapshot(g), ser().serialize([g])


def _telemetry():
    want = {k: (v["rows"], v["fallback_rows"])
            for k, v in ref_tel.status().items()}
    got = {k: (v["rows"], v["fallback_rows"])
           for k, v in port_tel.status().items()}
    return got, want


def _agree(lines, config, rows_path=False):
    want, want_bytes = _parse("ref", lines, config, rows_path)
    got, got_bytes = _parse("port", lines, config, rows_path)
    assert got == want
    assert got_bytes == want_bytes
    tel_got, tel_want = _telemetry()
    assert tel_got == tel_want
    return got, tel_got


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_native_tier_matches_reference(corpus, config, both_native):
    _agree(CORPORA[corpus](), CONFIGS[config])


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_index_tier_matches_reference(corpus, config, no_native):
    si.device_kernel(si.MODE_DELIM, 0x2C, "cpu").reset_counts()
    si.device_kernel(si.MODE_DELIM, 0x7C, "cpu").reset_counts()
    _got, tel = _agree(CORPORA[corpus](), CONFIGS[config])
    quote = CONFIGS[config].get("Mode") == "quote"
    sep = CONFIGS[config].get("Separator", ",").encode()[0]
    kern = si.device_kernel(si.MODE_DELIM, sep, "cpu")
    # one K5 dispatch for the group in quote mode, none otherwise
    assert kern.device_batches == kern.dispatch_count == int(quote)
    assert kern.launches == 0 and kern.host_groups == {}
    if quote:
        lines = CORPORA[corpus]()
        F = len(CONFIGS[config]["Keys"])
        deviant = sum(td.csv_deviant(ln, F, sep) for ln in lines)
        assert list(tel.values()) == [(len(lines), deviant)]


def test_index_tier_fields_equal_the_fsm(no_native):
    """The index tier's fields, row by row, are the reference FSM's with
    the join rule (``testdata.csv_oracle``); the fallback rows are the
    deviant rows."""
    lines = td.gen_quoted_csv(800, seed=5)
    got, tel = _agree(lines, {"Keys": list(td.CSV_KEYS), "Mode": "quote"})
    want = td.csv_oracle(lines)
    fields = got["fields"]
    for i, rec in enumerate(want):
        if "rawLog" in rec:
            assert fields["rawLog"][i] == rec["rawLog"].encode()
            continue
        assert {k: fields[k][i].decode() for k in td.CSV_KEYS} == rec
    deviant = sum(td.csv_deviant(ln) for ln in lines)
    assert 0 < deviant < len(lines) // 20
    assert list(tel.values()) == [(len(lines), deviant)]


def test_row_over_the_largest_bucket_takes_the_numpy_twin(no_native):
    lines = CSV_GOLDEN_ROWS + [b'"' + b"x," * 2100 + b'",tail,end']
    kern = si.device_kernel(si.MODE_DELIM, 0x2C, "cpu")
    kern.reset_counts()
    _agree(lines, CONFIGS["quote3"])
    assert kern.host_groups == {si.HOST_LONG_ROW: 1}
    assert kern.device_batches == 0


@pytest.mark.parametrize("config", ["quote3", "plain3", "pipe6"])
def test_struct_off_matches_reference(config, monkeypatch):
    monkeypatch.setenv("LOONG_STRUCT", "0")
    _agree(CORPORA["csv"]() + CORPORA["pipe"](), CONFIGS[config])


@pytest.mark.parametrize("config", ["quote3", "plain3", "pipe6_quote"])
def test_row_path_matches_reference(config):
    _agree(CORPORA["golden"]() + CORPORA["pipe"]()[:50], CONFIGS[config],
           rows_path=True)


def test_fsm_is_the_reference_fsm():
    from loongcollector_tpu.processor.parse_delimiter import \
        _csv_fsm_split as ref_fsm
    for line in CORPORA["csv"]() + CORPORA["pipe"]():
        for sep in (b",", b"|", b"||"):
            assert _csv_fsm_split(line, sep) == ref_fsm(line, sep)


def test_fused_stage_spec_only_in_non_quote_mode():
    from loongcollector_tpu_torch.pipeline.fused_chain import \
        FusionPlanContext
    ctx = PortContext("p", device="cpu")
    for config, fuses in (("pipe6", True), ("plain3", True),
                          ("quote3", False), ("quote_not_enough", False)):
        p = PortDelimiter()
        assert p.init(dict(CONFIGS[config]), ctx)
        spec = p.fused_stage_spec(FusionPlanContext())
        assert (spec is not None) == fuses
        if fuses:
            assert spec.spec.kind == "extract"
            assert spec.spec.ident == ["extract", p.engine.pattern]
    assert PortDelimiter().init({"Keys": []}, ctx) is False


def test_registered_under_both_names():
    from loongcollector_tpu_torch.pipeline.plugin.registry import \
        PluginRegistry
    reg = PluginRegistry.instance()
    reg.load_static_plugins()
    for name in ("processor_parse_delimiter_native",
                 "processor_parse_delimiter_tpu"):
        assert reg.create_processor(name).__class__ is PortDelimiter


# -- end to end: both agents on the slice's three configs -------------------

_TIME = re.compile(rb'"__time__": \d+')

AGENT_CASES = {
    "csv_native": (lambda: td.gen_quoted_csv(3000, seed=19),
                   td.quoted_csv_config, {}),
    "csv_index": (lambda: td.gen_quoted_csv(3000, seed=19),
                  td.quoted_csv_config, {"LOONG_DISABLE_NATIVE": "1"}),
    "pipe_filter": (lambda: td.gen_pipe_log(4000, seed=23),
                    td.pipe_filter_config, {"LOONG_FUSED": "1"}),
    "json_filter": (lambda: td.gen_json_events(800, seed=29),
                    td.json_filter_config, {}),
}


def _agent(who, cfg_dir, tmp_path, env_vars):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               **env_vars)
    if who == "ref":
        # its own data dir: the reference keeps file checkpoints by (dev,
        # inode) in ~/.loongcollector_tpu, shared by every reference run
        cmd = [sys.executable, "-m", "loongcollector_tpu", "--config",
               str(cfg_dir), "--once", "--data-dir",
               str(tmp_path / "ref_data")]
    else:
        cmd = [sys.executable, "-m", "loongcollector_tpu_torch", "--config",
               str(cfg_dir), "--once", "--cpu", "--data-dir",
               str(tmp_path / "port_data"), "--stats",
               str(tmp_path / "stats.json")]
    subprocess.run(cmd, cwd=str(tmp_path), env=env, check=True,
                   capture_output=True, timeout=300)


@pytest.mark.parametrize("case", sorted(AGENT_CASES))
def test_agents_agree_end_to_end(case, tmp_path):
    gen, config, env_vars = AGENT_CASES[case]
    lines = gen()
    log = tmp_path / "in.log"
    log.write_bytes(b"\n".join(lines) + b"\n")
    outs = {}
    for who in ("ref", "port"):
        cfg_dir = tmp_path / f"cfg_{who}"
        cfg_dir.mkdir()
        out = tmp_path / f"out_{who}.json"
        (cfg_dir / "p.yaml").write_text(config(str(log), str(out)))
        _agent(who, cfg_dir, tmp_path, env_vars)
        outs[who] = out.read_bytes()
    got = _TIME.sub(b'"__time__": 0', outs["port"])
    assert got == _TIME.sub(b'"__time__": 0', outs["ref"])
    recs = [json.loads(x) for x in got.splitlines()]
    stats = json.loads((tmp_path / "stats.json").read_text())
    if case.startswith("csv"):
        want = td.csv_oracle(lines)
        assert [{k: r.get(k) for k in w} for r, w in zip(recs, want)] == want
        assert len(recs) == len(want)
        k5 = stats["k5"]
        deviant = sum(td.csv_deviant(ln) for ln in lines)
        if case == "csv_index":
            assert k5["fallback_rows"] == deviant > 0
            assert k5["device_batches"] == k5["dispatches"] \
                == len(td.reader_chunks(lines)) == 2
        else:
            assert k5["fallback_rows"] == k5["dispatches"] == 0
        assert k5["launches"] == 0 and k5["host_groups"] == {}
    elif case == "pipe_filter":
        want = td.pipe_filter_oracle(lines)
        assert [{k: r.get(k) for k in td.PIPE_KEYS} for r in recs] == want
        fu = stats["fusion"]
        assert fu["runs_planned"] == 1 and fu["fused_groups"] \
            == fu["fused_dispatches"] > 0
        assert stats["device_batches"] == 0
    else:
        want = td.json_filter_oracle(lines)
        assert [{k: r.get(k) for k in w} for r, w in zip(recs, want)] == want
        assert len(recs) == len(want)
        assert stats["device_batches"] > 0 and stats["k2"]["launches"] == 0


def test_csv_oracle_and_deviance_are_independent_of_the_index():
    """The oracle's deviant rows are those the index tier flags, on a
    corpus that holds each kind."""
    lines = td.gen_quoted_csv(2000, seed=1) + CSV_GOLDEN_ROWS
    F = len(td.CSV_KEYS)
    mat = np.zeros((len(lines), 512), np.uint8)
    lens = np.array([len(x) for x in lines], np.int32)
    for i, ln in enumerate(lines):
        mat[i, :len(ln)] = np.frombuffer(ln, np.uint8) if ln else 0
    masks = si.struct_index_numpy(mat, lens, si.MODE_DELIM, 0x2C)
    *_, deviant = si.emit_delim_spans(
        mat.reshape(-1), np.arange(len(lines), dtype=np.int64) * 512, lens,
        si.unpack16(masks[3], 512), si.unpack16(masks[1], 512), F)
    assert deviant.tolist() == [td.csv_deviant(ln, F) for ln in lines]
    doubled = sum(b'""' in ln for ln in lines[:2000])
    assert 8 <= doubled <= 40 and deviant[:2000].sum() >= doubled
