"""The small native processors: the port's ``processor_desensitize_native``,
``processor_timestamp_filter_native``, ``processor_parse_apsara_native``
and ``processor_parse_from_pb_native`` against the JAX package's, on the
CPU.

Each case runs the same config on the same seeded input — a split
columnar group (raw lines or a parsed field) and a group of log events —
through both packages' processors: the ``init`` result and the columns or
events leave bytes for bytes equal.  ``timestamp_filter`` reads the clock:
``time.time`` is pinned for both.  ``parse_apsara``'s local-time path reads
the process's time zone, which both packages share here.
"""

import time

import numpy as np
import pytest
import torch

from loongcollector_tpu.models import PipelineEventGroup as RefGroup
from loongcollector_tpu.models import SourceBuffer as RefSourceBuffer
from loongcollector_tpu.pipeline.plugin.interface import \
    PluginContext as RefContext
from loongcollector_tpu.pipeline.serializer.sls_serializer import \
    SLSEventGroupSerializer as RefSLS
from loongcollector_tpu.processor import desensitize as ref_desens
from loongcollector_tpu.processor import parse_apsara as ref_apsara
from loongcollector_tpu.processor import parse_from_pb as ref_pb
from loongcollector_tpu.processor import timestamp_filter as ref_tsf
from loongcollector_tpu.processor.parse_regex import \
    ProcessorParseRegex as RefParse
from loongcollector_tpu.processor.split_log_string import \
    ProcessorSplitLogString as RefSplit
from loongcollector_tpu_torch import testdata as td
from loongcollector_tpu_torch.models import PipelineEventGroup, SourceBuffer
from loongcollector_tpu_torch.pipeline.plugin.interface import PluginContext
from loongcollector_tpu_torch.pipeline.serializer.sls_serializer import \
    SLSEventGroupSerializer
from loongcollector_tpu_torch.processor import desensitize as port_desens
from loongcollector_tpu_torch.processor import parse_apsara as port_apsara
from loongcollector_tpu_torch.processor import parse_from_pb as port_pb
from loongcollector_tpu_torch.processor import timestamp_filter as port_tsf
from loongcollector_tpu_torch.processor.parse_regex import ProcessorParseRegex
from loongcollector_tpu_torch.processor.split_log_string import \
    ProcessorSplitLogString
from test_torch_alarms import alarms_left_empty  # noqa: F401
from test_torch_container import containers_left_empty  # noqa: F401
from test_torch_container import snapshot

PKGS = {
    "ref": dict(Group=RefGroup, Buf=RefSourceBuffer, Split=RefSplit,
                Parse=RefParse, desens=ref_desens, tsf=ref_tsf,
                apsara=ref_apsara, pb=ref_pb, SLS=RefSLS,
                Ctx=lambda: RefContext("p")),
    "port": dict(Group=PipelineEventGroup, Buf=SourceBuffer,
                 Split=ProcessorSplitLogString, Parse=ProcessorParseRegex,
                 desens=port_desens, tsf=port_tsf, apsara=port_apsara,
                 pb=port_pb, SLS=SLSEventGroupSerializer,
                 Ctx=lambda: PluginContext("p", device=torch.device("cpu"))),
}


@pytest.fixture(autouse=True)
def _host_routes_in_the_reference(monkeypatch):
    monkeypatch.setenv("LOONG_DEVICE_MIN_BYTES", str(1 << 40))


def _split(pkg, lines, ts=None, parse=None):
    P = PKGS[pkg]
    data = b"\n".join(lines) + b"\n"
    sb = P["Buf"](len(data) + 64)
    g = P["Group"](sb)
    g.add_raw_event(100).set_content(sb.copy_string(data))
    sp = P["Split"]()
    sp.init({}, P["Ctx"]())
    sp.process(g)
    if ts is not None:
        g.columns.timestamps[:] = ts
    if parse is not None:
        pr = P["Parse"]()
        assert pr.init({"SourceKey": "content", "Regex": parse[0],
                        "Keys": parse[1]}, P["Ctx"]())
        pr.process(g)
    return g


def _events(pkg, rows):
    P = PKGS[pkg]
    g = P["Group"]()
    sb = g.source_buffer
    for ts, fields in rows:
        ev = g.add_log_event(ts)
        for k, v in fields.items():
            ev.set_content(sb.copy_string(k), sb.copy_string(v))
    return g


def _both(make, module, cls, cfg):
    out = {}
    for pkg in ("ref", "port"):
        P = PKGS[pkg]
        p = getattr(P[module], cls)()
        if not p.init(dict(cfg), P["Ctx"]()):
            out[pkg] = "init refused"
            continue
        g = make(pkg)
        p.process(g)
        out[pkg] = snapshot(g)
    assert out["port"] == out["ref"]
    return out["port"]


# -- processor_desensitize_native ------------------------------------------------

def _secret_lines(seed, n=120):
    rng = np.random.default_rng(seed)
    out = []
    for i, line in enumerate(td.gen_lines(n, seed=seed)):
        k = int(rng.integers(4))
        if k == 0:
            line += b" password=" + rng.integers(48, 122, 8,
                                                 dtype=np.uint8).tobytes()
        elif k == 1:
            line += b" card=4111-1111-%04d-1111 password=x pwd" % i
        elif k == 2:
            line = b"password=" + line
        out.append(line)
    return out


DESENS = [
    {"SourceKey": "content", "Method": "const",
     "Regex": r"(password=)[^\s]+", "ReplacingString": "***"},
    {"SourceKey": "content", "Method": "md5", "Regex": r"(password=)(\S+)"},
    {"SourceKey": "content", "Method": "md5", "Regex": r"\d{4}-\d{4}"},
    {"SourceKey": "user", "Method": "const", "Regex": r"(user)(\d+)"},
    {"SourceKey": "content"},
]


@pytest.mark.parametrize("cfg", DESENS, ids=range(len(DESENS)))
@pytest.mark.parametrize("form", ["raw", "parsed", "events"])
def test_desensitize_matches_reference(cfg, form):
    lines = _secret_lines(3)
    if form == "raw":
        def make(pkg):
            return _split(pkg, lines)
    elif form == "parsed":
        def make(pkg):
            return _split(pkg, lines, parse=(td.APACHE + r"(.*)",
                                             td.APACHE_KEYS + ["rest"]))
    else:
        def make(pkg):
            return _events(pkg, [(i, {b"content": ln, b"user": b"user%d" % i})
                                 for i, ln in enumerate(lines)])
    _both(make, "desens", "ProcessorDesensitize", cfg)


# -- processor_timestamp_filter_native --------------------------------------------

NOW = 1_700_000_500
TSF = [{"StartTime": NOW - 300}, {"EndTime": NOW - 100},
       {"StartTime": NOW - 400, "EndTime": NOW - 50},
       {"RelativeWindowSeconds": 120},
       {"RelativeWindowSeconds": 600, "EndTime": NOW - 200}, {}]


@pytest.mark.parametrize("cfg", TSF, ids=range(len(TSF)))
@pytest.mark.parametrize("form", ["columns", "events"])
def test_timestamp_filter_matches_reference(cfg, form, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: float(NOW))
    rng = np.random.default_rng(8)
    ts = (NOW - rng.integers(0, 600, 300)).astype(np.int64)
    lines = td.gen_lines(300, seed=8)
    if form == "columns":
        def make(pkg):
            return _split(pkg, lines, ts=ts)
    else:
        def make(pkg):
            return _events(pkg, [(int(t), {b"content": ln})
                                 for t, ln in zip(ts, lines)])
    got = _both(make, "tsf", "ProcessorTimestampFilter", cfg)
    if cfg:
        assert 0 < len(got if form == "events" else got["content"]) < 300


# -- processor_parse_apsara_native -------------------------------------------------

def _apsara_lines(seed, n=200):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(8))
        t = f"2024-01-{1 + i % 28:02d} {i % 24:02d}:{i % 60:02d}:07.{i:06d}"
        body = f"\tk{i}:v{i}\tlatency:{int(rng.integers(1000))}\tmsg:a:b"
        if k == 0:
            line = f"[{1700000000 + i}123456]\t[INFO]{body}"
        elif k == 1:
            line = f"[{t}]\t[WARN]\t[{1000 + i}]\t[svc.cpp:{i}]{body}"
        elif k == 2:
            line = f"[{t}]\t[ERROR]\t[thr]\t[nofile]{body}\t\tempty:"
        elif k == 3:
            line = f"no bracket {t}"
        elif k == 4:
            line = f"[{t}"
        elif k == 5:
            line = f"[not a time]\t[INFO]{body}"
        else:
            line = f"[{t}]{body}\tnocolon"
        out.append(line.encode())
    return out


APSARA = [{}, {"SourceTimezone": "GMT+08:00"}, {"SourceTimezone": "GMT-03:30"},
          {"KeepingSourceWhenParseFail": False},
          {"SourceKey": "msg", "SourceTimezone": "GMT+00:00"}]


@pytest.mark.parametrize("cfg", APSARA, ids=range(len(APSARA)))
@pytest.mark.parametrize("form", ["columns", "events"])
def test_parse_apsara_matches_reference(cfg, form):
    lines = _apsara_lines(4)
    if form == "columns":
        def make(pkg):
            return _split(pkg, lines)
    else:
        def make(pkg):
            return _events(pkg, [(1, {b"content": ln, b"msg": ln})
                                 for ln in lines])
    _both(make, "apsara", "ProcessorParseApsara", cfg)


# -- processor_parse_from_pb_native -----------------------------------------------

def _loggroup(pkg, seed, n):
    """LogGroup wire bytes of ``n`` log events, made by the package's own
    SLS serializer."""
    P = PKGS[pkg]
    g = P["Group"]()
    sb = g.source_buffer
    for i, line in enumerate(td.gen_lines(n, seed=seed)):
        ev = g.add_log_event(1700000000 + i)
        ev.set_content(b"content", sb.copy_string(line))
        ev.set_content(b"idx", sb.copy_string(b"%d" % i))
    g.set_tag("host", "h%d" % seed)
    return P["SLS"](topic=b"t", source=b"s").serialize([g])


@pytest.mark.parametrize("source_key", ["content", "payload"])
def test_parse_from_pb_matches_reference(source_key):
    payloads = [_loggroup("port", s, 20 + s) for s in range(3)]
    assert payloads == [_loggroup("ref", s, 20 + s) for s in range(3)]

    def make(pkg):
        P = PKGS[pkg]
        g = P["Group"]()
        sb = g.source_buffer
        g.add_raw_event(5).set_content(sb.copy_string(payloads[0]))
        ev = g.add_log_event(6)
        ev.set_content(source_key.encode(), sb.copy_string(payloads[1]))
        ev = g.add_log_event(7)
        ev.set_content(b"other", sb.copy_string(b"kept"))
        g.add_raw_event(8).set_content(sb.copy_string(b"\x0a\xff\xff"))
        g.add_raw_event(9).set_content(sb.copy_string(payloads[2]))
        g.add_metric_event(10)
        return g
    got = _both(make, "pb", "ProcessorParseFromPB",
                {"SourceKey": source_key})
    assert len(got) > 60
