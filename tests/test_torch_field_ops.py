"""The port's field processors against the JAX package's, on the CPU.

``processor_add_fields``, ``processor_rename``, ``processor_drop`` and
``processor_strreplace`` on columnar groups (split Apache lines, parsed or
not) and on object groups (log events beside a span) leave the
reference's fields and events.  ``processor_drop``'s ``Match`` runs one
``match_batch`` a condition on a columnar group (Tier-1 and DFA-tier
patterns, on a parsed field and on the raw content) and compacts the
columns; its engines count those batches.
"""

import re

import numpy as np
import pytest
import torch

from loongcollector_tpu.models import PipelineEventGroup as RefGroup
from loongcollector_tpu.models import SourceBuffer as RefSourceBuffer
from loongcollector_tpu.pipeline.plugin.interface import \
    PluginContext as RefContext
from loongcollector_tpu.processor import field_ops as ref_ops
from loongcollector_tpu.processor.parse_regex import \
    ProcessorParseRegex as RefParse
from loongcollector_tpu.processor.split_log_string import \
    ProcessorSplitLogString as RefSplit
from loongcollector_tpu_torch import testdata as td
from loongcollector_tpu_torch.models import PipelineEventGroup, SourceBuffer
from loongcollector_tpu_torch.pipeline.plugin.interface import PluginContext
from loongcollector_tpu_torch.processor import field_ops
from loongcollector_tpu_torch.processor.parse_regex import \
    ProcessorParseRegex
from loongcollector_tpu_torch.processor.split_log_string import \
    ProcessorSplitLogString
from test_torch_alarms import alarms_left_empty  # noqa: F401

PKGS = {
    "ref": (RefGroup, RefSourceBuffer, RefSplit, RefParse, ref_ops,
            RefContext),
    "port": (PipelineEventGroup, SourceBuffer, ProcessorSplitLogString,
             ProcessorParseRegex, field_ops,
             lambda: PluginContext("p", device=torch.device("cpu"))),
}
CLASSES = {"add": "ProcessorAddFields", "rename": "ProcessorRenameFields",
           "drop": "ProcessorDrop", "replace": "ProcessorStrReplace"}


@pytest.fixture(autouse=True)
def _host_routes_in_the_reference(monkeypatch):
    monkeypatch.setenv("LOONG_DEVICE_MIN_BYTES", str(1 << 40))


def _lines(seed):
    rng = np.random.default_rng(seed)
    lines = td.gen_lines(300, seed=seed)
    for i in range(5, 300, 37):
        lines[i] = bytes(rng.integers(32, 127, int(rng.integers(0, 60)),
                                      dtype=np.uint8))
    return lines


def _columnar(pkg, lines, parse):
    Group, Buf, Split, Parse, _ops, Ctx = PKGS[pkg]
    data = b"\n".join(lines) + b"\n"
    sb = Buf(len(data) + 64)
    g = Group(sb)
    g.add_raw_event(1700000000).set_content(sb.copy_string(data))
    split = Split()
    split.init({}, Ctx())
    split.process(g)
    if parse:
        p = Parse()
        assert p.init({"SourceKey": "content", "Regex": td.APACHE,
                       "Keys": td.APACHE_KEYS}, Ctx())
        p.process(g)
    return g


def _objects(pkg, seed):
    Group, Buf, *_ = PKGS[pkg]
    rng = np.random.default_rng(seed)
    sb = Buf()
    g = Group(sb)
    for i in range(80):
        ev = g.add_log_event(1700000000 + i)
        ev.set_content(b"content", sb.copy_string(
            td.gen_lines(1, seed=seed * 100 + i)[0]))
        if rng.random() < 0.7:
            ev.set_content(b"url", sb.copy_string(
                td.APACHE_PATHS[int(rng.integers(len(td.APACHE_PATHS)))]))
        if rng.random() < 0.3:
            ev.set_content(b"env", sb.copy_string("staging"))
        if i % 19 == 0:
            g.add_span_event(3).name = b"span"
    return g


def _fields(group):
    cols = group.columns
    if cols is None or group._events:
        return [[(k.to_bytes(), v.to_bytes()) for k, v in ev.contents]
                if hasattr(ev, "contents") else type(ev).__name__
                for ev in group.events]
    arena = group.source_buffer.as_array()

    def col(offs, lens):
        return [bytes(arena[o: o + n].tobytes()) if n >= 0 else None
                for o, n in zip(offs, lens)]
    out = {"content": col(cols.offsets, cols.lengths),
           "content_consumed": cols.content_consumed,
           "timestamps": cols.timestamps.tolist()}
    for name, (offs, lens) in sorted(cols.fields.items()):
        out[name] = col(offs, lens)
    return out


CASES = {
    "add": {"Fields": {"env": "prod", "region": "us-west-2"}},
    "add_ignore": {"Fields": {"env": "prod", "method": "NONE"},
                   "IgnoreIfExist": True},
    "rename": {"SourceKeys": ["url", "status"], "DestKeys": ["path", "code"]},
    "rename_content": {"SourceKeys": ["content"], "DestKeys": ["line"]},
    "drop_keys": {"DropKeys": ["ident", "user", "content"]},
    "drop_match_t1": {"Match": {"url": r"/favicon\.ico|/health"}},
    "drop_match_dfa": {"Match": {"url": r"/static/.*|.*\.(?:js|png)"}},
    "drop_match_content": {"Match": {"content": r".*\" 5\d\d \d+"}},
    "drop_both": {"DropKeys": ["size"], "Match": {"method": "HEAD|PUT"}},
    "replace_regex": {"SourceKey": "url", "Match": r"\d+",
                      "ReplaceString": "{id}"},
    "replace_const": {"SourceKey": "content", "Method": "const",
                      "Match": "HTTP/1.1", "ReplaceString": "h1"},
}


def _make(pkg, case):
    *_, ops, Ctx = PKGS[pkg]
    cls = getattr(ops, CLASSES[case.split("_")[0]])
    p = cls()
    assert p.init(dict(CASES[case]), Ctx())
    return p


@pytest.mark.parametrize("parse", [True, False], ids=["parsed", "raw"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_columnar_equals_reference(case, parse):
    lines = _lines(len(case))
    out = {}
    for pkg in PKGS:
        g = _columnar(pkg, lines, parse)
        p = _make(pkg, case)
        if pkg == "port":
            for _key, eng in getattr(p, "conditions", []):
                eng.reset_counts()
        p.process(g)
        out[pkg] = (_fields(g), p)
    assert out["port"][0] == out["ref"][0]
    port = out["port"][1]
    for key, eng in getattr(port, "conditions", []):
        # one batch where the condition's field exists: a parsed field, or
        # the content before a parse consumed it
        assert eng.device_batches + eng.dfa_batches \
            == int((key == b"content") != parse)
        assert eng.re_tier_rows == eng.dfa_re_rows == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_objects_equal_reference(case):
    out = {}
    for pkg in PKGS:
        g = _objects(pkg, len(case))
        _make(pkg, case).process(g)
        out[pkg] = _fields(g)
    assert out["port"] == out["ref"]


def test_drop_match_drops_what_re_matches():
    lines = _lines(4)
    g = _columnar("port", lines, True)
    _make("port", "drop_match_t1").process(g)
    rx = re.compile(td.APACHE.encode())
    want = [m.group(6) if m else None for m in map(rx.fullmatch, lines)]
    want = [u for u in want if u not in (b"/favicon.ico", b"/health")]
    assert _fields(g)["url"] == want


@pytest.mark.parametrize("kind,cfg", [
    ("add", {}), ("rename", {"SourceKeys": ["a"], "DestKeys": []}),
    ("drop", {}), ("replace", {"SourceKey": "x"}),
    ("replace", {"Match": "(", "Method": "regex"})])
def test_refused_configs_equal_reference(kind, cfg):
    got = {}
    for pkg in PKGS:
        *_, ops, Ctx = PKGS[pkg]
        got[pkg] = getattr(ops, CLASSES[kind])().init(dict(cfg), Ctx())
    assert got["port"] is got["ref"] is False
