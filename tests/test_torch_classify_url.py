"""``processor_classify_url`` in the port against the JAX package's, on the
CPU, and the URL-classified Apache path end to end.

* The reference's own case (``tests/test_ebpf_forward.py``: four urls,
  three rules, a columnar group) and a seeded sweep of Apache groups
  (``gen_lines`` with unparsable lines, parsed, then classified by
  ``testdata.URL_RULES``) leave the reference's fields.
* The first matching rule wins, and each rule runs only over the rows no
  earlier rule took: the rows each engine's ``match_batch`` is given.
* Object groups (log events with and without the source field, beside
  span and metric events) are classified on Python ``re`` as the
  reference's are, and counted in ``re_rows``.
* ``url_classify_config`` through ``python -m loongcollector_tpu_torch
  --cpu --once`` writes the JAX agent's NDJSON (each agent with its own
  data dir), which equals ``url_classify_oracle``; ``--stats`` shows the
  rules on their tiers (Tier-1, the DFA tier for ``static``) and no rule
  row on ``re``.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from loongcollector_tpu.models import PipelineEventGroup as RefGroup
from loongcollector_tpu.models import SourceBuffer as RefSourceBuffer
from loongcollector_tpu.pipeline.plugin.interface import \
    PluginContext as RefContext
from loongcollector_tpu.processor.classify_url import \
    ProcessorClassifyUrl as RefClassify
from loongcollector_tpu.processor.parse_regex import \
    ProcessorParseRegex as RefParse
from loongcollector_tpu.processor.split_log_string import \
    ProcessorSplitLogString as RefSplit
from loongcollector_tpu_torch import testdata as td
from loongcollector_tpu_torch.models import PipelineEventGroup, SourceBuffer
from loongcollector_tpu_torch.pipeline.plugin.interface import PluginContext
from loongcollector_tpu_torch.processor.classify_url import \
    ProcessorClassifyUrl
from loongcollector_tpu_torch.processor.parse_regex import \
    ProcessorParseRegex
from loongcollector_tpu_torch.processor.split_log_string import \
    ProcessorSplitLogString

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = [{"Name": n, "Regex": r} for n, r in td.URL_RULES]
_TIME = re.compile(rb'"__time__": \d+')

PKGS = {
    "ref": (RefGroup, RefSourceBuffer, RefSplit, RefParse, RefClassify,
            RefContext),
    "port": (PipelineEventGroup, SourceBuffer, ProcessorSplitLogString,
             ProcessorParseRegex, ProcessorClassifyUrl,
             lambda: PluginContext("p", device=torch.device("cpu"))),
}


@pytest.fixture(autouse=True)
def _host_routes_in_the_reference(monkeypatch):
    monkeypatch.setenv("LOONG_DEVICE_MIN_BYTES", str(1 << 40))


def _split(pkg, data):
    Group, Buf, Split, _p, _c, Ctx = PKGS[pkg]
    sb = Buf(len(data) + 64)
    g = Group(sb)
    g.add_raw_event(1700000000).set_content(sb.copy_string(data))
    split = Split()
    split.init({}, Ctx())
    split.process(g)
    return g


def _fields(group):
    cols = group.columns
    arena = group.source_buffer.as_array()

    def col(offs, lens):
        return [bytes(arena[o: o + n].tobytes()) if n >= 0 else None
                for o, n in zip(offs, lens)]
    out = {"content": col(cols.offsets, cols.lengths),
           "content_consumed": cols.content_consumed}
    for name, (offs, lens) in sorted(cols.fields.items()):
        out[name] = col(offs, lens)
    return out


def _classify(pkg, cfg):
    *_, Classify, Ctx = PKGS[pkg]
    p = Classify()
    assert p.init(cfg, Ctx())
    return p


def test_reference_case_columnar():
    data = b"/api/v1/users\n/static/app.js\n/checkout/pay\n/zzz\n"
    cfg = {"SourceKey": "content",
           "Rules": [{"Name": "api", "Regex": r"/api/.*"},
                     {"Name": "static", "Regex": r"/static/.*|.*\.js"},
                     {"Name": "checkout", "Regex": r"/checkout.*"}]}
    out = {}
    for pkg in PKGS:
        g = _split(pkg, data)
        _classify(pkg, cfg).process(g)
        out[pkg] = _fields(g)
    assert out["port"] == out["ref"]
    assert out["port"]["category"] == [b"api", b"static", b"checkout",
                                       b"other"]


def _apache_lines(seed):
    rng = np.random.default_rng(seed)
    lines = td.gen_lines(500, seed=seed)
    for i in range(7, 500, 41):                 # lines the parse refuses
        lines[i] = bytes(rng.integers(32, 127, int(rng.integers(0, 80)),
                                      dtype=np.uint8))
    paths = [b"/static/site.css", b"/api/v1/", b"/api/v2/orders/x",
             b"/api/v1/app.js", b"/healthz", b"/x.js"]
    for i in range(3, 500, 29):                 # urls at the rules' edges
        lines[i] = re.sub(rb'"(\S+) \S+ ', b'"\\1 ' + paths[i % len(paths)]
                          + b" ", lines[i], count=1)
    return lines


@pytest.mark.parametrize("seed,chunk", [(0, 500), (1, 97), (2, 64),
                                        (3, 251)])
def test_apache_sweep_equals_reference(seed, chunk):
    lines = _apache_lines(seed)
    cfg = {"SourceKey": "url", "TargetKey": "category",
           "DefaultCategory": "other", "Rules": RULES}
    parse_cfg = {"SourceKey": "content", "Regex": td.APACHE,
                 "Keys": td.APACHE_KEYS}
    cats = []
    for i in range(0, len(lines), chunk):
        data = b"\n".join(lines[i: i + chunk]) + b"\n"
        out = {}
        for pkg in PKGS:
            *_, Parse, _c, Ctx = PKGS[pkg]
            parse = Parse()
            assert parse.init(parse_cfg, Ctx())
            g = _split(pkg, data)
            parse.process(g)
            _classify(pkg, cfg).process(g)
            out[pkg] = _fields(g)
        assert out["port"] == out["ref"]
        cats += [(u, c) for u, c in zip(out["port"]["url"],
                                        out["port"]["category"])]
    want = [(None, None) if m is None else
            (m.group(6), td.url_category(m.group(6)).encode())
            for m in map(re.compile(td.APACHE.encode()).fullmatch, lines)]
    assert cats == want
    assert {c for _u, c in cats} == {None, b"api", b"static", b"health",
                                     b"other"}


def test_first_rule_wins_over_the_rows_left():
    """Each rule's engine is given only the rows no earlier rule took."""
    urls = [b"/api/v1/app.js", b"/static/a.css", b"/health", b"/api/v1/x",
            b"/index.html", b"/y.js"]
    g = _split("port", b"\n".join(urls) + b"\n")
    p = _classify("port", {"SourceKey": "content", "Rules": RULES})
    seen = []
    for _name, eng in p.rules:
        orig = eng.match_batch

        def spy(arena, offs, lens, orig=orig):
            seen.append([bytes(arena[o: o + n].tobytes())
                         for o, n in zip(offs, lens)])
            return orig(arena, offs, lens)
        eng.match_batch = spy
    try:
        p.process(g)
    finally:
        for _name, eng in p.rules:
            del eng.match_batch
    assert seen == [urls, [urls[i] for i in (1, 2, 4, 5)],
                    [urls[2], urls[4]]]
    assert _fields(g)["category"] == [b"api", b"static", b"health", b"api",
                                      b"other", b"static"]


def _object_group(pkg, seed):
    Group, Buf, *_ = PKGS[pkg]
    rng = np.random.default_rng(seed)
    sb = Buf()
    g = Group(sb)
    paths = td.APACHE_PATHS + ["/static/x.css", "/api/v1/", "/nope"]
    for i in range(120):
        ev = g.add_log_event(1700000000 + i)
        ev.set_content(b"pid", sb.copy_string(str(i)))
        if rng.random() < 0.8:
            ev.set_content(b"path", sb.copy_string(
                paths[int(rng.integers(len(paths)))]))
        if i % 17 == 0:
            g.add_span_event(5).name = b"GET /x"
        if i % 23 == 0:
            g.add_metric_event(5).set_name(b"m")
    return g


def _object_fields(group):
    return [[(k.to_bytes(), v.to_bytes()) for k, v in ev.contents]
            if hasattr(ev, "contents") else type(ev).__name__
            for ev in group.events]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_object_groups_equal_reference(seed):
    cfg = {"SourceKey": "path", "TargetKey": "category",
           "DefaultCategory": "misc", "Rules": RULES}
    out = {}
    for pkg in PKGS:
        g = _object_group(pkg, seed)
        p = _classify(pkg, cfg)
        if pkg == "port":
            for _name, eng in p.rules:
                eng.reset_counts()
        p.process(g)
        out[pkg] = (_object_fields(g), p)
    assert out["port"][0] == out["ref"][0]
    with_path = sum(1 for ev in out["port"][0]
                    if isinstance(ev, list) and dict(ev).get(b"path"))
    assert out["port"][1].re_rows == with_path > 0
    for _name, eng in out["port"][1].rules:
        assert eng.device_batches == eng.dfa_batches == 0


def test_refuses_a_rule_without_name_or_regex():
    for pkg in PKGS:
        *_, Classify, Ctx = PKGS[pkg]
        assert not Classify().init({"Rules": [{"Name": "a"}]}, Ctx())
        assert not Classify().init({"Rules": []}, Ctx())


def _agent(who, cfg_dir, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    if who == "ref":
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


def test_agents_agree_end_to_end(tmp_path):
    lines = _apache_lines(9) + td.gen_lines(3000, seed=10)
    log = tmp_path / "access.log"
    log.write_bytes(b"\n".join(lines) + b"\n")
    outs = {}
    for who in ("ref", "port"):
        cfg_dir = tmp_path / f"cfg_{who}"
        cfg_dir.mkdir()
        out = tmp_path / f"out_{who}.json"
        (cfg_dir / "p.yaml").write_text(td.url_classify_config(str(log),
                                                               str(out)))
        _agent(who, cfg_dir, tmp_path)
        outs[who] = out.read_bytes()
    got = _TIME.sub(b'"__time__": 0', outs["port"])
    assert got == _TIME.sub(b'"__time__": 0', outs["ref"])
    recs = [json.loads(x) for x in got.splitlines()]
    for r in recs:
        del r["__time__"]
    assert recs == td.url_classify_oracle(lines)
    stats = json.loads((tmp_path / "stats.json").read_text())
    engines = {e["pattern"]: e for e in stats["engines"]}
    tiers = {name: engines[rx]["tier"] for name, rx in td.URL_RULES}
    assert tiers == {"api": "SEGMENT", "static": "DFA", "health": "SEGMENT"}
    for _name, rx in td.URL_RULES + [("drop", td.URL_DROP)]:
        e = engines[rx]
        assert e["re_tier_rows"] == e["dfa_re_rows"] == 0, rx
        assert e["re_oversize_rows"] == 0, rx
        assert e["device_batches"] + e["dfa_batches"] > 0, rx
    assert stats["classify"]["re_rows"] == 0
    assert stats["ebpf"] is None
