"""Grok, the filter and the engine's ``match_batch`` in the port against the
JAX package's, on the CPU.

* ``grok.expand`` gives the reference's regex for every default pattern,
  with custom patterns, and refuses what it refuses.
* ``processor_grok`` (one ``Match`` pattern, and several, which take the
  fused set) and ``processor_filter_native`` (Include and Exclude over
  Tier-1, DFA-tier and ``re``-tier patterns, on the raw content and on a
  parsed field) leave the reference's fields and rows.
* ``RegexEngine.match_batch`` at each tier equals the reference's, rows
  over the largest bucket included, with the port's counts of K2 batches
  and ``re`` rows.
"""

import re

import numpy as np
import pytest
import torch

from loongcollector_tpu.models import PipelineEventGroup as RefGroup
from loongcollector_tpu.models import SourceBuffer as RefSourceBuffer
from loongcollector_tpu.ops.regex import grok as ref_grok
from loongcollector_tpu.ops.regex.engine import RegexEngine as RefEngine
from loongcollector_tpu.pipeline.plugin.interface import \
    PluginContext as RefContext
from loongcollector_tpu.processor.filter import ProcessorFilter as RefFilter
from loongcollector_tpu.processor.grok import ProcessorGrok as RefGrok
from loongcollector_tpu.processor.parse_regex import \
    ProcessorParseRegex as RefParse
from loongcollector_tpu.processor.split_log_string import \
    ProcessorSplitLogString as RefSplit
from loongcollector_tpu_torch.models import PipelineEventGroup, SourceBuffer
from loongcollector_tpu_torch.ops.regex import grok
from loongcollector_tpu_torch.ops.regex.engine import RegexEngine
from loongcollector_tpu_torch.ops.regex.program import PatternTier
from loongcollector_tpu_torch.pipeline.plugin.interface import PluginContext
from loongcollector_tpu_torch.processor.filter import ProcessorFilter
from loongcollector_tpu_torch.processor.grok import ProcessorGrok
from loongcollector_tpu_torch.processor.parse_regex import \
    ProcessorParseRegex
from loongcollector_tpu_torch.processor.split_log_string import \
    ProcessorSplitLogString
from loongcollector_tpu_torch.testdata import (JAVA_FILTER, JAVA_PARSE,
                                               gen_java_log, gen_lines)


@pytest.fixture(autouse=True)
def _host_routes_in_the_reference(monkeypatch):
    monkeypatch.setenv("LOONG_DEVICE_MIN_BYTES", str(1 << 40))


@pytest.mark.parametrize("name", sorted(ref_grok.DEFAULT_PATTERNS))
def test_expand_equals_reference(name):
    assert grok.expand("%{" + name + "}") \
        == ref_grok.expand("%{" + name + "}")
    assert grok.expand("x %{" + name + ":f.a} y") \
        == ref_grok.expand("x %{" + name + ":f.a} y")


def test_expand_custom_and_errors():
    custom = {"ID": r"[a-z]{2}\d+", "PAIR": r"%{ID:left}=%{ID:right}"}
    assert grok.expand("%{PAIR} %{INT:n}", custom) \
        == ref_grok.expand("%{PAIR} %{INT:n}", custom)
    with pytest.raises(grok.GrokError, match="unknown"):
        grok.expand("%{NOPE}")
    with pytest.raises(grok.GrokError, match="too deep"):
        grok.expand("%{LOOP}", {"LOOP": "a%{LOOP}"})


def _groups(lines, chunk=97):
    """The same lines as columnar groups of both packages."""
    out = []
    for pkg in ("ref", "port"):
        Group, Buf, Split, ctx = (
            (RefGroup, RefSourceBuffer, RefSplit, RefContext())
            if pkg == "ref" else
            (PipelineEventGroup, SourceBuffer, ProcessorSplitLogString,
             PluginContext("p", device=torch.device("cpu"))))
        split = Split()
        split.init({}, ctx)
        groups = []
        for i in range(0, len(lines), chunk):
            data = b"\n".join(lines[i: i + chunk]) + b"\n"
            sb = Buf(len(data) + 64)
            g = Group(sb)
            g.add_raw_event(1700000000).set_content(sb.copy_string(data))
            split.process(g)
            groups.append(g)
        out.append((groups, ctx))
    return out


def _fields(group):
    cols = group.columns
    arena = group.source_buffer.as_array()

    def col(offs, lens):
        return [bytes(arena[o: o + n].tobytes()) if n >= 0 else None
                for o, n in zip(offs, lens)]
    out = {"content": col(cols.offsets, cols.lengths),
           "parse_ok": None if cols.parse_ok is None
           else cols.parse_ok.tolist(),
           "content_consumed": cols.content_consumed}
    for name, (offs, lens) in sorted(cols.fields.items()):
        out[name] = col(offs, lens)
    return out


def _apache_corpus(seed):
    rng = np.random.default_rng(seed)
    lines = gen_lines(400, seed=seed)
    for i in range(0, 400, 23):
        lines[i] = bytes(rng.integers(32, 127, int(rng.integers(0, 90)),
                                      dtype=np.uint8))
    lines[5] = lines[5].replace(b" HTTP/", b"/" + b"q" * 4500 + b" HTTP/")
    lines[6] = b"k=1 x"
    return lines


@pytest.mark.parametrize("match", [
    "%{COMMONAPACHELOG}",
    ["%{COMMONAPACHELOG}", r"%{WORD:key}=%{INT:val} %{GREEDYDATA:rest}"],
    [r"%{IPV4:ip} %{GREEDYDATA:rest}", "%{COMMONAPACHELOG}"],
])
def test_grok_equals_reference(match):
    lines = _apache_corpus(3)
    (ref_groups, ref_ctx), (groups, ctx) = _groups(lines)
    cfg = {"Match": match}
    ref, port = RefGrok(), ProcessorGrok()
    assert ref.init(cfg, ref_ctx) and port.init(cfg, ctx)
    assert (port._fused_set is None) == isinstance(match, str)
    for rg, g in zip(ref_groups, groups):
        ref.process(rg)
        port.process(g)
        assert _fields(g) == _fields(rg)
    fs = port._fused_set
    if fs is not None:
        # K4 when the set fits the device caps, else the host scanner
        assert (fs.device_batches, fs.host_rows) == (
            (len(groups), 1) if fs.fdfa.device_ok else (0, len(lines)))


FILTERS = [
    {"Include": {"content": JAVA_FILTER}},                       # DFA tier
    {"Include": {"content": r"\d{4}-\d{2}-\d{2} [\d:]+ (\w+) .*"}},  # Tier-1
    {"Exclude": {"content": r"(a+)+\1"}},                        # re tier
    {"Include": {"message": JAVA_FILTER},                        # a field
     "Exclude": {"level": r"(?:WARN|INFO)"}},
]


@pytest.mark.parametrize("cfg", range(len(FILTERS)))
def test_filter_equals_reference(cfg):
    lines = gen_java_log(800, seed=cfg)
    lines[3] = b"aa" * 3000 + b"a"                 # over the largest bucket
    lines[4] = b"x Exception " + b"y" * 4200
    (ref_groups, ref_ctx), (groups, ctx) = _groups(lines, chunk=150)
    parse_cfg = {"Regex": JAVA_PARSE, "Keys": ["time", "level", "message"]}
    ref, port = RefFilter(), ProcessorFilter()
    assert ref.init(FILTERS[cfg], ref_ctx) and port.init(FILTERS[cfg], ctx)
    needs_parse = "message" in FILTERS[cfg].get("Include", {})
    rp, pp = RefParse(), ProcessorParseRegex()
    assert rp.init(parse_cfg, ref_ctx) and pp.init(parse_cfg, ctx)
    kept = 0
    for rg, g in zip(ref_groups, groups):
        if needs_parse:
            rp.process(rg)
            pp.process(g)
        ref.process(rg)
        port.process(g)
        assert _fields(g) == _fields(rg)
        kept += len(g.columns)
    assert 0 < kept < len(lines)


def _layout(lines):
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines) or b"\0", np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    return arena, offs, lens


@pytest.mark.parametrize("pattern,tier", [
    (r"\d{4}-\d{2}-\d{2} .*", PatternTier.SEGMENT),
    (JAVA_FILTER, PatternTier.DFA),
    (r"(?:ab|a)+c", PatternTier.DFA),
    (r"(\w)\1.*", PatternTier.CPU),
])
def test_match_batch_equals_reference(monkeypatch, pattern, tier):
    from loongcollector_tpu_torch.ops.kernels import dfa_scan
    monkeypatch.setattr(dfa_scan, "MAX_BATCH", 512)
    lines = gen_java_log(1200, seed=4) + [b"abababc", b"aac", b"zz top"]
    lines += [b"2024-01-01 " + b"Error" * 900, b"ab" * 2100 + b"c"]
    arena, offs, lens = _layout(lines)
    ref = RefEngine(pattern).match_batch(arena, offs, lens)
    eng = RegexEngine(pattern, device="cpu")
    assert eng.tier is tier
    got = eng.match_batch(arena, offs, lens)
    np.testing.assert_array_equal(got, np.asarray(ref))
    rx = re.compile(pattern.encode())
    assert got.tolist() == [rx.fullmatch(x) is not None for x in lines]
    assert got.any() and not got.all()
    over = int((lens > 4096).sum())
    if tier is PatternTier.DFA:
        assert eng.dfa_batches == -(-(len(lines) - over) // 512)
        assert eng.dfa_re_rows == over == 2
        assert eng.re_tier_rows == 0 == eng.device_batches
    elif tier is PatternTier.SEGMENT:
        assert eng.device_batches > 0 and eng.re_oversize_rows == over
        assert eng.dfa_batches == 0
    else:
        assert eng.re_tier_rows == len(lines) and eng.dfa_batches == 0


@pytest.mark.parametrize("threads", [1, 4])
def test_grok_nginx_once_cpu_equals_oracle(tmp_path, monkeypatch, threads):
    """``grok_nginx.yaml`` as shipped, with only FilePaths and the sink
    changed: every record carries ``expand("%{COMMONAPACHELOG}")``'s named
    groups by ``re``, in file order."""
    import json
    import os
    from loongcollector_tpu_torch.application import main as port_main
    monkeypatch.setenv("LOONG_PROCESS_THREADS", str(threads))
    lines = _apache_corpus(9)
    log_path = str(tmp_path / "nginx.log")
    with open(log_path, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")
    out_path = str(tmp_path / "out.json")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "example_config", "quick_start",
                           "grok_nginx.yaml")) as f:
        text = f.read()
    text = text.replace("/tmp/loongcollector_demo/nginx.log", log_path)
    text = text.replace("  - Type: flusher_stdout",
                        f"  - Type: flusher_file\n    FilePath: {out_path}")
    (tmp_path / "cfg").mkdir()
    (tmp_path / "cfg" / "grok_nginx.yaml").write_text(text)
    stats = str(tmp_path / "stats.json")
    assert port_main(["--config", str(tmp_path / "cfg"), "--once", "--cpu",
                      "--stats", stats]) == 0
    rx = re.compile(grok.expand("%{COMMONAPACHELOG}").encode())
    with open(out_path, "rb") as f:
        got = [json.loads(x) for x in f]
    assert len(got) == len(lines)
    for line, rec in zip(lines, got):
        m = rx.fullmatch(line)
        if m is None:
            assert rec["rawLog"] == line.decode()
            continue
        want = {k: v.decode() for k, v in m.groupdict().items()
                if v is not None}
        assert {k: rec[k] for k in rx.groupindex if k in rec} == want
    with open(stats) as f:
        st = json.load(f)
    assert st["device_batches"] == st["plane"]["dispatches"] > 0
    assert st["re_oversize_rows"] == 1
