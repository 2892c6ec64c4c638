"""``processor_spl``: the port's ``processor/spl.py`` against the JAX
package's, on the CPU.

Every case of the JAX package's ``tests/test_spl.py`` is a case of one
parametrised test (``CASES``): the same script on the same input (lines
split into a columnar group, a parsed columnar group, or log events)
through both packages' processors gives the same ``init`` result and the
same columns or events, bytes for bytes.  Beside them: the SPL stages of
the shipped ``spl_enrich_join.yaml`` and the Apache script of the chip's
SPL phase (a Tier-1 parse, a Tier-1 and a DFA-tier ``matches``, an
``extend`` with ``if``) on seeded logs, the float formatting of ``stats``
and ``extend`` on seeded numbers, and both agents on the two configs.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from loongcollector_tpu.models import ColumnarLogs as RefColumnar
from loongcollector_tpu.models import PipelineEventGroup as RefGroup
from loongcollector_tpu.models import SourceBuffer as RefSourceBuffer
from loongcollector_tpu.pipeline.plugin.interface import \
    PluginContext as RefContext
from loongcollector_tpu.processor import spl as ref_spl
from loongcollector_tpu.processor.parse_regex import \
    ProcessorParseRegex as RefParse
from loongcollector_tpu.processor.split_log_string import \
    ProcessorSplitLogString as RefSplit
from loongcollector_tpu_torch import testdata as td
from loongcollector_tpu_torch.models import (ColumnarLogs, PipelineEventGroup,
                                             SourceBuffer)
from loongcollector_tpu_torch.ops.regex.program import PatternTier
from loongcollector_tpu_torch.pipeline.plugin.interface import PluginContext
from loongcollector_tpu_torch.processor import spl as port_spl
from loongcollector_tpu_torch.processor.parse_regex import ProcessorParseRegex
from loongcollector_tpu_torch.processor.split_log_string import \
    ProcessorSplitLogString
from test_torch_alarms import alarms_left_empty  # noqa: F401
from test_torch_container import containers_left_empty  # noqa: F401
from test_torch_container import snapshot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TIME = re.compile(rb'"__time__": \d+')

PKGS = {
    "ref": (RefGroup, RefSourceBuffer, RefColumnar, RefSplit, RefParse,
            ref_spl, lambda: RefContext("t")),
    "port": (PipelineEventGroup, SourceBuffer, ColumnarLogs,
             ProcessorSplitLogString, ProcessorParseRegex, port_spl,
             lambda: PluginContext("t", device=torch.device("cpu"))),
}


def _lines(pkg, data, parse=None):
    Group, Buf, _C, Split, Parse, _spl, Ctx = PKGS[pkg]
    sb = Buf(len(data) + 64)
    g = Group(sb)
    g.add_raw_event(100).set_content(sb.copy_string(data))
    split = Split()
    split.init({}, Ctx())
    split.process(g)
    if parse is not None:
        p = Parse()
        assert p.init({"SourceKey": "content", "Regex": parse[0],
                       "Keys": parse[1]}, Ctx())
        p.process(g)
    return g


def _rows(pkg, rows, ts=1700000000):
    Group, Buf, *_ = PKGS[pkg]
    g = Group(Buf(4096))
    sb = g.source_buffer
    for i, row in enumerate(rows):
        t, fields = row if isinstance(row, tuple) else (ts, row)
        ev = g.add_log_event(t)
        for k, v in fields.items():
            ev.set_content(sb.copy_string(k.encode()),
                           sb.copy_string(v.encode()))
    return g


def _uid_columns(pkg):
    """The columnar group of ``test_inner_join_on_columnar_group_drops_all``."""
    Group, Buf, Columnar, *_ = PKGS[pkg]
    data = b"uid=7\nuid=8\n"
    sb = Buf(len(data) + 64)
    view = sb.copy_string(data)
    g = Group(sb)
    cols = Columnar(np.array([view.offset, view.offset + 6], np.int32),
                    np.array([5, 5], np.int32),
                    np.full(2, 1700000000, dtype=np.int64))
    cols.set_field("uid", np.array([view.offset + 4, view.offset + 10],
                                   np.int32), np.array([1, 1], np.int32))
    g.set_columns(cols)
    return g


TABLE = "uid,team,region\n42,core,eu\n7,infra,us\n"

# (case, script, input): input is ("lines", bytes[, (regex, keys)]),
# ("rows", [dict or (ts, dict)]), ("uid_columns",).  ``{table}`` in a
# script is a CSV of TABLE in the test's tmp dir.
CASES = [
    ("parse_where_project",
     r"* | parse content with regex '(?P<level>\w+) (?P<msg>.*)'"
     r" | where level = 'ERROR' | project level, msg",
     ("lines", b"ERROR disk full\nINFO fine\nERROR cpu hot\n")),
    ("where_matches_device",
     r"* | parse content with regex '(?P<path>\S+) (?P<code>\d+)'"
     r" | where path matches '/api/.*'",
     ("lines", b"/api/users 200\n/static/x 200\n/api/pay 500\n")),
    ("numeric_comparison",
     r"* | parse content with regex '(?P<name>\w+)=(?P<ms>\d+)'"
     r" | where ms > 100", ("lines", b"a=250\nb=50\nc=101\n")),
    ("extend_concat_and_rename",
     r"* | parse content with regex '(?P<h>\w+):(?P<l>\w+)'"
     r" | extend combo = concat(h, '-', l) | rename combo as id"
     r" | project id", ("lines", b"n1:ERROR\nn2:WARN\n")),
    ("limit", "* | limit 2", ("lines", b"a\nb\nc\nd\n")),
    ("contains", "* | where content contains 'needle'",
     ("lines", b"has needle here\nnothing\nneedle again\n")),
    ("unsupported_stage_fails_init", "* | frobnicate x",
     ("lines", b"a\n")),
    ("bad_regex_fails_init", "* | parse content with regex '('",
     ("lines", b"a\n")),
    ("pipe_inside_regex_literal",
     r"* | parse content with regex '(?P<m>GET|POST) (?P<p>\S+)'"
     r" | where m = 'POST'", ("lines", b"GET /a\nPOST /b\n")),
    ("gte_lte_operators",
     r"* | parse content with regex '(?P<n>\d+)' | where n >= 100"
     r" | where n <= 100", ("lines", b"99\n100\n101\n")),
    ("concat_with_comma_literal",
     r"* | parse content with regex '(?P<a>\w+) (?P<b>\w+)'"
     r" | extend x = concat(a, ', ', b) | project x",
     ("lines", b"hello world\n")),
    ("stats_count_by", "* | stats count() by level",
     ("rows", [(1, {"level": "E"}), (2, {"level": "I"}),
               (3, {"level": "E"})])),
    ("stats_sum_avg_min_max",
     "* | stats sum(lat), avg(lat), min(lat), max(lat) as peak",
     ("rows", [(1, {"lat": "10"}), (2, {"lat": "30"}), (3, {"lat": "20"})])),
    ("sort_numeric_desc", "* | sort by -lat",
     ("rows", [(1, {"lat": "10", "id": "a"}), (2, {"lat": "30", "id": "b"}),
               (3, {"lat": "20", "id": "c"})])),
    ("stats_columnar_path",
     "* | stats count(), sum(lat) by level | sort by level",
     ("lines", b"E 10\nI 20\nE 30\n", (r"(\w+) (\d+)", ["level", "lat"]))),
    ("count_field_counts_non_null", "* | stats count(lat), count()",
     ("rows", [(1, {"lat": "10"}), (2, {"x": "1"}), (3, {"lat": "20"})])),
    ("nan_does_not_poison_stats_or_sort",
     "* | sort by lat | stats max(lat), min(lat), count() by id",
     ("rows", [(1, {"lat": "10", "id": "a"}), (2, {"lat": "nan", "id": "b"}),
               (3, {"lat": "5", "id": "c"})])),
    ("string_functions",
     "* | extend u = upper(name) | extend s = substring(name, 1, 2)"
     " | extend r = replace(name, 'a', 'o')"
     " | extend p = split_part(path, '/', 3)",
     ("rows", [{"name": "alice", "path": "/api/users/42"}])),
    ("nested_calls", "* | extend x = concat(upper(kind), '-', md5(kind))",
     ("rows", [{"kind": "web"}])),
    ("math_and_round",
     "* | extend total = add(a, b) | extend r = round(div(a, b), 2)",
     ("rows", [{"a": "10", "b": "4"}, {"a": "1", "b": "3"},
               {"a": "7", "b": "0"}])),
    ("if_conditional",
     "* | extend level = if(status >= 500, 'error', 'ok')",
     ("rows", [{"status": "503"}, {"status": "200"}])),
    ("json_extract_and_coalesce",
     "* | extend city = json_extract(doc, '$.addr.city')"
     " | extend who = coalesce(nick, name)",
     ("rows", [{"doc": '{"addr": {"city": "hz"}}', "name": "bob",
                "nick": ""}])),
    ("from_unixtime", "* | extend t = from_unixtime(ts, '%Y-%m-%d')",
     ("rows", [{"ts": "1700000000"}])),
    ("unknown_function_fails_compile", "* | extend x = frobnicate(a)",
     ("rows", [{"a": "1"}])),
    ("inner_join", "* | join file('{table}') on uid",
     ("rows", [{"uid": "42", "msg": "a"}, {"uid": "99", "msg": "b"}])),
    ("left_join_keeps_unmatched", "* | join type=left file('{table}') on uid",
     ("rows", [{"uid": "7"}, {"uid": "99"}])),
    ("absent_table_defers_malformed_fails",
     "* | join file('{later}') on uid", ("rows", [{"uid": "42"}])),
    ("nested_if",
     "* | extend sev = if(code >= 500, 'err', if(code >= 400, 'warn', 'ok'))",
     ("rows", [{"code": "503"}, {"code": "404"}, {"code": "200"}])),
    ("if_inside_concat",
     "* | extend m = concat('[', if(n > 1, 'many', 'one'), ']')",
     ("rows", [{"n": "5"}])),
    ("inner_join_on_columnar_group_drops_all",
     "* | join file('{table}') on uid", ("uid_columns",)),
]


def _input(pkg, spec):
    if spec[0] == "lines":
        return _lines(pkg, spec[1], spec[2] if len(spec) > 2 else None)
    if spec[0] == "rows":
        return _rows(pkg, spec[1])
    return _uid_columns(pkg)


def _run(pkg, script, spec):
    _G, _B, _C, _S, _P, spl, Ctx = PKGS[pkg]
    p = spl.ProcessorSPL()
    if not p.init({"Script": script}, Ctx()):
        return "init refused", None
    g = _input(pkg, spec)
    p.process(g)
    return snapshot(g), p


@pytest.mark.parametrize("case,script,spec", CASES, ids=[c[0] for c in CASES])
def test_spl_case_matches_reference(case, script, spec, tmp_path):
    table = tmp_path / "lookup.csv"
    table.write_text(TABLE)
    later = tmp_path / "later.csv"
    script = script.replace("{table}", str(table)).replace("{later}",
                                                           str(later))
    got, port_p = _run("port", script, spec)
    want, ref_p = _run("ref", script, spec)
    assert got == want
    if case == "absent_table_defers_malformed_fails":
        # the table ships later: the next batch joins
        later.write_text("uid,team\n42,core\n")
        rows = ("rows", [{"uid": "42"}, {"uid": "9"}])
        groups = {}
        for pkg, p in (("port", port_p), ("ref", ref_p)):
            g = _input(pkg, rows)
            p.process(g)
            groups[pkg] = snapshot(g)
        assert groups["port"] == groups["ref"]
        assert len(groups["port"]) == 1
        bad = tmp_path / "bad.csv"
        bad.write_text("wrong,header\n1,2\n")
        bad_script = f"* | join file('{bad}') on uid"
        assert _run("port", bad_script, rows)[0] == \
            _run("ref", bad_script, rows)[0] == "init refused"
    if case.endswith("fails_init") or case.endswith("fails_compile"):
        assert got == "init refused"
    else:
        assert got != "init refused"


def _numbers(seed, n=400, finite=False):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.normal(0, 1e3, n // 4),
                           rng.integers(-10**6, 10**6, n // 4),
                           rng.random(n // 4) * 10.0 ** rng.integers(
                               -8, 12, n // 4),
                           rng.choice([0.5, 1.5, 2.5, -0.5, 1e16, 3e-7,
                                       7, 0.1, 0.2], n // 4)])
    out = []
    for i, v in enumerate(vals):
        s = repr(float(v)) if i % 3 else str(int(v)) if float(
            v).is_integer() else repr(float(v))
        out.append({"k": "abcde"[i % 5], "v": s,
                    "w": repr(float(vals[(i * 7) % len(vals)]))})
    out += [{"k": "c", "v": "x"}, {"k": "d"}]
    if not finite:
        # (the expression library raises on these in both packages)
        out += [{"k": "a", "v": "nan"}, {"k": "b", "v": "inf"}]
    return out


@pytest.mark.parametrize("script", [
    "* | stats count(), sum(v), avg(v), min(v), max(v), count(w) by k"
    " | sort by k",
    "* | extend a = add(v, w) | extend d = div(v, w) | extend m = mul(v, w)"
    " | extend r = round(v, 3) | extend f = floor(v) | extend c = ceil(w)"
    " | extend p = pow(abs(v), 0.5) | extend s = sub(v, w)"
    " | extend o = mod(v, 7)"
    " | extend b = abs(w)",
    "* | sort by v desc, k | limit 50",
    "* | where v >= 0 | where v != '0' | sort by -w",
])
@pytest.mark.parametrize("seed", [1, 2])
def test_numbers_format_as_the_reference(script, seed):
    rows = _numbers(seed, finite="extend" in script)
    got, _ = _run("port", script, ("rows", rows))
    want, _ = _run("ref", script, ("rows", rows))
    assert got == want


@pytest.fixture(autouse=True)
def _host_routes_in_the_reference(monkeypatch):
    # the reference's engines take the host route on small batches; the
    # results are the same either way
    monkeypatch.setenv("LOONG_DEVICE_MIN_BYTES", str(1 << 40))


def test_apache_script_tiers_and_records_match_reference():
    lines = td.gen_lines(3000, seed=5)
    data = b"\n".join(lines) + b"\n"
    script = td.spl_apache_script()
    got, p = _run("port", script, ("lines", data))
    want, _ = _run("ref", script, ("lines", data))
    assert got == want
    tiers = [st.engine.tier for st in p.stages
             if getattr(st, "engine", None) is not None]
    assert tiers == [PatternTier.SEGMENT, PatternTier.SEGMENT,
                     PatternTier.DFA]
    # the oracle: re and the script's semantics
    named = re.compile(td.SPL_APACHE_NAMED.encode())
    status = re.compile(td.SPL_APACHE_STATUS.encode())
    url = re.compile(td.SPL_APACHE_URL.encode())
    kept = []
    for line in lines:
        m = named.fullmatch(line)
        if m and status.fullmatch(m["status"]) and url.fullmatch(m["url"]):
            kept.append((line, b"server" if int(m["status"]) >= 500
                         else b"client"))
    assert got["content"] == [k[0] for k in kept]
    assert got["kind"] == [k[1] for k in kept]
    assert 0 < len(kept) < len(lines)


def test_enrich_join_stages_match_reference(tmp_path):
    lines = td.gen_requests(2000, seed=3, users=60)
    csv_path = tmp_path / "teams.csv"
    csv_path.write_bytes(td.teams_csv(users=60, seed=3))
    script = ("* | extend sev = if(status >= 500, 'error', 'ok')"
              " | extend bucket = concat(sev, '-', round(div(latency_ms, 100)))"
              f" | join type=left file('{csv_path}') on user_id")
    spec = ("lines", b"\n".join(lines) + b"\n",
            (r"(\S+) (\d+) (\d+)", ["user_id", "status", "latency_ms"]))
    got, _ = _run("port", script, spec)
    want, _ = _run("ref", script, spec)
    assert got == want and len(got) == len(lines)


def _agents(tmp_path, name, config, monkeypatch):
    outs = {}
    for who in ("ref", "port"):
        cfg_dir = tmp_path / f"cfg_{name}_{who}"
        cfg_dir.mkdir()
        outs[who] = tmp_path / f"{name}_{who}.json"
        (cfg_dir / f"{name}.yaml").write_text(config(str(outs[who])))
        if who == "ref":
            env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
            subprocess.run([sys.executable, "-m", "loongcollector_tpu",
                            "--config", str(cfg_dir), "--once",
                            "--data-dir", str(tmp_path / f"{name}_ref_data")],
                           cwd=str(tmp_path), env=env, check=True,
                           capture_output=True, timeout=600)
        else:
            from loongcollector_tpu_torch.application import main
            assert main(["--config", str(cfg_dir), "--once", "--cpu",
                         "--data-dir", str(tmp_path / f"{name}_port_data"),
                         "--stats", str(tmp_path / f"{name}.stats")]) == 0
    with open(tmp_path / f"{name}.stats") as f:
        stats = json.load(f)
    return ([_TIME.sub(b"", x) for x in outs["port"].read_bytes().splitlines()],
            [_TIME.sub(b"", x) for x in outs["ref"].read_bytes().splitlines()],
            stats)


def test_spl_agents_agree(tmp_path, monkeypatch):
    monkeypatch.delenv("LOONG_DEVICE_MIN_BYTES")
    req = tmp_path / "requests.log"
    req.write_bytes(b"\n".join(td.gen_requests(3000, seed=8, users=80))
                    + b"\n")
    csv_path = tmp_path / "teams.csv"
    csv_path.write_bytes(td.teams_csv(users=80, seed=8))
    got, want, stats = _agents(
        tmp_path, "join", lambda out: td.spl_enrich_join_config(
            str(req), str(csv_path), out), monkeypatch)
    assert got == want and len(got) == 3000
    assert stats["stage_seconds"]["processor_spl"] > 0
    apache = tmp_path / "access.log"
    lines = td.gen_lines(3000, seed=9)
    apache.write_bytes(b"\n".join(lines) + b"\n")
    got, want, stats = _agents(
        tmp_path, "apache", lambda out: td.spl_apache_config(
            str(apache), out), monkeypatch)
    assert got == want and 0 < len(got) < len(lines)
    engines = {e["pattern"]: e for e in stats["engines"]}
    assert engines[td.SPL_APACHE_URL]["tier"] == "DFA"
    assert engines[td.SPL_APACHE_URL]["dfa_batches"] > 0
    assert engines[td.SPL_APACHE_STATUS]["device_batches"] > 0
