"""Resident stage fusion in the port against the JAX package, on the CPU.

* The plain K7 (``ops/fused_pipeline.build_fused_fn``) equals the JAX
  package's ``build_fused_fn``, jitted on the CPU, bit-exact on every
  output, on the stage lists of ``testdata.fused_stage_lists`` (all but the
  over-budget one, whose point is the card's shared memory).  Each
  package's specs are its own, built from the same patterns; the
  THREE_STAGE and Apache-filter lists come from each package's planner,
  whose stage identities must agree.
* Whole pipelines with ``LOONG_FUSED=1``: THREE_STAGE, the Apache-filter
  processors on 2,000 lines, and grok behind a source filter.  Three
  snapshots are byte-identical: the port fused, the port with
  ``LOONG_FUSED=0``, and the JAX package fused (the reference's own
  snapshot, ``tests/test_fused_pipeline.py``).
* Planning mirrors the reference's ``TestPlanning``: an unbindable filter
  or a consumed source ends a run, the multiline classify is terminal,
  ``LOONG_FUSED=0`` runs per-stage, a group holding a row over 4096 bytes
  runs per-stage.
* One dispatch per chunk (``dispatch_count`` = the plane's dispatches), the
  tuner's floors keyed per program, a failing program releasing every slot
  and byte of budget, and the Apache-filter config end to end through the
  CLI (``--once --cpu``) against its ``re`` oracle.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from loongcollector_tpu import models as ref_models
from loongcollector_tpu.ops import device_stream as ref_stream
from loongcollector_tpu.ops import fused_pipeline as ref_fp
from loongcollector_tpu.ops.device_plane import DevicePlane as RefPlane
from loongcollector_tpu.ops.regex.dfa import compile_dfa as ref_compile_dfa
from loongcollector_tpu.ops.regex.fuse import compile_fused as ref_fused
from loongcollector_tpu.ops.regex.program import compile_tier1 as ref_tier1
from loongcollector_tpu.pipeline.pipeline import \
    CollectionPipeline as RefPipeline
from loongcollector_tpu_torch import models
from loongcollector_tpu_torch import testdata as td
from loongcollector_tpu_torch.application import main as port_main
from loongcollector_tpu_torch.ops import device_stream
from loongcollector_tpu_torch.ops import fused_pipeline as fp
from loongcollector_tpu_torch.ops.device_batch import pack_rows
from loongcollector_tpu_torch.ops.device_plane import (DevicePlane,
                                                       mem_live_bytes)
from loongcollector_tpu_torch.pipeline.fused_chain import (FusionPlanContext,
                                                           plan_fusion)
from loongcollector_tpu_torch.pipeline.pipeline import CollectionPipeline

CPU = torch.device("cpu")
RX = td.THREE_STAGE_RX
THREE_STAGE = {
    "inputs": [],
    "processors": [
        {"Type": "processor_filter_native",
         "Include": {"content": td.THREE_STAGE_SOURCE}},
        {"Type": "processor_parse_regex_tpu", "Regex": RX,
         "Keys": ["word", "num"]},
        {"Type": "processor_filter_native",
         "Include": {"num": td.THREE_STAGE_NUM}},
    ],
    "flushers": [{"Type": "flusher_stdout"}],
}
LINES = [b"abc 123", b"nope!", b"zz 15", b"yy 25", b"q 1", b"mixed 9x",
         b"deep 1000"]
EXPECT = [(b"abc", b"123"), (b"zz", b"15"), (b"q", b"1"),
          (b"deep", b"1000")]
APACHE_FILTER = {
    "inputs": [],
    "processors": [
        {"Type": "processor_parse_regex_tpu", "SourceKey": "content",
         "Regex": td.APACHE, "Keys": list(td.APACHE_KEYS)},
        {"Type": "processor_filter_native",
         "Include": dict(td.APACHE_FILTER_INCLUDE),
         "Exclude": dict(td.APACHE_FILTER_EXCLUDE)},
    ],
    "flushers": [{"Type": "flusher_stdout"}],
}
GROK = {
    "inputs": [],
    "processors": [
        {"Type": "processor_filter_native", "Include": {"content": r"\w+ .*"}},
        {"Type": "processor_grok", "Match": list(td.GROK_SET)},
    ],
    "flushers": [{"Type": "flusher_stdout"}],
}
GROK_LINES = [b"abc 123", b"abc def", b"!!", b"zz 9", b"x y z", b"q 7"]


@pytest.fixture(autouse=True)
def _fused_env(monkeypatch):
    monkeypatch.setenv("LOONG_FUSED", "1")
    prev = ref_models.set_columnar_enabled(True)
    prev_port = models.set_columnar_enabled(True)
    for reset in (DevicePlane.reset_for_testing, RefPlane.reset_for_testing,
                  device_stream.reset_for_testing,
                  ref_stream.reset_for_testing, fp.reset_for_testing,
                  ref_fp.reset_for_testing):
        reset()
    yield
    ref_models.set_columnar_enabled(prev)
    models.set_columnar_enabled(prev_port)
    for reset in (DevicePlane.reset_for_testing, RefPlane.reset_for_testing,
                  device_stream.reset_for_testing,
                  ref_stream.reset_for_testing, fp.reset_for_testing,
                  ref_fp.reset_for_testing):
        reset()


def make_group(mod, lines):
    blob = b"".join(lines)
    sb = mod.SourceBuffer(len(blob) + 256)
    g = mod.PipelineEventGroup(sb)
    views = [sb.copy_string(ln) for ln in lines]
    g.set_columns(mod.ColumnarLogs(
        offsets=np.array([v.offset for v in views], np.int32),
        lengths=np.array([len(ln) for ln in lines], np.int32),
        timestamps=np.full(len(lines), 1700000002, np.int64)))
    return g


def snapshot(group):
    """The reference's canonical (content, fields) bytes of a columnar
    group."""
    cols = group.columns
    arena = group.source_buffer.as_array()
    n = len(cols)
    content = []
    if not cols.content_consumed:
        for i in range(n):
            o, ln = int(cols.offsets[i]), int(cols.lengths[i])
            content.append(bytes(arena[o:o + ln].tobytes()))
    fields = {}
    for k, (offs, lens) in sorted(cols.fields.items()):
        vals = []
        for i in range(n):
            ln = int(lens[i])
            vals.append(None if ln < 0 else
                        bytes(arena[int(offs[i]):int(offs[i]) + ln]
                              .tobytes()))
        fields[k] = vals
    return {"n": n, "content": content, "fields": fields}


def port_pipeline(cfg, name="p"):
    return CollectionPipeline(name, dict(cfg), CPU)


def ref_pipeline(cfg, name="r"):
    p = RefPipeline()
    assert p.init(name, dict(cfg))
    return p


def process_one(pipeline, group):
    fin = pipeline.process_begin([group])
    if fin is not None:
        fin()
    return group


def three_ways(monkeypatch, cfg, lines):
    """(port fused, port per-stage, JAX fused) snapshots of one group."""
    p = port_pipeline(cfg, "fused")
    fused = snapshot(process_one(p, make_group(models, lines)))
    ref = snapshot(process_one(ref_pipeline(cfg), make_group(ref_models,
                                                             lines)))
    monkeypatch.setenv("LOONG_FUSED", "0")
    staged = snapshot(process_one(port_pipeline(cfg, "staged"),
                                  make_group(models, lines)))
    monkeypatch.setenv("LOONG_FUSED", "1")
    return p, fused, staged, ref


# ---------------------------------------------------------------------------
# the plain program against the JAX program


def _ref_specs(specs):
    """The JAX package's specs of the same patterns, from the identities."""
    out = []
    for spec in specs:
        ident = spec.ident
        if spec.kind == "extract":
            out.append(ref_fp.StageSpec("extract", ref_tier1(ident[1]),
                                        ident))
        elif spec.kind == "scan":
            out.append(ref_fp.StageSpec("scan", ref_fused(ident[1:]), ident))
        else:
            conds = []
            for c in spec.payload:
                ci = c.ident
                if c.kind == "extract_ok":
                    payload = ref_tier1(ci[1])
                else:
                    payload = ref_compile_dfa(ci[1])
                conds.append(ref_fp.StageCond(c.kind, payload, ci,
                                              binding=c.binding,
                                              negate=c.negate))
            out.append(ref_fp.StageSpec("keep", conds, ident))
    return out


def _compare_programs(port_specs, ref_specs, rows_fn, seed):
    rng = np.random.default_rng(seed)
    plain = fp.build_fused_fn(port_specs)
    ref = jax.jit(ref_fp.build_fused_fn(ref_specs))
    for L in (128, 1024):
        lines = rows_fn(rng, 60, L)
        lens = np.array([len(x) for x in lines], np.int32)
        arena = np.frombuffer(b"".join(lines) or b"\0", np.uint8)
        offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
        batch = pack_rows(arena, offs, lens, L, 64 + 32)
        want = [np.asarray(a) for a in ref(batch.rows, batch.lengths)]
        got = [t.numpy() for t in plain(torch.from_numpy(batch.rows),
                                        torch.from_numpy(batch.lengths))]
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            if w.dtype == np.uint32 or g.dtype == np.int32 \
                    and w.dtype == np.int32:
                g = g.view(w.dtype)
            assert g.shape == w.shape and g.dtype == w.dtype, (i, g.dtype,
                                                               w.dtype)
            assert np.array_equal(g, w), (L, i, np.nonzero(
                (g != w).reshape(len(g), -1).any(axis=1))[0][:5])


LISTS = {name: (specs, rows) for name, specs, rows in td.fused_stage_lists()
         if name != "over_budget"}


@pytest.mark.parametrize("name", sorted(LISTS))
def test_plain_program_equals_the_jax_program(name):
    specs, rows_fn = LISTS[name]
    _compare_programs(specs, _ref_specs(specs), rows_fn, seed=len(name))


@pytest.mark.parametrize("cfg,name", [(THREE_STAGE, "three_stage"),
                                      (APACHE_FILTER, "apache_filter")])
def test_planners_agree_and_programs_match(cfg, name):
    port = port_pipeline(cfg)
    ref = ref_pipeline(cfg)
    (prun,), (rrun,) = port.fused_runs, ref._fused_runs
    assert (prun.head, prun.end) == (rrun.head, rrun.end)
    pspecs = [m.spec for m in prun.members]
    rspecs = [m.spec for m in rrun.members]
    assert [s.ident for s in pspecs] == [s.ident for s in rspecs]
    assert [s.ident for s in pspecs] == [s.ident for s in LISTS[name][0]]
    _compare_programs(pspecs, rspecs, LISTS[name][1], seed=3)


# ---------------------------------------------------------------------------
# whole pipelines


def test_three_stage_snapshots_agree(monkeypatch):
    p, fused, staged, ref = three_ways(monkeypatch, THREE_STAGE, LINES)
    assert fused == staged == ref
    assert list(zip(fused["fields"]["word"], fused["fields"]["num"])) \
        == EXPECT
    assert p.fused_runs[0].program().dispatch_count == 1


def test_apache_filter_snapshots_agree(monkeypatch):
    lines = td.gen_lines(2000, seed=17)
    lines[5] = b"not an access log line"
    p, fused, staged, ref = three_ways(monkeypatch, APACHE_FILTER, lines)
    assert fused == staged == ref
    want = td.apache_filter_oracle(lines)
    assert fused["n"] == len(want) and 0.25 < len(want) / 2000 < 0.45
    assert fused["fields"]["url"] == [w["url"].encode() for w in want]
    run = p.fused_runs[0]
    assert (run.fused_groups, run.long_row_groups) == (1, 0)


def test_grok_behind_a_source_filter(monkeypatch):
    p, fused, staged, ref = three_ways(monkeypatch, GROK, GROK_LINES)
    assert [(r.head, r.end) for r in p.fused_runs] == [(0, 2)]
    assert [m.spec.kind for m in p.fused_runs[0].members] == ["keep", "scan"]
    assert fused == staged == ref


def test_chunks_are_one_dispatch_each(monkeypatch):
    monkeypatch.setattr(fp, "MAX_BATCH", 512)
    lines = td.gen_lines(2000, seed=4)
    plane = DevicePlane.reset_for_testing()
    p = port_pipeline(APACHE_FILTER)
    fused = snapshot(process_one(p, make_group(models, lines)))
    program = p.fused_runs[0].program()
    assert program.dispatch_count == plane.counters()["dispatches"] == 4
    process_one(p, make_group(models, LINES[:1] + lines[:10]))
    assert program.dispatch_count == plane.counters()["dispatches"] == 5
    assert program.launches == 0
    monkeypatch.setenv("LOONG_FUSED", "0")
    staged = snapshot(process_one(port_pipeline(APACHE_FILTER, "s"),
                                  make_group(models, lines)))
    assert fused == staged
    ring = device_stream.batch_ring().totals()
    assert ring["leased"] == 0 and ring["leases"] == ring["returns"]
    assert mem_live_bytes("resident_columns") == 0
    assert plane.inflight_bytes() == 0


def test_tuner_floors_keyed_per_program():
    p = port_pipeline(THREE_STAGE)
    process_one(p, make_group(models, LINES))
    lanes = device_stream.auto_tuner().chosen().get("lane_buckets", {})
    sig = p.fused_runs[0].program().signature
    assert list(lanes) == [f"fused:{sig[:8]}"]


def test_a_failing_program_raises_and_releases(monkeypatch):
    plane = DevicePlane.reset_for_testing()
    p = port_pipeline(APACHE_FILTER)
    program = p.fused_runs[0].program()

    def broken(rows, lengths, events=None):
        raise RuntimeError("fused_program launch failed: injected")

    monkeypatch.setattr(program, "__call__", broken)
    monkeypatch.setattr(type(program), "__call__",
                        lambda self, r, l, events=None: broken(r, l))
    g = make_group(models, td.gen_lines(300, seed=2))
    with pytest.raises(RuntimeError, match="injected"):
        process_one(p, g)
    ring = device_stream.batch_ring().totals()
    assert ring["leased"] == 0 and ring["leases"] == ring["returns"] == 1
    assert plane.inflight_bytes() == 0
    assert mem_live_bytes("resident_columns") == 0
    assert p.in_process_count() == 0


# ---------------------------------------------------------------------------
# planning


def test_unbindable_filter_breaks_the_run():
    cfg = dict(THREE_STAGE)
    cfg["processors"] = [
        {"Type": "processor_parse_regex_tpu", "Regex": RX,
         "Keys": ["word", "num"]},
        {"Type": "processor_filter_native",
         "Include": {"not_a_capture": r"\d+"}},
    ]
    assert port_pipeline(cfg).fused_runs == []
    assert ref_pipeline(cfg)._fused_runs == []


def test_consumed_source_breaks_the_run():
    cfg = dict(THREE_STAGE)
    cfg["processors"] = [
        {"Type": "processor_parse_regex_tpu", "Regex": RX,
         "Keys": ["word", "num"]},
        {"Type": "processor_filter_native", "Include": {"content": r".*"}},
    ]
    assert port_pipeline(cfg).fused_runs == []
    assert ref_pipeline(cfg)._fused_runs == []


def test_multiline_spec_is_terminal():
    from loongcollector_tpu_torch.pipeline.plugin.interface import \
        PluginContext
    from loongcollector_tpu_torch.processor.split_multiline import \
        ProcessorSplitMultilineLogString
    proc = ProcessorSplitMultilineLogString()
    assert proc.init({"Multiline": {"StartPattern": td.JAVA_START,
                                    "ContinuePattern": td.JAVA_CONTINUE}},
                     PluginContext(device=CPU))
    ms = proc.fused_stage_spec(FusionPlanContext())
    assert ms is not None and ms.spec.terminal and ms.spec.kind == "scan"
    # a terminal scan ends its run: alone it plans nothing
    assert plan_fusion([proc, proc], CPU) == []


def test_disabled_fusion_runs_per_stage(monkeypatch):
    monkeypatch.setenv("LOONG_FUSED", "0")
    plane = DevicePlane.reset_for_testing()
    p = port_pipeline(THREE_STAGE)
    assert p.fused_runs and not p.fused_runs[0].enabled()
    g = process_one(p, make_group(models, LINES))
    snap = snapshot(g)
    assert list(zip(snap["fields"]["word"], snap["fields"]["num"])) == EXPECT
    assert p.fused_runs[0]._program is None
    assert fp.stage_fusion_status()["programs"] == []
    assert plane.counters()["dispatches"] >= 1      # the per-stage parse


def test_fusion_follows_the_device_when_unset(monkeypatch):
    monkeypatch.delenv("LOONG_FUSED")
    assert not fp.fusion_enabled(CPU)
    assert fp.fusion_enabled(torch.device("cuda", 0))
    monkeypatch.setenv("LOONG_FUSED", "1")
    assert fp.fusion_enabled(CPU)


def test_group_with_a_row_over_4096_runs_per_stage(monkeypatch):
    lines = td.gen_lines(50, seed=9)
    lines[7] = lines[7].replace(b" HTTP/", b"/" + b"q" * 4200 + b" HTTP/")
    p, fused, staged, ref = three_ways(monkeypatch, APACHE_FILTER, lines)
    assert fused == staged == ref
    run = p.fused_runs[0]
    assert (run.fused_groups, run.long_row_groups) == (0, 1)
    assert run._program is None


# ---------------------------------------------------------------------------
# the CLI


def test_apache_filter_config_end_to_end(tmp_path, monkeypatch):
    lines = td.gen_lines(2000, seed=11)
    log_path = tmp_path / "access.log"
    log_path.write_bytes(b"\n".join(lines) + b"\n")
    want = td.apache_filter_oracle(lines)
    for fused in ("1", "0"):
        monkeypatch.setenv("LOONG_FUSED", fused)
        out = tmp_path / f"out{fused}.json"
        cfg_dir = tmp_path / f"cfg{fused}"
        cfg_dir.mkdir()
        (cfg_dir / "apache_filter.yaml").write_text(
            td.apache_filter_config(str(log_path), str(out)))
        stats_path = tmp_path / f"stats{fused}.json"
        assert port_main(["--config", str(cfg_dir), "--once", "--cpu",
                          "--stats", str(stats_path)]) == 0
        recs = [json.loads(x) for x in out.read_bytes().splitlines()]
        assert [{k: r[k] for k in td.APACHE_KEYS} for r in recs] == want
        st = json.loads(stats_path.read_text())
        fu = st["fusion"]
        assert fu["runs_planned"] == 1 and fu["k7_launches"] == 0
        if fused == "1":
            assert fu["fused_groups"] == fu["fused_dispatches"] \
                == fu["program_dispatches"] == st["plane"]["dispatches"] \
                == fu["exec_legs"] >= 1
            assert st["device_batches"] == 0 and st["k2"]["launches"] == 0
        else:
            assert fu["fused_groups"] == fu["fused_dispatches"] == 0
            assert st["device_batches"] >= 1
        assert st["ring"]["leased"] == 0
        assert st["device_memory"]["total_live_bytes"] == 0
    assert os.path.getsize(tmp_path / "out1.json") \
        == os.path.getsize(tmp_path / "out0.json")


def test_java_filter_groups_fuse_unless_a_record_passes_4096(tmp_path,
                                                             monkeypatch):
    """Path 2 (parse, then a filter on the parsed message) with fusion on:
    the groups holding a record over 4096 bytes run per-stage, exactly
    those the reader's chunks give (``testdata.java_groups``), the rest
    fuse; every record equals the ``re`` oracle either way."""
    import functools
    from loongcollector_tpu_torch.input.file import input_file
    from loongcollector_tpu_torch.input.file.reader import LogFileReader
    lines = td.gen_java_log(4000, seed=26)
    log_path = tmp_path / "app.log"
    log_path.write_bytes(b"\n".join(lines) + b"\n")
    monkeypatch.setattr(input_file, "LogFileReader",
                        functools.partial(LogFileReader, chunk_size=65536))
    groups = td.java_groups(lines, 65536)
    long_groups = sum(any(len(r) > 4096 for r in g) for g in groups)
    assert 0 < long_groups < len(groups)
    out, cfg_dir = tmp_path / "out.json", tmp_path / "cfg"
    cfg_dir.mkdir()
    (cfg_dir / "p.yaml").write_text(td.java_filter_config(str(log_path),
                                                          str(out)))
    stats_path = tmp_path / "stats.json"
    assert port_main(["--config", str(cfg_dir), "--once", "--cpu", "--stats",
                      str(stats_path)]) == 0
    records = td.java_records(lines, td.JAVA_CONTINUE)
    want = td.java_oracle(records, td.JAVA_FILTER)
    got = [json.loads(x) for x in out.read_bytes().splitlines()]
    keys = ("time", "level", "message", "rawLog")
    assert [{k: r[k] for k in keys if k in r} for r in got] == want
    fu = json.loads(stats_path.read_text())["fusion"]
    assert fu["runs_planned"] == 1
    assert (fu["fused_groups"], fu["long_row_groups"], fu["other_groups"]) \
        == (len(groups) - long_groups, long_groups, 0)
    assert fu["fused_dispatches"] == fu["fused_groups"]


def test_a_failing_group_releases_the_groups_dispatched_before_it(
        monkeypatch):
    plane = DevicePlane.reset_for_testing()
    p = port_pipeline(APACHE_FILTER)
    run = p.fused_runs[0]
    groups = [make_group(models, td.gen_lines(200, seed=s)) for s in (1, 2)]
    real = run._dispatch_group
    calls = []

    def second_fails(g):
        calls.append(g)
        if len(calls) == 2:
            raise RuntimeError("fused_program launch failed: injected")
        return real(g)

    monkeypatch.setattr(run, "_dispatch_group", second_fails)
    with pytest.raises(RuntimeError, match="injected"):
        p.process_begin(groups)
    ring = device_stream.batch_ring().totals()
    assert ring["leased"] == 0 and ring["leases"] == ring["returns"] == 1
    assert plane.inflight_bytes() == 0
    assert mem_live_bytes("resident_columns") == 0
    assert p.in_process_count() == 0


# ---------------------------------------------------------------------------
# K7's struct_index stage (K5's masks), which no planner emits


STRUCT_LISTS = {name: (specs, rows)
                for name, specs, rows in td.struct_stage_lists()}


def _ref_struct_specs(specs):
    """The JAX package's specs of a struct stage list: struct_index stages
    as they are, the rest from their identities."""
    out = []
    for spec in specs:
        if spec.kind == "struct_index":
            out.append(ref_fp.StageSpec("struct_index", spec.payload,
                                        spec.ident))
        else:
            out += _ref_specs([spec])
    return out


@pytest.mark.parametrize("name", sorted(STRUCT_LISTS))
def test_plain_struct_program_equals_the_jax_program(name):
    specs, rows_fn = STRUCT_LISTS[name]
    _compare_programs(specs, _ref_struct_specs(specs), rows_fn,
                      seed=len(name))


@pytest.mark.parametrize("name", sorted(STRUCT_LISTS))
def test_struct_program_flat_output_and_staged_run(name):
    """The CPU program's flat output splits back into the plain version's
    arrays at every L (the masks' width follows L), and ``staged_run`` (K5
    as the stage's own kernel) gives the same arrays."""
    specs, rows_fn = STRUCT_LISTS[name]
    program = fp.FusedProgramKernel(specs, name)
    rng = np.random.default_rng(11)
    for L in (17, 128, 512):
        lines = rows_fn(rng, 30, L)
        lens = np.array([len(x) for x in lines], np.int32)
        arena = np.frombuffer(b"".join(lines) or b"\0", np.uint8)
        offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
        batch = pack_rows(arena, offs, lens, L, 37)
        rows, lengths = (torch.from_numpy(batch.rows),
                         torch.from_numpy(batch.lengths))
        (flat,) = program(rows, lengths)
        assert flat.numel() == program.descriptor.flat_bytes(37, L)
        want = program.plain(rows, lengths)
        staged = [t for tup in program.staged_run(rows, lengths)
                  for t in tup]
        for got, w, s in zip(program.split(flat, 37), want, staged):
            assert torch.equal(got.reshape(w.shape), w)
            assert torch.equal(s, w)
    assert program.launches == 0


def test_struct_dispatch_assembles_chunks_of_different_L(monkeypatch):
    """A group cut into chunks of 64 rows whose longest rows fall in
    different buckets: the port's ``FusedDispatch`` unpacks each chunk's
    masks into ``[n, Lmax]`` as the reference's ``_finish_struct`` does."""
    monkeypatch.setattr(fp, "MAX_BATCH", 64)
    monkeypatch.setattr(ref_fp, "MAX_BATCH", 64)
    specs = STRUCT_LISTS["delim_struct_keep"][0]
    lines = td.gen_pipe_log(64, seed=3) \
        + [ln + b"|" + b"x" * 300 for ln in td.gen_pipe_log(64, seed=4)] \
        + td.gen_pipe_log(40, seed=5) + [b'a|"b|c"|d|e|f|' + b"y" * 900]
    arena = np.frombuffer(b"".join(lines), np.uint8)
    lens = np.array([len(x) for x in lines], np.int32)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    program = fp.FusedProgramKernel(specs, "struct")
    got = fp.FusedDispatch(program, arena, offs, lens, CPU).dispatch() \
        .result()
    ref_prog = ref_fp.FusedProgramKernel(_ref_struct_specs(specs), "struct")
    want = ref_fp.FusedDispatch(ref_prog, arena, offs, lens).dispatch() \
        .result()
    assert program.dispatch_count == 3
    assert got.n == want.n == len(lines)
    for g_stage, w_stage in zip(got.stages, want.stages):
        assert len(g_stage) == len(w_stage)
        for g, w in zip(g_stage, w_stage):
            w = np.asarray(w)
            assert g.shape == w.shape and np.array_equal(g, w.astype(g.dtype))
    assert got.stages[1][0].shape == (len(lines), 1024)
    ring = device_stream.batch_ring().totals()
    assert ring["leased"] == 0 and ring["leases"] == ring["returns"]
    assert mem_live_bytes("resident_columns") == 0


def test_no_planner_emits_a_struct_index_stage():
    """Planning the slice's configs gives extract and keep stages only: the
    quote-mode delimiter and the JSON parse stay outside fused runs."""
    for cfg in (
            {"inputs": [], "flushers": [{"Type": "flusher_stdout"}],
             "processors": [
                 {"Type": "processor_parse_delimiter_native",
                  "Separator": "|", "Keys": list(td.PIPE_KEYS)},
                 {"Type": "processor_filter_native",
                  "Include": dict(td.PIPE_INCLUDE),
                  "Exclude": dict(td.PIPE_EXCLUDE)}]},
            {"inputs": [], "flushers": [{"Type": "flusher_stdout"}],
             "processors": [
                 {"Type": "processor_parse_delimiter_native",
                  "Mode": "quote", "Keys": list(td.CSV_KEYS)},
                 {"Type": "processor_filter_native",
                  "Include": {"method": "GET"}}]},
            {"inputs": [], "flushers": [{"Type": "flusher_stdout"}],
             "processors": [
                 {"Type": "processor_parse_json_native"},
                 {"Type": "processor_filter_native",
                  "Include": {"level": td.JSON_FILTER_LEVEL}}]}):
        p = port_pipeline(cfg)
        kinds = [s.kind for r in p.fused_runs for s in r.program().specs]
        assert "struct_index" not in kinds
        assert kinds in ([], ["extract", "keep"])
