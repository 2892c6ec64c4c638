"""Multiline assembly in the port against the JAX package's, on the CPU.

* ``ProcessorSplitMultilineLogString``: the same Java log, cut into groups
  at seeded line boundaries and marked as a reader marks a chunk that
  breaks a record (``ML_PARTIAL_TAIL``, then ``ML_CONTINUE``), runs
  through the line split and the multiline split of both packages, in the
  start-only, start+continue, start+end and end-only modes, with
  ``UnmatchedContentTreatment`` single_line and discard.  Every group's
  records and the records ``drain_groups`` releases at the end are equal
  byte for byte; in the start-only mode they are also the whole file's
  records by ``re`` (``testdata.java_records``), the last one included.
  (With a continue pattern the carry absorbs the next chunk's leading
  unmatched lines, a stray line included, in both packages alike.)
* ``python -m loongcollector_tpu_torch --once --cpu`` on the multiline
  paths: the stock ``multiline_java.yaml`` (start only) and the
  start+continue config with an exception filter, at one and four
  workers, with chunks small enough that records break across them: every
  record equals the ``re`` oracle in file order, the file's last record
  (shipped by the stop-time drain) included, and the stats count the
  fused set's and the filter's device batches and host-routed rows.
"""

import functools
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from loongcollector_tpu.models import EventGroupMetaKey as RefMetaKey
from loongcollector_tpu.models import PipelineEventGroup as RefGroup
from loongcollector_tpu.models import SourceBuffer as RefSourceBuffer
from loongcollector_tpu.pipeline.plugin.interface import \
    PluginContext as RefContext
from loongcollector_tpu.processor.split_log_string import \
    ProcessorSplitLogString as RefSplit
from loongcollector_tpu.processor.split_multiline import \
    ProcessorSplitMultilineLogString as RefMultiline
from loongcollector_tpu_torch.application import main as port_main
from loongcollector_tpu_torch.input.file import input_file
from loongcollector_tpu_torch.input.file.reader import LogFileReader
from loongcollector_tpu_torch.models import (EventGroupMetaKey,
                                             PipelineEventGroup, SourceBuffer)
from loongcollector_tpu_torch.pipeline.plugin.interface import PluginContext
from loongcollector_tpu_torch.processor.split_log_string import \
    ProcessorSplitLogString
from loongcollector_tpu_torch.processor.split_multiline import \
    ProcessorSplitMultilineLogString
from loongcollector_tpu_torch.testdata import (JAVA_CONTINUE, JAVA_FILTER,
                                               JAVA_START, gen_java_log,
                                               java_filter_config,
                                               java_oracle, java_records)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
END = r"\t\.\.\. \d+ more"
MODES = {
    "start": {"StartPattern": JAVA_START},
    "start_cont": {"StartPattern": JAVA_START,
                   "ContinuePattern": JAVA_CONTINUE},
    "start_end": {"StartPattern": JAVA_START, "EndPattern": END},
    "end": {"EndPattern": END},
}


@pytest.fixture(autouse=True)
def _host_routes_in_the_reference(monkeypatch):
    # the reference's engines take their exact host walkers; the port's
    # run their plain versions on the CPU
    monkeypatch.setenv("LOONG_DEVICE_MIN_BYTES", str(1 << 40))


def _log(seed):
    lines = gen_java_log(1500, seed=seed)
    # unmatched content: a leading run, and stray lines between records
    lines = [b"garbage before the first record", b""] + lines
    for i in range(300, len(lines), 400):
        lines.insert(i, b"stray line %d" % i)
    return lines


def _chunks(rng, lines, mode):
    """Seeded chunk boundaries at line boundaries, each chunk marked as a
    reader marks it: partial when the next chunk's first line continues
    its last record (start modes) or its last line closes no record (end
    mode); the last chunk is partial unless it ends on a closed record."""
    import re
    start = re.compile(JAVA_START.encode())
    end = re.compile(END.encode())
    cuts = sorted(set(rng.integers(1, len(lines), 9).tolist()))
    bounds = [0] + cuts + [len(lines)]
    out = []
    for k in range(len(bounds) - 1):
        chunk = lines[bounds[k]:bounds[k + 1]]
        last = k == len(bounds) - 2
        if mode == "end":
            partial = not end.fullmatch(chunk[-1])
        else:
            partial = last or not start.fullmatch(lines[bounds[k + 1]])
        out.append((b"\n".join(chunk) + b"\n", partial))
    return out


def _run(pkg, mode, unmatched, chunks):
    """Records of every group, then of ``drain_groups``, as bytes."""
    if pkg == "ref":
        Group, Buf, Key, Split, Multi = (RefGroup, RefSourceBuffer, RefMetaKey,
                                         RefSplit, RefMultiline)
        ctx = RefContext()
        ctx.pipeline_name = "ml"
    else:
        Group, Buf, Key, Split, Multi = (
            PipelineEventGroup, SourceBuffer, EventGroupMetaKey,
            ProcessorSplitLogString, ProcessorSplitMultilineLogString)
        ctx = PluginContext("ml", device=torch.device("cpu"))
    split, multi = Split(), Multi()
    split.init({}, ctx)
    assert multi.init({"Multiline": dict(
        MODES[mode], UnmatchedContentTreatment=unmatched)}, ctx)
    out = []

    def records(group):
        cols = group.columns
        arena = group.source_buffer.as_array()
        return [bytes(arena[o: o + n].tobytes())
                for o, n in zip(cols.offsets, cols.lengths)]

    prev_partial = False
    for data, partial in chunks:
        sb = Buf(len(data) + 64)
        g = Group(sb)
        g.add_raw_event(1700000000).set_content(sb.copy_string(data))
        g.set_metadata(Key.LOG_FILE_PATH, "/logs/app.log")
        g.set_metadata(Key.LOG_FILE_INODE, "42")
        if partial:
            g.set_metadata(Key.ML_PARTIAL_TAIL, "1")
        if prev_partial:
            g.set_metadata(Key.ML_CONTINUE, "1")
        prev_partial = partial
        split.process(g)
        multi.process(g)
        out.append(records(g))
    out.append([r for g in multi.drain_groups() for r in records(g)])
    return out


@pytest.mark.parametrize("unmatched", ["single_line", "discard"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_split_multiline_equals_reference(mode, unmatched):
    rng = np.random.default_rng(len(mode) * 7 + len(unmatched))
    lines = _log(int(rng.integers(100)))
    chunks = _chunks(rng, lines, mode)
    got = _run("port", mode, unmatched, chunks)
    want = _run("ref", mode, unmatched, chunks)
    assert got == want
    flat = [r for grp in got for r in grp]
    assert len(flat) > 10
    if mode != "end":
        assert got[-1], "the last record ships from drain_groups"
    if mode == "start" and unmatched == "single_line":
        assert flat == java_records(lines)


def test_flush_timeout_groups_equals_reference(monkeypatch):
    """A carried record idle past the flush timeout is released as a group
    of its own, with its source's path and inode, as the reference's is;
    a second call finds nothing."""
    import loongcollector_tpu.processor.split_multiline as ref_mod
    import loongcollector_tpu_torch.processor.split_multiline as port_mod
    out = {}
    for pkg, mod, multi, ctx, key in (
            ("ref", ref_mod, RefMultiline(), RefContext(), RefMetaKey),
            ("port", port_mod, ProcessorSplitMultilineLogString(),
             PluginContext("ml", device=torch.device("cpu")),
             EventGroupMetaKey)):
        monkeypatch.setattr(mod, "CARRY_FLUSH_S", 0.0)
        assert multi.init({"Multiline": MODES["start"]}, ctx)
        multi._carry["/logs/app.log:42"] = (b"held record", 1700000001, 0.0)
        groups = multi.flush_timeout_groups()
        assert multi.flush_timeout_groups() == []
        out[pkg] = [(g.get_metadata(key.LOG_FILE_PATH).to_bytes(),
                     g.get_metadata(key.LOG_FILE_INODE).to_bytes(),
                     g.columns.timestamps.tolist(),
                     bytes(g.source_buffer.as_array()[
                         g.columns.offsets[0]:][:g.columns.lengths[0]]))
                    for g in groups]
    assert out["port"] == out["ref"] == [
        (b"/logs/app.log", b"42", [1700000001], b"held record")]


# -- the agent, end to end on the CPU ---------------------------------------

@pytest.fixture(scope="module")
def java_log(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multiline")
    lines = gen_java_log(4000, seed=26)     # holds a line over 4096 bytes
    path = str(tmp / "app.log")
    with open(path, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")
    return tmp, path, lines


def _config(tmp, name, log_path, out_path, path):
    cfg_dir = tmp / f"config_{name}"
    cfg_dir.mkdir()
    if path == 1:
        with open(os.path.join(REPO, "example_config", "quick_start",
                               "multiline_java.yaml")) as f:
            text = f.read()
        text = text.replace("/tmp/loongcollector_demo/app.log", log_path)
        text = text.replace("  - Type: flusher_stdout",
                            f"  - Type: flusher_file\n    FilePath: "
                            f"{out_path}")
    else:
        text = java_filter_config(log_path, out_path)
    (cfg_dir / "p.yaml").write_text(text)
    return str(cfg_dir)


@pytest.mark.parametrize("path", [1, 2])
@pytest.mark.parametrize("threads", [1, 4])
def test_once_cpu_equals_oracle(java_log, monkeypatch, path, threads):
    tmp, log_path, lines = java_log
    monkeypatch.setenv("LOONG_PROCESS_THREADS", str(threads))
    # 8 KiB reads: records break across chunks and ride the carry
    monkeypatch.setattr(input_file, "LogFileReader",
                        functools.partial(LogFileReader, chunk_size=8192))
    name = f"{path}_{threads}"
    out_path = str(tmp / f"out_{name}.json")
    stats_path = str(tmp / f"stats_{name}.json")
    cfg = _config(tmp, name, log_path, out_path, path)
    assert port_main(["--config", cfg, "--once", "--cpu",
                      "--data-dir", str(tmp / f"data_{name}"),
                      "--stats", stats_path]) == 0
    cont = JAVA_CONTINUE if path == 2 else None
    records = java_records(lines, cont)
    want = java_oracle(records, JAVA_FILTER if path == 2 else None)
    with open(out_path, "rb") as f:
        got = [json.loads(x) for x in f]
    keys = ("time", "level", "message", "rawLog")
    assert [{k: r[k] for k in keys if k in r} for r in got] == want
    with open(stats_path) as f:
        st = json.load(f)
    assert st["events"] == len(want) and st["drained_groups"] == 1
    msgs = [r["message"].encode() for r in java_oracle(records)]
    long_lines = sum(len(x) > 4096 for x in lines)
    long_records = sum(len(r) > 4096 for r in records)
    assert long_lines > 0 and long_records > 0
    if path == 1:
        # K1 is the start gate (lines) and the parse (records)
        assert st["re_oversize_rows"] == long_lines + long_records
        assert st["k4"]["device_batches"] == 0 == st["k2"]["device_batches"]
        return
    assert st["re_oversize_rows"] == long_records
    k2, k4 = st["k2"], st["k4"]
    assert k4["device_batches"] > 0 and k2["device_batches"] > 0
    assert k4["host_rows"] == long_lines
    assert k2["host_rows"] == sum(len(m) > 4096 for m in msgs) > 0
    assert k2["launches"] == k4["launches"] == 0        # plain on the CPU
    assert k2["kernel_seconds"] is None


@pytest.mark.parametrize("kernel", ["K2", "K4"])
def test_dfa_kernel_failure_fails_the_run(java_log, monkeypatch, capsys,
                                          kernel):
    """No fallback: a K2 or K4 call that raises makes path 2 exit 1, with
    nothing re-run on the host scanner or on re."""
    from loongcollector_tpu_torch.ops.kernels import dfa_scan
    tmp, log_path, _lines = java_log
    monkeypatch.setattr(input_file, "LogFileReader",
                        functools.partial(LogFileReader, chunk_size=65536))
    cls = dfa_scan.DFAMatchKernel if kernel == "K2" \
        else dfa_scan.FusedScanKernel
    calls = []
    real = cls.__call__

    def failing(self, rows, lengths, events=None):
        calls.append(hashlib.sha1(rows.numpy().tobytes()).hexdigest())
        if len(calls) == 2:
            raise RuntimeError(f"injected {kernel} fault")
        return real(self, rows, lengths, events)

    monkeypatch.setattr(cls, "__call__", failing)
    name = f"fail_{kernel}"
    cfg = _config(tmp, name, log_path, str(tmp / f"out_{name}.json"), 2)
    assert port_main(["--config", cfg, "--once", "--cpu",
                      "--data-dir", str(tmp / f"data_{name}")]) == 1
    assert f"injected {kernel} fault" in capsys.readouterr().err
    # groups already queued may still run, but no batch runs twice
    assert len(calls) >= 2 and len(set(calls)) == len(calls)
