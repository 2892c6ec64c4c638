"""The Apache main path end to end: the JAX package against the port.

One seeded Apache log (with noise, oversize lines and a final line without
a newline) goes through the JAX package's processors — file reader →
split → processor_parse_regex_tpu → processor_parse_timestamp_native →
JsonSerializer — and through the port's ``--once --cpu`` CLI with a
flusher_file sink.  The NDJSON must be byte-equal.  ``time.time`` is pinned
in both runs: lines whose regex or timestamp parse fails keep the read
time as ``__time__``, which would otherwise differ between two runs.

The port's run streams: the input pushes into the bounded process queue
and the processor runner's workers dispatch through the device plane.  It
is held byte-equal at 1 and 4 workers and at depth 1 and 3, and a kernel
failure must fail the run (exit code 1) with the plane settled.
"""

import hashlib
import json
import os
import time

import numpy as np
import pytest

from loongcollector_tpu.input.file.reader import LogFileReader
from loongcollector_tpu.pipeline.plugin.interface import PluginContext
from loongcollector_tpu.pipeline.serializer.json_serializer import \
    JsonSerializer
from loongcollector_tpu.processor.parse_regex import ProcessorParseRegex
from loongcollector_tpu.processor.parse_timestamp import \
    ProcessorParseTimestamp
from loongcollector_tpu.processor.split_log_string import \
    ProcessorSplitLogString
from loongcollector_tpu_torch.application import main as port_main
from loongcollector_tpu_torch.ops import device_stream
from loongcollector_tpu_torch.ops.device_plane import (DevicePlane,
                                                       mem_live_bytes)
from loongcollector_tpu_torch.ops.kernels.field_extract import ExtractKernel
from loongcollector_tpu_torch.testdata import gen_lines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "example_config", "quick_start",
                    "file_regex_apache.yaml")


def _write_log(path):
    rng = np.random.default_rng(5)
    lines = gen_lines(7000, seed=5)       # > one 512 KiB chunk
    for i in range(0, 7000, 501):
        lines[i] = bytes(rng.integers(32, 127, 60, dtype=np.uint8))
    lines[3] = lines[3].replace(b" HTTP/", b"/" + b"p" * 4500 + b" HTTP/")
    lines[9] = lines[9].replace(b"10/Oct/2000", b"99/Xyz/2000")
    data = b"\n".join(lines) + b"\n" + b'1.2.3.4 - - [10/Oct/2000:13:55:36 ' \
        b'-0700] "GET / HTTP/1.1" 200 5'    # no trailing newline
    with open(path, "wb") as f:
        f.write(data)


def _reference_ndjson(log_path):
    with open(YAML) as f:
        import yaml
        cfg = yaml.safe_load(f)
    ctx = PluginContext("apache")
    procs = [ProcessorSplitLogString()]
    procs[0].init({}, ctx)
    for pcfg, cls in zip(cfg["processors"],
                         (ProcessorParseRegex, ProcessorParseTimestamp)):
        p = cls()
        assert p.init(pcfg, ctx)
        procs.append(p)
    ser = JsonSerializer()
    reader = LogFileReader(log_path)
    out = []
    while True:
        group = reader.read() or reader.read(force_flush=True)
        if group is None:
            break
        for p in procs:
            p.process(group)
        out.append(ser.serialize([group]))
    reader.close()
    return b"".join(out)


def test_apache_once_cpu_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    log_path = str(tmp_path / "access.log")
    out_path = str(tmp_path / "out.json")
    _write_log(log_path)
    cfg_dir = tmp_path / "config"
    cfg_dir.mkdir()
    with open(YAML) as f:
        text = f.read()
    text = text.replace("/tmp/loongcollector_demo/access.log", log_path)
    text = text.replace("  - Type: flusher_stdout",
                        f"  - Type: flusher_file\n    FilePath: {out_path}")
    (cfg_dir / "file_regex_apache.yaml").write_text(text)
    stats_path = str(tmp_path / "stats.json")
    assert port_main(["--config", str(cfg_dir), "--once", "--cpu",
                      "--data-dir", str(tmp_path / "port_data"),
                      "--stats", stats_path]) == 0
    with open(out_path, "rb") as f:
        got = f.read()
    want = _reference_ndjson(log_path)
    assert got.count(b"\n") == 7001
    assert b'"rawLog"' in got and b'"__time__": 1700000000' in got
    assert got == want
    import json
    with open(stats_path) as f:
        stats = json.load(f)
    assert stats["events"] == 7001 and stats["device"] == "cpu"
    assert stats["re_oversize_rows"] == 1 and stats["launches"] == 0


# -- the streaming main path: process queue → runner → plane ---------------

PINNED_TIME = 1700000000.25


@pytest.fixture(scope="module")
def apache_case(tmp_path_factory):
    """The seeded log, its config directory and the reference's NDJSON."""
    tmp = tmp_path_factory.mktemp("streaming")
    log_path = str(tmp / "access.log")
    _write_log(log_path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "time", lambda: PINNED_TIME)
        want = _reference_ndjson(log_path)
    return tmp, log_path, want


def _config(tmp, log_path, out_path):
    cfg_dir = tmp / f"config_{os.path.basename(out_path)}"
    cfg_dir.mkdir()
    with open(YAML) as f:
        text = f.read()
    text = text.replace("/tmp/loongcollector_demo/access.log", log_path)
    text = text.replace("  - Type: flusher_stdout",
                        f"  - Type: flusher_file\n    FilePath: {out_path}")
    (cfg_dir / "file_regex_apache.yaml").write_text(text)
    return str(cfg_dir)


@pytest.mark.parametrize("threads,depth", [(1, 1), (1, 3), (4, 1), (4, 3)])
def test_streaming_once_cpu_matches_reference(apache_case, monkeypatch,
                                              threads, depth):
    """``--once --cpu`` through the runner's workers and the plane at one
    and four workers and depth 1 and 3: byte-equal to the reference."""
    tmp, log_path, want = apache_case
    monkeypatch.setattr(time, "time", lambda: PINNED_TIME)
    monkeypatch.setenv("LOONG_PROCESS_THREADS", str(threads))
    monkeypatch.setenv("LOONG_STREAM_DEPTH", str(depth))
    out_path = str(tmp / f"out_{threads}_{depth}.json")
    stats_path = str(tmp / f"stats_{threads}_{depth}.json")
    cfg_dir = _config(tmp, log_path, out_path)
    assert port_main(["--config", cfg_dir, "--once", "--cpu",
                      "--data-dir", str(tmp / f"data_{threads}_{depth}"),
                      "--stats", stats_path]) == 0
    with open(out_path, "rb") as f:
        assert f.read() == want
    with open(stats_path) as f:
        st = json.load(f)
    assert (st["threads"], st["depth"], st["events"]) == (threads, depth,
                                                          7001)
    assert st["plane"]["dispatches"] == st["device_batches"] > 0
    assert st["plane"]["inflight_bytes"] == 0 and st["ring"]["leased"] == 0
    assert st["ring"]["leases"] == st["ring"]["returns"] \
        == st["device_batches"]
    assert st["device_memory"]["total_live_bytes"] == 0
    legs = st["timeline"]["legs"]
    assert legs["exec"]["count"] == st["device_batches"]
    assert legs["exec"]["clock"] == "host"
    assert st["kernel_seconds"] is None and st["busy_share"] is None


def test_kernel_failure_fails_the_run(apache_case, monkeypatch, capsys):
    """No fallback: a kernel that fails on the second chunk makes the
    agent exit non-zero; the plane and the ring are left settled."""
    tmp, log_path, _want = apache_case
    DevicePlane.reset_for_testing()
    device_stream.reset_for_testing()
    calls = []
    real_call = ExtractKernel.__call__

    def failing(self, rows, lengths, events=None):
        calls.append(hashlib.sha1(rows.numpy().tobytes()).hexdigest())
        if len(calls) == 2:
            raise RuntimeError("injected kernel fault")
        return real_call(self, rows, lengths, events)

    monkeypatch.setattr(ExtractKernel, "__call__", failing)
    out_path = str(tmp / "out_fail.json")
    cfg_dir = _config(tmp, log_path, out_path)
    assert port_main(["--config", cfg_dir, "--once", "--cpu",
                      "--data-dir", str(tmp / "data_fail")]) == 1
    assert "injected kernel fault" in capsys.readouterr().err
    # at most three groups (two chunks of lines and the final unterminated
    # line), one kernel call each: no chunk is run twice
    assert 2 <= len(calls) <= 3 and len(set(calls)) == len(calls)
    assert DevicePlane.instance().inflight_bytes() == 0
    assert device_stream.batch_ring().leased_total() == 0
    assert mem_live_bytes("ring_slots") == 0
