"""The port's chip lanes against the JAX package's, on the CPU.

The JAX router runs over the eight virtual CPU devices ``tests/conftest.py``
forces; the port's over a list that repeats the CPU device (its
``reset_for_testing(devices)`` hook, the same one ``chip_smoke.py`` uses
with ``cuda:0`` on one card).  Inputs come from a numpy seed.

* ``lane_for_source`` / ``lane_for_worker`` for the same (queue key,
  source, workers) over 1, 2, 4 and 8 devices; ``mesh_chip_cap`` and
  ``lanes_enabled`` on the same environments; ``LOONG_MESH_CHIPS=1`` and
  ``LOONG_MESH_LANES=0`` give no lanes; the runner's worker → lane map;
* a lane-bound parse: the spans, and the lane's dispatches, real and
  padding rows and settled in-flight bytes, equal the reference's;
  ``over_share`` decides as the reference's does;
* the agent with four workers on four lanes: per-lane dispatches add up to
  the engines' device batches and the NDJSON is byte-identical to the
  one-worker run; the Apache-filter path's K7 chunks run on the lanes, and
  its records equal the one-worker run's;
* failures raise: a worker whose lane lookup throws fails the runner.
"""

import json
import time

import jax
import numpy as np
import pytest
import torch

from loongcollector_tpu.ops import chip_lanes as ref_lanes
from loongcollector_tpu.ops.regex import engine as ref_engine_mod
from loongcollector_tpu.pipeline.queue.process_queue_manager import \
    ProcessQueueManager as RefPQM
from loongcollector_tpu.runner.processor_runner import \
    ProcessorRunner as RefRunner
from loongcollector_tpu_torch import testdata as td
from loongcollector_tpu_torch.application import main as port_main
from loongcollector_tpu_torch.ops import chip_lanes, device_stream
from loongcollector_tpu_torch.ops.device_plane import DevicePlane
from loongcollector_tpu_torch.ops.regex import engine as port_engine
from loongcollector_tpu_torch.pipeline.queue.process_queue_manager import \
    ProcessQueueManager
from loongcollector_tpu_torch.runner.processor_runner import ProcessorRunner
from loongcollector_tpu_torch.testdata import APACHE, gen_lines

import test_torch_pipeline as tp

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("LOONG_NATIVE_T1", "0")
    for var in ("LOONG_MESH_CHIPS", "LOONG_MESH_LANES", "LOONG_SHARDED"):
        monkeypatch.delenv(var, raising=False)
    port_engine.clear_engine_cache()
    ref_engine_mod.clear_engine_cache()
    yield
    chip_lanes.set_thread_lane(None)
    ref_lanes.set_thread_lane(None)
    monkeypatch.undo()
    chip_lanes.reset_for_testing()
    ref_lanes.reset_for_testing()
    port_engine.clear_engine_cache()
    ref_engine_mod.clear_engine_cache()
    device_stream.reset_for_testing()
    DevicePlane.reset_for_testing()


def _lane_index(lane):
    return None if lane is None else lane.index


SOURCES = [b"srcA", b"srcB", b"/var/log/x.log:123", None, b"", b"\xff" * 9]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_lane_routing_matches_reference(n):
    ref = ref_lanes.ChipLaneRouter(list(jax.devices())[:n])
    port = chip_lanes.ChipLaneRouter([CPU] * n)
    assert port.lane_count() == ref.lane_count() == (n if n > 1 else 0)
    rng = np.random.default_rng(n)
    keys = [int(k) for k in rng.integers(0, 2 ** 40, 6)] + [0, 7]
    for key in keys:
        for src in SOURCES:
            for workers in (1, 2, 3, 4, 8):
                assert _lane_index(port.lane_for_source(key, src, workers)) \
                    == _lane_index(ref.lane_for_source(key, src, workers))
    for w in range(12):
        assert _lane_index(port.lane_for_worker(w)) \
            == _lane_index(ref.lane_for_worker(w))
    assert [ln["chip"] for ln in port.status()["lanes"]] \
        == [ln["chip"] for ln in ref.status()["lanes"]]


ENVS = [{}, {"LOONG_MESH_CHIPS": "4"}, {"LOONG_MESH_CHIPS": "1"},
        {"LOONG_MESH_CHIPS": "0"}, {"LOONG_MESH_CHIPS": "x"},
        {"LOONG_MESH_LANES": "1"}, {"LOONG_MESH_LANES": "0"},
        {"LOONG_MESH_LANES": " 1 "}, {"LOONG_MESH_LANES": "yes"},
        {"LOONG_MESH_CHIPS": "2", "LOONG_MESH_LANES": "0"}]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(
    f"{k[11:]}={v!r}" for k, v in e.items()) or "unset")
def test_env_knobs_match_reference(env, monkeypatch):
    assert chip_lanes.mesh_chip_cap(env) == ref_lanes.mesh_chip_cap(env)
    assert chip_lanes.lanes_enabled(env) == ref_lanes.lanes_enabled(env)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref = ref_lanes.reset_for_testing(list(jax.devices()))
    port = chip_lanes.reset_for_testing([CPU] * 8)
    assert port.lane_count() == ref.lane_count()


def test_one_chip_gives_no_lanes(monkeypatch):
    monkeypatch.setenv("LOONG_MESH_CHIPS", "1")
    r = chip_lanes.reset_for_testing([CPU] * 8)
    assert r.lane_count() == 0 and r.lane_for_worker(0) is None
    assert ref_lanes.reset_for_testing().lane_count() == 0


def test_no_cuda_discovers_no_lanes():
    """On a machine without CUDA the router finds no device: no lanes."""
    assert chip_lanes.ChipLaneRouter._discover() == []
    assert chip_lanes.reset_for_testing().lane_count() == 0
    assert chip_lanes.router().lane_for_worker(3) is None


def test_worker_lane_map_matches_reference():
    chip_lanes.reset_for_testing([CPU] * 8)
    ref_lanes.reset_for_testing()
    port = ProcessorRunner(ProcessQueueManager(), None, thread_count=4,
                           device=CPU)
    ref = RefRunner(RefPQM(), None, thread_count=4)
    try:
        assert port.chip_lane_map() == ref.chip_lane_map() == [0, 1, 2, 3]
    finally:
        ref.metrics.mark_deleted()
    # lanes of another device kind than the runner's bind nothing
    chip_lanes.reset_for_testing([torch.device("cuda", 0)] * 4)
    assert port.chip_lane_map() == [None] * 4
    assert ProcessorRunner(ProcessQueueManager(), None,
                           thread_count=1).chip_lane_map() == []


def _layout(lines):
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines), np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    return arena, offs, lens


@pytest.mark.parametrize("n_lines", [300, 5000])
def test_lane_bound_parse_matches_reference(n_lines):
    lines = gen_lines(n_lines, seed=n_lines)
    arena, offs, lens = _layout(lines)
    ref_router = ref_lanes.reset_for_testing()
    port_router = chip_lanes.reset_for_testing([CPU] * 8)
    ref_lane, lane = ref_router.lanes[2], port_router.lanes[2]
    ref_lanes.set_thread_lane(ref_lane)
    chip_lanes.set_thread_lane(lane)
    ref = ref_engine_mod.RegexEngine(APACHE).parse_batch(arena, offs, lens)
    eng = port_engine.RegexEngine(APACHE, device="cpu")
    got = eng.parse_batch(arena, offs, lens)
    np.testing.assert_array_equal(np.asarray(ref.ok), got.ok)
    np.testing.assert_array_equal(np.asarray(ref.cap_off), got.cap_off)
    np.testing.assert_array_equal(np.asarray(ref.cap_len), got.cap_len)
    kern = eng._device_kernel(lane)
    assert isinstance(kern, port_engine._LanePlacedKernel)
    assert kern.device == lane.device and kern.lane is lane
    st, rst = lane.status(), ref_lane.status()
    for key in ("dispatches", "rows_real", "rows_padded", "inflight_bytes"):
        assert st[key] == rst[key], key
    assert st["dispatches"] == eng.device_batches >= 1
    assert st["inflight_bytes"] == 0
    assert all(ln.status()["dispatches"] == 0
               for ln in port_router.lanes if ln is not lane)
    tuned = device_stream.auto_tuner().chosen()
    assert "chip:2" in tuned.get("lane_buckets", {})


@pytest.mark.parametrize("inflight,budget,lanes", [
    (0, 1000, 4), (300, 1000, 4), (250, 1000, 4), (900, 1000, 1),
    (10, 0, 4), (600, 1000, 2)])
def test_over_share_matches_reference(inflight, budget, lanes):
    class _Plane:
        budget_bytes = budget
    port = chip_lanes.ChipLane(0, CPU)
    ref = ref_lanes.ChipLane(0, jax.devices()[0])
    try:
        port.note_dispatch(inflight)
        ref.note_dispatch(inflight)
        assert port.over_share(_Plane, lanes) == ref.over_share(_Plane, lanes)
        port.note_done(inflight + 5)
        assert port.inflight_bytes() == 0
    finally:
        port.mark_deleted()
        ref.mark_deleted()


# -- the agent on lanes ---------------------------------------------------------


def _run(tmp, cfg_text, tag, threads, monkeypatch):
    monkeypatch.setenv("LOONG_PROCESS_THREADS", str(threads))
    port_engine.clear_engine_cache()
    cfg_dir = tmp / f"cfg_{tag}"
    cfg_dir.mkdir()
    out = tmp / f"out_{tag}.json"
    (cfg_dir / "p.yaml").write_text(cfg_text(str(out)))
    stats = tmp / f"stats_{tag}.json"
    assert port_main(["--config", str(cfg_dir), "--once", "--cpu",
                      "--data-dir", str(tmp / f"data_{tag}"),
                      "--stats", str(stats)]) == 0
    return out.read_bytes(), json.loads(stats.read_text())


def _many_sources(tmp, n_files=6):
    """Several files, so four workers each get some (the affinity hash is
    per source)."""
    paths = []
    for i in range(n_files):
        p = tmp / f"access{i}.log"
        p.write_bytes(b"\n".join(gen_lines(1500, seed=40 + i)) + b"\n")
        paths.append(str(p))
    return paths


def _apache_cfg(paths):
    def text(out):
        return tp_apache_yaml().replace(
            "FilePaths:\n      - /tmp/loongcollector_demo/access.log",
            "FilePaths: [" + ", ".join(paths) + "]").replace(
            "  - Type: flusher_stdout",
            f"  - Type: flusher_file\n    FilePath: {out}")
    return text


def tp_apache_yaml():
    with open(tp.YAML) as f:
        return f.read()


def _records_by_file(ndjson, paths):
    """Records grouped by the file whose line they parse, in output order:
    per-source order is what affinity keeps, while files interleave
    differently across workers."""
    import re
    rx = re.compile(APACHE.encode())
    owner = {}
    for i, p in enumerate(paths):
        with open(p, "rb") as f:
            for line in f.read().splitlines():
                m = rx.fullmatch(line)
                if m is not None:
                    owner[tuple(g.decode() for g in m.groups())] = i
    out = {}
    for rec in ndjson.splitlines():
        obj = json.loads(rec)
        key = tuple(obj[k] for k in td.APACHE_KEYS)
        out.setdefault(owner[key], []).append(rec)
    return out


def test_four_workers_on_four_lanes(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: tp.PINNED_TIME)
    paths = _many_sources(tmp_path)
    cfg = _apache_cfg(paths)
    assert "access0.log" in cfg("x")
    one, st1 = _run(tmp_path, cfg, "w1", 1, monkeypatch)
    chip_lanes.reset_for_testing([CPU] * 4)
    four, st4 = _run(tmp_path, cfg, "w4", 4, monkeypatch)
    assert sorted(one.splitlines()) == sorted(four.splitlines())
    by_file = _records_by_file(one, paths)
    assert len(by_file) == len(paths)
    assert by_file == _records_by_file(four, paths)
    assert st1["mesh"] is None
    lanes = st4["mesh"]["router"]["lanes"]
    assert len(lanes) == 4
    assert sum(ln["dispatches"] for ln in lanes) == st4["device_batches"] \
        == st4["plane"]["dispatches"] > 0
    assert sum(ln["dispatches"] > 0 for ln in lanes) >= 2
    assert all(ln["inflight_bytes"] == 0 for ln in lanes)
    assert st4["mesh"]["kernels"] == []
    assert "lane_buckets" in st4["tuner"]


def test_apache_filter_on_lanes(tmp_path, monkeypatch):
    """K7's chunks run on the lanes (``FusedProgramKernel.for_lane``): the
    fused dispatches add up to the lanes' dispatches and the records equal
    the one-worker run's."""
    monkeypatch.setenv("LOONG_FUSED", "1")
    paths = _many_sources(tmp_path, 4)
    lines = []
    for p in paths:
        with open(p, "rb") as f:
            lines += f.read().splitlines()

    def cfg(out):
        text = td.apache_filter_config(paths[0], out)
        return text.replace(f"FilePaths: [{paths[0]}]",
                            "FilePaths: [" + ", ".join(paths) + "]")

    one, st1 = _run(tmp_path, cfg, "f1", 1, monkeypatch)
    chip_lanes.reset_for_testing([CPU] * 4)
    four, st4 = _run(tmp_path, cfg, "f4", 4, monkeypatch)
    want = td.apache_filter_oracle(lines)
    keys = td.APACHE_KEYS
    for got in (one, four):
        recs = [json.loads(r) for r in got.splitlines()]
        assert sorted(json.dumps({k: r[k] for k in keys}, sort_keys=True)
                      for r in recs) == sorted(
            json.dumps(w, sort_keys=True) for w in want)
    fu = st4["fusion"]
    lanes = st4["mesh"]["router"]["lanes"]
    assert fu["fused_dispatches"] == sum(ln["dispatches"] for ln in lanes) \
        == st4["plane"]["dispatches"] > 0
    assert st4["launches"] == st4["device_batches"] == 0


# -- failures raise -------------------------------------------------------------


def test_lane_lookup_failure_fails_the_worker(monkeypatch):
    def boom():
        raise RuntimeError("lane router down")

    monkeypatch.setattr(chip_lanes, "router", boom)
    runner = ProcessorRunner(ProcessQueueManager(), None, thread_count=2,
                             device=CPU)
    with pytest.raises(RuntimeError, match="lane router down"):
        runner._chip_lane_for(0)
    runner.init()
    try:
        deadline = time.monotonic() + 10
        while not runner.failed() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert runner.failed()
        assert "lane router down" in repr(runner.error)
    finally:
        runner.stop()
