"""The port's processor runner, on the CPU, against the reference's
contracts (``tests/test_device_plane.py:173-247``):

* cross-group overlap: with a 40 ms injected device round trip the runner
  keeps group N's device work in flight while it handles its neighbours,
  beating the serial wall-clock floor;
* back-pressure: a stalled device fills the plane's byte budget, the
  worker stops popping, the bounded process queue refuses pushes at its
  high watermark, and everything drains once the device recovers;
* per-source order at four workers, the affinity hash, the worker lane and
  the thread-count setting, compared with the reference's;
* the once-a-second pump of the ``TimeoutFlushManager``: an idle rollup
  closes its window while the run goes on.
"""

import json
import time

import numpy as np
import pytest
import torch

from conftest import wait_for
from loongcollector_tpu.models import PipelineEventGroup as RefGroup
from loongcollector_tpu.models import EventGroupMetaKey as RefMetaKey
from loongcollector_tpu.runner import processor_runner as ref_runner
from loongcollector_tpu_torch.models import (EventGroupMetaKey,
                                             PipelineEventGroup, SourceBuffer)
from loongcollector_tpu_torch.ops import device_stream
from loongcollector_tpu_torch.ops.device_plane import (DevicePlane,
                                                       LatencyInjectedKernel,
                                                       StallableKernel)
from loongcollector_tpu_torch.ops.regex.engine import get_engine
from loongcollector_tpu_torch.pipeline.pipeline_manager import \
    CollectionPipelineManager
from loongcollector_tpu_torch.pipeline.queue.process_queue_manager import \
    ProcessQueueManager
from loongcollector_tpu_torch.runner import processor_runner as port_runner
from test_torch_alarms import alarms_left_empty  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture()
def stack(tmp_path):
    device_stream.reset_for_testing()
    pqm = ProcessQueueManager()
    mgr = CollectionPipelineManager(pqm, CPU)
    runners = []

    def make_runner(threads=1):
        r = port_runner.ProcessorRunner(pqm, mgr, thread_count=threads)
        runners.append(r)
        return r
    yield pqm, mgr, make_runner, tmp_path
    for r in runners:
        r.stop()
    mgr.stop_all()
    DevicePlane.reset_for_testing()
    device_stream.reset_for_testing()


def _start_pipeline(mgr, tmp_path, pattern, name):
    out_path = tmp_path / f"{name}.jsonl"
    mgr.update_pipelines([(name, {
        "inputs": [],
        "processors": [{"Type": "processor_parse_regex_tpu",
                        "Regex": pattern, "Keys": ["w", "d"]}],
        "flushers": [{"Type": "flusher_file", "FilePath": str(out_path)}],
    })])
    return mgr.find_pipeline(name), out_path


def _make_group(n_events, line=b"abc 123", source=None):
    sb = SourceBuffer()
    g = PipelineEventGroup(sb)
    for _ in range(n_events):
        ev = g.add_log_event(1)
        ev.set_content(sb.copy_string(b"content"), sb.copy_string(line))
    if source is not None:
        g.set_tag(b"__source__", source)
    return g


# A push the bounded queue refuses is retried every 10 ms until the workers
# drain it below its low watermark; on a loaded host that takes longer than
# the runner's default 10 retries, so a test waits up to 30 s, as it waits
# for its lines.
PUSH_RETRIES = 3000


def _push(runner, key, group):
    return runner.push_queue(key, group, retry_times=PUSH_RETRIES)


def _lines(path):
    return path.read_text().count("\n") if path.exists() else 0


class _InFlight:
    """Counts the dispatches whose results are not consumed yet, and the
    most that were at once."""

    def __init__(self, inner):
        self.inner = inner
        self.now = self.peak = 0

    def __call__(self, *args):
        self.now += 1
        self.peak = max(self.peak, self.now)
        dispatch = {"done": False}
        return tuple(_Consumed(o, self, dispatch) for o in self.inner(*args))


class _Consumed:
    def __init__(self, value, counter, dispatch):
        self.value, self.counter, self.dispatch = value, counter, dispatch

    def block_until_ready(self):
        self.value.block_until_ready()
        if not self.dispatch["done"]:
            self.dispatch["done"] = True
            self.counter.now -= 1
        return self

    def __array__(self, dtype=None, copy=None):
        self.block_until_ready()
        return np.asarray(self.value)


def test_cross_group_overlap(stack):
    """The reference's scenario with a 200 ms round trip (the reference
    uses 40 ms): the port's plain version and its serializer run on the
    host for every group, and a round trip long against that host work
    keeps the wall-clock comparison about overlap, not about the host's
    speed on a loaded machine.  The margin is the reference's."""
    pqm, mgr, make_runner, tmp_path = stack
    rtt = 0.2
    DevicePlane.reset_for_testing()
    pattern = r"(\w+) (\d+)"
    pipeline, out_path = _start_pipeline(mgr, tmp_path, pattern, "overlap")
    eng = get_engine(pattern, CPU)
    inflight = _InFlight(
        LatencyInjectedKernel(eng._staged, rtt, serialize=False))
    eng.set_device_kernel_override(inflight)
    try:
        runner = make_runner()
        runner.init()
        key = pipeline.process_queue_key
        assert _push(runner, key, _make_group(4))
        assert wait_for(lambda: _lines(out_path) >= 4)
        groups = 12
        t0 = time.perf_counter()
        for _ in range(groups):
            assert _push(runner, key, _make_group(4))
        assert wait_for(lambda: _lines(out_path) >= 4 * (groups + 1),
                        timeout=groups * rtt * 2 + 5)
        elapsed = time.perf_counter() - t0
        serial_floor = groups * rtt
        assert elapsed < serial_floor * 0.75, (
            f"overlapped={elapsed * 1e3:.0f}ms vs serial floor "
            f"{serial_floor * 1e3:.0f}ms: the runner does not overlap groups")
        # the lane holds a group's device work while the next dispatches
        # (up to three at depth 3; the tuner's flush deadline may complete
        # the oldest sooner)
        assert inflight.peak >= 2 and inflight.now == 0
        assert runner.error is None
    finally:
        eng.set_device_kernel_override(None)


def test_watermark_holds_under_stalled_device(stack):
    pqm, mgr, make_runner, tmp_path = stack
    # a budget of about one 256x128 chunk: the second group must wait
    plane = DevicePlane.reset_for_testing(budget_bytes=40 * 1024)
    pattern = r"(\w+) (\d+)y"
    pipeline, out_path = _start_pipeline(mgr, tmp_path, pattern, "stall")
    eng = get_engine(pattern, CPU)
    stall = StallableKernel(eng._staged, rtt_s=0.0)
    eng.set_device_kernel_override(stall)
    stall.stall()
    try:
        runner = make_runner()
        runner.init()
        key = pipeline.process_queue_key
        q = pqm.get_queue(key)
        pushed = 0
        for _ in range(q._cap_high + 10):
            if not pqm.push_queue(key, _make_group(4, b"abc 123y")):
                break
            pushed += 1
        assert wait_for(lambda: not pqm.is_valid_to_push(key), timeout=10)
        assert plane.inflight_bytes() <= plane.budget_bytes + 40 * 1024
        # one popped run may sit in the blocked worker's hands beyond the
        # queue's bound
        assert pushed <= q._cap_high + 3 + runner.run_max_groups
        assert _lines(out_path) == 0
        stall.unstall()
        assert wait_for(lambda: _lines(out_path) >= 4 * pushed, timeout=30)
        assert wait_for(lambda: pqm.is_valid_to_push(key), timeout=10)
        assert plane.inflight_bytes() == 0
        assert device_stream.batch_ring().leased_total() == 0
        # a group counts as settled just after its flusher wrote it
        assert wait_for(lambda: runner.groups_settled() == pushed,
                        timeout=10)
        assert runner.error is None
    finally:
        eng.set_device_kernel_override(None)


def test_four_workers_keep_per_source_order(stack):
    pqm, mgr, make_runner, tmp_path = stack
    DevicePlane.reset_for_testing()
    pattern = r"(\w+) (\d+)"
    pipeline, out_path = _start_pipeline(mgr, tmp_path, pattern, "order")
    eng = get_engine(pattern, CPU)
    eng.set_device_kernel_override(
        LatencyInjectedKernel(eng._staged, 0.005, serialize=False))
    try:
        runner = make_runner(threads=4)
        runner.init()
        key = pipeline.process_queue_key
        n = 0
        for seq in range(12):
            for src in (b"alpha", b"beta", b"gamma", b"delta", b"eps"):
                line = src + b" " + str(seq).encode()
                assert _push(runner, key, _make_group(2, line, src))
                n += 2
        assert wait_for(lambda: _lines(out_path) >= n, timeout=30)
        seqs = {}
        for rec in out_path.read_text().splitlines():
            obj = json.loads(rec)
            seqs.setdefault(obj["w"], []).append(int(obj["d"]))
        assert len(seqs) == 5
        for got in seqs.values():
            assert got == sorted(got) and len(got) == 24
        shards = {port_runner.shard_of(key, s, 4)
                  for s in (b"alpha", b"beta", b"gamma", b"delta", b"eps")}
        assert len(shards) > 1          # the sources spread over workers
        assert runner.error is None
    finally:
        eng.set_device_kernel_override(None)


@pytest.mark.parametrize("n", [1, 2, 4, 7])
def test_shard_and_source_match_reference(n):
    rng = np.random.default_rng(n)
    for _ in range(50):
        key = int(rng.integers(1, 1 << 40))
        src = bytes(rng.integers(0, 256, int(rng.integers(0, 20)),
                                 dtype=np.uint8))
        assert port_runner.shard_of(key, src, n) == \
            ref_runner.shard_of(key, src, n)
        assert port_runner.shard_of(key, None, n) == \
            ref_runner.shard_of(key, None, n)
    for meta in ({}, {"path": b"/var/log/a.log"},
                 {"path": b"/var/log/a.log", "inode": b"42"},
                 {"path": b"/x", "tag": b"pod-7"}):
        port_g, ref_g = PipelineEventGroup(), RefGroup()
        for g, mk in ((port_g, EventGroupMetaKey), (ref_g, RefMetaKey)):
            if "path" in meta:
                g.set_metadata(mk.LOG_FILE_PATH, meta["path"])
            if "inode" in meta:
                g.set_metadata(mk.LOG_FILE_INODE, meta["inode"])
            if "tag" in meta:
                g.set_tag(b"__source__", meta["tag"])
        assert port_runner.group_source_id(port_g) == \
            ref_runner.group_source_id(ref_g)


@pytest.mark.parametrize("raw", ["1", "4", "0", "x", None])
def test_thread_count_setting(raw):
    env = {} if raw is None else {"LOONG_PROCESS_THREADS": raw}
    want = int(raw) if raw in ("1", "4") else 1
    assert port_runner.resolve_thread_count(env) == want
    if raw in ("1", "4"):
        assert ref_runner.resolve_thread_count(env) == want


def test_worker_lane_matches_reference():
    for depth in (1, 2, 3, 5):
        ref = ref_runner.WorkerLane(0, depth)
        port = port_runner.WorkerLane(0, depth)
        assert port.capacity == ref.capacity
        for lane in (ref, port):
            for i in range(lane.capacity):
                lane.put(("g", i))
            lane.put(None)                 # nothing in flight: no entry
        assert port.full() and ref.full()
        assert [port.take() for _ in range(port.capacity + 1)] == \
            [ref.take() for _ in range(ref.capacity + 1)]
        assert not port.busy() and port.oldest_age() is None
    with pytest.raises(RuntimeError):
        lane = port_runner.WorkerLane(0, 2)
        lane.put(1)
        lane.put(2)


@pytest.mark.parametrize("threads", [1, 2])
def test_runner_pumps_the_timeout_flush_hooks(stack, threads):
    """Once a second the runner pumps the ``TimeoutFlushManager``
    (reference ``processor_runner.py:450-470``), from its one worker or
    from the dispatch loop: a rollup whose source went idle closes its open
    window while the run goes on, before any stop-time drain."""
    pqm, mgr, make_runner, tmp_path = stack
    out_path = tmp_path / "rollup.jsonl"
    mgr.update_pipelines([("rollup", {
        "inputs": [],
        "aggregators": [{"Type": "aggregator_metric_rollup",
                         "WindowSecs": 10, "IdleFlushSecs": 0,
                         "Substrate": "numpy"}],
        "flushers": [{"Type": "flusher_file", "FilePath": str(out_path)}],
    })])
    pipeline = mgr.find_pipeline("rollup")
    runner = make_runner(threads)
    runner.init()
    sb = SourceBuffer()
    g = PipelineEventGroup(sb)
    for v in (b"3", b"4"):
        ev = g.add_log_event(1)
        ev.set_content(sb.copy_string(b"__name__"), sb.copy_string(b"m"))
        ev.set_content(sb.copy_string(b"value"), sb.copy_string(v))
    assert _push(runner, pipeline.process_queue_key, g)
    assert wait_for(lambda: _lines(out_path) >= 1, timeout=5)
    row = json.loads(out_path.read_text().splitlines()[0])
    assert (row["__name__"], row["count"], row["sum"]) == ("m", "2", "7")
    assert runner.error is None
