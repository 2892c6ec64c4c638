"""The port's device plane, dispatch timeline and compile watch, held
against the JAX package's on the CPU.

Each plane scenario of ``tests/test_device_plane.py`` (acquire/release
accounting, an oversize dispatch, an error surfacing at ``result()``, the
abandoned-future backstop, an idempotent force-release, a failure in the
middle of a dispatch loop) runs the same script through the reference's
``DevicePlane`` and the port's; both must give the same in-flight bytes
after every step.  The timeline (``ops/xprof.py``) and the compile watch
(``ops/compile_watch.py``) are checked on their own: host legs on the CPU,
device legs read only once their events completed, the storm rule of the
reference, and one build recorded when two threads reach the first build
at once.
"""

import gc
import threading
import time

import numpy as np
import pytest

from loongcollector_tpu.ops import device_plane as ref_dp
from loongcollector_tpu.ops import device_stream as ref_stream
from loongcollector_tpu.ops.regex import engine as ref_engine
from loongcollector_tpu_torch.ops import compile_watch
from loongcollector_tpu_torch.ops import device_plane as port_dp
from loongcollector_tpu_torch.ops import device_stream as port_stream
from loongcollector_tpu_torch.ops import xprof
from loongcollector_tpu_torch.ops.regex import engine as port_engine


@pytest.fixture(autouse=True)
def fresh_planes(monkeypatch):
    monkeypatch.setenv("LOONG_NATIVE_T1", "0")
    yield
    ref_dp.DevicePlane.reset_for_testing()
    port_dp.DevicePlane.reset_for_testing()


def _accounting(dp):
    """tests/test_device_plane.py:50-66, recording in-flight bytes."""
    seen = []
    plane = dp.DevicePlane.reset_for_testing(budget_bytes=1000)
    k = dp.LatencyInjectedKernel(lambda x: x + 1, 0.0)
    f1 = plane.submit(k, (np.arange(10),), 600)
    seen.append(plane.inflight_bytes())
    got = []
    t = threading.Thread(
        target=lambda: got.append(plane.submit(k, (np.arange(5),), 600)))
    t.start()
    time.sleep(0.15)
    seen.append(("blocked", not got, plane.inflight_bytes()))
    seen.append(np.asarray(f1.result()[0]).tolist())
    t.join(2)
    seen.append(("unblocked", bool(got), plane.inflight_bytes()))
    seen.append(np.asarray(got[0].result()[0]).tolist())
    seen.append(plane.inflight_bytes())
    return seen


def _oversize(dp):
    plane = dp.DevicePlane.reset_for_testing(budget_bytes=100)
    k = dp.LatencyInjectedKernel(lambda x: x * 2, 0.0)
    f = plane.submit(k, (np.arange(4),), 5000)     # > the whole budget
    seen = [plane.inflight_bytes(), np.asarray(f.result()[0]).tolist()]
    return seen + [plane.inflight_bytes()]


def _error_at_result(dp):
    plane = dp.DevicePlane.reset_for_testing(budget_bytes=1000)

    def bad(x):
        raise ValueError("boom")

    f = plane.submit(bad, (np.arange(3),), 100)
    seen = [plane.inflight_bytes()]                # held until consumed
    for _ in range(2):                             # sticky, released once
        with pytest.raises(ValueError):
            f.result()
        seen.append(plane.inflight_bytes())
    return seen


def _abandoned(dp):
    plane = dp.DevicePlane.reset_for_testing(budget_bytes=1000)
    k = dp.LatencyInjectedKernel(lambda x: x + 1, 0.0)
    fut = plane.submit(k, (np.arange(8),), 600)
    seen = [plane.inflight_bytes()]
    del fut
    gc.collect()
    return seen + [plane.inflight_bytes()]


def _force_release(dp):
    plane = dp.DevicePlane.reset_for_testing(budget_bytes=1000)
    k = dp.LatencyInjectedKernel(lambda x: x + 1, 0.0)
    fut = plane.submit(k, (np.arange(8),), 600)
    fut.release()
    seen = [plane.inflight_bytes()]
    fut.release()                       # a second release must not go below 0
    seen.append(plane.inflight_bytes())
    with pytest.raises(RuntimeError):
        fut.result()                    # released futures surface an error
    return seen


SCENARIOS = {
    "accounting": (_accounting,
                   [600, ("blocked", True, 600), list(range(1, 11)),
                    ("unblocked", True, 600), list(range(1, 6)), 0]),
    "oversize": (_oversize, [5000, [0, 2, 4, 6], 0]),
    "error_at_result": (_error_at_result, [100, 0, 0]),
    "abandoned_backstop": (_abandoned, [600, 0]),
    "force_release": (_force_release, [0, 0]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_plane_scenario_matches_reference(name):
    script, want = SCENARIOS[name]
    ref = script(ref_dp)
    port = script(port_dp)
    assert port == ref == want


def _mid_loop_failure(dp, stream_mod, engine_mod, monkeypatch, make_engine):
    """tests/test_device_plane.py:291-321: the second chunk's pack raises
    while the first chunk is in flight; no budget may be left behind."""
    plane = dp.DevicePlane.reset_for_testing()
    stream_mod.reset_for_testing()
    monkeypatch.setattr(engine_mod, "MAX_BATCH", 256)
    eng, inner = make_engine()
    eng.set_device_kernel_override(
        dp.LatencyInjectedKernel(inner, 0.05, serialize=False))
    line = b"abc 123"
    arena = np.frombuffer(line * 1024, dtype=np.uint8).copy()
    offsets = np.arange(1024, dtype=np.int64) * len(line)
    lengths = np.full(1024, len(line), dtype=np.int32)
    real_pack = stream_mod.pack_rows
    calls = {"n": 0}

    def failing_pack(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected mid-loop pack failure")
        return real_pack(*args, **kwargs)

    monkeypatch.setattr(stream_mod, "pack_rows", failing_pack)
    with pytest.raises(RuntimeError, match="injected"):
        eng.parse_batch_async(arena, offsets, lengths)
    return [calls["n"], plane.inflight_bytes(),
            stream_mod.batch_ring().leased_total()]


def test_mid_loop_failure_releases_budget_like_reference(monkeypatch):
    pattern = r"(\w+) (\d+)"

    def ref_engine_():
        eng = ref_engine.RegexEngine(pattern)
        return eng, eng._segment_kernel

    def port_engine_():
        eng = port_engine.RegexEngine(pattern, device="cpu")
        return eng, eng._device_kernel()

    ref = _mid_loop_failure(ref_dp, ref_stream, ref_engine, monkeypatch,
                            ref_engine_)
    port = _mid_loop_failure(port_dp, port_stream, port_engine, monkeypatch,
                             port_engine_)
    assert port == ref == [2, 0, 0]
    assert port_dp.mem_live_bytes("ring_slots") == 0


def test_budget_wait_counted_and_tenant_share():
    plane = port_dp.DevicePlane.reset_for_testing(budget_bytes=1000)
    k = port_dp.LatencyInjectedKernel(lambda x: x, 0.0)
    f1 = plane.submit(k, (np.arange(2),), 800)
    drained = []

    def on_wait():
        if drained:
            return False
        drained.append(f1.result())
        return True

    f2 = plane.submit(k, (np.arange(2),), 800, on_wait=on_wait)
    assert drained and plane.counters()["budget_waits"] == 1
    assert plane.counters()["peak_inflight_bytes"] == 800
    f2.result()
    assert plane.counters()["dispatches"] == 2
    port_dp.reset_tenants_for_testing()
    port_dp.register_tenant("a")
    port_dp.register_tenant("b")
    assert port_dp.tenant_share_bytes(1000) == 500
    port_dp._tenant_note("a", 400)
    assert port_dp.tenant_over_share("a", 200, 1000)
    assert not port_dp.tenant_over_share("b", 200, 1000)
    port_dp.reset_tenants_for_testing()


def test_host_output_refuses_device_tensors():
    import torch
    t = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="host buffers"):
        port_dp.to_host_array(t)
    assert port_dp.to_host_array(torch.arange(3)).tolist() == [0, 1, 2]


# -- dispatch timeline ------------------------------------------------------

class _FakeEvent:
    """Stands in for a CUDA event: a completion flag and a device time."""

    def __init__(self, t_ms, done=True):
        self.t_ms = t_ms
        self.done = done

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return other.t_ms - self.t_ms


def test_timeline_legs_union_and_overlap():
    with xprof.active() as t:
        t.device_epoch = _FakeEvent(0.0)
        ids = [xprof.begin_dispatch(100) for _ in range(3)]
        # dispatch 2's h2d [1.5, 2.5) ms overlaps dispatch 1's exec [1, 2)
        spans = [((0.0, 1.0), (1.0, 2.0)), ((1.5, 2.5), (2.5, 3.0)),
                 ((5.0, 6.0), (6.0, 7.0))]
        for xid, (h2d, ex) in zip(ids, spans):
            xprof.event_leg(xid, "h2d", _FakeEvent(h2d[0]), _FakeEvent(h2d[1]))
            xprof.event_leg(xid, "exec", _FakeEvent(ex[0]), _FakeEvent(ex[1]))
            xprof.leg(xid, "pack", time.perf_counter(), 0.001)
        # an event pair still running at settle is dropped, not waited on
        xprof.event_leg(ids[2], "d2h", _FakeEvent(7.0), _FakeEvent(8.0, False))
        for xid in ids:
            xprof.close_dispatch(xid)
        legs = t.leg_summary()
        assert legs["exec"]["count"] == 3 and legs["exec"]["clock"] == "device"
        assert legs["pack"]["clock"] == "host"
        assert legs["exec"]["sum_s"] == pytest.approx(0.0025)
        assert legs["exec"]["median_s"] == pytest.approx(0.001)
        assert t.exec_union_seconds() == pytest.approx(0.0025)
        assert t.overlapped_dispatches() == 1
        assert t.stats() == {"dispatches": 3, "closed": 3, "dropped": 0,
                             "unresolved_legs": 1}
    assert xprof.begin_dispatch(1) == 0        # off: the null id


def test_timeline_cpu_legs_from_a_parse():
    eng = port_engine.RegexEngine(r"(\w+) (\d+)", device="cpu")
    line = b"abc 123"
    arena = np.frombuffer(line * 600, dtype=np.uint8).copy()
    offsets = np.arange(600, dtype=np.int64) * len(line)
    lengths = np.full(600, len(line), dtype=np.int32)
    with xprof.active() as t:
        res = eng.parse_batch(arena, offsets, lengths)
    assert res.ok.all()
    legs = t.leg_summary()
    assert set(legs) == {"pack", "submit", "exec", "d2h"}
    assert all(v["clock"] == "host" and v["count"] == 1
               for v in legs.values())
    assert t.decomposition()["regex:1024x128"]["legs_count"]["exec"] == 1


# -- compile watch ----------------------------------------------------------

def test_compile_watch_first_call_and_storm(monkeypatch):
    compile_watch.reset_for_testing()
    monkeypatch.setattr(compile_watch, "STORM_COMPILES", 3)
    warnings = []
    monkeypatch.setattr(compile_watch.log, "warning",
                        lambda msg, *a: warnings.append(msg % a))
    t0 = time.perf_counter()
    compile_watch.note_call("fam", "a", t0)
    compile_watch.note_call("fam", "a", t0)
    st = compile_watch.compile_status()["fam"]
    assert (st["compiles"], st["cache_hits"]) == (1, 1)
    for g in ("b", "c", "d"):
        compile_watch.note_call("fam", g, t0)
    st = compile_watch.compile_status()["fam"]
    assert st["compiles"] == 4 and st["storm_episodes"] == 1
    assert len(warnings) == 1 and "family=fam" in warnings[0]
    compile_watch.reset_for_testing()


def test_concurrent_first_builds_record_one_build(monkeypatch, tmp_path):
    """Two workers reaching the first launch at once: one nvcc run, one
    build in the compile watch, the other a cache hit."""
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    compile_watch.reset_for_testing()
    monkeypatch.setattr(fxc, "_lib", None)
    monkeypatch.setattr(fxc, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(fxc, "_nvcc", lambda: "nvcc")
    runs = []

    class _Proc:
        returncode = 0
        stdout = stderr = ""

    def fake_nvcc(cmd, **kw):
        runs.append(cmd)
        time.sleep(0.1)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return _Proc()

    class _Fn:
        pass

    class _Lib:
        def __getattr__(self, name):
            fn = _Fn()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(fxc.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(fxc.ctypes, "CDLL", lambda path: _Lib())
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(fxc.build()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert len(runs) == 1 and len(libs) == 2 and libs[0] is libs[1]
    st = compile_watch.compile_status()[fxc.BUILD_FAMILY]
    assert st["compiles"] == 1 and st["cache_hits"] == 0
    monkeypatch.setattr(fxc, "_lib", None)      # a later process: on disk
    fxc.build()
    st = compile_watch.compile_status()[fxc.BUILD_FAMILY]
    assert (st["compiles"], st["cache_hits"]) == (1, 1) and len(runs) == 1
    compile_watch.reset_for_testing()
