"""The port's RegexEngine against the JAX package's, on the CPU.

``parse_batch(device="cpu")`` in the port must return the same
arena-absolute spans as the reference ``RegexEngine.parse_batch`` on its
device route (``LOONG_NATIVE_T1=0``: packed [B, L] batches through the
XLA kernel, row origins added, oversize rows through ``re``), over an
Apache corpus mixed with rows longer than 4096 bytes and non-matching
noise.  Bit-exact: the outputs are bools and int32 spans.

The async path: ``parse_batch_async`` over several chunks at depth 1 and
3 against the reference, dispatch-ahead beating the serial floor behind an
injected round trip (``tests/test_device_plane.py:92-127``), and no
fallback: a kernel failing at launch or at result fails the parse with
nothing re-run and no budget or ring slot left behind.
"""

import re
import time

import numpy as np
import pytest

from loongcollector_tpu.ops.regex import engine as ref_engine_mod
from loongcollector_tpu.ops.regex.engine import RegexEngine as RefEngine
from loongcollector_tpu_torch.ops import device_stream
from loongcollector_tpu_torch.ops.device_plane import (DevicePlane,
                                                       LatencyInjectedKernel)
from loongcollector_tpu_torch.ops.regex import engine as port_engine
from loongcollector_tpu_torch.ops.regex.program import PatternTier
from loongcollector_tpu_torch.testdata import APACHE, gen_lines
from test_torch_alarms import alarms_left_empty  # noqa: F401


def _layout(lines):
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines), np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    return arena, offs, lens


def _corpus(seed):
    rng = np.random.default_rng(seed)
    lines = gen_lines(300, seed=seed)
    for i in range(0, 300, 37):
        # oversize rows: one matching (a long URL), one not
        lines[i] = lines[i].replace(b" HTTP/", b"x" * 5000 + b" HTTP/")
        lines[i + 1] = bytes(rng.integers(32, 127, 4200, dtype=np.uint8))
    for i in range(5, 300, 11):
        lines[i] = bytes(rng.integers(32, 127, int(rng.integers(0, 90)),
                                      dtype=np.uint8))
    return lines


@pytest.mark.parametrize("seed", range(2))
def test_parse_batch_matches_reference(monkeypatch, seed):
    monkeypatch.setenv("LOONG_NATIVE_T1", "0")
    lines = _corpus(seed)
    arena, offs, lens = _layout(lines)
    ref = RefEngine(APACHE).parse_batch(arena, offs, lens)
    eng = port_engine.RegexEngine(APACHE, device="cpu")
    assert eng.tier is PatternTier.SEGMENT
    got = eng.parse_batch(arena, offs, lens)
    np.testing.assert_array_equal(np.asarray(ref.ok), got.ok)
    np.testing.assert_array_equal(np.asarray(ref.cap_off), got.cap_off)
    np.testing.assert_array_equal(np.asarray(ref.cap_len), got.cap_len)
    assert got.ok.sum() > 250 and (~got.ok).sum() > 20
    assert eng.re_oversize_rows == int((lens > 4096).sum()) > 0
    assert eng.device_batches == 1 and eng.re_tier_rows == 0


def test_over_kernel_limits_takes_re_tier_at_build():
    """33 captures exceed the kernel's 32 (the caps-overflow case of
    tests/test_native_t1.py): decided once, when the engine is built,
    logged as a demotion, and every row is counted on the re route."""
    pattern = "".join(r"(\d)-" for _ in range(33))[:-1]
    eng = port_engine.RegexEngine(pattern, device="cpu")
    assert eng.tier is PatternTier.CPU and eng.kernel is None
    assert "33 captures" in port_engine.demotions[pattern]
    lines = [b"-".join(b"%d" % (i % 10) for i in range(33)), b"1-2", b""]
    arena, offs, lens = _layout(lines)
    got = eng.parse_batch(arena, offs, lens)
    assert eng.re_tier_rows == 3 and eng.device_batches == 0
    rx = re.compile(pattern.encode())
    assert got.ok.tolist() == [True, False, False]
    m = rx.fullmatch(lines[0])
    assert got.cap_off[0].tolist() == [m.start(g + 1) for g in range(33)]
    assert got.cap_len[0].tolist() == [1] * 33
    # the reference runs it at its SEGMENT tier: same matches and spans
    ref = RefEngine(pattern).parse_batch(arena, offs, lens)
    np.testing.assert_array_equal(np.asarray(ref.ok), got.ok)
    np.testing.assert_array_equal(np.asarray(ref.cap_len), got.cap_len)
    np.testing.assert_array_equal(np.asarray(ref.cap_off)[0], got.cap_off[0])


def test_get_engine_caches_per_device():
    a = port_engine.get_engine(APACHE, "cpu")
    assert port_engine.get_engine(APACHE.encode(), "cpu") is a


# -- the async path (parse_batch_async, PendingParse, the plane) ----------

@pytest.fixture()
def fresh_plane():
    DevicePlane.reset_for_testing()
    device_stream.reset_for_testing()
    yield
    DevicePlane.reset_for_testing()
    device_stream.reset_for_testing()


def _settled():
    ring = device_stream.batch_ring()
    return (DevicePlane.instance().inflight_bytes(), ring.leased_total())


@pytest.mark.parametrize("depth", [1, 3])
def test_parse_batch_async_matches_reference(monkeypatch, fresh_plane, depth):
    """More than one MAX_BATCH of seeded Apache rows (with oversize rows and
    noise), chunked the same way in both engines."""
    monkeypatch.setenv("LOONG_NATIVE_T1", "0")
    monkeypatch.setattr(ref_engine_mod, "MAX_BATCH", 128)
    monkeypatch.setattr(port_engine, "MAX_BATCH", 128)
    lines = _corpus(2)
    arena, offs, lens = _layout(lines)
    ref = RefEngine(APACHE).parse_batch(arena, offs, lens)
    eng = port_engine.RegexEngine(APACHE, device="cpu")
    pending = eng.parse_batch_async(arena, offs, lens, depth=depth)
    assert not pending.done
    got = pending.result()
    assert pending.done and pending.result() is got
    np.testing.assert_array_equal(np.asarray(ref.ok), got.ok)
    np.testing.assert_array_equal(np.asarray(ref.cap_off), got.cap_off)
    np.testing.assert_array_equal(np.asarray(ref.cap_len), got.cap_len)
    assert eng.device_batches == 3       # 284 device rows in chunks of 128
    assert _settled() == (0, 0)


def _abc(n):
    line = b"abc 123"
    arena = np.frombuffer(line * n, dtype=np.uint8).copy()
    offsets = np.arange(n, dtype=np.int64) * len(line)
    lengths = np.full(n, len(line), dtype=np.int32)
    return arena, offsets, lengths


def test_pipelined_chunks_beat_serial_2x(monkeypatch, fresh_plane):
    """tests/test_device_plane.py:92-114 with the plain version behind a
    20 ms injected round trip: the eight chunks' round trips overlap to
    under half the serial floor.  The reference's compiled kernel computes
    a chunk in far under a millisecond; the port's plain version runs on
    the host inside each dispatch (~1.5 ms a chunk, and many times that on
    a loaded machine), so that compute time is measured and set apart from
    the time the round trips cost."""
    rtt = 0.02
    monkeypatch.setattr(port_engine, "MAX_BATCH", 256)
    eng = port_engine.RegexEngine(r"(\w+) (\d+)", device="cpu")
    staged = eng._device_kernel()
    compute = []

    def timed(*args):
        t = time.perf_counter()
        try:
            return staged(*args)
        finally:
            compute.append(time.perf_counter() - t)

    eng.set_device_kernel_override(
        LatencyInjectedKernel(timed, rtt, serialize=False))
    arena, offsets, lengths = _abc(2048)
    eng.parse_batch(arena[:7 * 8], offsets[:8], lengths[:8])     # warm-up
    compute.clear()
    t0 = time.perf_counter()
    res = eng.parse_batch(arena, offsets, lengths)
    elapsed = time.perf_counter() - t0
    assert res.ok.all()
    np.testing.assert_array_equal(res.cap_off[:, 0], offsets)
    np.testing.assert_array_equal(res.cap_len[:, 1], 3)
    n_chunks = 2048 // 256
    assert len(compute) == n_chunks
    serial_floor = n_chunks * rtt
    waited = elapsed - sum(compute)
    assert waited < serial_floor / 2, (
        f"pipelined={elapsed * 1e3:.1f}ms, of which host compute "
        f"{sum(compute) * 1e3:.1f}ms, vs serial floor "
        f"{serial_floor * 1e3:.1f}ms: dispatch-ahead is not overlapping")


def test_budget_pressure_still_correct(monkeypatch, fresh_plane):
    DevicePlane.reset_for_testing(budget_bytes=40 * 1024)
    monkeypatch.setattr(port_engine, "MAX_BATCH", 256)
    eng = port_engine.RegexEngine(r"(\w+) (\d+)", device="cpu")
    eng.set_device_kernel_override(
        LatencyInjectedKernel(eng._device_kernel(), 0.002, serialize=False))
    res = eng.parse_batch(*_abc(1024))
    assert res.ok.all()
    assert DevicePlane.instance().counters()["budget_waits"] > 0
    assert _settled() == (0, 0)


class _FailingHandle:
    def block_until_ready(self):
        raise RuntimeError("kernel fault at result")


@pytest.mark.parametrize("where", ["launch", "result"])
def test_kernel_failure_raises_and_releases(monkeypatch, fresh_plane, where):
    """No fallback: a kernel that fails at launch or at result fails the
    parse; nothing re-runs a chunk on the plain version or on re, and no
    budget or slot is left behind."""
    monkeypatch.setattr(port_engine, "MAX_BATCH", 256)
    eng = port_engine.RegexEngine(r"(\w+) (\d+)", device="cpu")
    staged = eng._device_kernel()
    calls = []

    def failing(slot, C):
        calls.append(slot)
        if len(calls) == 3:
            if where == "launch":
                raise RuntimeError("kernel fault at launch")
            return (_FailingHandle(),) * 3
        return staged(slot, C)

    eng.set_device_kernel_override(failing)
    plain_calls = []
    real_plain = eng.kernel.plain
    monkeypatch.setattr(eng.kernel, "plain",
                        lambda *a: plain_calls.append(1) or real_plain(*a))
    monkeypatch.setattr(eng, "_cpu_fallback_rows",
                        lambda *a: pytest.fail("a chunk went to re"))
    with pytest.raises(RuntimeError, match=f"kernel fault at {where}"):
        eng.parse_batch(*_abc(1024))
    assert len(calls) == 4 if where == "launch" else len(calls) >= 3
    assert len(plain_calls) == len(calls) - 1       # no re-run of chunk 3
    assert _settled() == (0, 0)
    from loongcollector_tpu_torch.ops.device_plane import mem_live_bytes
    assert mem_live_bytes("ring_slots") == 0
