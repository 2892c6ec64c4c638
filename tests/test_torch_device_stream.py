"""The port's streaming pieces held against the JAX package's on the CPU:
the pipelined dispatch window (``DeviceStream``), the batch ring, the
width auto-tuner and the depth/tuner settings.  Each scenario runs the same
seeded script through the reference module and its port and compares what
can be observed; the slot fence (a slot whose copies may still run stays
out of its pool) is the port's own.
"""

import numpy as np
import pytest
import torch

from loongcollector_tpu.ops import device_plane as ref_dp
from loongcollector_tpu.ops import device_stream as ref_stream
from loongcollector_tpu_torch.ops import device_plane as port_dp
from loongcollector_tpu_torch.ops import device_stream as port_stream
from loongcollector_tpu_torch.ops.device_batch import pack_rows

PAIRS = [(ref_dp, ref_stream), (port_dp, port_stream)]


@pytest.fixture(autouse=True)
def fresh():
    yield
    for dp, stream in PAIRS:
        dp.DevicePlane.reset_for_testing()
        stream.reset_for_testing()


def _window(dp, stream_mod, depth):
    """Seven batches, the fourth raising at dispatch, the sixth taking
    longer than the rest: advances after each submit, then the results."""
    plane = dp.DevicePlane.reset_for_testing(budget_bytes=1 << 20)
    stream = stream_mod.DeviceStream(plane, depth)
    fast = dp.LatencyInjectedKernel(lambda x: x * 2, 0.002, serialize=False)
    slow = dp.LatencyInjectedKernel(lambda x: x * 3, 0.02, serialize=False)

    def bad(x):
        raise ValueError("boom")

    seen = []
    for i in range(7):
        kern = bad if i == 3 else (slow if i == 5 else fast)
        stream.submit(kern, (np.arange(i, i + 3),), 100, tag=i)
        seen.append((stream.advances, stream.inflight()))
    results = [(tag, type(out).__name__ if isinstance(out, Exception)
                else np.asarray(out[0]).tolist())
               for tag, out in stream.drain()]
    return seen, results, stream.advances, plane.inflight_bytes()


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_stream_window_matches_reference(depth):
    ref = _window(ref_dp, ref_stream, depth)
    port = _window(port_dp, port_stream, depth)
    assert port == ref
    seen, results, advances, inflight = port
    assert [t for t, _ in results] == list(range(7))
    assert results[3] == (3, "ValueError") and advances == 7
    assert inflight == 0


def _ring(stream_mod, lease):
    """Lease and release over two geometries past the pool cap."""
    ring = stream_mod.BatchRing(slots_per_geometry=2)
    seen = []
    held = []
    for B, L, hold in [(256, 128, 3), (256, 128, 1), (512, 128, 2),
                       (256, 128, 4), (512, 256, 1), (512, 128, 3)]:
        slots = [lease(ring, B, L) for _ in range(hold)]
        seen.append(ring.leased_total())
        for s in slots[:-1]:
            s.release()
        held.append(slots[-1])
        seen.append((ring.leased_total(), ring.pooled_total()))
    for s in held:
        s.release()
        s.release()                 # idempotent
    seen.append((ring.leased_total(), ring.pooled_total()))
    stats = {g: (v["slot_allocs"], v["slot_reuses"])
             for g, v in ring.stats().items()}
    return seen, stats


def test_ring_counts_match_reference():
    ref = _ring(ref_stream, lambda r, B, L: r.lease(B, L))
    port = _ring(port_stream, lambda r, B, L: r.lease(B, L, pinned=False))
    assert port == ref
    seen, stats = port
    assert seen[-1] == (0, 5)
    assert sum(a for a, _ in stats.values()) > 0 \
        and sum(r for _, r in stats.values()) > 0


class _Fence:
    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_slot_stays_out_of_pool_until_its_copies_complete():
    ring = port_stream.BatchRing(slots_per_geometry=2)
    slot = ring.lease(256, 128)
    fence = slot.fence = _Fence()
    slot.release()
    assert ring.leased_total() == 0 and ring.fenced_total() == 1
    assert ring.pooled_total() == 0
    other = ring.lease(256, 128)
    assert other is not slot          # still fenced: a fresh slot
    other.release()
    fence.done = True
    again = ring.lease(256, 128)      # the sweep re-pools the fenced slot
    assert ring.fenced_total() == 0 and again in (slot, other)
    again.release()
    assert port_dp.mem_live_bytes("ring_slots") == 0


def test_slot_pack_writes_host_tensors():
    lines = [b"abc 123", b"", b"x" * 100]
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines), np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    ring = port_stream.BatchRing()
    slot = ring.lease(256, 128)
    batch = slot.pack(arena, offs, lens)
    want = pack_rows(arena, offs, lens, 128, 256)
    assert not slot.pinned and slot.rows.dtype == torch.uint8
    np.testing.assert_array_equal(slot.rows.numpy(), want.rows)
    np.testing.assert_array_equal(slot.lengths.numpy(), want.lengths)
    np.testing.assert_array_equal(slot.origins.numpy(), want.origins)
    assert batch.n_real == 3 and batch.rows is slot._np[0]
    ok, off, ln = slot.outputs(4)
    assert ok.shape == (256,) and off.shape == ln.shape == (256, 4)
    assert slot.outputs(4)[0] is ok
    slot.release()


def _tuner(stream_mod):
    rng = np.random.default_rng(7)
    tuner = stream_mod.WidthAutoTuner()
    seen = []
    for step in range(400):
        L = (128, 256)[step % 2]
        B = tuner.min_batch_for(L)
        dense = step > 250
        n_real = int(rng.integers(B // 2 if dense else 1,
                                  B + 1 if dense else max(2, B // 8)))
        tuner.observe_pack(L, B, n_real)
        seen.append((tuner.min_batch_for(128), tuner.min_batch_for(256)))
    return seen, tuner.chosen()["buckets"]


def test_tuner_floors_match_reference():
    ref = _tuner(ref_stream)
    port = _tuner(port_stream)
    assert port == ref
    floors = {f for pair in port[0] for f in pair}
    assert min(floors) == port_stream.MIN_TUNED_FLOOR and max(floors) == 256


@pytest.mark.parametrize("raw", [None, "", "1", "4", "9", "0", "x"])
def test_depth_and_tuner_settings_match_reference(raw):
    env = {} if raw is None else {"LOONG_STREAM_DEPTH": raw,
                                  "LOONG_STREAM_TUNER": raw}
    assert port_stream.stream_depth(env) == ref_stream.stream_depth(env)
    assert port_stream.tuner_enabled(env) == ref_stream.tuner_enabled(env)
