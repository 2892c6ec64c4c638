"""The sharded parse plane (K8) against the JAX package's, on the CPU.

The JAX side runs on the eight virtual CPU devices that
``tests/conftest.py`` forces; the port's mesh is ``m`` shards of the one
CPU device (``make_mesh(m, device="cpu")``), where each shard runs K8's
plain version (``extract_stats_plain``).  Inputs come from a numpy seed.
Every comparison is bit-exact: ok, cap_off and cap_len, and the three
counts (matched, events, bytes), exact integers — pad rows included, under
a pattern that matches the empty string, at an odd B.

* ``ShardedParsePlane`` for m in {1, 2, 4, 8}, three patterns (one of them
  empty-matching), L in {128, 512}, aligned and unaligned B (the
  unaligned batches go through ``ShardedKernel``'s private pad buffer, as
  the reference's do);
* ``ShardedKernel``: ``batch_multiple``, ``pad_fallbacks``, the deltas of
  ``materialize_stats()`` and ``status()`` after three dispatches, per-chip
  occupancy (the reference's ``TestShardAlignedPacking``,
  ``tests/test_loongmesh.py:136-192``);
* the engine with ``LOONG_SHARDED=1`` against the JAX engine with
  ``LOONG_SHARDED=1``, on the reference engine tests' corpus;
* the agent's NDJSON: ``LOONG_MESH_CHIPS=1`` against ``8`` byte-identical
  (``TestChipsByteIdentity``), and the Apache config with
  ``LOONG_SHARDED=1`` against the JAX package's processors with
  ``LOONG_SHARDED=1``;
* failures raise: ``make_mesh`` with no CUDA device and no
  ``device="cpu"``, a staged slot that is not a mesh multiple, and the
  K8 launch for rows that are not on the current device.
"""

import gc
import json
import time

import jax
import numpy as np
import pytest
import torch

from loongcollector_tpu.ops.regex import engine as ref_engine_mod
from loongcollector_tpu.ops.regex.program import \
    compile_tier1 as ref_compile
from loongcollector_tpu.parallel import mesh as ref_mesh
from loongcollector_tpu_torch.application import main as port_main
from loongcollector_tpu_torch.ops import chip_lanes, device_stream
from loongcollector_tpu_torch.ops.device_batch import pack_rows, pad_batch
from loongcollector_tpu_torch.ops.device_plane import (DevicePlane,
                                                       mem_live_bytes)
from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
from loongcollector_tpu_torch.ops.kernels.field_extract import (
    ExtractKernel, extract_stats_plain)
from loongcollector_tpu_torch.ops.regex import engine as port_engine
from loongcollector_tpu_torch.ops.regex.program import compile_tier1
from loongcollector_tpu_torch.parallel import mesh as port_mesh
from loongcollector_tpu_torch.testdata import APACHE, gen_lines
from loongcollector_tpu_torch.utils.device import NoCudaDevice

import test_torch_pipeline as tp

PAT = r"(\w+):(\d+)"
EMPTY = r"(\w*)"             # matches the empty string: pad rows are ok
PATTERNS = [APACHE, PAT, EMPTY]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("LOONG_NATIVE_T1", "0")
    # the JAX mesh's process-wide counters (mesh_*_total, pad fallbacks per
    # chip count) stay as this file found them: its own tests read them as
    # absolute values
    monkeypatch.setattr(ref_mesh, "_mesh_records", {})
    port_engine.clear_engine_cache()
    ref_engine_mod.clear_engine_cache()
    yield
    port_engine.clear_engine_cache()
    ref_engine_mod.clear_engine_cache()
    chip_lanes.set_thread_lane(None)
    chip_lanes.reset_for_testing()
    device_stream.reset_for_testing()
    DevicePlane.reset_for_testing()


def _rows(pattern, B, L, seed):
    """A numpy-seeded batch for ``pattern``: matching rows, noise, empty
    rows, and (from the batch builder) padding rows."""
    rng = np.random.default_rng(seed)
    if pattern == APACHE:
        lines = [x[:L] for x in gen_lines(B, seed=seed)]
    else:
        lines = [b"k%d:%d" % (i, int(rng.integers(0, 10 ** 6)))
                 for i in range(B)]
    for i in range(0, len(lines), 7):
        lines[i] = bytes(rng.integers(32, 127, int(rng.integers(0, L // 2)),
                                      dtype=np.uint8))
    for i in range(3, len(lines), 11):
        lines[i] = b""
    lines = lines[: max(1, B - 5)]          # the batch builder pads 5 rows
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines) or b"\0", np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    batch = pack_rows(arena, offs, lens, L, B)
    return np.ascontiguousarray(batch.rows), np.ascontiguousarray(
        batch.lengths)


def _ref_counts(stats):
    return [int(np.asarray(stats[k])) for k in ("matched", "events",
                                                "bytes")]


@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("pattern", PATTERNS, ids=["apache", "kv", "empty"])
@pytest.mark.parametrize("L", [128, 512])
@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "unaligned"])
def test_sharded_plane_matches_reference(m, pattern, L, aligned):
    B = 64 if aligned else 61
    rows, lengths = _rows(pattern, B, L, seed=B * 7 + m + L)
    ref = ref_mesh.ShardedKernel(ref_compile(pattern),
                                 ref_mesh.make_mesh(m))
    kern = port_mesh.ShardedKernel(compile_tier1(pattern),
                                   port_mesh.make_mesh(m, device="cpu"))
    ref_base = ref.materialize_stats()
    base = kern.materialize_stats()
    # the counters are the process's, per chip count: compare what this
    # call added
    ref_pf = ref.status()["pad_fallbacks"]
    pf = kern.status()["pad_fallbacks"]
    r_ok, r_off, r_len = (np.asarray(a) for a in ref(rows, lengths))
    ok, off, length = (t.numpy() for t in kern(rows, lengths))
    assert ok.shape == r_ok.shape == (-(-B // m) * m,)
    np.testing.assert_array_equal(ok, r_ok)
    np.testing.assert_array_equal(off, r_off)
    np.testing.assert_array_equal(length, r_len)
    want = {k: v - ref_base[k] for k, v in ref.materialize_stats().items()}
    got = {k: v - base[k] for k, v in kern.materialize_stats().items()}
    assert got == want
    if pattern == EMPTY:
        # every padding row matched, and counted
        assert got["matched"] == int(ok.sum()) >= ok.shape[0] - B + 5
    assert kern.status()["pad_fallbacks"] - pf \
        == ref.status()["pad_fallbacks"] - ref_pf \
        == (0 if aligned or m == 1 else 1)


@pytest.mark.parametrize("m", [1, 4, 8])
def test_plane_step_counts_per_shard(m):
    """The plane's direct step returns one count vector a shard; their sum
    is the reference's psum'd stats, each shard's the plain K8 of its
    rows."""
    rows, lengths = _rows(EMPTY, 64, 128, seed=m)
    prog = compile_tier1(EMPTY)
    plane = port_mesh.ShardedParsePlane(prog,
                                        port_mesh.make_mesh(m, device="cpu"))
    ok, off, length, counts = plane(torch.from_numpy(rows),
                                    torch.from_numpy(lengths))
    assert counts.shape == (m, 3) and counts.dtype == torch.int64
    ref = ref_mesh.ShardedParsePlane(ref_compile(EMPTY),
                                     ref_mesh.make_mesh(m))
    *_, stats = ref(*ref.put(rows, lengths))
    assert counts.sum(dim=0).tolist() == _ref_counts(stats)
    s = 64 // m
    for i in range(m):
        shard = extract_stats_plain(torch.from_numpy(rows[i * s:(i + 1) * s]),
                                    torch.from_numpy(
                                        lengths[i * s:(i + 1) * s]), prog)
        assert counts[i].tolist() == shard[3].tolist()


# -- ShardedKernel: the reference's TestShardAlignedPacking -------------------


def _kv_batch(n, B):
    lines = [b"k%d:%d" % (i, i) for i in range(n)]
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines), np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    return pack_rows(arena, offs, lens, 128, B), lens


def _both(m):
    return (ref_mesh.ShardedKernel(ref_compile(PAT), ref_mesh.make_mesh(m)),
            port_mesh.ShardedKernel(compile_tier1(PAT),
                                    port_mesh.make_mesh(m, device="cpu")))


def test_batch_multiple_contract():
    ref, kern = _both(8)
    assert kern.batch_multiple == ref.batch_multiple == 8
    for n, mb, mult in ((5, 32, 8), (300, None, 8), (10, 4, 8),
                        (100, 32, 6)):
        B = pad_batch(n, min_batch=mb, multiple_of=mult)
        assert B % mult == 0 and B >= n


@pytest.mark.parametrize("n,B", [(64, 64), (300, 300)],
                         ids=["aligned", "unaligned"])
def test_direct_call_pads_like_reference(n, B):
    ref, kern = _both(8)
    batch, _ = _kv_batch(n, B)
    ref_pf = ref.status()["pad_fallbacks"]
    pf = kern.status()["pad_fallbacks"]
    r = [np.asarray(a) for a in ref(batch.rows, batch.lengths)]
    g = [t.numpy() for t in kern(batch.rows, batch.lengths)]
    for a, b in zip(r, g):
        np.testing.assert_array_equal(a, b)
    single = ExtractKernel(compile_tier1(PAT)).plain(
        torch.from_numpy(batch.rows), torch.from_numpy(batch.lengths))
    np.testing.assert_array_equal(g[0][:B], single[0].numpy())
    assert kern.status()["pad_fallbacks"] - pf \
        == ref.status()["pad_fallbacks"] - ref_pf == (B % 8 != 0)


def test_stats_fold_off_the_hot_path_like_reference():
    ref, kern = _both(8)
    batch, lens = _kv_batch(64, 64)
    base_r, base_k = ref.status(), kern.status()
    for _ in range(3):
        ref(batch.rows, batch.lengths)
        kern(batch.rows, batch.lengths)
    # queued, not yet folded: the counters still hold the base
    assert len(kern._stats_pending) == 3
    assert kern._matched_total.value == base_k["totals"]["matched"]
    tr, tk = ref.materialize_stats(), kern.materialize_stats()
    for key in ("matched", "events", "bytes"):
        assert tk[key] - base_k["totals"][key] \
            == tr[key] - base_r["totals"][key]
    assert tk["matched"] - base_k["totals"]["matched"] == 3 * 64
    assert tk["bytes"] - base_k["totals"]["bytes"] == 3 * int(lens.sum())
    sr, sk = ref.status(), kern.status()
    assert sk["chips"] == sr["chips"] == 8
    assert sk["dispatches"] - base_k["dispatches"] \
        == sr["dispatches"] - base_r["dispatches"] == 3
    assert sk["per_chip_row_occupancy"] == sr["per_chip_row_occupancy"]
    assert sk["per_chip_padding_fraction"] \
        == sr["per_chip_padding_fraction"]


def test_queue_folds_oldest_past_its_depth():
    _, kern = _both(2)
    batch, _ = _kv_batch(64, 64)
    for _ in range(kern.STATS_QUEUE_MAX + 3):
        kern(batch.rows, batch.lengths)
    assert len(kern._stats_pending) == kern.STATS_QUEUE_MAX
    assert port_mesh.mesh_status()["kernels"]


# -- the engine in sharded mode -------------------------------------------------


@pytest.mark.parametrize("seed", range(2))
def test_sharded_engine_matches_reference(monkeypatch, seed):
    monkeypatch.setenv("LOONG_SHARDED", "1")
    monkeypatch.setenv("LOONG_MESH_CHIPS", "8")
    from test_torch_engine import _corpus, _layout
    lines = _corpus(seed)
    arena, offs, lens = _layout(lines)
    ref_eng = ref_engine_mod.RegexEngine(APACHE)
    ref_kern = ref_eng._maybe_sharded()
    eng = port_engine.RegexEngine(APACHE, device="cpu")
    kern = eng._maybe_sharded()
    assert isinstance(kern, port_mesh.ShardedKernel)
    assert kern.batch_multiple == ref_kern.batch_multiple == 8 \
        == len(jax.devices())
    ref_base, base = ref_kern.status(), kern.status()
    ref = ref_eng.parse_batch(arena, offs, lens)
    got = eng.parse_batch(arena, offs, lens)
    np.testing.assert_array_equal(np.asarray(ref.ok), got.ok)
    np.testing.assert_array_equal(np.asarray(ref.cap_off), got.cap_off)
    np.testing.assert_array_equal(np.asarray(ref.cap_len), got.cap_len)
    assert eng._device_kernel() is kern
    assert eng.device_batches == 1 and eng.kernel.launches == 0
    ref_st, st = ref_kern.status(), kern.status()
    for key in ("matched", "events", "bytes"):
        assert st["totals"][key] - base["totals"][key] \
            == ref_st["totals"][key] - ref_base["totals"][key]
    assert st["totals"]["events"] - base["totals"]["events"] \
        == int(((lens > 0) & (lens <= 4096)).sum())
    assert st["dispatches"] - base["dispatches"] \
        == ref_st["dispatches"] - ref_base["dispatches"] == 1
    assert st["per_chip_row_occupancy"] == ref_st["per_chip_row_occupancy"]
    assert st["pad_fallbacks"] - base["pad_fallbacks"] == 0


def test_sharded_off_and_auto(monkeypatch):
    """``LOONG_SHARDED=0`` keeps the staged K1; unset, a one-shard CPU
    mesh keeps it too, and ``LOONG_MESH_CHIPS=4`` turns the mesh on."""
    monkeypatch.setenv("LOONG_SHARDED", "0")
    monkeypatch.setenv("LOONG_MESH_CHIPS", "4")
    eng = port_engine.RegexEngine(PAT, device="cpu")
    assert not isinstance(eng._device_kernel(), port_mesh.ShardedKernel)
    monkeypatch.delenv("LOONG_SHARDED")
    monkeypatch.delenv("LOONG_MESH_CHIPS")
    eng = port_engine.RegexEngine(PAT, device="cpu")
    assert not isinstance(eng._device_kernel(), port_mesh.ShardedKernel)
    monkeypatch.setenv("LOONG_MESH_CHIPS", "4")
    eng = port_engine.RegexEngine(PAT, device="cpu")
    kern = eng._device_kernel()
    assert isinstance(kern, port_mesh.ShardedKernel)
    assert kern.batch_multiple == 4


@pytest.mark.parametrize("depth", [1, 3])
def test_sharded_async_chunks_settle(monkeypatch, depth):
    """Several chunks in flight through the sharded plane: spans equal the
    single-device engine's, the plane, ring and staging ledger settle."""
    monkeypatch.setenv("LOONG_MESH_CHIPS", "4")
    monkeypatch.setattr("loongcollector_tpu_torch.ops.regex.engine.MAX_BATCH",
                        256)
    DevicePlane.reset_for_testing()
    device_stream.reset_for_testing()
    lines = gen_lines(1000, seed=9)
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines), np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    monkeypatch.setenv("LOONG_SHARDED", "0")
    want = port_engine.RegexEngine(APACHE, device="cpu").parse_batch(
        arena, offs, lens)
    monkeypatch.setenv("LOONG_SHARDED", "1")
    eng = port_engine.RegexEngine(APACHE, device="cpu")
    kern = eng._maybe_sharded()
    base = kern.status()
    got = eng.parse_batch_async(arena, offs, lens, depth=depth).result()
    np.testing.assert_array_equal(got.ok, want.ok)
    np.testing.assert_array_equal(got.cap_off, want.cap_off)
    np.testing.assert_array_equal(got.cap_len, want.cap_len)
    st = kern.status()
    assert eng.device_batches == st["dispatches"] - base["dispatches"] == 4
    assert st["totals"]["events"] - base["totals"]["events"] == 1000
    assert st["totals"]["bytes"] - base["totals"]["bytes"] \
        == int(lens.sum())
    assert DevicePlane.instance().inflight_bytes() == 0
    assert device_stream.batch_ring().leased_total() == 0
    assert mem_live_bytes("sharded_staging") == 0


# -- the agent ------------------------------------------------------------------


def _agent(tmp, log_path, tag, monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port_engine.clear_engine_cache()
    gc.collect()        # the cleared engines' sharded kernels go too
    out_path = str(tmp / f"out_{tag}.json")
    stats_path = str(tmp / f"stats_{tag}.json")
    cfg_dir = tp._config(tmp, log_path, out_path)
    assert port_main(["--config", cfg_dir, "--once", "--cpu",
                      "--stats", stats_path]) == 0
    with open(out_path, "rb") as f, open(stats_path) as g:
        return f.read(), json.load(g)


def test_agent_chips_1_vs_8_byte_identical(tp_case, monkeypatch):
    tmp, log_path, want = tp_case
    monkeypatch.setattr(time, "time", lambda: tp.PINNED_TIME)
    # the mesh counters are the process's, per chip count
    base = {c: port_mesh._mesh_record(c).counter("mesh_events_total").value
            for c in (1, 8)}
    one, st1 = _agent(tmp, log_path, "c1", monkeypatch, LOONG_SHARDED="1",
                      LOONG_MESH_CHIPS="1")
    eight, st8 = _agent(tmp, log_path, "c8", monkeypatch,
                        LOONG_MESH_CHIPS="8")
    assert one == eight
    for st, chips in ((st1, 1), (st8, 8)):
        mesh = st["mesh"]
        (k,) = [k for k in mesh["kernels"] if k["chips"] == chips]
        assert st["launches"] == 0 and st["launch_shapes"] == []
        assert st["device_batches"] == st["plane"]["dispatches"] > 0
        assert k["totals"]["events"] - base[chips] + st["re_oversize_rows"] \
            == st["events"] == 7001
        assert st["timeline"]["legs"]["exec"]["count"] \
            == st["device_batches"]
        assert st["device_memory"]["families"]["sharded_staging"][
            "live_bytes"] == 0
        assert mesh["router"] is None


def test_agent_sharded_matches_reference(tp_case, monkeypatch):
    """The Apache config with ``LOONG_SHARDED=1`` on both sides: the JAX
    package's processors over its eight-device mesh, the port's agent over
    eight CPU shards; the NDJSON is byte-equal."""
    tmp, log_path, _ = tp_case
    monkeypatch.setattr(time, "time", lambda: tp.PINNED_TIME)
    monkeypatch.setenv("LOONG_SHARDED", "1")
    ref_engine_mod.clear_engine_cache()
    want = tp._reference_ndjson(log_path)
    assert any(e._sharded not in (None, False)
               for e in ref_engine_mod._engine_cache.values())
    got, st = _agent(tmp, log_path, "ref8", monkeypatch,
                     LOONG_MESH_CHIPS="8")
    assert got == want
    assert st["mesh"]["kernels"][0]["chips"] == 8


@pytest.fixture
def tp_case(tmp_path):
    log_path = str(tmp_path / "access.log")
    tp._write_log(log_path)
    return tmp_path, log_path, None


# -- the timeline's shard legs ------------------------------------------------


class _Event:
    """Stands in for a CUDA event: a completion flag and a device time."""

    def __init__(self, t_ms):
        self.t_ms = t_ms

    def query(self):
        return True

    def elapsed_time(self, other):
        return other.t_ms - self.t_ms


def test_shard_legs_resolve_per_shard():
    """A sharded dispatch's h2d legs, tagged with their shards, resolve
    into the leg summary and, per shard, into ``shard_leg_summary``; its
    one exec leg stays one for the busy share."""
    from loongcollector_tpu_torch.ops import xprof
    with xprof.active() as t:
        t.device_epoch = _Event(0.0)
        for d in range(2):
            xid = xprof.begin_dispatch(100)
            for i in range(4):
                xprof.event_leg(xid, "h2d", _Event(d * 10 + i),
                                _Event(d * 10 + i + 0.5 * (i + 1)), shard=i)
            xprof.event_leg(xid, "exec", _Event(d * 10 + 4),
                            _Event(d * 10 + 6))
            xprof.close_dispatch(xid)
        legs = t.leg_summary()
        shards = t.shard_leg_summary()
    assert legs["h2d"]["count"] == 8 and legs["exec"]["count"] == 2
    assert sorted(shards["h2d"]) == ["0", "1", "2", "3"]
    for i in range(4):
        got = shards["h2d"][str(i)]
        assert got["count"] == 2
        assert got["median_s"] == pytest.approx(0.5e-3 * (i + 1))
    assert "exec" not in shards
    assert t.exec_union_seconds() == pytest.approx(4e-3)


# -- failures raise ---------------------------------------------------------------


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        port_mesh.make_mesh()
    with pytest.raises(NoCudaDevice):
        port_mesh.ShardedKernel(compile_tier1(PAT))
    assert port_mesh.make_mesh(3, device="cpu").size == 3
    assert port_mesh.make_mesh(devices=["cpu"] * 2).size == 2


def test_engine_mesh_build_failure_raises(monkeypatch):
    monkeypatch.setenv("LOONG_SHARDED", "1")

    def boom(*a, **k):
        raise RuntimeError("no mesh")

    monkeypatch.setattr(port_mesh, "make_mesh", boom)
    eng = port_engine.RegexEngine(PAT, device="cpu")
    lines = [b"a:1"] * 4
    lens = np.array([3] * 4, np.int32)
    offs = np.arange(4, dtype=np.int64) * 3
    with pytest.raises(RuntimeError, match="no mesh"):
        eng.parse_batch(np.frombuffer(b"".join(lines), np.uint8), offs, lens)


def test_unaligned_slot_raises():
    kern = port_mesh.ShardedKernel(compile_tier1(PAT),
                                   port_mesh.make_mesh(4, device="cpu"))
    slot = device_stream.batch_ring().lease(30, 64)
    try:
        with pytest.raises(ValueError, match="multiple of the mesh"):
            kern(slot, 2)
    finally:
        slot.release()


class _OtherDeviceRows:
    device = torch.device("cuda", 1)


def test_k8_launch_off_the_current_device_raises(monkeypatch):
    """The C entry point writes through the current device's pointers, so
    rows on another device raise before any launch."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    kp = fxc.program_arrays(compile_tier1(PAT))
    with pytest.raises(ValueError, match="current device"):
        fxc.launch_stats(_OtherDeviceRows(), None, None, kp)


def test_with_stats_sends_cuda_tensors_to_k8_never_plain(monkeypatch):
    kern = ExtractKernel(compile_tier1(PAT))

    def plain(*a):
        raise AssertionError("plain version ran for a CUDA tensor")

    kern.plain = plain
    calls = []
    monkeypatch.setattr(kern, "device_program", lambda dev: "prog")
    monkeypatch.setattr(fxc, "launch_stats",
                        lambda *a: calls.append(a) or ("o", "f", "l", "s"))
    rows = _OtherDeviceRows()
    assert kern.with_stats(rows, rows) == ("o", "f", "l", "s")
    assert kern.stats_launches == 1 and kern.launches == 0 and len(calls) == 1


# -- K8's one launch a device: the pieces' schedule -------------------------------


def _k8_twin(ok, lengths, shard_rows, threads, pieces, mutation=None):
    """K8's count epilogue in numpy, as one launch over shards of
    ``shard_rows`` rows runs it: block b holds rows [b·T, (b+1)·T), each
    warp 32 of them; a lane's shard is its row // shard_rows; each lane
    sums, by shuffles up 1, 2, 4, 8, 16 lanes, the lanes from its shard's
    first row in the warp to its own; the last lane of each piece (the
    warp's last row, or a shard's) writes the piece's three counts at
    ``ceil(r/32) + ceil(r/s) - ceil(r/lcm)`` for its first row r, over
    whatever the buffer held.  ``mutation``: "boundary" puts the shard
    boundaries one row late; "accumulate" adds to the buffer instead of
    writing it."""
    B = len(ok)
    _, lcm = fxc.stat_pieces(B, shard_rows)
    shift = 1 if mutation == "boundary" else 0
    vals = np.stack([np.asarray(ok, np.int64),
                     (np.asarray(lengths) > 0).astype(np.int64),
                     np.asarray(lengths, np.int64)], axis=1)
    for row0 in range(0, B, threads):
        nrows = min(threads, B - row0)
        for wrow in range(0, threads, 32):
            wrows = max(0, min(32, nrows - wrow))
            if not wrows:
                continue
            first = row0 + wrow
            lane = np.arange(32)
            row = first + lane
            sh = (row - shift) // shard_rows
            seg = np.maximum(sh * shard_rows + shift - first, 0)
            v = np.zeros((32, 3), np.int64)
            v[:wrows] = vals[first:first + wrows]
            for d in (1, 2, 4, 8, 16):
                up = np.roll(v, d, axis=0)
                take = lane - d >= seg
                v = v + np.where(take[:, None], up, 0)
            for ln in range(wrows):
                if ln == 31 or ln + 1 == wrows \
                        or (row[ln] + 1 - shift) % shard_rows == 0:
                    r = first + int(seg[ln])
                    p = -(-r // 32) + -(-r // shard_rows) - -(-r // lcm)
                    if mutation == "accumulate":
                        pieces[p] += v[ln]
                    else:
                        pieces[p] = v[ln]
    return pieces


def _k8_shards(rows, lengths, m, prog):
    s = len(rows) // m
    return [extract_stats_plain(torch.from_numpy(rows[i * s:(i + 1) * s]),
                                torch.from_numpy(lengths[i * s:(i + 1) * s]),
                                prog)[3].tolist() for i in range(m)]


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("threads", ["geometry", 128])
def test_k8_one_launch_twin_equals_plain_and_jax(m, threads):
    """The twin of K8's one launch over a device's m shards (B/m not a
    multiple of 32: warps straddle shard boundaries) folds, per shard, to
    the plain K8 of the shard's rows and, summed, to the JAX plane's psum'd
    totals; a second launch on the same buffer (the first launch's pieces
    in it) folds to the second batch's counts.  The plain pieces of
    ``ExtractKernel.with_stats`` are the twin's."""
    prog = compile_tier1(EMPTY)
    kern = ExtractKernel(prog)
    ref = ref_mesh.ShardedParsePlane(ref_compile(EMPTY),
                                     ref_mesh.make_mesh(m))
    B = 300
    s = B // m
    assert s % 32
    n_pieces, _ = fxc.stat_pieces(B, s)
    T = threads if threads == 128 else fxc.launch_geometry(
        B, 128, kern.num_caps, kern.kernel_program.pivot,
        len(kern.kernel_program.blob))[0]
    buf = np.full((n_pieces, 3), -7, np.int64)          # stale memory
    for seed in (m, m + 10):
        rows, lengths = _rows(EMPTY, B, 128, seed=seed)
        ok = kern.plain(torch.from_numpy(rows), torch.from_numpy(lengths))[0]
        buf = _k8_twin(ok.numpy(), lengths, s, T, buf)
        got = port_mesh.fold_pieces(buf, B, s)
        assert got.tolist() == _k8_shards(rows, lengths, m, prog)
        *_, stats = ref(*ref.put(rows, lengths))
        assert got.sum(dim=0).tolist() == _ref_counts(stats)
        plain = kern.with_stats(torch.from_numpy(rows),
                                torch.from_numpy(lengths), shard_rows=s)[3]
        np.testing.assert_array_equal(plain.numpy(), buf)


@pytest.mark.parametrize("mutation", ["boundary", "accumulate"])
def test_k8_twin_mutations_fail(mutation):
    """Two faults of the twin each show at every mesh size: shard
    boundaries one row off, and pieces added to the buffer's old contents
    (the second launch then counts the first's rows too)."""
    prog = compile_tier1(EMPTY)
    kern = ExtractKernel(prog)
    for m in (1, 2, 3, 4):
        B = 300
        s = B // m
        n_pieces, _ = fxc.stat_pieces(B, s)
        buf = np.zeros((n_pieces, 3), np.int64)
        wrong = 0
        for seed in (m, m + 10):
            rows, lengths = _rows(EMPTY, B, 128, seed=seed)
            ok = kern.plain(torch.from_numpy(rows),
                            torch.from_numpy(lengths))[0]
            buf = _k8_twin(ok.numpy(), lengths, s, 32, buf, mutation)
            got = port_mesh.fold_pieces(buf, B, s).tolist()
            wrong += got != _k8_shards(rows, lengths, m, prog)
        assert wrong, (mutation, m)


def test_mesh_runs_give_each_device_one_launch():
    """``DeviceMesh.runs``: a device's consecutive shards are one run (one
    K8 launch), a repeated device out of order a run each."""
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert port_mesh.DeviceMesh([c0] * 4).runs() == [(c0, 0, 4)]
    assert port_mesh.DeviceMesh([c0, c0, c1, c1]).runs() == [
        (c0, 0, 2), (c1, 2, 2)]
    assert port_mesh.DeviceMesh([c0, c1, c0]).runs() == [
        (c0, 0, 1), (c0, 2, 1), (c1, 1, 1)]


def test_staged_cpu_dispatch_folds_counts_per_shard():
    """A staged dispatch of a four-shard CPU mesh returns its counts as
    ``ShardCounts``, whose fold is each shard's plain K8 counts."""
    prog = compile_tier1(EMPTY)
    plane = port_mesh.ShardedParsePlane(
        prog, port_mesh.make_mesh(4, device="cpu"))
    rows, lengths = _rows(EMPTY, 96, 128, seed=5)
    slot = device_stream.batch_ring().lease(96, 128)
    try:
        slot.rows.numpy()[:] = rows
        slot.lengths.numpy()[:] = lengths
        outs, counts, fence = plane.staged(slot, prog.num_caps)
        assert fence is None and isinstance(counts, port_mesh.ShardCounts)
        assert counts.fold().tolist() == _k8_shards(rows, lengths, 4, prog)
        np.testing.assert_array_equal(
            outs[0].numpy(), ExtractKernel(prog).plain(
                torch.from_numpy(rows), torch.from_numpy(lengths))[0])
    finally:
        slot.release()
