"""K6, the rollup's segment reduce, in the port against the JAX package.

* the plain K6 (``segment_reduce.reduce_plain``) against the reference's
  ``build_reduce_fn`` jitted on CPU JAX, over the seeded batches of
  ``testdata.k6_cases`` at B up to 2048: several B and G, 41 buckets and
  1, invalid shares of 0, 10% and 100%, a hot segment, +-inf and both
  zeros.  Counts, histograms, min, max and last are exact (``array_equal``,
  under which -0.0 == +0.0); sums, f32 in both, within rtol = atol = 1e-5,
  the reference's own device tolerance (``scripts/agg_equivalence.py:163``),
  since the two add in different orders;
* the host twins bit-identical with the reference's: ``hist_bucket`` and
  ``hist_bucket_scalar``, ``parse_values``, ``_first_seen_ids`` and
  ``fold_batch_numpy`` (floats compared with ``equal_nan``: inf + -inf in
  one key sums to NaN on every substrate), and ``fold_batch_native`` equal
  to the reference's;
* ``SegmentReduceKernel.fold_batch`` on the CPU against the reference's
  device fold (JAX on the CPU), on the gate's ``device_ok`` corpora
  (rebuilt in ``testdata.agg_batch_corpus``): group ids, representative
  rows, counts and histograms exact, min / max / last equal, sums at the
  gate's tolerance; and against the numpy twin as the gate holds the
  device (min / max / last equal to the twin's through f32);
* a fold of more than ``MAX_BATCH`` rows raises, as the reference's fails;
* a fold that names no device runs on the card, and raises without one.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loongcollector_tpu.ops.kernels import segment_reduce as ref  # noqa: E402
from loongcollector_tpu_torch import testdata as td  # noqa: E402
from loongcollector_tpu_torch.ops.kernels import segment_reduce as sr  # noqa: E402
from test_torch_alarms import alarms_left_empty  # noqa: E402,F401
from test_torch_parse_delimiter import both_native  # noqa: E402,F401

TOL = 1e-5    # rtol = atol: scripts/agg_equivalence.py:163

FIELDS = ("group_id", "rep_row", "sum", "count", "min", "max", "last",
          "hist")


@pytest.fixture(autouse=True)
def _reference_state_cleared():
    """The JAX package's alarm buffer and ledger are process-wide: what the
    reference code run here leaves in them must not reach a later test in
    the same worker."""
    yield
    from loongcollector_tpu.monitor import ledger as _ref_ledger
    from loongcollector_tpu.monitor.alarms import AlarmManager
    from loongcollector_tpu_torch.monitor import ledger as _port_ledger
    AlarmManager.instance().flush()
    _ref_ledger.disable()
    _port_ledger.disable()


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if np.issubdtype(a.dtype, np.floating):
        return np.array_equal(a, b, equal_nan=True)
    return np.array_equal(a, b)


_jax_fns = {}


def _jax_reduce(vals, seg, buckets, valid, G, n_hist):
    fn = _jax_fns.get(n_hist)
    if fn is None:
        fn = _jax_fns[n_hist] = jax.jit(ref.build_reduce_fn(n_hist),
                                        static_argnums=(4,))
    return [np.asarray(a) for a in jax.device_get(
        fn(jnp.asarray(vals), jnp.asarray(seg), jnp.asarray(buckets),
           jnp.asarray(valid), G))]


@pytest.mark.parametrize("case", td.k6_cases(max_rows=2048),
                         ids=lambda c: c[0])
def test_plain_k6_matches_jax_build_reduce_fn(case):
    _label, B, G, n_hist, invalid, hot, inf, spread = case
    vals, seg, buckets, valid = td.k6_batch(B + G, B, G, n_hist, invalid,
                                            hot, inf, spread=spread)
    want = _jax_reduce(vals, seg, buckets, valid, G, n_hist)
    got = [t.numpy() for t in sr.reduce_plain(
        torch.from_numpy(vals), torch.from_numpy(seg),
        torch.from_numpy(buckets), torch.from_numpy(valid), G, n_hist)]
    names = ("sum", "count", "min", "max", "last", "hist")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        if name == "sum":
            assert g.dtype == np.float32
            assert np.allclose(g, w, rtol=TOL, atol=TOL, equal_nan=True)
        else:
            assert np.array_equal(g, w.astype(g.dtype)), name
    if invalid == 1.0:
        assert not got[1].any() and not got[5].any()


def test_plain_k6_of_an_empty_batch_is_the_empty_values():
    """B = 0 (a cluster-tier geometry chip_smoke.py launches): every
    segment keeps its empty values."""
    e = np.zeros(0, np.float32)
    i = np.zeros(0, np.int32)
    got = [t.numpy() for t in sr.reduce_plain(
        torch.from_numpy(e), torch.from_numpy(i), torch.from_numpy(i),
        torch.from_numpy(np.zeros(0, bool)), 16, 41)]
    want = _jax_reduce(np.zeros(1, np.float32), np.full(1, 16, np.int32),
                       np.zeros(1, np.int32), np.zeros(1, bool), 16, 41)
    _check_six(got, want, "B=0")
    assert (got[2] == np.inf).all() and (got[3] == -np.inf).all()
    assert not got[1].any() and not got[4].any() and not got[5].any()


def test_kernel_wrapper_on_cpu_is_the_plain_version():
    vals, seg, buckets, valid = td.k6_batch(3, 512, 64, 41, 0.1, True, True)
    kern = sr.SegmentReduceKernel()
    args = [torch.from_numpy(a) for a in (vals, seg, buckets, valid)]
    got = kern(*args, 64)
    want = sr.reduce_plain(*args, 64, 41)
    # sums may be NaN (inf + -inf in one segment): compared with equal_nan
    assert all(_same(a.numpy(), b.numpy()) for a, b in zip(got, want))
    assert kern.dispatch_count == 1 and kern.launches == 0


def test_split_outputs_layout():
    G, n_hist = 16, 3
    flat = torch.arange(5 * G + G * n_hist, dtype=torch.int32)
    s, c, mn, mx, last, hist = sr.split_outputs(flat, G, n_hist)
    assert c.tolist() == list(range(G, 2 * G))
    assert s.dtype == mn.dtype == mx.dtype == last.dtype == torch.float32
    assert s.view(torch.int32).tolist() == list(range(G))
    assert last.view(torch.int32).tolist() == list(range(4 * G, 5 * G))
    assert hist.shape == (G, n_hist) and int(hist[0, 0]) == 5 * G


@pytest.mark.parametrize("seed", range(4))
def test_hist_bucket_bit_identical(seed):
    rng = np.random.default_rng(seed)
    v = np.concatenate([
        rng.standard_normal(4000) * 10.0 ** rng.integers(-5, 12, 4000),
        2.0 ** np.arange(-4, 45), [0.0, -0.0, 1.0, np.inf, -np.inf,
                                   np.nextafter(1.0, 2.0), 1e300]])
    for base in (1.0, 0.5, 3.0):
        for n_hist in (41, 8, 1):
            got = sr.hist_bucket(v, base, n_hist)
            assert _same(got, ref.hist_bucket(v, base, n_hist))
            assert [sr.hist_bucket_scalar(float(x), base, n_hist)
                    for x in v[:300]] == [
                ref.hist_bucket_scalar(float(x), base, n_hist)
                for x in v[:300]]


def _value_tokens(seed):
    rng = np.random.default_rng(seed)
    toks = [b" 1.5 ", b"\t2e3\t", b"+.5", b"-0.0", b"1_0", b"0x10", b"nan",
            b"inf", b"-INF", b"Infinity", b"", b"  ", b"1e", b".", b"5.",
            b".5e-2", b"12345678901234567890", b"3." + b"1" * 40,
            b" " * 40 + b"7", b"1e300", b"-1e-300"]
    for _ in range(2000):
        x = rng.standard_normal() * 10.0 ** int(rng.integers(-8, 12))
        form = int(rng.integers(4))
        toks.append((f"{x:.6g}" if form == 0 else f"{x:.3f}" if form == 1
                     else f"{x:.5e}" if form == 2
                     else str(int(x))).encode())
    return toks


@pytest.mark.parametrize("seed", range(3))
def test_parse_values_bit_identical(seed):
    toks = _value_tokens(seed)
    arena = np.frombuffer(b"".join(toks), np.uint8)
    lens = np.array([len(t) for t in toks], np.int32)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    lens[::97] = -1                      # absent values
    got = sr.parse_values(arena, offs, lens)
    want = ref.parse_values(arena, offs, lens)
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.parametrize("case", range(len(td.agg_batch_corpus())))
def test_first_seen_ids_and_numpy_fold_bit_identical(case):
    _label, rows, _ok = td.agg_batch_corpus()[case]
    args = td.pack_agg_rows(rows)
    got = sr.fold_batch_numpy(*args)
    want = ref.fold_batch_numpy(*args)
    for f in FIELDS:
        assert _same(getattr(got, f), getattr(want, f)), f
    assert _same(got.rep_key_blob, want.rep_key_blob)
    assert got.key_widths == want.key_widths
    arena, slots, key_offs, key_lens = args[:4]
    mat, widths = sr._key_matrix(arena, slots, key_offs, key_lens)
    rmat, rwidths = ref._key_matrix(arena, slots, key_offs, key_lens)
    assert _same(mat, rmat) and widths == rwidths
    ids, first = sr._first_seen_ids(mat)
    rids, rfirst = ref._first_seen_ids(rmat)
    assert _same(ids, rids) and _same(first, rfirst)


@pytest.mark.parametrize("case", range(len(td.agg_batch_corpus())))
def test_native_fold_equals_reference(case, both_native):
    # both bridges loaded whatever this worker's state (``both_native``)
    _label, rows, _ok = td.agg_batch_corpus()[case]
    args = td.pack_agg_rows(rows)
    got = sr.fold_batch_native(*args)
    want = ref.fold_batch_native(*args)
    assert (got is None) == (want is None)    # both bridges load one lib
    for f in FIELDS if got is not None else ():
        assert _same(getattr(got, f), getattr(want, f)), f


DEVICE_CASES = [i for i, (_l, _r, ok) in enumerate(td.agg_batch_corpus())
                if ok]


@pytest.mark.parametrize("case", DEVICE_CASES)
def test_device_fold_on_cpu_matches_reference_device_fold(case):
    _label, rows, _ok = td.agg_batch_corpus()[case]
    args = td.pack_agg_rows(rows)
    kern = sr.SegmentReduceKernel()
    got = kern.fold_batch(*args, device="cpu")
    want = ref.SegmentReduceKernel().fold_batch(*args)
    numpy_fold = ref.fold_batch_numpy(*args)
    for f in ("group_id", "rep_row", "count", "hist", "min", "max", "last"):
        assert _same(getattr(got, f), getattr(want, f)), f
    assert np.allclose(got.sum, want.sum, rtol=TOL, atol=TOL, equal_nan=True)
    # the gate's view: device against the numpy twin
    for f in ("group_id", "rep_row", "count", "hist"):
        assert _same(getattr(got, f), getattr(numpy_fold, f)), f
    for f in ("min", "max", "last"):
        assert _same(getattr(got, f), getattr(numpy_fold, f).astype(
            np.float32).astype(np.float64)), f
    assert np.allclose(got.sum, numpy_fold.sum, rtol=TOL, atol=TOL)
    assert _same(got.rep_key_blob, want.rep_key_blob)
    assert got.key_widths == want.key_widths
    assert kern.dispatch_count == 1 and kern.launches == 0


@pytest.mark.parametrize("n_hist", [41, 1])
def test_device_fold_geometry(n_hist):
    """B is pad_batch(n) and Gq the groups rounded up to a power of two of
    at least 16; a fold with no valid row dispatches nothing."""
    from loongcollector_tpu_torch.ops.device_batch import pad_batch
    rows = [(b"m%d" % (i % 37), (b"h",), b"%d" % i, 0) for i in range(300)]
    args = td.pack_agg_rows(rows)
    kern = sr.SegmentReduceKernel(n_hist)
    seen = []
    orig = kern._reduce_staged

    def spy(buf, B, Gq, device):
        seen.append((B, Gq, buf.numel()))
        return orig(buf, B, Gq, device)
    kern._reduce_staged = spy
    fold = kern.fold_batch(*args, device="cpu")
    assert seen == [(pad_batch(300), 64, 13 * pad_batch(300))]
    assert fold.n_groups == 37 and fold.hist.shape == (37, n_hist)
    bad = [(b"m", (b"h",), b"nan", 0)] * 5
    empty = kern.fold_batch(*td.pack_agg_rows(bad), device="cpu")
    assert empty.n_groups == 0 and empty.n_invalid == 5
    assert kern.dispatch_count == 1


def test_fold_over_max_batch_raises():
    from loongcollector_tpu_torch.ops.device_batch import MAX_BATCH
    n = MAX_BATCH + 1
    arena = np.frombuffer(b"m1", np.uint8)
    args = (arena, np.zeros(n, np.int64), np.zeros((n, 1), np.int64),
            np.ones((n, 1), np.int32), np.ones(n, np.int64),
            np.ones(n, np.int32))
    with pytest.raises(sr.BatchTooLarge, match="MAX_BATCH"):
        sr.SegmentReduceKernel().fold_batch(*args, device="cpu")


def test_fold_defaults_to_the_card(monkeypatch):
    """A caller that names no device gets the card: with none there the
    fold raises rather than running the plain version on the CPU."""
    from loongcollector_tpu_torch.utils.device import NoCudaDevice
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kern = sr.SegmentReduceKernel()
    args = td.pack_agg_rows([(b"m", (b"h",), b"1", 0)])
    with pytest.raises(NoCudaDevice):
        kern.fold_batch(*args)
    assert kern.dispatch_count == 0


# -- the cluster form (chip_probe.py k6): its plan and a numpy twin ---------
#
# The form measured against K6's three kernels on the card, kept in
# chip_probe.py: one thread-block cluster whose blocks each hold a range of
# the segments in shared memory.  Its geometry is host arithmetic, and its
# schedule is held here against the plain K6 and the reference.

import chip_probe  # noqa: E402


@pytest.mark.parametrize("G,n_hist,c", [(2048, 41, 2), (4096, 41, 4),
                                        (16, 41, 1), (2049, 41, 2),
                                        (65536, 1, 7)])
def test_cluster_form_takes_the_fewest_blocks_that_fit(G, n_hist, c):
    """The rollup path's folds (Gq 2048 and 4096 at 41 buckets), the
    smallest Gq and an odd G take the fewest blocks whose ranges fit 227 KB
    of shared memory each."""
    assert chip_probe.smallest_cluster(G, n_hist) == c
    blocks, threads, smem = chip_probe.form_plan("cluster", G, n_hist, c)
    assert (blocks, threads) == (c, 1024)
    assert smem == chip_probe.cluster_smem(-(-G // c), n_hist) \
        <= chip_probe.K6_SMEM_MAX == 232_448
    if c > 1:
        assert chip_probe.form_plan("cluster", G, n_hist, c - 1) is None
    if (G, n_hist) == (2048, 41):        # 20 + 4 n_hist bytes a segment
        assert chip_probe.cluster_smem(2048, 41) == 376_832


def test_cluster_form_holds_no_bench_geometry():
    """B = Gq = 65536 at 41 buckets (12.3 MB of state) fits no cluster."""
    assert chip_probe.smallest_cluster(65536, 41) is None
    assert chip_probe.form_plan("cluster", 65536, 41, 16) is None
    assert chip_probe.form_plan("shared", 65536, 41, 64) is not None
    assert chip_probe.form_plan("cluster_global", 65536, 41, 16) == (
        16, 1024, 0)


@pytest.mark.parametrize("n_hist", [41, 8, 1])
def test_cluster_form_boundary(n_hist):
    """``cluster_capacity`` is the largest G the cluster form holds: it and
    one below take the largest cluster, one above fits none; a card that
    holds smaller clusters moves the boundary with it."""
    cap = chip_probe.cluster_capacity(n_hist)
    R = cap // chip_probe.K6_MAX_CLUSTER
    assert chip_probe.cluster_smem(R, n_hist) <= chip_probe.K6_SMEM_MAX \
        < chip_probe.cluster_smem(R + 1, n_hist)
    for G in (cap - 1, cap):
        assert chip_probe.smallest_cluster(G, n_hist) == 16
    assert chip_probe.smallest_cluster(cap + 1, n_hist) is None
    cap8 = chip_probe.cluster_capacity(n_hist, max_cluster=8)
    assert cap8 == 8 * R
    assert chip_probe.smallest_cluster(cap8, n_hist, max_cluster=8) == 8
    assert chip_probe.smallest_cluster(cap8 + 1, n_hist,
                                       max_cluster=8) is None
    if n_hist == 41:
        assert cap == 20_208


def test_cluster_form_source_agrees_with_its_plan():
    import re
    text = chip_probe.K6_FORMS
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(consts["kClusterThreads"]) == chip_probe.K6_THREADS
    assert int(consts["kMaxCluster"]) == chip_probe.K6_MAX_CLUSTER
    assert "return 20 * round4(R) + 4 * R * n_hist;" in text
    assert "return 20 * round4(R) + 4 * R * n_hist + 4 * threads;" in text
    # the cluster form's fold: distributed shared-memory reductions
    reds = re.findall(r'"red\.([\w.:]+) ', text)
    assert reds and all(r.startswith("relaxed.cluster.shared::cluster.")
                        for r in reds)
    assert "cudaLaunchKernelEx" in text
    assert set(chip_probe.K6_FORM_CODES) == set(chip_probe.K6_FORM_SIZES)


_POISON = np.int32(0x7FC0DEAD)    # a word no section writes


def _cluster_twin(vals, seg, buckets, valid, G, n_hist, cluster,
                  owned=None, empty_values=True):
    """The cluster form's schedule in numpy, as ``cluster_kernel`` of
    ``chip_probe.K6_FORMS`` runs it:
    each block's shared memory (last row + 1, sum, count, min and max
    over ``Rp`` words, then the histogram) gets its empty values; each
    valid row whose segment lies in ``[0, G)`` folds into the block
    ``s // R`` at ``s - owner R`` (f32 adds; the float min / max on bit
    patterns, signed for a clear sign bit and unsigned otherwise; a u32
    max of ``row + 1``; the histogram when the bucket lies in
    ``[0, n_hist)``); then each block writes its owned range
    (``owned_range``) of each section, and each last value read from its
    row (0 for none).  The output starts as poison, so a word no block
    writes shows."""
    from loongcollector_tpu_torch.ops.kernels import segment_reduce_cuda as src
    owned = owned or chip_probe.owned_range
    R = -(-G // cluster)
    Rp = -(-R // 4) * 4
    out = np.full(src.out_words(G, n_hist), _POISON, np.int32)
    seg = seg.astype(np.int64)
    keep = valid & (seg >= 0) & (seg < G)
    owner = np.where(keep, seg // R, -1)
    for rank in range(cluster):
        last = np.zeros(Rp, np.uint32)
        sec = np.zeros((4, Rp), np.int32)
        if empty_values:
            sec[2] = np.int32(0x7F800000)
            sec[3] = np.uint32(0xFF800000).view(np.int32)
        hist = np.zeros(R * n_hist, np.int32)
        mine = np.nonzero(owner == rank)[0]
        k = seg[mine] - rank * R
        v = vals[mine].astype(np.float32)
        bits = v.view(np.int32)
        np.add.at(sec[0].view(np.float32), k, v)
        np.add.at(sec[1], k, 1)
        pos = bits >= 0
        np.minimum.at(sec[2], k[pos], bits[pos])
        np.maximum.at(sec[3], k[pos], bits[pos])
        np.maximum.at(sec[2].view(np.uint32), k[~pos],
                      bits[~pos].view(np.uint32))
        np.minimum.at(sec[3].view(np.uint32), k[~pos],
                      bits[~pos].view(np.uint32))
        np.maximum.at(last, k, (mine + 1).astype(np.uint32))
        b = buckets[mine].astype(np.int64)
        inb = (b >= 0) & (b < n_hist)
        np.add.at(hist, k[inb] * n_hist + b[inb], 1)
        r0, n = owned(rank, cluster, G)
        for j in range(4):
            out[j * G + r0: j * G + r0 + n] = sec[j][:n]
        rows = last[:n].astype(np.int64)
        out[4 * G + r0: 4 * G + r0 + n] = np.where(
            rows > 0, vals.astype(np.float32).view(np.int32)[rows - 1], 0)
        out[5 * G + r0 * n_hist: 5 * G + (r0 + n) * n_hist] = \
            hist[:n * n_hist]
    return out


def _twin_cases():
    """(label, B, G, n_hist, arrays) for the twin: the seeded batches of
    ``k6_cases`` (hot segments, empty segments, +-inf) and the edge kinds
    (every row in one segment, rows at owner boundaries +-1, segments and
    buckets out of range, every segment empty) at cluster geometries."""
    out = []
    for label, B, G, n_hist, invalid, hot, inf, spread in \
            td.k6_cases(max_rows=2048):
        out.append((label, B, G, n_hist, td.k6_batch(
            B + G, B, G, n_hist, invalid, hot, inf, spread=spread)))
    for B, G, n_hist in ((2048, 2048, 41), (2048, 4096, 41), (512, 16, 41),
                         (2048, 2049, 41), (1024, 300, 1)):
        c = chip_probe.smallest_cluster(G, n_hist)
        for kind in td.K6_EDGE_KINDS:
            out.append((f"{kind}_B{B}_G{G}_h{n_hist}", B, G, n_hist,
                        td.k6_edge_batch(kind, G + B, B, G, n_hist,
                                         -(-G // c))))
    return out


_TWIN_CASES = _twin_cases()


def _check_six(got, want, what, hist=True):
    names = ("sum", "count", "min", "max", "last", "hist")[:6 if hist else 5]
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, name)
        if name == "sum":
            assert np.allclose(g, w, rtol=TOL, atol=TOL, equal_nan=True), \
                (what, name)
        else:
            assert np.array_equal(g, w.astype(g.dtype)), (what, name)


@pytest.mark.parametrize("case", range(len(_TWIN_CASES)),
                         ids=[c[0] for c in _TWIN_CASES])
def test_cluster_schedule_twin_matches_plain_and_jax(case):
    """The twin of the cluster schedule, at the fewest blocks that fit and
    at the largest cluster, equals the plain K6 and the JAX
    ``build_reduce_fn``: counts, min, max, last and histograms exact, sums
    within rtol = atol = 1e-5.  A bucket outside ``[0, n_hist)`` (which
    the host's bucketing never gives) lands in a neighbouring segment's
    histogram in the reference's flat scatter and is dropped by the
    kernel, so the histograms of such batches are held to the plain K6
    only."""
    label, B, G, n_hist, (vals, seg, buckets, valid) = _TWIN_CASES[case]
    want = sr.reduce_plain(torch.from_numpy(vals), torch.from_numpy(seg),
                           torch.from_numpy(buckets),
                           torch.from_numpy(valid), G, n_hist)
    want = [t.numpy() for t in want]
    kept = valid & (seg >= 0) & (seg < G)
    hist_defined = bool(((buckets[kept] >= 0)
                         & (buckets[kept] < n_hist)).all())
    ref_out = _jax_reduce(vals, seg, buckets, valid, G, n_hist)
    _check_six(want, ref_out, f"{label} plain vs JAX", hist_defined)
    for c in sorted({chip_probe.smallest_cluster(G, n_hist),
                     chip_probe.K6_MAX_CLUSTER}):
        flat = _cluster_twin(vals, seg, buckets, valid, G, n_hist, c)
        assert not (flat == _POISON).any(), f"{label}: a word left unwritten"
        got = [t.numpy() for t in sr.split_outputs(torch.from_numpy(flat), G,
                                                   n_hist)]
        _check_six(got, want, f"{label} twin at {c}")
        _check_six(got, ref_out, f"{label} twin at {c} vs JAX", hist_defined)


@pytest.mark.parametrize("mutation", ["owner_range_off_by_one",
                                      "no_empty_values"])
def test_cluster_schedule_twin_mutations_fail(mutation):
    """Each of two faults of the twin (a block's owned range one segment
    off; the empty values not written) makes it disagree with the plain
    K6 on the edge batches."""

    def shifted(rank, cluster, G):
        r0, n = chip_probe.owned_range(rank, cluster, G)
        return r0 + 1, n

    kw = ({"owned": shifted} if mutation == "owner_range_off_by_one"
          else {"empty_values": False})
    failed = 0
    for label, B, G, n_hist, (vals, seg, buckets, valid) in _TWIN_CASES:
        if not label.startswith(("boundaries", "empty", "mixed")):
            continue
        want = [t.numpy() for t in sr.reduce_plain(
            torch.from_numpy(vals), torch.from_numpy(seg),
            torch.from_numpy(buckets), torch.from_numpy(valid), G, n_hist)]
        c = chip_probe.smallest_cluster(G, n_hist)
        try:           # a range past the output's end cannot even be written
            flat = _cluster_twin(vals, seg, buckets, valid, G, n_hist, c,
                                 **kw)
            got = [t.numpy() for t in sr.split_outputs(
                torch.from_numpy(flat), G, n_hist)]
            _check_six(got, want, label)
        except (AssertionError, ValueError):
            failed += 1
    assert failed >= 10


def test_owned_ranges_cover_every_segment_once():
    for G in (1, 16, 17, 2047, 2048, 2049, 4096, 20_208):
        for c in (1, 2, 3, 4, 8, 16):
            seen = np.zeros(G, np.int64)
            for rank in range(c):
                r0, n = chip_probe.owned_range(rank, c, G)
                assert 0 <= n <= -(-G // c)
                seen[r0:r0 + n] += 1
            assert (seen == 1).all(), (G, c)
