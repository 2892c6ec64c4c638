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
def test_native_fold_equals_reference(case):
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
