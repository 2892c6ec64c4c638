"""K3 in the port against the JAX package's program, on the CPU.

The plain version (``ops/kernels/dfa_scan.span_walk_plain`` behind
``DFASpanMatchKernel.plain``) must equal ``build_dfa_span_match_fn`` of the
JAX package, jitted on the CPU, bit-exact, on the same packed rows and
spans: spans at a row's start, in its middle, at its end and past its
length, negative starts, ``spanlen = -1`` and ``0``, padding rows, at
every length bucket.  Both agree with ``re.fullmatch`` on the span, cut at
the row's length.  The automata are each package's own compile of the
same pattern.

The wrapper: a CUDA tensor goes to the K3 launch (counted), never to the
plain version; ``LazySpanMatchKernel`` builds its kernel once, at its
first call; the entry point's C signature matches its ctypes binding.
"""

import os
import re
import zlib

import jax
import numpy as np
import pytest
import torch

from loongcollector_tpu.ops.kernels.dfa_scan import build_dfa_span_match_fn
from loongcollector_tpu.ops.regex.dfa import compile_dfa as ref_compile_dfa
from loongcollector_tpu_torch import testdata as td
from loongcollector_tpu_torch.ops.device_batch import (LENGTH_BUCKETS,
                                                        pack_rows)
from loongcollector_tpu_torch.ops.kernels import dfa_scan, dfa_scan_cuda
from loongcollector_tpu_torch.ops.kernels.dfa_scan import (
    DFASpanMatchKernel, LazySpanMatchKernel)
from loongcollector_tpu_torch.ops.regex.dfa import compile_dfa

PATTERNS = [r"[45]\d\d", "/health", td.JAVA_FILTER, r"(?:ab)+x", r"\d*",
            td.LIMIT_DFA]


def _batch(rng, L, B=96):
    lines = td._apache_rows(rng, 40, L) + td._java_rows(rng, 30, L) \
        + [b"404", b"/health", b"abx", b"ababx", b"", b"123"]
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines), np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    batch = pack_rows(arena, offs, lens, L, B)
    n = len(lines)
    ln = batch.lengths.astype(np.int64)
    starts = rng.integers(-3, L + 5, B).astype(np.int32)
    spans = rng.integers(-2, L + 5, B).astype(np.int32)
    starts[:12], spans[:12] = 0, ln[:12]                    # whole rows
    starts[12:20] = ln[12:20] // 2                          # the middle on
    spans[12:20] = ln[12:20] - starts[12:20]
    starts[20:28] = np.maximum(ln[20:28] - 3, 0)            # the end
    spans[20:28] = 3
    spans[28:34] = -1                                       # absent
    spans[34:40] = 0                                        # empty
    starts[40:46], spans[40:46] = 2, ln[40:46] + 50          # past length
    starts[n - 6:n] = 0                                     # the words
    spans[n - 6:n] = ln[n - 6:n]
    return lines, batch, starts, spans


def _expected(rx, line, start, span, L):
    if span < 0:
        return False
    lo, hi = max(start, 0), min(start + span, len(line), L)
    return rx.fullmatch(line[lo:hi] if hi > lo else b"") is not None


@pytest.mark.parametrize("pattern", PATTERNS)
def test_span_match_equals_the_jax_program(pattern):
    rng = np.random.default_rng(zlib.crc32(pattern.encode()))
    ref = jax.jit(build_dfa_span_match_fn(ref_compile_dfa(pattern)))
    kern = DFASpanMatchKernel(compile_dfa(pattern))
    rx = re.compile(pattern.encode())
    for L in LENGTH_BUCKETS:
        lines, batch, starts, spans = _batch(rng, L)
        want = np.asarray(ref(batch.rows, batch.lengths, starts, spans))
        got = kern(torch.from_numpy(batch.rows),
                   torch.from_numpy(batch.lengths), torch.from_numpy(starts),
                   torch.from_numpy(spans)).numpy()
        assert got.dtype == np.bool_
        assert np.array_equal(got, want), (L, np.nonzero(got != want)[0])
        for i, line in enumerate(lines):
            assert bool(got[i]) == _expected(rx, line[:L], int(starts[i]),
                                             int(spans[i]), L), (L, line)
        # padding rows (length 0): the empty span only
        for i in range(len(lines), len(batch.lengths)):
            assert bool(got[i]) == (spans[i] >= 0
                                    and rx.fullmatch(b"") is not None)
    assert kern.launches == 0      # the plain version is not a launch


class _FakeCuda:
    device = torch.device("cuda", 0)
    shape = (4, 128)


def test_cuda_tensor_launches_k3_never_plain(monkeypatch):
    kern = DFASpanMatchKernel(compile_dfa(r"[45]\d\d"))

    def plain(*a):
        raise AssertionError("plain version ran for a CUDA tensor")

    calls = []
    monkeypatch.setattr(kern, "plain", plain)
    monkeypatch.setattr(kern, "tables", lambda dev: ("t256", "accept"))
    monkeypatch.setattr(kern, "gate", lambda dev, L: ("gate", L))
    monkeypatch.setattr(dfa_scan_cuda, "launch",
                        lambda *a, **k: calls.append((a, k)) or "out")
    t = _FakeCuda()
    assert kern(t, t, "starts", "spans") == "out"
    assert kern.launches == 1
    (args, kw), = calls
    assert args[0] == "span" and kw["spans"] == ("starts", "spans")
    assert kw["gate"] == ("gate", 128)


def test_lazy_kernel_builds_once_at_first_call():
    lazy = LazySpanMatchKernel(compile_dfa("/health"))
    assert lazy._k is None and lazy.launches == 0
    rows = torch.zeros((4, 128), dtype=torch.uint8)
    rows[0, :7] = torch.tensor(list(b"/health"), dtype=torch.uint8)
    lens = torch.tensor([7, 3, 0, 7], dtype=torch.int32)
    out = lazy(rows, lens, torch.tensor([0, 0, 0, 0], dtype=torch.int32),
               torch.tensor([7, 3, -1, 6], dtype=torch.int32))
    assert out.tolist() == [True, False, False, False]
    first = lazy._k
    lazy(rows, lens, torch.zeros(4, dtype=torch.int32),
         torch.zeros(4, dtype=torch.int32))
    assert lazy._k is first


def test_span_entry_point_matches_its_binding():
    src = open(dfa_scan_cuda._SRC).read()
    m = re.search(r"int lct_dfa_span_match\(([^)]*)\)", src)
    params = [p.strip() for p in m.group(1).split(",")]
    assert len(params) == 20
    # rows, lengths, B, L, t256, S, accept, start, first_settled, starts,
    # spanlens, gate_lo, gate_hi, gate_bits, out, threads, smem, stream,
    # ev_start, ev_end
    assert params[8] == "int32_t first_settled"
    assert params[9].startswith("const int32_t* starts")
    assert params[10].startswith("const int32_t* spanlens")
    assert params[11:14] == ["int32_t gate_lo", "int32_t gate_hi",
                             "const uint32_t* gate_bits"]
    assert dfa_scan_cuda.ENTRY_POINTS["span"] == "lct_dfa_span_match"
    assert DFASpanMatchKernel.mode == "span"
    assert "dfa_span_kernel" in src


def test_ptxas_report_keys_the_span_walker():
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_115dfa_span_kernelEPKhPKilS3_iS3_iS3_S3_Ph' "
           "for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN12_GLOBAL__N_115"
           "dfa_span_kernelEPKhPKilS3_iS3_iS3_S3_Ph\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 24 registers\n")
    rep = dfa_scan_cuda.ptxas_report(log)
    assert rep == {"span": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                            "registers": 24}}


def test_launch_rejects_bad_spans():
    t256 = torch.zeros((2, 256), dtype=torch.uint8)
    acc = torch.zeros(2, dtype=torch.int32)
    rows = torch.zeros((4, 128), dtype=torch.uint8)
    lens = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        dfa_scan_cuda.launch("span", rows, lens, t256, acc, 0, 2)
    with pytest.raises(ValueError, match="length gate"):
        dfa_scan_cuda.launch("span", rows, lens, t256, acc, 0, 2,
                             spans=(lens, lens))
    with pytest.raises(ValueError, match="CUDA"):
        dfa_scan_cuda.launch("span", rows, lens, t256, acc, 0, 2,
                             spans=(lens, lens), gate=(0, 0, None))
    assert os.path.isfile(dfa_scan_cuda._SRC)
    assert dfa_scan.span_walk_plain is not None


# -- the length gate -----------------------------------------------------------

INF = float("inf")

# (name, pattern or None for the 128-state cap automaton, the accepted
# lengths below 65 where they are known from the pattern itself)
GATED = [
    ("health", "/health", lambda n: n == 7),
    ("healthcheck", "healthcheck", lambda n: n == 11),
    ("status", r"[45]\d\d", lambda n: n == 3),
    ("level", "ERROR|WARN", lambda n: n in (4, 5)),
    ("a2to5", "a{2,5}", lambda n: 2 <= n <= 5),
    ("two_or_four", "ab|abcd", lambda n: n in (2, 4)),
    ("dot_tail", "a.*", lambda n: n >= 1),
    ("java_start", td.JAVA_START, lambda n: n >= 11),
    ("empty_too", "(?:ab)*", lambda n: n % 2 == 0),
    ("cap", None, None),
]


def _gated_arrays(pattern):
    if pattern is None:
        return dfa_scan.settled_last(*td.cap_automaton(seed=3))
    return DFASpanMatchKernel(compile_dfa(pattern)).arrays


def _brute_lengths(arrays, budget=1 << 17, n_cap=64):
    """Every walk from the start, a byte at a time, over one byte of each
    set of bytes that lead every state alike, dropping walks in states
    that reach no accepting state (found by a search from each state), up
    to ``n_cap`` bytes or ``budget`` walks: the lengths at which some walk
    ends accepting, and the longest length enumerated in full (``INF``
    when every walk died out)."""
    t = arrays.t256.astype(np.int64)
    acc = np.asarray(arrays.accept) != 0
    _, reps = np.unique(t.T, axis=0, return_index=True)
    live = np.zeros(len(t), bool)
    for s in range(len(t)):
        seen, todo = {s}, [s]
        while todo:
            for v in set(t[todo.pop()].tolist()) - seen:
                seen.add(v)
                todo.append(v)
        live[s] = acc[sorted(seen)].any()
    states, found, n = np.array([arrays.start]), set(), 0
    while True:
        if acc[states].any():
            found.add(n)
        nxt = t[states][:, reps].reshape(-1)
        nxt = nxt[live[nxt]]
        if not len(nxt):
            return found, INF
        if len(nxt) > budget or n == n_cap:
            return found, n
        states, n = nxt, n + 1


@pytest.mark.parametrize("name", [g[0] for g in GATED])
def test_length_gate_sets_equal_brute_force(name):
    """``accepted_lengths`` equals a brute-force enumeration of the walks
    (and the set the pattern itself gives, to 64 bytes), the gate's hull
    is its least and greatest member to 64 bytes, and the gate K3 takes
    passes exactly those lengths: a bitmap only where the hull is not
    exact."""
    _, pattern, known = next(g for g in GATED if g[0] == name)
    arrays = _gated_arrays(pattern)
    n_max = 64
    got = dfa_scan.accepted_lengths(arrays, n_max)
    found, upto = _brute_lengths(arrays)
    for n in range(min(upto, n_max) + 1):
        assert got[n] == (n in found), (name, n)
    if known is not None:
        assert got.tolist() == [known(n) for n in range(n_max + 1)]
    gate = dfa_scan.length_gate(arrays, n_max)
    assert gate.lo == min(np.nonzero(got)[0])
    if upto == INF:
        assert gate.hi == max(found)
    else:
        assert gate.hi >= max(found)
    if name in ("dot_tail", "java_start", "empty_too", "cap"):
        assert gate.hi == n_max
    np.testing.assert_array_equal(gate.passes(np.arange(n_max + 1)), got)
    assert (gate.bits is not None) == (name in ("two_or_four", "empty_too"))
    # the period found for a long bound repeats what each layer gives
    np.testing.assert_array_equal(
        dfa_scan.accepted_lengths(arrays, 4096)[:n_max + 1], got)


def _gate_twin(arrays, gate, rows, lengths, starts, spans, mutation=None):
    """K3's gated walk in numpy, as ``dfa_span_kernel`` runs it: the span
    cut at the row's length; an absent span, or a walked length the gate
    rejects, gives 0 without a walk; else 16-byte words of the span through
    the table, stopping at a settled state once a word.  Returns the
    results and which rows walked.  ``mutation``: "off_by_one" tests the
    length one above; "before_cut" tests the span's length before the cut
    at the row's length."""
    t = arrays.t256.astype(np.int64)
    fs = arrays.first_settled
    B, L = rows.shape
    out, walked = np.zeros(B, bool), np.zeros(B, bool)
    for r in range(B):
        n_len = int(np.clip(lengths[r], 0, L))
        st, sl = int(starts[r]), int(spans[r])
        end = st + max(sl, 0)
        lo, hi = max(st, 0), min(end, n_len)
        n = max(hi - lo, 0)
        if mutation == "before_cut":
            n = max(end - lo, 0)
        elif mutation == "off_by_one":
            n += 1
        if sl < 0 or not gate.passes(np.array([n]))[0]:
            continue
        walked[r] = True
        s, p = arrays.start, lo
        while p < hi and s < fs:
            e = min((p // 16 + 1) * 16, hi)
            for q in range(p, e):
                s = int(t[s, rows[r, q]])
            p = e
        out[r] = arrays.accept[s] != 0
    return out, walked


def _gate_batches(rng, L):
    """``_batch``'s spans, and rows whose spans hold the gated lengths and
    lengths beside them, whole, cut at the row's length (a span running
    past it), from a negative start, empty, absent, and padding rows."""
    out = [_batch(rng, L)]
    words = [b"/health", b"/healt", b"/health/", b"404", b"4041", b"40",
             b"ERROR", b"WARN", b"WARNS", b"ERRO", b"aaaaa", b"aaaaaa",
             b"ab", b"abcd", b"abc", b"abab", b"healthcheck", b"a", b""]
    lines, kinds = [], []
    for w in words:
        lines += [w] * 6 + [b"xx " + w, w + b" yy"]
        kinds += list(range(6)) + [1, 6]
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines), np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    B = len(lines) + 9
    batch = pack_rows(arena, offs, lens, L, B)
    ln = batch.lengths.astype(np.int64)
    kind = np.array(kinds + [0] * 9)
    starts = np.zeros(B, np.int32)
    spans = ln.astype(np.int32).copy()              # whole rows
    starts[kind == 1] = 3                           # past a 3-byte head
    spans[kind == 1] = np.maximum(ln[kind == 1] - 3, 0)
    spans[kind == 2] = ln[kind == 2] + 20           # cut at the length
    starts[kind == 3], spans[kind == 3] = -2, ln[kind == 3] + 2
    spans[kind == 4] = 0
    spans[kind == 5] = -1
    spans[kind == 6] = ln[kind == 6] - 3            # the word of w + " yy"
    out.append((lines, batch, starts, spans))
    return out


GATE_PATTERNS = ["/health", r"[45]\d\d", "ERROR|WARN", "a{2,5}", "ab|abcd",
                 r"(?:ab)+x", r"\d*", "healthcheck"]


@pytest.mark.parametrize("pattern", GATE_PATTERNS)
def test_gate_twin_equals_plain_and_jax(pattern):
    """The twin of K3's gated walk equals the plain K3 and the JAX
    ``build_dfa_span_match_fn`` on random spans and on spans that hold the
    gated lengths and the lengths beside them: cut by the row's length,
    from negative starts, empty, absent (-1), and padding rows.  The gate
    keeps every row the walk accepts, and on the fullmatch literals turns
    most rows away."""
    rng = np.random.default_rng(zlib.crc32(pattern.encode()) + 1)
    ref = jax.jit(build_dfa_span_match_fn(ref_compile_dfa(pattern)))
    kern = DFASpanMatchKernel(compile_dfa(pattern))
    for L in (128, 256):
        gate = dfa_scan.length_gate(kern.arrays, L)
        for lines, batch, starts, spans in _gate_batches(rng, L):
            want = np.asarray(ref(batch.rows, batch.lengths, starts, spans))
            plain = kern.plain(torch.from_numpy(batch.rows),
                               torch.from_numpy(batch.lengths),
                               torch.from_numpy(starts),
                               torch.from_numpy(spans)).numpy()
            np.testing.assert_array_equal(plain, want)
            got, walked = _gate_twin(kern.arrays, gate, batch.rows,
                                     batch.lengths, starts, spans)
            np.testing.assert_array_equal(got, want, err_msg=pattern)
            assert not (want & ~walked).any()
            if pattern in ("/health", "healthcheck"):
                assert walked.mean() < 0.5


@pytest.mark.parametrize("mutation", ["off_by_one", "before_cut"])
def test_gate_twin_mutations_fail(mutation):
    """Two faults of the twin each show: a gate one length off, and the
    gate tested on the span's length before its cut at the row's length."""
    failed = 0
    rng = np.random.default_rng(7)
    for pattern in GATE_PATTERNS:
        kern = DFASpanMatchKernel(compile_dfa(pattern))
        gate = dfa_scan.length_gate(kern.arrays, 128)
        for _, batch, starts, spans in _gate_batches(rng, 128):
            want = kern.plain(torch.from_numpy(batch.rows),
                              torch.from_numpy(batch.lengths),
                              torch.from_numpy(starts),
                              torch.from_numpy(spans)).numpy()
            got, _ = _gate_twin(kern.arrays, gate, batch.rows,
                                batch.lengths, starts, spans, mutation)
            failed += int((got != want).any())
    assert failed >= 4


def test_gate_reaches_the_launch_on_the_device_it_runs_on():
    """``DFASpanMatchKernel.gate``: the hull as ints and, only where the
    hull is not exact, the bitmap over lengths 0..max(L, 4096) as i32 words
    on the rows' device, made once."""
    exact = DFASpanMatchKernel(compile_dfa("/health"))
    assert exact.gate(torch.device("cpu"), 128) == (7, 7, None)
    holes = DFASpanMatchKernel(compile_dfa("ab|abcd"))
    lo, hi, bits = holes.gate(torch.device("cpu"), 128)
    assert (lo, hi) == (2, 4) and bits.dtype == torch.int32
    assert bits.numel() == -(-(LENGTH_BUCKETS[-1] + 1) // 32)
    assert bits[0].item() == (1 << 2) | (1 << 4)
    assert holes.gate(torch.device("cpu"), 128)[2] is bits
