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


def test_cuda_tensor_launches_k3_never_plain(monkeypatch):
    kern = DFASpanMatchKernel(compile_dfa(r"[45]\d\d"))

    def plain(*a):
        raise AssertionError("plain version ran for a CUDA tensor")

    calls = []
    monkeypatch.setattr(kern, "plain", plain)
    monkeypatch.setattr(kern, "tables", lambda dev: ("t256", "accept"))
    monkeypatch.setattr(dfa_scan_cuda, "launch",
                        lambda *a, **k: calls.append((a, k)) or "out")
    t = _FakeCuda()
    assert kern(t, t, "starts", "spans") == "out"
    assert kern.launches == 1
    (args, kw), = calls
    assert args[0] == "span" and kw["spans"] == ("starts", "spans")


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
    assert len(params) == 17
    # rows, lengths, B, L, t256, S, accept, start, first_settled, starts,
    # spanlens, out, threads, smem, stream, ev_start, ev_end
    assert params[8] == "int32_t first_settled"
    assert params[9].startswith("const int32_t* starts")
    assert params[10].startswith("const int32_t* spanlens")
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
    with pytest.raises(ValueError, match="CUDA"):
        dfa_scan_cuda.launch("span", rows, lens, t256, acc, 0, 2,
                             spans=(lens, lens))
    assert os.path.isfile(dfa_scan_cuda._SRC)
    assert dfa_scan.span_walk_plain is not None
