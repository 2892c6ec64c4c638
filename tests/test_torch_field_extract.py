"""The port's plain PyTorch Tier-1 extract against the JAX package's kernels.

Same rows (made with numpy seeds) through the reference ``ExtractKernel``
(XLA on the CPU), the reference ``PallasExtractKernel`` in interpret mode,
and ``loongcollector_tpu_torch``'s ``ExtractKernel`` on CPU tensors (its
plain version).  Every output is an integer or a bool, so the tolerance is
zero: (ok, cap_off, cap_len) must be bit-exact.  The CUDA kernel itself is
held against the same plain version on the card by ``chip_smoke.py``.
"""

import re

import numpy as np
import pytest
import torch

from loongcollector_tpu.ops.device_batch import pack_rows, pick_length_bucket
from loongcollector_tpu.ops.kernels.field_extract import \
    ExtractKernel as RefExtractKernel
from loongcollector_tpu.ops.kernels.field_extract_pallas import \
    PallasExtractKernel
from loongcollector_tpu.ops.regex.program import (Tier1Unsupported,
                                                  compile_tier1)
from loongcollector_tpu_torch.ops.device_batch import LENGTH_BUCKETS
from loongcollector_tpu_torch.ops.kernels.field_extract import ExtractKernel
from loongcollector_tpu_torch.ops.regex.program import \
    compile_tier1 as port_compile

from test_fuzz_generative import (CLASSES, LITERALS, PIVOT_FORMS, gen_inputs,
                                  gen_pattern)
from test_pallas_kernel import PATTERNS, _inputs_for
from test_torch_alarms import alarms_left_empty  # noqa: F401


def _batch(lines, L=None, B=None):
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines) or b"\0", np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    L = L or pick_length_bucket(int(lens.max()))
    return pack_rows(arena, offs, lens, L, B)


def _port(pattern, batch):
    kern = ExtractKernel(port_compile(pattern))
    out = kern(torch.from_numpy(batch.rows), torch.from_numpy(batch.lengths))
    assert kern.launches == 0          # CPU tensors take the plain version
    return [t.numpy() for t in out]


def _assert_same(ref, port, what):
    for r, p, name in zip(ref, port, ("ok", "cap_off", "cap_len")):
        r = np.asarray(r)
        assert r.shape == p.shape, (what, name)
        np.testing.assert_array_equal(r, p, err_msg=f"{what}: {name}")


def _check_vs_xla(pattern, lines, L=None):
    batch = _batch(lines, L)
    ref = RefExtractKernel(compile_tier1(pattern))(batch.rows, batch.lengths)
    _assert_same(ref, _port(pattern, batch), (pattern, batch.rows.shape))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_plain_matches_reference_xla(pattern):
    lines = [ln for ln, _ in _inputs_for(pattern)] + [b""]
    _check_vs_xla(pattern, lines)


def _accepted(rng, make, want, double_pivot=False):
    """Up to `want` patterns from `make(rng)` that compile to Tier-1."""
    out = []
    for _ in range(300):
        pattern = make(rng)
        try:
            prog = compile_tier1(pattern)
        except (Tier1Unsupported, re.error):
            continue
        if double_pivot and prog.pivot2 is None:
            continue
        out.append(pattern)
        if len(out) == want:
            break
    assert len(out) == want
    return out


def _double_pivot(rng):
    """tests/test_fuzz_generative.py test_generative_double_pivot's form."""
    pk = int(rng.integers(len(PIVOT_FORMS)))
    p1 = PIVOT_FORMS[pk]
    p2 = (PIVOT_FORMS[pk] if rng.integers(4)
          else PIVOT_FORMS[int(rng.integers(len(PIVOT_FORMS)))])
    lit = re.escape(LITERALS[int(rng.integers(len(LITERALS)))])
    pre = (re.escape(LITERALS[int(rng.integers(len(LITERALS)))])
           if rng.integers(2)
           else CLASSES[int(rng.integers(len(CLASSES)))] + "+")
    suf = re.escape(LITERALS[int(rng.integers(len(LITERALS)))])
    if rng.integers(2):
        suf += CLASSES[int(rng.integers(len(CLASSES)))] + "+"
    return f"{pre}{p1}{lit}{p2}{suf}"


@pytest.mark.parametrize("seed", range(3))
def test_plain_matches_reference_generative(seed):
    rng = np.random.default_rng(1000 + seed)
    for pattern in _accepted(rng, gen_pattern, 4):
        _check_vs_xla(pattern, gen_inputs(rng, pattern, 60) + [b""], L=128)


@pytest.mark.parametrize("seed", range(2))
def test_plain_matches_reference_double_pivot(seed):
    rng = np.random.default_rng(4000 + seed)
    for pattern in _accepted(rng, _double_pivot, 3, double_pivot=True):
        _check_vs_xla(pattern, gen_inputs(rng, pattern, 60) + [b""], L=128)


@pytest.mark.parametrize("L", LENGTH_BUCKETS[:3])
def test_plain_matches_reference_rows_exactly_L(L):
    """Rows exactly L bytes long (matching and not), empty rows and padding
    rows: the cursor clamps at L and a literal at cur == L must fail."""
    rng = np.random.default_rng(L)
    apache = PATTERNS[0]
    base = b'1.2.3.4 - frank [10/Oct/2000:13:55:36 -0700] "GET /a HTTP/1.0" 200 '
    lines = [base + b"7" * (L - len(base)),                 # matches, len L
             base + b"7" * (L - len(base) - 1) + b" ",      # fails at L
             bytes(rng.integers(32, 127, L, dtype=np.uint8)), b""]
    assert all(len(x) == L for x in lines[:3])
    _check_vs_xla(apache, lines, L=L)
    _check_vs_xla(r"pre (.*) post", [b"pre " + b"x" * (L - 9) + b" post",
                                     b"pre " + b"x" * (L - 4), b""], L=L)


@pytest.mark.parametrize("pattern", [PATTERNS[0], PATTERNS[3], PATTERNS[5]])
def test_plain_matches_reference_pallas_interpret(pattern):
    lines = [ln for ln, _ in _inputs_for(pattern)] + [b""]
    batch = _batch(lines, B=256)
    ref = PallasExtractKernel(compile_tier1(pattern), interpret=True)(
        batch.rows, batch.lengths)
    _assert_same(ref, _port(pattern, batch), pattern)
