"""The port compiles and serializes the same SegmentProgram as the JAX package.

Over the kernel-test patterns and a seeded generative set, the port's
``compile_tier1`` + ``serialize_program`` arrays equal the reference's
(``np.array_equal``, exact), and ``program_arrays_from_reference`` packs the
reference's arrays into the kernel blob the port builds itself, whose
sections read back as the input arrays.
"""

import re

import numpy as np
import pytest

from loongcollector_tpu.ops.regex.native_exec import \
    serialize_program as ref_serialize
from loongcollector_tpu.ops.regex.program import (Tier1Unsupported,
                                                  compile_tier1)
from loongcollector_tpu_torch.ops.kernels.field_extract_cuda import (
    HEADER_WORDS, M, program_arrays, program_arrays_from_reference)
from loongcollector_tpu_torch.ops.regex.native_exec import serialize_program
from loongcollector_tpu_torch.ops.regex.program import \
    compile_tier1 as port_compile

from test_fuzz_generative import gen_pattern
from test_pallas_kernel import PATTERNS
from test_torch_alarms import alarms_left_empty  # noqa: F401


def _generated(seed, want=10):
    rng = np.random.default_rng(7000 + seed)
    out = []
    for _ in range(400):
        pattern = gen_pattern(rng)
        try:
            compile_tier1(pattern)
        except (Tier1Unsupported, re.error):
            continue
        out.append(pattern)
        if len(out) == want:
            break
    return out


CASES = PATTERNS + _generated(0) + _generated(1) + [
    r"(a|b(c|d(e|f)))x",                          # nested alternation
    r"\[([^\]]*)\] (.*?):(.*?)=",                 # double pivot
]


def _unpack(blob):
    """Read the sections of a kernel blob back as numpy arrays."""
    h = blob[:HEADER_WORDS]
    words = blob[HEADER_WORDS:h[M["BITS_OFF"]]]
    K = h[M["NCLASSES"]]
    bits = blob[h[M["BITS_OFF"]]:h[M["BITS_OFF"]] + 8 * K].view(np.uint32)
    bitmaps = np.unpackbits(bits.view(np.uint8).reshape(K, 32), axis=1,
                            bitorder="little")
    n = h[M["NLITS"]]
    loffs = blob[h[M["LOFFS_OFF"]]:h[M["LOFFS_OFF"]] + n]
    llens = blob[h[M["LLENS_OFF"]]:h[M["LLENS_OFF"]] + n]
    lits = blob[h[M["BLOB_OFF"]]:].view(np.uint8)[:h[M["BLOB_LEN"]]]
    return words, bitmaps, lits, loffs, llens, int(h[M["NCAPS"]])


@pytest.mark.parametrize("pattern", CASES)
def test_port_serializes_like_reference(pattern):
    ref = ref_serialize(compile_tier1(pattern))
    port = serialize_program(port_compile(pattern))
    assert len(ref) == len(port) == 6
    for r, p in zip(ref[:5], port[:5]):
        assert r.dtype == p.dtype and np.array_equal(r, p), pattern
    assert ref[5] == port[5]
    kp = program_arrays_from_reference(*ref)
    assert np.array_equal(kp.blob, program_arrays(port_compile(pattern)).blob)
    for r, back in zip(ref, _unpack(kp.blob)):
        assert np.array_equal(np.asarray(r), np.asarray(back)), pattern


def test_kernel_limits_are_checked_when_packing():
    from loongcollector_tpu_torch.ops.kernels.field_extract_cuda import (
        MAX_DEPTH, KernelUnsupported)
    deep = "".join("(?:a" for _ in range(MAX_DEPTH + 1)) + "b" + \
        ")?" * (MAX_DEPTH + 1)
    try:
        prog = port_compile(deep)
    except Tier1Unsupported:
        pytest.skip("nested optional pattern not Tier-1")
    with pytest.raises(KernelUnsupported):
        program_arrays(prog)
    assert program_arrays(port_compile(PATTERNS[0])).depth == 0
