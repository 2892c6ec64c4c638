"""Launch geometry, instantiation and limits of the CUDA field-extract kernel.

``field_extract_cuda.launch_geometry`` picks the threads per block and the
dynamic shared memory of every launch, and ``KernelProgram.entry_point`` the
kernel instantiation, from the program header.  Both are plain Python, so
they are checked here on the CPU for every length bucket, capture count,
nesting depth and pivot kind: a block is whole warps, fits the H100's
232,448 bytes of shared memory, and at the main path's B=8192 gives each of
the 132 SMs a block.  The kernel itself runs only on the card
(``chip_smoke.py``).
"""

import re

import numpy as np
import pytest

import chip_smoke
from loongcollector_tpu_torch.ops.device_batch import LENGTH_BUCKETS
from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
from loongcollector_tpu_torch.ops.regex.native_exec import (MAX_CAPS,
                                                            MAX_CLASSES)
from loongcollector_tpu_torch.ops.regex.program import (Tier1Unsupported,
                                                        compile_tier1)

H100_SMEM = 232_448
H100_SMS = 132
ACCEPTED_PROGRAM_BYTES = 48 * 1024    # every program this size must load


def _check_geometry(B, L, C, pivot, prog_words):
    threads, smem = fxc.launch_geometry(B, L, C, pivot, prog_words)
    assert threads % 32 == 0 and 32 <= threads <= fxc.MAX_THREADS
    assert smem == fxc.smem_bytes(threads, L, C, pivot, prog_words)
    assert smem <= H100_SMEM
    assert threads * L <= fxc.ROW_TILE_BYTES or threads == 32
    if B == 8192:
        assert -(-B // threads) >= H100_SMS
    return threads, smem


@pytest.mark.parametrize("pivot", [0, 1, 2])
@pytest.mark.parametrize("L", LENGTH_BUCKETS)
def test_geometry_fits_every_bucket(L, pivot):
    for C in range(1, MAX_CAPS + 1):
        for prog_words in (64, fxc.MAX_PROGRAM_BYTES // 4):
            for B in (256, 8192, 65536):
                _check_geometry(B, L, C, pivot, prog_words)


def test_geometry_of_the_main_path():
    """Apache at B=8192, L=128: 256 blocks of one warp; at B=65536,
    blocks of 128."""
    prog = fxc.program_arrays(compile_tier1(chip_smoke.APACHE))
    assert _check_geometry(8192, 128, 9, 0, len(prog.blob))[0] == 32
    assert _check_geometry(65536, 128, 9, 0, len(prog.blob))[0] == 128


def test_program_budget_is_what_the_largest_block_leaves():
    assert fxc.MAX_PROGRAM_BYTES >= ACCEPTED_PROGRAM_BYTES
    words = fxc.MAX_PROGRAM_BYTES // 4
    assert fxc.smem_bytes(32, LENGTH_BUCKETS[-1], MAX_CAPS, 2, words) \
        == H100_SMEM
    with pytest.raises(ValueError):
        fxc.launch_geometry(256, 2 * LENGTH_BUCKETS[-1], MAX_CAPS, 2, words)


def _nested(depth, caps):
    return (r"(\d)," * (caps - depth - 1) + r"(\w+)"
            + r"(?:-(\w+)" * depth + ")?" * depth + " end")


@pytest.mark.parametrize("depth", range(fxc.MAX_DEPTH + 1))
def test_nested_programs_pick_their_instantiation(depth):
    for C in range(depth + 1, MAX_CAPS + 1):
        kp = fxc.program_arrays(compile_tier1(_nested(depth, C)))
        assert (kp.depth, kp.num_caps, kp.pivot) == (depth, C, 0)
        assert int(kp.blob[fxc.M["DEPTH"]]) == depth
        assert kp.entry_point == f"lct_field_extract_d{int(depth > 0)}_p0"
        for L in LENGTH_BUCKETS:
            _check_geometry(8192, L, C, kp.pivot, len(kp.blob))


@pytest.mark.parametrize("pattern, entry", [
    (chip_smoke.APACHE, "d0_p0"),
    (chip_smoke.PATTERNS[2], "d1_p1"),        # Optional_ (and a pivot)
    (chip_smoke.PATTERNS[3], "d1_p0"),        # Alt
    (chip_smoke.PATTERNS[5], "d0_p1"),        # single pivot
    (chip_smoke.MORE_PATTERNS[0], "d0_p2"),   # double pivot
    (chip_smoke.MORE_PATTERNS[1], "d1_p2"),   # Alt and a double pivot
    (chip_smoke.DEEP, "d1_p0"),
    (chip_smoke.WIDE, "d0_p1"),
])
def test_instantiation_matches_header(pattern, entry):
    prog = compile_tier1(pattern)
    kp = fxc.program_arrays(prog)
    h = kp.blob
    assert bool(h[fxc.M["HAS_P1"]]) == (prog.pivot is not None)
    assert bool(h[fxc.M["HAS_P2"]]) == (prog.pivot2 is not None)
    pivot = 2 if h[fxc.M["HAS_P2"]] else int(h[fxc.M["HAS_P1"]])
    nested = int(h[fxc.M["DEPTH"]]) > 0
    assert kp.entry_point == f"lct_field_extract_d{int(nested)}_p{pivot}"
    assert kp.entry_point == "lct_field_extract_" + entry
    assert kp.entry_point in fxc.ENTRY_POINTS


def _generated(seed, want):
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < want:
        pattern = chip_smoke.gen_pattern(rng)
        try:
            compile_tier1(pattern)
        except (Tier1Unsupported, re.error):
            continue
        out.append(pattern)
    return out


ACCEPTED = (chip_smoke.PATTERNS + chip_smoke.MORE_PATTERNS
            + [chip_smoke.DEEP, chip_smoke.WIDE] + _generated(8100, 12))


@pytest.mark.parametrize("pattern", ACCEPTED)
def test_programs_within_48kb_stay_accepted(pattern):
    prog = compile_tier1(pattern)
    kp = fxc.program_arrays(prog)
    assert len(kp.blob) * 4 <= ACCEPTED_PROGRAM_BYTES
    assert prog.num_caps <= MAX_CAPS and len(prog.classes) <= MAX_CLASSES
    for L in LENGTH_BUCKETS:
        _check_geometry(8192, L, kp.num_caps, kp.pivot, len(kp.blob))


def _literal_alt(n_long, last):
    rng = np.random.default_rng(n_long)
    chars = np.frombuffer(b"abcdefgh", np.uint8)
    lits = [rng.choice(chars, 4000).tobytes().decode() for _ in range(n_long)]
    lits.append("q" * last)
    return "(x|" + "|".join(lits) + ")," + r"(\w+)," * 29 + r"(.*);(\d+)"


def test_largest_48kb_program_stays_accepted():
    """The largest 32-capture pivot program of at most 48 KB."""
    lo, hi = 1, 4000
    while lo < hi:          # longest last literal that fits 48 KB
        mid = (lo + hi + 1) // 2
        size = 4 * len(fxc.program_arrays(
            compile_tier1(_literal_alt(11, mid))).blob)
        lo, hi = (mid, hi) if size <= ACCEPTED_PROGRAM_BYTES else (lo, mid - 1)
    kp = fxc.program_arrays(compile_tier1(_literal_alt(11, lo)))
    assert ACCEPTED_PROGRAM_BYTES - 16 <= 4 * len(kp.blob) \
        <= ACCEPTED_PROGRAM_BYTES
    assert (kp.num_caps, kp.pivot) == (32, 1)
    for L in LENGTH_BUCKETS:
        _check_geometry(8192, L, kp.num_caps, kp.pivot, len(kp.blob))


def test_program_over_the_budget_is_unsupported():
    kp = fxc.program_arrays(compile_tier1(_literal_alt(17, 3000)))
    assert 4 * len(kp.blob) <= fxc.MAX_PROGRAM_BYTES
    _check_geometry(256, LENGTH_BUCKETS[-1], 32, 1, len(kp.blob))
    with pytest.raises(fxc.KernelUnsupported, match="shared memory"):
        fxc.program_arrays(compile_tier1(_literal_alt(19, 1)))


def test_source_agrees_with_the_wrapper():
    """The kernel's constants and entry points are the ones the wrapper
    sizes and binds (the constants live in the walker's header, which the
    source includes)."""
    src = ""
    for path in fxc.source_files(fxc._SRC):
        with open(path) as f:
            src += f.read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kMaxThreads"]) == fxc.MAX_THREADS
    assert int(consts["kMaxDepth"]) == fxc.MAX_DEPTH
    assert int(consts["kMaxCaps"]) == MAX_CAPS
    assert int(consts["kSmemBudget"]) == fxc.SMEM_BUDGET == H100_SMEM
    entries = re.findall(r"LCT_FIELD_EXTRACT\((\w+), (true|false), (\d)\)",
                         src)
    assert sorted(e for e, _, _ in entries) == sorted(fxc.ENTRY_POINTS)
    for name, nested, pivot in entries:
        assert name == f"lct_field_extract_d{int(nested == 'true')}_p{pivot}"


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120field_extract_kernelILb0ELi0EEEvPKhPKilS4_iPhPiS7_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120field_extract_kernelILb0ELi0EEEvPKhPKilS4_iPhPiS7_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120field_extract_kernelILb1ELi2EEEvPKhPKilS4_iPhPiS7_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120field_extract_kernelILb1ELi2EEEvPKhPKilS4_iPhPiS7_
    3232 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 416 bytes cmem[0]
"""


def test_ptxas_report_reads_each_instantiation():
    rep = fxc.ptxas_report(PTXAS_LOG)
    assert rep == {
        "d0_p0": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                  "registers": 40},
        "d1_p2": {"stack": 3232, "spill_stores": 8, "spill_loads": 4,
                  "registers": 72},
    }


def test_dfa_ptxas_report_keys_each_walker():
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda as dsc
    log = "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{name}"
        f"EvPKhPKilS2_iS4_iiPv' for 'sm_90a'\n"
        f"ptxas info    : Function properties for _ZN12_GLOBAL__N_1{name}"
        f"EvPKhPKilS2_iS4_iiPv\n    0 bytes stack frame, 0 bytes spill "
        f"stores, 0 bytes spill loads\nptxas info    : Used {regs} "
        f"registers\n"
        for name, regs in (("15dfa_walk_kernelILb0E", 20),
                           ("15dfa_walk_kernelILb1E", 21),
                           ("15dfa_span_kernel", 24)))
    rep = dsc.ptxas_report(log)
    assert {k: v["registers"] for k, v in rep.items()} == {
        "match": 20, "tags": 21, "span": 24}
