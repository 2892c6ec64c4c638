"""K5, the structural index, in the port against the JAX package, on the CPU.

* The plain K5 (``ops/kernels/struct_index.build_index_fn``) equals the
  JAX package's ``build_index_fn`` jitted on the CPU, its numpy twin
  ``struct_index_numpy`` and the native ``lct_struct_index`` (through the
  port's bridge, as 16-bit words), bit for bit, in JSON mode and in
  delimiter mode (``,`` and ``|``), on the reference's adversarial rows
  (backslash runs of 1-9 ending at bytes 54-63, ``tests/
  test_struct_index.py:110-125``), absent rows (length -1), padding rows
  and a seeded corpus, at ``L`` of 1, 15, 16, 17, 33, 128 and 512.
* The host twins copied from the reference (``struct_index_numpy``,
  ``unpack16``, ``native_masks_as_words16``, ``emit_delim_spans``) give
  the reference's arrays on the same inputs.
* ``StructIndexKernel.index_batch`` is one dispatch a group on the CPU,
  in the plane's length buckets, its masks equal to the reference's
  ``index_batch``; a group one batch cannot hold returns None and is
  counted in ``host_groups`` by reason.
* The kernel's schedule (``struct_index_cuda.schedule_twin``, its numpy
  twin): a row walks ``ceil(n / 32)`` steps and reads no byte at or past
  its length, step s makes words 2s and 2s + 1 for lanes 2(s % 16) and
  2(s % 16) + 1, and the lanes store every 32 words, zeros past the
  walk; it equals the plain K5 and the JAX ``build_index_fn``, exactly,
  in both modes, at ``L`` of 16, 48, 128, 512, 1024 and 4096, on rows
  whose lengths sit at every 32-byte step edge and one byte either side.
* The CUDA wrapper's host side (``struct_index_cuda``): the source's
  constants are the wrapper's, the grid is a warp a row, and ptxas's
  report parses.  The kernel itself runs only on the card
  (``chip_smoke.py`` phase 18).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongcollector_tpu import native as ref_native
from loongcollector_tpu.ops.kernels import struct_index as ref_si
from loongcollector_tpu_torch import native
from loongcollector_tpu_torch import testdata as td
from loongcollector_tpu_torch.ops.device_batch import (LENGTH_BUCKETS,
                                                       pick_length_bucket)
from loongcollector_tpu_torch.ops.kernels import struct_index as si
from loongcollector_tpu_torch.ops.kernels import struct_index_cuda as sic
from test_torch_alarms import alarms_left_empty  # noqa: F401
from test_torch_parse_delimiter import both_native  # noqa: F401

LENGTHS = [1, 15, 16, 17, 33, 128, 512]
MODES = [(si.MODE_JSON, 0x2C), (si.MODE_DELIM, 0x2C), (si.MODE_DELIM, 0x7C)]


def _rows():
    rows = td.struct_adversarial_rows()
    rows += td.gen_quoted_csv(40, seed=3) + td.gen_pipe_log(40, seed=4)
    rows += td.gen_json_events(10, seed=5)
    rng = np.random.default_rng(77)
    rows += [bytes(rng.integers(0, 256, int(rng.integers(0, 600)),
                                dtype=np.uint8)) for _ in range(30)]
    return rows


def _matrix(rows, L, pad=5, absent=True):
    """rows cut to L, then ``pad`` padding rows; with ``absent`` two rows
    are absent (length -1)."""
    B = len(rows) + pad
    mat = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, r in enumerate(rows):
        r = r[:L]
        if r:
            mat[i, :len(r)] = np.frombuffer(r, np.uint8)
        lens[i] = len(r)
    if absent:
        for i in (3, len(rows) // 2):
            lens[i] = -1
            mat[i] = 0
    return mat, lens


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("mode,sep", MODES, ids=["json", "delim_comma",
                                                  "delim_pipe"])
def test_plain_k5_equals_jax_numpy_and_native(mode, sep, L):
    mat, lens = _matrix(_rows(), L)
    got = [t.numpy() for t in si.build_index_fn(mode, sep)(
        torch.from_numpy(mat), torch.from_numpy(lens))]
    jax_fn = jax.jit(ref_si.build_index_fn(mode, sep))
    want = [np.asarray(a) for a in jax_fn(jnp.asarray(mat),
                                          jnp.asarray(lens))]
    twin = ref_si.struct_index_numpy(mat, lens, mode=mode, sep=sep)
    assert len(got) == len(want) == 4
    W = (L + 15) // 16
    for g, w, t in zip(got, want, twin):
        assert g.dtype == np.int32 and g.shape == (len(mat), W)
        assert np.array_equal(g, w) and np.array_equal(g, t)
        assert g.min() >= 0 and g.max() < 1 << 16
    # the native host index over the same rows, as 16-bit words
    arena = mat.reshape(-1)
    offs = np.arange(len(mat), dtype=np.int64) * L
    nat = native.struct_index(arena, offs, lens,
                              native.STRUCT_MODE_JSON if mode == si.MODE_JSON
                              else native.STRUCT_MODE_DELIM, sep,
                              W=-(-L // 64))
    assert nat is not None
    for g, n in zip(got, nat):
        assert np.array_equal(si.native_masks_as_words16(n)[:, :W], g)


def test_escape_runs_cross_step_and_word_boundaries():
    """A backslash run ending at every byte of 40-70 (a 32-byte step ends
    at 63, a 16-bit word at 47 and 63), and a row of exactly L bytes."""
    rows = [b"x" * (end - k) + b"\\" * k + b'"a"'
            for end in range(40, 71) for k in range(1, 10)]
    rows.append(b"\\" * 64)
    rows.append(b'"' + b"\\" * 62 + b'"')
    mat, lens = _matrix(rows, 64, pad=0, absent=False)
    got = si.build_index_fn(si.MODE_JSON, 0x2C)(torch.from_numpy(mat),
                                                torch.from_numpy(lens))
    want = ref_si.struct_index_numpy(mat, lens, mode=ref_si.MODE_JSON)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_host_twins_equal_the_reference():
    rng = np.random.default_rng(8)
    lines = td.gen_quoted_csv(300, seed=8) + [
        b'a,b,c', b'"a,b",c,d', b'"a""b",c,x', b'a"b,c"d,e', b'', b',',
        b'"unterminated, z', b'p,q,r,s,t,u,v,w,x,y']
    mat, lens = _matrix(lines, 512, pad=0)
    masks = si.struct_index_numpy(mat, lens, si.MODE_DELIM, 0x2C)
    ref_masks = ref_si.struct_index_numpy(mat, lens, ref_si.MODE_DELIM, 0x2C)
    for m, r in zip(masks, ref_masks):
        assert np.array_equal(m, r)
    for m in masks:
        assert np.array_equal(si.unpack16(m, 512), ref_si.unpack16(m, 512))
    u64 = rng.integers(0, 2 ** 63, (7, 3), dtype=np.int64).view(np.uint64)
    assert np.array_equal(si.native_masks_as_words16(u64),
                          ref_si.native_masks_as_words16(u64))
    arena = mat.reshape(-1)
    offs = np.arange(len(mat), dtype=np.int64) * 512
    qb, sb = si.unpack16(masks[3], 512), si.unpack16(masks[1], 512)
    for F in (3, 8):
        got = si.emit_delim_spans(arena, offs, lens, qb, sb, F)
        want = ref_si.emit_delim_spans(arena, offs, lens, qb, sb, F)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def _arena(lines):
    blob = b"".join(lines)
    lens = np.array([len(x) for x in lines], np.int32)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    return np.frombuffer(blob or b"\0", np.uint8), offs, lens


@pytest.mark.parametrize("mode,sep", MODES, ids=["json", "delim_comma",
                                                  "delim_pipe"])
def test_index_batch_is_one_dispatch_a_group(mode, sep):
    lines = td.gen_quoted_csv(700, seed=9) + td.struct_adversarial_rows()
    arena, offs, lens = _arena(lines)
    kern = si.StructIndexKernel(mode, sep, device="cpu")
    masks, L = kern.index_batch(arena, offs, lens)
    assert kern.dispatch_count == kern.device_batches == 1
    assert kern.launches == 0 and kern.host_groups == {}
    assert L == pick_length_bucket(int(lens.max())) == 512
    ref = ref_si.StructIndexKernel(mode=mode, sep=sep)
    want, ref_L = ref.index_batch(arena, offs, lens)
    assert ref_L == L and ref.dispatch_count == 1
    for g, w in zip(masks, want):
        assert g.shape == (len(lines), L // 16)
        assert np.array_equal(g, np.asarray(w))


def test_index_batch_leaves_what_one_batch_cannot_hold():
    kern = si.StructIndexKernel(si.MODE_DELIM, 0x2C, device="cpu")
    arena, offs, lens = _arena([b"a,b", b"x" * (LENGTH_BUCKETS[-1] + 1)])
    assert kern.index_batch(arena, offs, lens) is None
    arena, offs, lens = _arena([b"a,b"] * 9)
    with pytest.MonkeyPatch.context() as mp:
        from loongcollector_tpu_torch.ops import device_batch
        mp.setattr(device_batch, "MAX_BATCH", 8)
        assert kern.index_batch(arena, offs, lens) is None
    assert kern.host_groups == {si.HOST_LONG_ROW: 1, si.HOST_MANY_ROWS: 1}
    assert kern.dispatch_count == kern.device_batches == 0
    # a group of absent rows only (length -1) is one all-zero batch
    arena, offs, lens = _arena([b"", b""])
    lens[:] = -1
    masks, L = kern.index_batch(arena, offs, lens)
    assert L == LENGTH_BUCKETS[0] and all(not m.any() for m in masks)


def test_device_kernels_are_shared_by_mode_separator_and_device():
    a = si.device_kernel(si.MODE_DELIM, 0x2C, "cpu")
    assert si.device_kernel(si.MODE_DELIM, b","[0], torch.device("cpu")) is a
    assert si.device_kernel(si.MODE_DELIM, 0x7C, "cpu") is not a
    assert si.device_kernel(si.MODE_JSON, 0x2C, "cpu") is not a
    assert a in si.device_kernels()


SCHEDULE_L = [16, 48, 128, 512, 1024, 4096]


def _edge_rows(L, seed):
    """Rows over ``ab\\",{}[]:|`` with lengths at every 32-byte step edge
    and one byte either side, 0, L - 1, L and -1 (absent); the bytes past
    each length are quotes and backslashes, which would change every mask
    if the walk read them."""
    rng = np.random.default_rng(seed)
    lens = sorted({e for k in range(0, L + 33, 32) for e in (k - 1, k, k + 1)
                   if 0 <= e <= L} | {0, L - 1, L}) + [-1]
    alpha = np.frombuffer(b'ab\\",{}[]:|', np.uint8)
    mat = alpha[rng.integers(0, len(alpha), (len(lens), L))]
    for i, n in enumerate(lens):
        mat[i, max(n, 0):] = np.frombuffer(b'"\\', np.uint8)[
            np.arange(max(n, 0), L) % 2]
    return mat, np.array(lens, np.int32)


@pytest.mark.parametrize("L", SCHEDULE_L)
@pytest.mark.parametrize("mode,sep", [(si.MODE_JSON, 0x2C),
                                      (si.MODE_DELIM, 0x7C)],
                         ids=["json", "delim_pipe"])
def test_schedule_twin_equals_plain_and_jax(mode, sep, L):
    mat, lens = _edge_rows(L, L)
    got, steps = sic.schedule_twin(mat, lens, mode, sep)
    n = np.clip(lens, 0, L)
    assert np.array_equal(steps, (n + 31) // 32)        # the exit step
    want = np.stack([t.numpy() for t in si.build_index_fn(mode, sep)(
        torch.from_numpy(mat), torch.from_numpy(lens))])
    jax_fn = jax.jit(ref_si.build_index_fn(mode, sep))
    ref = np.stack([np.asarray(a) for a in jax_fn(jnp.asarray(mat),
                                                  jnp.asarray(lens))])
    assert got.shape == (4, len(mat), sic.words16(L)) and got.dtype == np.int32
    assert np.array_equal(got, want) and np.array_equal(got, ref)
    # the words past each walk's end are the zeros of its flushes
    for i, s in enumerate(steps):
        assert not got[:, i, 2 * s:].any()
    # bytes past the lengths are never read: zeroing them changes nothing
    clean = mat.copy()
    for i, k in enumerate(n):
        clean[i, k:] = 0
    assert np.array_equal(sic.schedule_twin(clean, lens, mode, sep)[0], got)


def test_cuda_wrapper_matches_its_source():
    with open(sic._SRC) as f:
        src = f.read()
    assert int(re.search(r"kThreads = (\d+)", src).group(1)) == sic.THREADS
    with open(sic._SRC.replace("struct_index.cu", "struct_walk.cuh")) as f:
        walk = f.read()
    assert {m: int(v) for m, v in re.findall(
        r"kStruct(Json|Delim) = (\d)", walk)} == {
        k.capitalize(): v for k, v in sic.MODES.items()}
    assert f"int {sic.ENTRY_POINT}(" in src
    assert sic.words16(1) == 1 and sic.words16(16) == 1 \
        and sic.words16(17) == 2 and sic.words16(4096) == 256
    assert sic.ROWS_PER_BLOCK * 32 == sic.THREADS
    assert int(re.search(r"kMaxL = (\d+)", src).group(1)) == sic.MAX_L \
        == LENGTH_BUCKETS[-1]
    # the walk stops at the length and stores 32 words at a time
    assert "(n + 31) >> 5" in walk and "w0 += 32" in walk
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_119struct_index_kernelILi1EEEvPKhPKilijPi' "
           "for 'sm_90a'\nptxas info    : Function properties for "
           "_ZN12_GLOBAL__N_119struct_index_kernelILi1EEEvPKhPKilijPi\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 30 registers\n")
    assert sic.ptxas_report(log) == {"delim": {
        "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 30}}


def test_cuda_launch_refuses_what_the_kernel_does_not_take():
    rows = torch.zeros((4, 16), dtype=torch.uint8)
    lens = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        sic.launch(rows, lens, si.MODE_JSON, 0x2C)
    big = torch.zeros((4, sic.MAX_L + 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="L=4112"):
        sic.launch(big, lens, si.MODE_JSON, 0x2C)


def test_reference_native_masks_agree_with_the_port_bridge(both_native):
    # both bridges loaded whatever this worker's state (``both_native``)
    lines = td.struct_adversarial_rows()
    arena, offs, lens = _arena(lines)
    for mode in (native.STRUCT_MODE_JSON, native.STRUCT_MODE_DELIM):
        got = native.struct_index(arena, offs, lens, mode, 0x2C)
        want = ref_native.struct_index(arena, offs, lens, mode, 0x2C)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
