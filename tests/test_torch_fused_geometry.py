"""K7's host side, on the CPU: descriptor packing, the flat output's
layout, shared-memory placement and the launch geometry.

The kernel (``csrc/fused_program.cu``) runs only on the card; what it is
given is plain Python (``ops/kernels/fused_program_cuda.py``) and is held
here: every record of the descriptor points at the section it names and
the sections hold the programs and tables they were packed from; the i32
outputs lie 4-byte aligned ahead of the byte outputs; the shared part of
the descriptor is padded to 16 bytes, and each keep condition's record
holds, resolved, what the kernel used to follow from it; a stage list whose
tables pass the shared-memory budget at L=4096 keeps some in device memory
and still fits one warp's block there; the block gives every SM a block
once a batch holds 32 rows an SM; the source's constants are the
wrapper's.
"""

import re

import numpy as np
import pytest
import torch

from loongcollector_tpu_torch import testdata as td
from loongcollector_tpu_torch.ops import fused_pipeline as fp
from loongcollector_tpu_torch.ops.device_batch import LENGTH_BUCKETS
from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
from loongcollector_tpu_torch.ops.kernels import fused_program_cuda as fpc
from loongcollector_tpu_torch.ops.kernels.dfa_scan import AutomatonArrays

LISTS = {name: (specs, rows) for name, specs, rows in td.fused_stage_lists()}


def _desc(name):
    return fpc.pack_descriptor(fp.kernel_stages(LISTS[name][0]))


def _header(desc):
    return {k: int(desc.blob[i]) for k, i in fpc.H.items()}


@pytest.mark.parametrize("name", sorted(LISTS))
def test_records_point_at_their_sections(name):
    stages = fp.kernel_stages(LISTS[name][0])
    desc = fpc.pack_descriptor(stages)
    blob = desc.blob
    h = _header(desc)
    assert h["MAGIC"] == fpc.MAGIC and h["NSTAGES"] == len(stages)
    assert h["TOTAL_WORDS"] == len(blob) and h["SHARED_WORDS"] \
        == desc.shared_words <= len(blob)
    assert h["ROW_BYTES"] == desc.row_bytes
    base = fpc.HEADER_WORDS
    conds = base + fpc.RECORD_WORDS * len(stages)

    def automaton_at(off, arrays):
        S = arrays.num_states
        assert list(blob[off:off + 2]) == [S, arrays.start]
        t256 = blob[off + 4:off + 4 + 64 * S].view(np.uint8).reshape(S, 256)
        assert np.array_equal(t256, arrays.t256)
        assert np.array_equal(blob[off + 4 + 64 * S:off + 4 + 65 * S],
                              arrays.accept)

    caps = 0
    units = {(o.stage, o.name): o.unit for o in desc.outputs}
    for si, st in enumerate(stages):
        rec = blob[base + fpc.RECORD_WORDS * si:][:fpc.RECORD_WORDS]
        assert rec[0] == fpc.STAGE_KINDS[st.kind]
        if st.kind == "extract":
            kp = st.obj
            assert np.array_equal(blob[rec[1]:rec[1] + len(kp.blob)], kp.blob)
            assert (rec[2], rec[3], rec[4]) == (kp.num_caps, caps, kp.pivot)
            caps += ((3 * kp.num_caps) | 1) * (2 if kp.pivot else 1)
            assert list(rec[5:8]) == [units[(si, n)] for n in
                                      ("ok", "cap_off", "cap_len")]
        elif st.kind == "scan":
            automaton_at(rec[1], st.obj)
            assert rec[5] == units[(si, "tags")]
        else:
            assert rec[2] == len(st.conds) and rec[5] == units[(si, "keep")]
            for k, c in enumerate(st.conds):
                crec = blob[conds + fpc.COND_WORDS * (rec[1] + k):][:5]
                assert list(crec[:2]) == [fpc.COND_KINDS[c.kind],
                                          int(c.negate)]
                assert list(crec[3:5]) == [c.prod, c.cap]
                if c.kind == "extract_ok":
                    assert np.array_equal(
                        blob[crec[2]:crec[2] + len(c.obj.blob)], c.obj.blob)
                else:
                    automaton_at(crec[2], c.obj)
    assert h["SCRATCH_OFF"] == caps and desc.caps_words >= caps


@pytest.mark.parametrize("name", sorted(LISTS))
def test_output_layout_and_split(name):
    program = fp.FusedProgramKernel(LISTS[name][0], name)
    desc = program.descriptor
    outs = desc.outputs
    assert [o.stage for o in outs] == sorted(o.stage for o in outs)
    assert len(outs) == program.n_outputs
    i32 = [o for o in outs if o.dtype == "int32"]
    u8 = [o for o in outs if o.dtype == "bool"]
    assert all(o.unit % 4 == 0 for o in i32)
    assert max((o.unit for o in i32), default=-1) \
        < min(o.unit for o in u8) if u8 else True
    assert desc.row_bytes == sum(o.width * o.itemsize for o in outs)
    # the plain outputs packed into a flat buffer come back out of it
    rng = np.random.default_rng(4)
    specs, rows_fn = LISTS[name]
    lines = rows_fn(rng, 40, 256)
    rows = torch.zeros((64, 256), dtype=torch.uint8)
    lens = torch.zeros(64, dtype=torch.int32)
    for i, line in enumerate(lines):
        rows[i, :len(line)] = torch.tensor(list(line), dtype=torch.uint8)
        lens[i] = len(line)
    (flat,) = program(rows, lens)
    assert flat.dtype == torch.uint8 and flat.numel() == 64 * desc.row_bytes
    want = program.plain(rows, lens)
    for got, w in zip(program.split(flat, 64), want):
        assert torch.equal(got.reshape(w.shape), w)
    for got, w in zip(program.split(flat.numpy(), 64), want):
        assert np.array_equal(got.reshape(w.shape), w.numpy())
    assert program.dispatch_count == 1 and program.launches == 0


def test_over_budget_tables_stay_in_device_memory():
    desc = _desc("over_budget")
    placed = desc.placement
    assert "device" in placed.values() and "shared" in placed.values()
    # the shared part is what fits beside one warp's rows at L=4096
    assert fpc.smem_bytes(32, LENGTH_BUCKETS[-1], desc) <= fxc.SMEM_BUDGET
    device_words = len(desc.blob) - desc.shared_words
    assert device_words > 0
    assert 4 * len(desc.blob) > fxc.SMEM_BUDGET - 32 * 4 * fpc.tile_words(
        LENGTH_BUCKETS[-1])
    for L in LENGTH_BUCKETS:
        for B in (256, 8192, 65536):
            t, smem = fpc.launch_geometry(B, L, desc)
            assert smem == fpc.smem_bytes(t, L, desc) <= fxc.SMEM_BUDGET


@pytest.mark.parametrize("name", sorted(LISTS))
def test_geometry_gives_every_sm_a_block(name):
    desc = _desc(name)
    for L in LENGTH_BUCKETS:
        for B in (256, 1024, 4224, 8192, 65536):
            t, smem = fpc.launch_geometry(B, L, desc)
            assert t % 32 == 0 and fxc.MIN_THREADS <= t <= fxc.MAX_THREADS
            assert smem <= fxc.SMEM_BUDGET
            assert t * L <= max(fxc.ROW_TILE_BYTES, 32 * L)
            if B >= 32 * fxc.NUM_SMS:
                assert -(-B // t) >= fxc.NUM_SMS


def test_instantiation_follows_the_first_extract_stage():
    got = {name: (_desc(name).first, _desc(name).first_stage,
                  _desc(name).general) for name in LISTS}
    assert got["apache_filter"] == (0, 0, False)
    assert got["three_stage"] == (0, 1, True)      # extract_ok: general
    assert got["extract_ok"] == (0, 0, True)
    assert got["match_scan"] == (-1, -1, False)
    assert got["bit31"] == (-1, -1, False)
    assert _desc("apache_filter").instantiation == "d0_p0"
    assert _desc("three_stage").instantiation == "d0_p0_g"
    assert len(set(fpc.INSTANTIATIONS)) == 8


def test_first_program_in_device_memory_runs_general(monkeypatch):
    # a budget with no room beside the rows: every section in device
    # memory, so the first extract program runs on the general walker
    stages = fp.kernel_stages(LISTS["apache_filter"][0])
    monkeypatch.setattr(fxc, "SMEM_BUDGET", 4 * (
        fpc.HEADER_WORDS + fpc.RECORD_WORDS + 2 * fpc.COND_WORDS + 8 + 32 * (
            fpc.tile_words(LENGTH_BUCKETS[-1]) + 27)))
    desc = fpc.pack_descriptor(stages)
    assert set(desc.placement.values()) == {"device"}
    assert (desc.first, desc.general) == (-1, True)
    assert desc.instantiation == "none_g"


def test_refused_stage_lists():
    stages = fp.kernel_stages(LISTS["apache_filter"][0])
    ext, keep = stages
    bad_span = fpc.KernelStage("keep", conds=(fpc.KernelCond(
        "span_match", keep.conds[0].obj, False, 1, 0),))
    with pytest.raises(fpc.FusedUnsupported, match="earlier extract"):
        fpc.pack_descriptor([ext, bad_span])
    bad_cap = fpc.KernelStage("keep", conds=(fpc.KernelCond(
        "span_match", keep.conds[0].obj, False, 0, 9),))
    with pytest.raises(fpc.FusedUnsupported):
        fpc.pack_descriptor([ext, bad_cap])
    with pytest.raises(fpc.FusedUnsupported, match="no condition"):
        fpc.pack_descriptor([ext, fpc.KernelStage("keep")])
    with pytest.raises(fpc.FusedUnsupported):
        fpc.pack_descriptor([ext] * (fpc.MAX_STAGES + 1))
    big = AutomatonArrays(np.zeros((129, 256), np.uint8),
                          np.zeros(129, np.int32), 0, 129)
    with pytest.raises(fpc.FusedUnsupported, match="states"):
        fpc.pack_descriptor([fpc.KernelStage("scan", big)])


STRUCT_LISTS = {name: specs for name, specs, _ in td.struct_stage_lists()}
ALL_LISTS = {**{n: s for n, (s, _) in LISTS.items()}, **STRUCT_LISTS}


def _all_device_budget(stages):
    """A shared-memory budget that holds the records of ``stages`` beside
    one warp's rows at the largest bucket, and no section."""
    desc = fpc.pack_descriptor(stages)
    records = fpc.HEADER_WORDS + fpc.RECORD_WORDS * len(stages) \
        + fpc.COND_WORDS * sum(len(st.conds) for st in stages)
    return 4 * (fpc._round4(records) + 32 * (
        fpc.tile_words(LENGTH_BUCKETS[-1]) + desc.caps_words))


def _section_end(desc, stages, name):
    """One past the last word of section ``name`` (``stage<i>`` or
    ``stage<i>.cond<k>``), found through the record that points at it."""
    base = fpc.HEADER_WORDS
    conds = base + fpc.RECORD_WORDS * len(stages)
    si, _, ck = name.partition(".cond")
    st = stages[int(si[len("stage"):])]
    rec = desc.blob[base + fpc.RECORD_WORDS * int(si[len("stage"):]):]
    if ck:
        obj = st.conds[int(ck)].obj
        off = int(desc.blob[conds + fpc.COND_WORDS * (rec[1] + int(ck))
                            + fpc.CF["SEC"]])
    else:
        obj, off = st.obj, int(rec[1])
    return off + (len(obj.blob) if hasattr(obj, "blob")
                  else 4 + 65 * obj.num_states)


@pytest.mark.parametrize("placed", ["packed", "device"])
@pytest.mark.parametrize("name", sorted(ALL_LISTS))
def test_shared_part_is_padded_to_16_bytes(name, placed, monkeypatch):
    stages = fp.kernel_stages(ALL_LISTS[name])
    if placed == "device":
        monkeypatch.setattr(fxc, "SMEM_BUDGET", _all_device_budget(stages))
    desc = fpc.pack_descriptor(stages)
    assert desc.shared_words % 4 == 0
    assert _header(desc)["SHARED_WORDS"] == desc.shared_words
    # the condition records and the tile after the shared part start at
    # 16-byte boundaries of the block's shared memory
    conds = fpc.HEADER_WORDS + fpc.RECORD_WORDS * len(stages)
    assert conds % 4 == 0
    for L in LENGTH_BUCKETS:
        t, smem = fpc.launch_geometry(8192, L, desc)
        assert smem == 4 * (desc.shared_words + t * (
            fpc.tile_words(L) + desc.caps_words))
    # zeros pad the records and the shared sections up to shared_words
    shared_end = max([conds + fpc.COND_WORDS * sum(
        len(st.conds) for st in stages)] + [
        _section_end(desc, stages, sec)
        for sec, where in desc.placement.items() if where == "shared"])
    assert shared_end <= desc.shared_words < shared_end + 4
    assert not desc.blob[shared_end:desc.shared_words].any()
    if placed == "device":
        assert "shared" not in desc.placement.values()


@pytest.mark.parametrize("placed", ["packed", "device"])
@pytest.mark.parametrize("name", sorted(LISTS))
def test_condition_records_are_resolved(name, placed, monkeypatch):
    """Each condition's resolved fields are what the kernel used to follow
    from it for every row: the producer's stage record (its capture-state
    offset, past the forward copy for a pivot program; its capture count)
    and the automaton's header (S, start, first settled state; the accept
    array after the table), with the sections in shared or device
    memory."""
    stages = fp.kernel_stages(LISTS[name][0])
    if placed == "device":
        monkeypatch.setattr(fxc, "SMEM_BUDGET", _all_device_budget(stages))
    desc = fpc.pack_descriptor(stages)
    blob = desc.blob
    base = fpc.HEADER_WORDS
    conds = base + fpc.RECORD_WORDS * len(stages)
    F = fpc.CF
    for si, st in enumerate(stages):
        rec = blob[base + fpc.RECORD_WORDS * si:][:fpc.RECORD_WORDS]
        for k, c in enumerate(st.conds):
            at = conds + fpc.COND_WORDS * (rec[1] + k)
            assert at % 4 == 0                      # 16-byte vector loads
            crec = blob[at:at + fpc.COND_WORDS]
            sec = int(crec[F["SEC"]])
            shared = sec < desc.shared_words
            assert crec[F["SHARED"]] == int(shared) == int(
                desc.placement[f"stage{si}.cond{k}"] == "shared")
            if placed == "device":
                assert not shared
            if c.kind == "extract_ok":
                C = int(blob[sec])                  # the program's M_NCAPS
                assert (crec[F["PCW"]], crec[F["PC"]]) == ((3 * C) | 1, C)
                continue
            S, start, fs = (int(v) for v in blob[sec:sec + 3])
            assert (crec[F["S"]], crec[F["START"]], crec[F["FS"]]) \
                == (S, start, fs) == (c.obj.num_states, c.obj.start,
                                      c.obj.first_settled)
            assert crec[F["TAB"]] == sec + 4
            assert crec[F["ACC"]] == sec + 4 + 64 * S
            assert np.array_equal(blob[crec[F["ACC"]]:][:S], c.obj.accept)
            if c.kind == "span_match":
                ps = blob[base + fpc.RECORD_WORDS * c.prod:]
                pC = int(ps[2])                     # S_COUNT
                pcw = (3 * pC) | 1
                fin = int(ps[3]) + (pcw if ps[4] else 0)  # S_CAPS_OFF, PIVOT
                assert (crec[F["FIN"]], crec[F["PCW"]], crec[F["PC"]]) \
                    == (fin, pcw, pC)
                assert (crec[F["PROD"]], crec[F["CAP"]]) == (c.prod, c.cap)


def test_struct_index_stage_is_accepted():
    """K5 is ported: a stage list holding a struct_index stage packs, builds
    its plain version, and runs, on the host and in the kernel's form."""
    specs = list(LISTS["apache_filter"][0]) + [
        fp.StageSpec("struct_index", ("json", 0x2C), ["struct_index"])]
    program = fp.FusedProgramKernel(specs, "x")
    assert [o.name for o in program.descriptor.outputs][-4:] == list(
        fpc.STRUCT_MASKS)
    assert program.n_outputs == 3 + 1 + 4
    rows = torch.zeros((8, 128), dtype=torch.uint8)
    lens = torch.zeros(8, dtype=torch.int32)
    outs = fp.build_fused_fn(specs)(rows, lens)
    assert [tuple(o.shape) for o in outs[-4:]] == [(8, 8)] * 4
    (flat,) = program(rows, lens)
    assert flat.numel() == program.descriptor.flat_bytes(8, 128)


@pytest.mark.parametrize("name", sorted(STRUCT_LISTS))
def test_struct_index_descriptor_and_row_bytes_follow_L(name):
    stages = fp.kernel_stages(STRUCT_LISTS[name])
    desc = fpc.pack_descriptor(stages)
    h = _header(desc)
    n_struct = sum(st.kind == "struct_index" for st in stages)
    assert h["NWIDE"] == desc.n_wide == 4 * n_struct
    assert h["ROW_BYTES"] == desc.row_bytes == sum(
        o.width * o.itemsize for o in desc.outputs)
    masks = [o for o in desc.outputs if o.mask]
    assert [o.wide for o in masks] == list(range(desc.n_wide))
    fixed_i32 = sum(4 * o.width for o in desc.outputs
                    if o.dtype == "int32" and not o.mask)
    assert all(o.unit == fixed_i32 for o in masks)
    base = fpc.HEADER_WORDS
    for si, st in enumerate(stages):
        rec = desc.blob[base + fpc.RECORD_WORDS * si:][:fpc.RECORD_WORDS]
        assert rec[0] == fpc.STAGE_KINDS[st.kind]
        if st.kind == "struct_index":
            first = next(o for o in masks if o.stage == si)
            assert (rec[1], rec[2]) == (fpc.STRUCT_MODES[st.obj[0]],
                                        st.obj[1])
            assert (rec[5], rec[6]) == (first.unit, first.wide)
    for L in (1, 16, 17, 100, 128, 4096):
        W = (L + 15) // 16
        assert desc.row_bytes_at(L) == desc.row_bytes + 16 * W * n_struct
        B = 67
        assert desc.flat_bytes(B, L) == B * desc.row_bytes_at(L)
        ends = []
        for o in desc.outputs:
            start = o.offset(B, W)
            if o.dtype == "int32":
                assert start % 4 == 0
            ends.append((start, start + B * o.width_at(W) * o.itemsize))
        ends.sort()
        assert ends[0][0] == 0 and ends[-1][1] == desc.flat_bytes(B, L)
        assert all(a[1] == b[0] for a, b in zip(ends, ends[1:]))
        flat = np.zeros(desc.flat_bytes(B, L), np.uint8)
        parts = fpc.split_flat(flat, B, desc)
        assert [p.shape for p, o in zip(parts, desc.outputs) if o.mask] \
            == [(B, W)] * desc.n_wide
    # the masks take no shared memory: the block is the one of the list
    # without them, the descriptor's stage record aside
    rest = [st for st in stages if st.kind != "struct_index"]
    if rest:
        t, smem = fpc.launch_geometry(8192, 128, desc)
        t2, smem2 = fpc.launch_geometry(8192, 128, fpc.pack_descriptor(rest))
        assert t == t2 and smem - smem2 == 4 * fpc.RECORD_WORDS


def test_struct_index_stage_refuses_an_unknown_mode_or_separator():
    for obj in (("xml", 0x2C), ("delim", 256), ("json", -1)):
        with pytest.raises(fpc.FusedUnsupported, match="struct_index"):
            fpc.pack_descriptor([fpc.KernelStage("struct_index", obj)])


def _enum(src, first):
    body = src[src.index("enum : int {\n  " + first):]
    body = body[:body.index("}")]
    names = re.findall(r"([A-Z]\w*)(?: = (\d+))?", body)
    return [n for n, _ in names]


def test_source_agrees_with_the_wrapper():
    with open(fpc._SRC) as f:
        src = f.read()
    header = _enum(src, "D_MAGIC")
    assert header[:len(fpc._HEADER)] == ["D_" + n for n in fpc._HEADER]
    assert header[-1] == "D_HEADER"
    assert int(re.search(r"D_HEADER = (\d+)", src).group(1)) \
        == fpc.HEADER_WORDS
    assert int(re.search(r"kMagic = (0x[0-9A-F]+)", src).group(1), 16) \
        == fpc.MAGIC
    assert int(re.search(r"kRecordWords = (\d+)", src).group(1)) \
        == fpc.RECORD_WORDS
    assert int(re.search(r"kMaxStages = (\d+)", src).group(1)) \
        == fpc.MAX_STAGES
    kinds = dict(re.findall(r"ST_(\w+) = (\d)", src))
    assert {k.lower(): int(v) for k, v in kinds.items()} == fpc.STAGE_KINDS
    ck = dict(re.findall(r"CK_(\w+) = (\d)", src))
    assert {"match": int(ck["MATCH"]), "extract_ok": int(ck["EXTRACT_OK"]),
            "span_match": int(ck["SPAN"])} == fpc.COND_KINDS
    assert int(re.search(r"kCondWords = (\d+)", src).group(1)) \
        == fpc.COND_WORDS
    assert _enum(src, "C_KIND") == ["C_" + f for f in fpc.COND_FIELDS]
    assert len(fpc.COND_FIELDS) <= fpc.COND_WORDS and fpc.COND_WORDS % 4 == 0
    # shared memory: the descriptor's padded part, copied 16 bytes at a
    # time, then the tile at a 16-byte boundary; an unpadded part traps
    assert "extern __shared__ __align__(16) int32_t smem[];" in src
    assert "reinterpret_cast<uint32_t*>(sdesc + shared_words)" in src
    assert "(shared_words & 3) != 0" in src
    assert "__pipeline_memcpy_async(dst + i, src + i, 16)" in src
    m = re.search(r"int lct_fused_program\(([^)]*)\)", src)
    assert len(m.group(1).split(",")) == 13
    assert "fused_program_kernel<2, true>" in src
    assert "fused_program_kernel<-1, false>" in src


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120fused_program_kernelILin1ELb0EEEvPKhPKilS4_S4_Ph' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120fused_program_kernelILin1ELb0EEEvPKhPKilS4_S4_Ph
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120fused_program_kernelILi0ELb0EEEvPKhPKilS4_S4_Ph' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120fused_program_kernelILi0ELb0EEEvPKhPKilS4_S4_Ph
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120fused_program_kernelILi2ELb1EEEvPKhPKilS4_S4_Ph' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120fused_program_kernelILi2ELb1EEEvPKhPKilS4_S4_Ph
    3248 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_ptxas_report_keys_each_instantiation():
    rep = fpc.ptxas_report(PTXAS_LOG)
    assert sorted(rep) == ["d0_p0", "d0_p2_g", "none"]
    assert rep["d0_p0"] == {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                            "registers": 56}
    assert rep["d0_p2_g"]["stack"] == 3248
