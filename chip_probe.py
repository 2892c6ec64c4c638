#!/usr/bin/env python3
"""Where the CUDA kernels spend their time, on one H100.

    python3 chip_probe.py            # run from the repo root
    python3 chip_probe.py dispatch   # the host cost of one plane dispatch
    python3 chip_probe.py ab OTHER/field_extract.cu   # K1 built two ways
    python3 chip_probe.py k8 OTHER/field_extract.cu   # K8 against another
    python3 chip_probe.py k3 OTHER/dfa_scan.cu   # K3, its gate and forms
    python3 chip_probe.py k2 OTHER/dfa_scan.cu   # K2/K4 against another build
    python3 chip_probe.py k7 OTHER/fused_program.cu  # K7 against another
    python3 chip_probe.py k5 OTHER/struct_index.cu   # K5 against another
    python3 chip_probe.py k6 OTHER/segment_reduce.cu  # K6 and its forms

Builds the kernel ``loongcollector_tpu_torch/ops/kernels/csrc/
field_extract.cu`` as it is, and ``stamped``, an edited copy with
``clock64()`` stamps taken by thread 0 of each block at its phase
boundaries (entry, the barrier after staging the program and the rows, the
end of warp 0's walk, the end of its write-back), into ``build/probe/``
(the package is not touched).

On the Apache rows of ``chip_smoke.py`` phase 4 (``B=8192`` with 5,500 real
rows, and ``B=65536``; ``L=128``) it prints the kernel's device time per
launch (50 launches replayed in a CUDA graph, inputs warm in L2, as in
``chip_smoke.py``) after checking the outputs bit-exact against the plain
version, and for ``stamped`` the median and largest cycles per block of
each phase over the blocks that hold real rows.  Needs a CUDA card and ``nvcc``; imports nothing of JAX.

``dispatch`` times the main path's dispatch of one chunk through the
device plane (``DevicePlane.submit`` of ``StagedKernel`` on a packed
``B=8192, L=128`` ring slot, then ``result()``), 300 times with the
timeline on as the agent runs it: the mean host microseconds of submit
and of result with profiling off, then the same loop under ``cProfile``
with the functions that take the most time of their own.

``ab OTHER`` builds K1 from ``OTHER`` (another ``field_extract.cu``, with
the headers beside it: a checkout of an earlier commit, say) and from this
tree, checks both bit-exact on the same rows, and times the Apache
instantiation of each in turns (other, this, this, other) at ``B=8192``
and ``B=65536``, ``L=128``, printing each build's ptxas figures.

``k2 OTHER/dfa_scan.cu`` builds K2 and K4 from ``OTHER`` (another
``dfa_scan.cu`` with its headers beside it, e.g. the parent commit's,
unpacked with ``git archive`` under the git-ignored ``build/``: the chip's
copy of the repo has no git) and from this tree, checks both against the
plain version, and times them in turns (other, this, this, other) on
path 2's own rows at ``B=2048, L=4096`` (``chip_smoke.path_rows`` over the
Java log's messages), at the adversarial point (``B=2048, L=4096``, no row
settling), at ``L=128`` (``B=8192`` and ``65536``) and K4 at ``B=8192,
L=256``, printing both bounds (row bytes to the settle points, and every
byte below the lengths).

The K4 points of ``k2`` also time K4 at ``L=128`` (``B=8192`` and
``65536``), on rows with a ``;`` every 17 bytes (``PARITY_SET``: the skip
scans a word and resumes, again and again) and on the 128-state cap
automaton (no skip state), and this tree's K4 at 32 and 64 threads a block
beside its own 128, with its block's rows staged in shared memory
(``k4_staged``, where they fit 48 KB) and with its escape test as
``__vcmpeq4``
(``k4_vcmpeq4``), and cut short at three points for timing its parts
(``k4_cut``).  Copies of both trees' ``dfa_scan.cu`` with ``clock64()``
stamps by thread 0 of each block in K4's kernel (entry, the tables copied,
the walk done, the result written, each after the warp's ``__syncwarp``)
give the median and largest cycles per block of the table copy, the walk
and the write on path 2's rows at ``B=8192, L=256``.

``k6 OTHER/segment_reduce.cu`` builds K6 from ``OTHER`` and from this
tree, and this tree's with ``K6_FORMS`` appended: the forms that hold the
segments on the chip or fold in one launch (``cluster``: one cluster whose
blocks own ranges of the segments in shared memory, rows folded into the
owner with distributed shared-memory reductions; ``shared``: blocks that
each own a range and read the whole batch; ``cluster_global``: one cluster
over device memory, two cluster barriers for the launch boundaries).  It
checks every build against the plain version and times them in turns
(there and back) at the rollup path's folds (``B=8192``, ``Gq=2048`` and
``4096``), on a hot segment and at ``B=Gq=65536``, each form at the block
counts of ``K6_FORM_SIZES`` that fit; prints ptxas's figures, the SASS
atomics of each kernel (``cuobjdump -sass``) and, from a stamped build,
each form's cycles a block by phase at the path's fold.

``k7 OTHER/fused_program.cu`` builds K7 from ``OTHER`` (with its headers
beside it, e.g. the parent commit's, unpacked with ``git archive`` under
``build/``) and packs its descriptors with that checkout's own host code,
beside this tree's K7, a form of it whose descriptor copy is one TMA
bulk copy (``TMA_COPY``) and one whose span conditions take K3's length
gate (``k7_gate``, the hull written into each record by
``gate_descriptor``); checks all four against the plain version and
times them in turns (other, this, TMA, gate, gate, TMA, this, other, twice)
on the Apache-filter program's ``B=8192, L=128`` chunk (5,500 rows) and on
the delimiter filter's (the pipe log's first 512 KB).  A copy of this tree's
``fused_program.cu`` with ``clock64()`` stamps by thread 0 of each block
(entry, rows staged, the barrier after the rows and the descriptor, the
end of the extract stage's walk, the end of ``write_warp_caps``, the end
of the keep stage, exit) gives the median and largest cycles per block of
each phase, beside K1's phases on the same chunk (its stamped copy, as the
default mode builds it); then K7's ``d0_p0`` and K1's ptxas registers,
dynamic shared memory per block and
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``.

``k5 OTHER/struct_index.cu`` builds K5 from ``OTHER``, from this tree, and
``direct``, this tree's without the row staging (each step's bytes read
from device memory, ``k5_direct``), checks all three against the plain
version and times them in turns (other, this, direct, direct, this, other)
at the CSV path's shapes (``B=4096``, ``L=512`` and ``256``), at ``L=128``
(``B=8192`` and ``65536``) and on long JSON rows (``B=1024, L=4096``),
beside the bound.

``k7`` also stamps the other tree's K7 and the gate form (their keep's
cycles a block beside this tree's, on both filter chunks).

``k8 OTHER/field_extract.cu`` builds K8 (``lct_sharded_extract_*``, K1's
walk with the count epilogue) from ``OTHER`` and from this tree, prints
both builds' ``stats_*`` ptxas figures, checks each shard's counts of both
against the plain K8 and their outputs against the plain K1, and times
K1, the other K8 and this one in turns (K1, other, this, this, other, K1)
at phase 4's shapes, at one shard and at the four shards of a one-card
mesh: a build from before the one-launch form (its counts a u64 [3] the
launcher zeroes with ``cudaMemsetAsync``) takes four launches of ``B/4``
rows, this tree's one launch over the four shards.  Beside the graph
replay it prints each dispatch's exec leg as the timeline records it
(CUDA events right before the first launch and after the last, host time
between launches included; median of 200).

``k3 OTHER/dfa_scan.cu`` builds K3 from ``OTHER``, from this tree (the
table copy issued first, the length gate and the span's first word
loaded beside it, the wait only where a row of the block walks) and ``K3_LDG`` appended to this tree's source (the gate
and no table copy: the walk through the read-only cache), checks all
three and ``word_after`` (``k3_word_after``: the span's first word
loaded only after the block waits for its table) against the plain K3,
and times them in turns (other, this, ldg, word_after, word_after, ldg,
this, other) at shape (a), ``[45]\\d\\d`` over the Apache status spans
(every span passes the gate), shape (b), ``/health`` over the url spans
(most spans turned away), both at ``B=8192`` (5,500 rows) and ``65536``,
``L=128``, and ``healthcheck`` over the delimiter filter's service spans
(the pipe log's first 512 KB), printing how many spans pass the gate.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "build", "probe")
STAMPS = 4


def edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"chip_probe: the kernel source changed; cannot "
                         f"find {old!r}")
    return src.replace(old, new)


def stamped(src: str) -> str:
    src = edit(src, "namespace {\n", "namespace {\n"
               "__device__ long long g_stamp[65536 * 4];\n"
               "#define STAMP(k) do { if (threadIdx.x == 0) "
               "g_stamp[blockIdx.x * 4 + (k)] = clock64(); } while (0)\n")
    src = edit(src, "  extern __shared__ int32_t smem[];\n",
               "  extern __shared__ int32_t smem[];\n  STAMP(0);\n")
    src = edit(src, "  __syncthreads();\n", "  __syncthreads();\n  STAMP(1);\n")
    src = edit(src, "  __syncwarp();\n", "  __syncwarp();\n  STAMP(2);\n")
    src = edit(src, "\n  if constexpr (STATS) {\n    // the warp",
               "\n  STAMP(3);\n  if constexpr (STATS) {\n    // the warp")
    return edit(src, 'extern "C" {\n', 'extern "C" {\n'
                "int probe_stamps(void* dst, size_t n) {\n"
                "  return (int)cudaMemcpyFromSymbol(dst, g_stamp, n);\n}\n")


def compile_so(fxc, name: str, src: str, include: str = ""):
    """``src`` compiled into ``build/probe/<name>.so``, loaded; returns the
    library and nvcc's output (the ptxas report).  ``include`` is the
    directory of the headers it includes (the kernel sources' own by
    default)."""
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, name + ".cu"), os.path.join(OUT, name + ".so")
    with open(cu, "w") as f:
        f.write(src)
    inc = include or os.path.dirname(fxc._SRC)
    proc = subprocess.run([fxc._nvcc(), *fxc.NVCC_FLAGS, "-I", inc, "-o", so,
                           cu], capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise SystemExit(f"chip_probe: nvcc failed on {name}:\n"
                         f"{proc.stderr[-3000:]}")
    return ctypes.CDLL(so), proc.stdout + proc.stderr


def build(fxc, name: str, src: str, include: str = ""):
    """K1's ``src`` compiled (``compile_so``) with its entry points bound;
    prints the ptxas figures of its instantiations."""
    lib, log = compile_so(fxc, name, src, include)
    lib.ptxas_log = log
    report = fxc.ptxas_report(log)
    print(f"chip_probe: {name}: ptxas d0_p0 {report.get('d0_p0')}; "
          f"registers " + ", ".join(
              f"{k} {r.get('registers')}" for k, r in sorted(report.items())
              if k in ("d0_p0", "d0_p1", "d0_p2", "d1_p0", "d1_p1",
                       "d1_p2")), flush=True)
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    for entry in fxc.ENTRY_POINTS:
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [vp, vp, ctypes.c_int64, i32, vp, i32, vp, vp, vp, i32,
                       i32, vp]
    # K8 since its one launch a device writes pieces (shard_rows and
    # lcm_rows follow the pointer); before, a u64 [3] the launcher zeroed
    pieces = "long long* pieces" in src
    lib.k8_pieces = pieces
    i64 = ctypes.c_int64
    for entry in fxc.STATS_ENTRY_POINTS:
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [vp, vp, i64, i32, vp, i32, vp, vp, vp, vp] + (
            [i64, i64] if pieces else []) + [i32, i32, vp]
    return lib


def launcher(fxc, lib, kern, prog, stats: bool = False, shards: int = 1):
    """K1's entry point of ``lib`` for ``kern``'s program, or with
    ``stats`` K8's (its counts then come back as a fifth output: the
    pieces of one launch over ``shards`` shards, or a build from before
    the pieces the u64 [3] of one shard)."""
    import torch
    kp = kern.kernel_program
    entry = kp.stats_entry_point if stats else kp.entry_point

    def launch(rows, lengths):
        B, L = rows.shape
        threads, smem = fxc.launch_geometry(B, L, kp.num_caps, kp.pivot,
                                            prog.numel())
        ok = torch.empty(B, dtype=torch.bool, device=rows.device)
        off = torch.empty((B, kp.num_caps), dtype=torch.int32,
                          device=rows.device)
        length = torch.empty_like(off)
        args = [rows.data_ptr(), lengths.data_ptr(), B, L, prog.data_ptr(),
                prog.numel(), ok.data_ptr(), off.data_ptr(),
                length.data_ptr()]
        counts = None
        if stats and lib.k8_pieces:
            n, lcm = fxc.stat_pieces(B, B // shards)
            counts = torch.empty((n, 3), dtype=torch.int64,
                                 device=rows.device)
            args += [counts.data_ptr(), B // shards, lcm]
        elif stats:
            counts = torch.empty(3, dtype=torch.int64, device=rows.device)
            args.append(counts.data_ptr())
        rc = getattr(lib, entry)(*args, threads, smem,
                                 torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"chip_probe: launch failed ({rc})")
        return ok, off, length, threads, counts
    return launch


def dispatch_cost(reps: int = 300) -> int:
    import cProfile
    import pstats
    import time
    import numpy as np
    import torch
    import chip_smoke
    from loongcollector_tpu_torch.ops import xprof
    from loongcollector_tpu_torch.ops.device_plane import DevicePlane
    from loongcollector_tpu_torch.ops.device_stream import batch_ring
    from loongcollector_tpu_torch.ops.regex.engine import RegexEngine
    from loongcollector_tpu_torch.testdata import gen_lines
    print(f"chip_probe: card: {chip_smoke.nvidia_smi()}", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    eng = RegexEngine(chip_smoke.APACHE, dev)
    staged = eng._device_kernel()
    lines = gen_lines(5500, seed=5)
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines), np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    slot = batch_ring().lease(8192, 128, pinned=True)
    slot.pack(arena, offs, lens)
    plane = DevicePlane.instance()
    C = eng.num_caps

    def loop(n):
        t_sub = t_res = 0.0
        for _ in range(n):
            t0 = time.perf_counter()
            fut = plane.submit(staged, (slot, C), 8192 * 128)
            t1 = time.perf_counter()
            fut.result()
            t_sub += t1 - t0
            t_res += time.perf_counter() - t1
        return t_sub / n * 1e6, t_res / n * 1e6

    with xprof.active(dev):
        loop(20)
        sub_us, res_us = loop(reps)
        print(f"chip_probe: dispatch B=8192 L=128, {reps} times: submit "
              f"{sub_us:.1f} us, result {res_us:.1f} us (host, mean, "
              f"profiling off)", flush=True)
        prof = cProfile.Profile()
        prof.enable()
        loop(reps)
        prof.disable()
    slot.release()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:25]
    for (fn, line, name), (_cc, calls, tt, ct, _callers) in rows:
        print(f"chip_probe: profile {tt / reps * 1e6:8.1f} us own "
              f"{ct / reps * 1e6:8.1f} us total per dispatch, {calls} calls: "
              f"{os.path.basename(fn)}:{line} {name}", flush=True)
    return 0


def apache_batches():
    """(B, real rows, rows, lengths) of phase 4's Apache batches, on the
    card."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch.ops.device_batch import pack_rows
    from loongcollector_tpu_torch.testdata import gen_lines
    base = gen_lines(65536, seed=5)
    for B, n_real in ((8192, 5500), (65536, 65536)):
        lines = base[:n_real]
        lens = np.array([len(x) for x in lines], np.int32)
        arena = np.frombuffer(b"".join(lines), np.uint8)
        offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
        batch = pack_rows(arena, offs, lens, 128, B)
        yield (B, n_real, torch.from_numpy(batch.rows).cuda(),
               torch.from_numpy(batch.lengths).cuda())


def ab(other: str) -> int:
    """K1 from ``other`` against this tree's, timed in turns."""
    import torch
    import chip_smoke
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    from loongcollector_tpu_torch.ops.kernels.field_extract import \
        ExtractKernel
    from loongcollector_tpu_torch.ops.regex.program import compile_tier1
    print(f"chip_probe: card: {chip_smoke.nvidia_smi()}", flush=True)
    kern = ExtractKernel(compile_tier1(chip_smoke.APACHE))
    prog = torch.from_numpy(kern.kernel_program.blob).cuda()
    with open(other) as f:
        other_src = f.read()
    with open(fxc._SRC) as f:
        this_src = f.read()
    calls = {"other": launcher(fxc, build(fxc, "other", other_src,
                                          os.path.dirname(os.path.abspath(
                                              other))), kern, prog),
             "this": launcher(fxc, build(fxc, "this", this_src), kern, prog)}
    for B, n_real, rows, lengths in apache_batches():
        outs = {k: [t.cpu() for t in fn(rows, lengths)[:3]]
                for k, fn in calls.items()}
        if not all(bool((a == b).all()) for a, b in zip(outs["other"],
                                                         outs["this"])):
            raise SystemExit(f"chip_probe: the two builds differ at B={B}")
        turns = [(k, chip_smoke.graph_ms([lambda fn=calls[k]: fn(rows,
                                                                 lengths)]))
                 for k in ("other", "this", "this", "other")]
        print(f"chip_probe: ab B={B} L=128 ({n_real} Apache rows): device "
              f"ms per launch in turns: " + ", ".join(
                  f"{k} {ms:.5f}" for k, ms in turns), flush=True)
    return 0


def exec_leg_ms(fn, reps: int = 200) -> float:
    """Median ms between CUDA events recorded right before and right after
    ``fn``'s launches, as the dispatch timeline records a sharded
    dispatch's exec leg (host time between launches included)."""
    import numpy as np
    import torch
    for _ in range(10):
        fn()
    got = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        got.append(e0.elapsed_time(e1))
    return float(np.median(got))


def k8_compare(other: str) -> int:
    """K1, the other tree's K8 and this tree's, in turns, at one shard and
    at the four shards of a one-card mesh (the other tree's: four launches
    of B/4 rows, each with its memset; this one's: one launch)."""
    import numpy as np
    import torch
    import chip_smoke
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    from loongcollector_tpu_torch.ops.kernels.field_extract import (
        ExtractKernel, fold_pieces, plain_counts)
    from loongcollector_tpu_torch.ops.regex.program import compile_tier1
    print(f"chip_probe: card: {chip_smoke.nvidia_smi()}", flush=True)
    kern = ExtractKernel(compile_tier1(chip_smoke.APACHE))
    prog = torch.from_numpy(kern.kernel_program.blob).cuda()
    with open(other) as f:
        other_src = f.read()
    with open(fxc._SRC) as f:
        src = f.read()
    libs = {}
    for name, text, inc in (("other", other_src,
                             os.path.dirname(os.path.abspath(other))),
                            ("this", src, "")):
        libs[name] = build(fxc, "k8_" + name, text, inc)
        rep = fxc.ptxas_report(libs[name].ptxas_log)
        print(f"chip_probe: k8 {name}: ptxas " + ", ".join(
            f"{k} {r.get('registers')} registers, {r.get('stack')} stack, "
            f"{r.get('spill_stores')} spills" for k, r in sorted(rep.items())
            if k.startswith("stats_")), flush=True)
    k1 = launcher(fxc, libs["this"], kern, prog)
    for B, n_real, rows, lengths in apache_batches():
        want = [t.cpu() for t in kern.plain(rows, lengths)]
        for m in (1, 4):
            s = B // m
            parts = [(rows[i * s:(i + 1) * s], lengths[i * s:(i + 1) * s])
                     for i in range(m)]
            k8_other = launcher(fxc, libs["other"], kern, prog, stats=True)
            k8_this = launcher(fxc, libs["this"], kern, prog, stats=True,
                               shards=m)
            calls = {"K1": lambda: k1(rows, lengths),
                     "other": lambda: [k8_other(r, n) for r, n in parts],
                     "this": lambda: k8_this(rows, lengths)}
            # both against the plain K8, shard by shard
            per = [plain_counts(want[0][i * s:(i + 1) * s],
                                lengths[i * s:(i + 1) * s].cpu()).tolist()
                   for i in range(m)]
            outs = calls["other"]()
            torch.cuda.synchronize()
            got_o = [o[4].cpu().tolist() for o in outs]
            cat = [torch.cat([o[j].cpu() for o in outs]) for j in range(3)]
            o = calls["this"]()
            got_t = fold_pieces(o[4].cpu(), B, s).tolist()
            if got_o != per or got_t != per or not all(
                    bool((a == w).all()) for a, w in zip(cat, want)) \
                    or not all(bool((a.cpu() == w).all())
                               for a, w in zip(o[:3], want)):
                raise SystemExit(f"chip_probe: K8 at B={B}, {m} shards: "
                                 f"other {got_o}, this {got_t}, plain {per}")
            turns = [(k, chip_smoke.graph_ms([calls[k]]))
                     for k in ("K1", "other", "this", "this", "other", "K1")]
            legs = [(k, exec_leg_ms(calls[k]))
                    for k in ("other", "this", "this", "other")]
            print(f"chip_probe: k8 B={B} L=128 ({n_real} Apache rows), {m} "
                  f"shard(s) (other: {m} launch(es) of {s} rows; this: one "
                  f"launch): device ms per dispatch in turns (graph "
                  f"replay): " + ", ".join(f"{k} {ms:.5f}" for k, ms in turns)
                  + "; exec leg (events around the launches, median): "
                  + ", ".join(f"{k} {ms:.5f}" for k, ms in legs), flush=True)
    return 0


# -- K3: the length gate, and the table copy off the row's chain -----------

# K3 with no table copy: the gate, then the walk through the read-only
# cache (``LdgTab``), for blocks where few rows pass the gate.
K3_LDG = """
namespace {
__global__ void __launch_bounds__(kMaxThreads)
dfa_span_ldg_kernel(const uint8_t* __restrict__ rows,
                    const int32_t* __restrict__ lengths, int64_t B, int32_t L,
                    const uint8_t* __restrict__ t256, int32_t S,
                    const int32_t* __restrict__ accept, int32_t start,
                    int32_t first_settled, const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ spanlens, int32_t gate_lo,
                    int32_t gate_hi, const uint32_t* __restrict__ gate_bits,
                    uint8_t* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (r >= B) return;
  int len = lengths[r];
  len = len < 0 ? 0 : (len > L ? L : len);
  const int32_t st = starts[r], sl = spanlens[r];
  const int64_t end = static_cast<int64_t>(st) + (sl < 0 ? 0 : sl);
  const int lo = st < 0 ? 0 : st;
  const int hi = static_cast<int>(end < len ? end : len);
  bool m = false;
  if (sl >= 0 && gate_passes(max(hi - lo, 0), gate_lo, gate_hi, gate_bits)) {
    const uint8_t* row = rows + r * L;
    const uint32_t s = walk_row_range(LdgTab{t256},
                                      static_cast<uint32_t>(start), row, lo,
                                      hi, aligned_rows(row, L),
                                      static_cast<uint32_t>(first_settled));
    m = __ldg(accept + s) != 0;
  }
  out[r] = m;
}
}  // namespace

extern "C" int lct_dfa_span_match_ldg(
    const uint8_t* rows, const int32_t* lengths, int64_t B, int32_t L,
    const uint8_t* t256, int32_t S, const int32_t* accept, int32_t start,
    int32_t first_settled, const int32_t* starts, const int32_t* spanlens,
    int32_t gate_lo, int32_t gate_hi, const uint32_t* gate_bits,
    uint8_t* out, int32_t threads, int32_t smem, void* stream,
    void* ev_start, void* ev_end) {
  if (B <= 0) return 0;
  const int64_t blocks = (B + threads - 1) / threads;
  dfa_span_ldg_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      rows, lengths, B, L, t256, S, accept, start, first_settled, starts,
      spanlens, gate_lo, gate_hi, gate_bits, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def k3_word_after(src: str) -> str:
    """``dfa_scan.cu`` with K3's first span word loaded only after the
    block has waited for its table (the walk of ``dfa_walk.cuh`` from the
    span's start), as the first gated form had it; slower than loading it
    beside the copy at every timed shape (PERF.md §6)."""
    src = edit(src, """  const uint8_t* row = rows + r * L;
  const bool vec = aligned_rows(row, L);
  uint4 q = make_uint4(0u, 0u, 0u, 0u);
  if (walk && vec && hi > lo)
    q = __ldg(reinterpret_cast<const uint4*>(row) + (lo >> 4));
  if (!__syncthreads_or(walk)) {""", """  const uint8_t* row = rows + r * L;
  if (!__syncthreads_or(walk)) {""")
    return edit(src, """    if (!vec)
      s = walk_row_range(tab, s, row, lo, hi, false, fs);
    else if (hi > lo)
      s = walk_span(tab, s, row, lo, hi, fs, q);""", """    s = walk_row_range(tab, s, row, lo, hi, aligned_rows(row, L), fs);""")


def k3_binding(lib, name: str, gated: bool) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [vp, vp, ctypes.c_int64, i32, vp, i32, vp, i32, i32, vp,
                   vp] + ([i32, i32, vp] if gated else []) \
        + [vp, i32, i32, vp, vp, vp]


def k3_caller(dsc, lib, name: str, gated: bool, kern, smem=True):
    """A K3 launch of ``kern``'s automaton through ``lib``'s entry point
    ``name``: with its length gate where the build takes one."""
    import torch
    entry = getattr(lib, name)
    a = kern.arrays

    def call(rows, lengths, starts, spans):
        B, L = rows.shape
        t256, accept = kern.tables(rows.device)
        threads = dsc.launch_geometry(B)
        out = torch.empty(B, dtype=torch.uint8, device=rows.device)
        gate = ()
        if gated:
            lo, hi, bits = kern.gate(rows.device, L)
            gate = (lo, hi, None if bits is None else bits.data_ptr())
        rc = entry(rows.data_ptr(), lengths.data_ptr(), B, L, t256.data_ptr(),
                   a.num_states, accept.data_ptr(), a.start, a.first_settled,
                   starts.data_ptr(), spans.data_ptr(), *gate, out.data_ptr(),
                   threads, dsc.smem_bytes(a.num_states) if smem else 0,
                   torch.cuda.current_stream().cuda_stream, None, None)
        if rc:
            raise SystemExit(f"chip_probe: K3 {name} launch failed ({rc})")
        return out
    return call


def k3_compare(other: str) -> int:
    """K3 built from ``other`` against this tree's (the table copy issued
    first, the gate, the wait only where a row walks) and ``K3_LDG`` (no
    copy, the walk through the read-only cache), in turns, at shape (a)
    (the status spans: every span passes the gate), shape (b) (``/health``
    over the url spans: most spans turned away) and on the delimiter
    filter's ``healthcheck`` over its service spans."""
    import numpy as np
    import torch
    import chip_smoke
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda as dsc
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    from loongcollector_tpu_torch.ops.kernels.dfa_scan import (
        DFASpanMatchKernel, length_gate)
    from loongcollector_tpu_torch.ops.kernels.field_extract import \
        ExtractKernel
    from loongcollector_tpu_torch.ops.regex.dfa import compile_dfa
    from loongcollector_tpu_torch.ops.regex.program import compile_tier1
    print(f"chip_probe: card: {chip_smoke.nvidia_smi()}", flush=True)
    with open(other) as f:
        other_src = f.read()
    with open(dsc._SRC) as f:
        src = f.read()
    libs = {}
    for name, text, inc in (("other", other_src,
                             os.path.dirname(os.path.abspath(other))),
                            ("this", src + K3_LDG, ""),
                            ("word_after", k3_word_after(src), "")):
        libs[name], log = compile_so(fxc, "k3_" + name, text, inc)
        rep = dsc.ptxas_report(log)
        print(f"chip_probe: k3 {name}: ptxas span {rep.get('span')}",
              flush=True)
    k3_binding(libs["other"], "lct_dfa_span_match", False)
    k3_binding(libs["this"], "lct_dfa_span_match", True)
    k3_binding(libs["this"], "lct_dfa_span_match_ldg", True)
    k3_binding(libs["word_after"], "lct_dfa_span_match", True)
    pipe_lines = td.gen_pipe_log(8192, seed=23)
    n_pipe = int((np.cumsum([len(x) + 1 for x in pipe_lines])
                  <= 512 * 1024).sum())
    base = td.gen_lines(65536, seed=5)
    cases = [("a status", r"[45]\d\d", chip_smoke.APACHE,
              td.APACHE_KEYS.index("status"), B, base[:n])
             for B, n in ((8192, 5500), (65536, 65536))]
    cases += [("b /health", "/health", chip_smoke.APACHE,
               td.APACHE_KEYS.index("url"), B, base[:n])
              for B, n in ((8192, 5500), (65536, 65536))]
    cases.append(("delimiter healthcheck", "healthcheck", td.PIPE_PATTERN,
                  td.PIPE_KEYS.index("service"), 8192, pipe_lines[:n_pipe]))
    for tag, pat, parse, cap, B, lines in cases:
        kern = DFASpanMatchKernel(compile_dfa(pat))
        batch, rows, lengths = dfa_batch(lines, B, 128)
        ext = ExtractKernel(compile_tier1(parse))
        _, off, ln = ext.plain(torch.from_numpy(batch.rows),
                               torch.from_numpy(batch.lengths))
        st_h = np.ascontiguousarray(off[:, cap].numpy())
        sp_h = np.ascontiguousarray(ln[:, cap].numpy())
        starts = torch.from_numpy(st_h).cuda()
        spans = torch.from_numpy(sp_h).cuda()
        calls = {"other": k3_caller(dsc, libs["other"], "lct_dfa_span_match",
                                    False, kern),
                 "this": k3_caller(dsc, libs["this"], "lct_dfa_span_match",
                                   True, kern),
                 "ldg": k3_caller(dsc, libs["this"],
                                  "lct_dfa_span_match_ldg", True, kern,
                                  smem=False),
                 "word_after": k3_caller(dsc, libs["word_after"],
                                         "lct_dfa_span_match", True, kern)}
        want = kern.plain(rows, lengths, starts, spans).cpu().numpy()
        for k, fn in calls.items():
            got = fn(rows, lengths, starts, spans).cpu().numpy().astype(bool)
            if not (got == want).all():
                raise SystemExit(f"chip_probe: K3 {k} != plain on {tag} "
                                 f"B={B}")
        walk = (sp_h >= 0) & length_gate(kern.arrays, 128).passes(
            np.maximum(sp_h, 0))
        turns = [(k, chip_smoke.graph_ms(
            [lambda fn=calls[k]: fn(rows, lengths, starts, spans)]))
            for k in ("other", "this", "ldg", "word_after", "word_after",
                      "ldg", "this", "other")]
        print(f"chip_probe: k3 {tag} B={B} L=128 ({len(lines)} rows, "
              f"{int((sp_h >= 0).sum())} spans, {int(walk.sum())} pass the "
              f"gate; {-(-B // dsc.launch_geometry(B))} blocks of "
              f"{dsc.launch_geometry(B)}): device ms per launch in turns: "
              + ", ".join(f"{k} {ms:.5f}" for k, ms in turns), flush=True)
    return 0


# -- K2: this tree's walk against another's ---------------------------------

def dfa_binding(lib, src: str):
    """Binds K2's and K4's entry points of a ``dfa_scan.cu`` build by that
    source's own signature; returns (takes the first settled state: since
    the settled exit; K4 takes the skip table: since the skip)."""
    import re
    m = re.search(r"int lct_dfa_match\(([^)]*)\)", src)
    new = "first_settled" in m.group(1)
    m = re.search(r"int lct_fused_scan\(([^)]*)\)", src)
    skip = "skips" in m.group(1)
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    for name in ("lct_dfa_match", "lct_fused_scan"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        extra = [vp] if skip and name == "lct_fused_scan" else []
        fn.argtypes = [vp, vp, ctypes.c_int64, i32, vp, i32, vp, i32] + (
            [i32, *extra, vp, i32, i32] if new else [vp, i32, i32]) \
            + [vp, vp, vp]
    return new, skip


def dfa_caller(dsc, lib, binding, kern, threads=None, smem=None):
    """A launch of ``kern``'s walk (K2 or K4) through ``lib`` (bound as
    ``dfa_binding`` gives), with the first settled state and the skip table
    for a build that takes them; ``threads`` a block, or the parent's
    choice; ``smem`` (a function of S, L and threads), or the wrapper's."""
    import torch
    new, skip = binding
    entry = getattr(lib, dsc.ENTRY_POINTS[kern.mode])
    a = kern.arrays
    S = a.num_states
    tags = kern.mode == "tags"

    def call(rows, lengths):
        B, L = rows.shape
        t256, accept = kern.tables(rows.device)
        t = threads or dsc.launch_geometry(B)
        sm = smem(S, L, t) if smem else dsc.smem_bytes(S, skip=tags and skip)
        out = torch.empty(B, dtype=torch.int32 if tags else torch.uint8,
                          device=rows.device)
        head = (rows.data_ptr(), lengths.data_ptr(), B, L, t256.data_ptr(),
                S, accept.data_ptr(), a.start)
        stream = torch.cuda.current_stream().cuda_stream
        tail = (out.data_ptr(), t, sm, stream, None, None)
        if not new:
            rc = entry(*head, *tail)
        elif tags and skip:
            rc = entry(*head, a.first_settled,
                       kern.skips(rows.device).data_ptr(), *tail)
        else:
            rc = entry(*head, a.first_settled, *tail)
        if rc:
            raise SystemExit(f"chip_probe: DFA launch failed ({rc})")
        return out
    return call


def k4_stamped(src: str) -> str:
    """``dfa_scan.cu`` (this tree's or an earlier one) with ``clock64()``
    stamps by thread 0 of each block in K4's kernel (``fused_scan_kernel``,
    or the earlier ``dfa_walk_kernel<true>``): entry (0), the tables copied
    (1), the walk done (2) and the result written (3), each of the last two
    after the warp's ``__syncwarp``."""
    own = "fused_scan_kernel(const uint8_t*" in src
    a = src.index("fused_scan_kernel(const uint8_t*" if own
                  else "dfa_walk_kernel(const uint8_t*")
    b = src.index("// K3:", a)
    body = src[a:b]
    body = edit(body, "  extern __shared__ __align__(16) uint8_t smem[];\n",
                "  extern __shared__ __align__(16) uint8_t smem[];\n"
                "  STAMP(0);\n")
    if own:                     # K4's own kernel (since the skip)
        body = edit(body, "  copy_skip_tables(tab, skip, acc, t256, skips, "
                    "accept, S);\n", "  copy_skip_tables(tab, skip, acc, "
                    "t256, skips, accept, S);\n  STAMP(1);\n")
        body = edit(body, "  out[r] = acc[s];\n", "  __syncwarp();\n"
                    "  STAMP(2);\n  out[r] = acc[s];\n  __syncwarp();\n"
                    "  STAMP(3);\n")
    else:
        body = edit(body, "\n\n  const int64_t r = static_cast<int64_t>",
                    "\n  STAMP(1);\n\n  const int64_t r = "
                    "static_cast<int64_t>")
        body = edit(body, "  if (kTags) {\n    static_cast<int32_t*>(out)[r]",
                    "  __syncwarp();\n  STAMP(2);\n"
                    "  if (kTags) {\n    static_cast<int32_t*>(out)[r]")
        body = edit(body, "    static_cast<int32_t*>(out)[r] = acc[s];\n",
                    "    static_cast<int32_t*>(out)[r] = acc[s];\n"
                    "    __syncwarp();\n    STAMP(3);\n")
    src = src[:a] + body + src[b:]
    src = edit(src, "namespace {\n\nconstexpr int kMaxThreads",
               "namespace {\n"
               "__device__ long long g_stamp[65536 * 4];\n"
               "#define STAMP(k) do { if (threadIdx.x == 0) "
               "g_stamp[blockIdx.x * 4 + (k)] = clock64(); } while (0)\n"
               "\nconstexpr int kMaxThreads")
    return edit(src, 'extern "C" {\n', 'extern "C" {\n'
                "int probe_stamps(void* dst, size_t n) {\n"
                "  return (int)cudaMemcpyFromSymbol(dst, g_stamp, n);\n}\n")


K4_STAGE_ROWS = """\
// The block's rows [r0, r0 + n) into shared memory at a stride of L + 16:
// the block's tile in coalesced 16-byte cp.async copies.
__device__ __forceinline__ void stage_rows(uint8_t* dst, const uint8_t* src,
                                           int n, int32_t L) {
  const int wpr = L >> 4;
  for (int i = threadIdx.x; i < n * wpr; i += blockDim.x) {
    const int row = i / wpr;
    __pipeline_memcpy_async(dst + row * (L + 16) + 16 * (i - row * wpr),
                            src + 16 * i, 16);
  }
}

"""


def k4_staged(src: str) -> str:
    """K4 with its block's rows staged in shared memory beside its tables
    (the block's tile by coalesced 16-byte ``cp.async``, at a stride of
    ``L + 16``, committed with the table copy) and walked there; rows must
    be 16-byte aligned, ``L`` a multiple of 16, and the launch's shared
    memory ``k4_staged_smem``."""
    a = src.index("__device__ __forceinline__ uint32_t fused_scan_walk(")
    b = src.index("// K2: one row a thread.")
    src = src[:a] + src[a:b].replace("__ldg(v + min(", "*(v + min(") \
        + src[b:]
    src = edit(src, "// K4: one row a thread, with the skip",
               K4_STAGE_ROWS + "// K4: one row a thread, with the skip")
    src = edit(src, """  const uint8_t* row = rows + r * L;
  const bool vec = L > 0 && aligned_rows(row, L);
  int len = 0;
  uint4 q = make_uint4(0u, 0u, 0u, 0u);
  if (r < B) {
    len = lengths[r];
    if (vec) q = __ldg(reinterpret_cast<const uint4*>(row));
  }
""", """  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  uint8_t* staged = smem + ((268 * S + 15) & ~15);
  stage_rows(staged, rows + r0 * L,
             static_cast<int>(B - r0 < blockDim.x ? B - r0 : blockDim.x), L);
  const uint8_t* row = staged + threadIdx.x * (L + 16);
  const bool vec = true;
  int len = 0;
  uint4 q = make_uint4(0u, 0u, 0u, 0u);
  if (r < B) len = lengths[r];
""")
    return edit(src, "  if (r >= B) return;\n  len = len < 0 ? 0 : (len > L ? L : len);",
                "  if (r >= B) return;\n"
                "  q = *reinterpret_cast<const uint4*>(row);\n"
                "  len = len < 0 ? 0 : (len > L ? L : len);")


def k4_staged_smem(S: int, L: int, threads: int) -> int:
    """``k4_staged``'s shared memory: the tables from a 16-byte boundary,
    then ``threads`` rows of ``L + 16`` bytes."""
    return -(-268 * S // 16) * 16 + threads * (L + 16)


def k4_cut(src: str, where: str) -> str:
    """K4's walk cut short, for timing its parts (its results are wrong):
    ``none`` walks nothing (the table copy, the row's length and first
    word, the write); ``skip`` stops at the first skip state (the words
    walked through the table before it); ``test`` stops after testing that
    word for an escape byte (before any scan loads)."""
    if where == "none":
        return edit(src, "  if (n <= 0) return s;\n", "  return s;\n")
    if where == "skip":
        return edit(src, "      int p = first_escape(q, eb, ne);\n",
                    "      return s;\n      int p = first_escape(q, eb, "
                    "ne);\n")
    return edit(src, "      if (p == 16) {                      // none in "
                "this word: skip it\n", "      if (p == 16) return s;\n"
                "      if (p == 16) {\n")


#: a one-member set whose two states (an even or odd count of ``;``) are
#: both skip states that ``;`` alone leaves, each for the other
PARITY_SET = [r"(?:[^;]*;[^;]*;)*[^;]*"]


def k4_vcmpeq4(src: str) -> str:
    """K4's escape test as four ``__vcmpeq4`` a 32-bit lane, whatever
    the state's count of escape bytes (the unused ones repeat the first),
    in place of the zero-byte test on the state's own escape bytes."""
    return edit(src, """  uint32_t h = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < n) {
      const uint32_t y = x ^ (((e >> (8 * j)) & 0xFFu) * 0x01010101u);
      h |= (y - 0x01010101u) & ~y & 0x80808080u;
    }
  }
  return h;""", """  uint32_t h = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    h |= __vcmpeq4(x, ((e >> (8 * j)) & 0xFFu) * 0x01010101u);
  return h;""")


def escape_rows(B, L, every=17):
    """Rows of lowercase letters with a ``;`` every ``every`` bytes, of
    lengths L/2..L: on ``PARITY_SET`` K4's skip scans a word, resumes at the
    ``;``, and scans again at the next word, all the way along."""
    import numpy as np
    rng = np.random.default_rng(every)
    out = []
    for _ in range(B):
        row = bytearray(rng.integers(97, 123, L, dtype=np.uint8).tobytes())
        row[every - 1::every] = b";" * len(row[every - 1::every])
        out.append(bytes(row[:int(rng.integers(L // 2, L + 1))]))
    return out


def dfa_batch(lines, B, L):
    """``lines`` packed at (B, L), on the card, and the host rows."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch.ops.device_batch import pack_rows
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines) or b"\0", np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    batch = pack_rows(arena, offs, lens, L, B)
    return (batch, torch.from_numpy(batch.rows).cuda(),
            torch.from_numpy(batch.lengths).cuda())


def k4_split(libs, kern, rows, lengths, B, n_real):
    """Median and largest cycles a block of K4's table copy, walk and
    write, from each stamped build in ``libs`` (name: (lib, binding)), over
    the blocks that hold real rows."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda as dsc
    for name, (lib, binding) in libs.items():
        threads = (dsc.launch_geometry(B) if name == "other"
                   else dsc.geometry(kern.mode, B))
        fn = dfa_caller(dsc, lib, binding, kern, threads)
        fn(rows, lengths)
        torch.cuda.synchronize()
        st = stamp_phases(lib, 4, -(-B // threads), -(-n_real // threads))
        phases = {"copy": st[:, 1] - st[:, 0], "walk": st[:, 2] - st[:, 1],
                  "write": st[:, 3] - st[:, 2], "block": st[:, 3] - st[:, 0]}
        print(f"chip_probe: k4 stamps {name} B={B} ({n_real} rows, blocks "
              f"of {threads}): cycles per block (median / largest) "
              + ", ".join(f"{k} {int(np.median(v))} / {int(v.max())}"
                          for k, v in phases.items()), flush=True)


def k2_compare(other: str) -> int:
    """K2 and K4 built from ``other`` against this tree's, in turns; K4's
    stamped split in both builds, and this tree's K4 at larger blocks."""
    import chip_smoke
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda as dsc
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    from loongcollector_tpu_torch.ops.kernels.dfa_scan import (
        DFAMatchKernel, FusedScanKernel, settle_points, settled_last)
    from loongcollector_tpu_torch.ops.regex.dfa import compile_dfa
    from loongcollector_tpu_torch.ops.regex.fuse import compile_fused
    print(f"chip_probe: card: {chip_smoke.nvidia_smi()}", flush=True)
    with open(other) as f:
        other_src = f.read()
    with open(dsc._SRC) as f:
        this_src = f.read()
    other_inc = os.path.dirname(os.path.abspath(other))
    libs, stamped_libs = {}, {}
    for name, src, inc in (("other", other_src, other_inc),
                           ("this", this_src, "")):
        lib, log = compile_so(fxc, "dfa_" + name, src, inc)
        rep = dsc.ptxas_report(log)
        print(f"chip_probe: dfa_{name}: ptxas " + ", ".join(
            f"{k} {r.get('registers')} registers, {r.get('stack')} stack, "
            f"{r.get('spill_stores')} spills"
            for k, r in sorted(rep.items())), flush=True)
        libs[name] = (lib, dfa_binding(lib, src))
        slib, _ = compile_so(fxc, "dfa_stamped_" + name, k4_stamped(src), inc)
        stamped_libs[name] = (slib, dfa_binding(slib, src))
    for name, form in (("vcmpeq4", k4_vcmpeq4), ("staged", k4_staged)):
        lib, _ = compile_so(fxc, "dfa_" + name, form(this_src))
        libs[name] = (lib, dfa_binding(lib, this_src))
    cuts = {}
    for where in ("none", "skip", "test"):
        lib, _ = compile_so(fxc, "dfa_cut_" + where, k4_cut(this_src, where))
        cuts[where] = (lib, dfa_binding(lib, this_src))
    java = td.gen_java_log(chip_smoke.MAIN_PATH_LINES, seed=13)
    msgs = [r["message"].encode()
            for r in td.java_oracle(td.java_records(java, td.JAVA_CONTINUE))
            if "message" in r]
    k2 = DFAMatchKernel(compile_dfa(td.JAVA_FILTER))
    k4 = FusedScanKernel(compile_fused([td.JAVA_START, td.JAVA_CONTINUE]))
    parity = chip_smoke.table_kernel(FusedScanKernel, FusedScanKernel(
        compile_fused(PARITY_SET)).arrays)
    cap = chip_smoke.table_kernel(FusedScanKernel,
                                  settled_last(*td.cap_automaton(seed=256)))
    rng = __import__("numpy").random.default_rng(3)
    cap_rows = [bytes(rng.integers(65, 90, int(n), dtype="uint8"))
                for n in rng.integers(128, 257, 8192)]      # no Z: open
    path4 = chip_smoke.path_rows(java, 8192, 256)
    points = [("K2 path", k2, chip_smoke.path_rows(msgs, 2048, 4096),
               2048, 4096),
              ("K2 adversarial", k2, chip_smoke.adversarial_rows(2048, 4096),
               2048, 4096),
              ("K2 bench", k2, chip_smoke.bench_rows(msgs, 8192, 128),
               8192, 128),
              ("K2 bench", k2, chip_smoke.bench_rows(msgs, 65536, 128),
               65536, 128),
              ("K4 path", k4, path4, 8192, 256),
              ("K4 bench", k4, chip_smoke.bench_rows(java, 8192, 128),
               8192, 128),
              ("K4 bench", k4, chip_smoke.bench_rows(java, 65536, 128),
               65536, 128),
              ("K4 escape every 17 bytes", parity, escape_rows(8192, 256),
               8192, 256),
              ("K4 cap automaton", cap, cap_rows, 8192, 256)]
    for tag, kern, lines, B, L in points:
        batch, rows, lengths = dfa_batch(lines, B, L)
        calls = {k: dfa_caller(dsc, lib, binding, kern,
                               None if k == "other"
                               else dsc.geometry(kern.mode, B),
                               k4_staged_smem if k == "staged" else None)
                 for k, (lib, binding) in libs.items()}
        order = ["other", "this", "this", "other"]
        if kern.mode == "tags":
            for t in (32, 64):
                calls[f"this_{t}t"] = dfa_caller(dsc, *libs["this"], kern,
                                                 threads=t)
            half = ["other", "this", "vcmpeq4", "this_32t", "this_64t"]
            if k4_staged_smem(kern.arrays.num_states, L, 128) <= 48 * 1024:
                half.insert(2, "staged")
            else:
                del calls["staged"]
            order = half + half[::-1]
        else:
            del calls["vcmpeq4"], calls["staged"]
        want = kern.plain(rows, lengths).cpu().numpy()
        for k, fn in calls.items():
            got = kern._epilogue(fn(rows, lengths)).cpu().numpy()
            if not (got == want).all():
                raise SystemExit(f"chip_probe: {tag} {k} != plain at "
                                 f"B={B} L={L}")
        turns = [(k, chip_smoke.graph_ms([lambda fn=calls[k]: fn(rows,
                                                                 lengths)]))
                 for k in order]
        walked = int(settle_points(kern.arrays, batch.rows,
                                   batch.lengths).sum())
        out_b = 1 if kern.mode == "match" else 4
        S = kern.arrays.num_states
        b_ms, _ = chip_smoke.dfa_bound_ms(B, S, walked, out_b)
        b_len, _ = chip_smoke.dfa_bound_ms(B, S, int(batch.lengths.sum()),
                                           out_b)
        print(f"chip_probe: k2 {tag} B={B} L={L} S={S} ("
              f"{int(batch.lengths.sum())} row bytes, {walked} to the "
              f"settle points): device ms per launch in turns: "
              + ", ".join(f"{k} {ms:.5f}" for k, ms in turns)
              + f"; bound {b_ms:.6f} ms (settle points), {b_len:.6f} ms "
              f"(lengths)", flush=True)
        if tag == "K4 path":
            k4_split(stamped_libs, kern, rows, lengths, B, len(lines))
            fns = {"this": calls["this"]}
            fns.update({f"cut_{w}": dfa_caller(dsc, lib, binding, kern,
                                               dsc.geometry(kern.mode, B))
                        for w, (lib, binding) in cuts.items()})
            seq = list(fns)
            ms = {k: [] for k in seq}
            for k in seq + seq[::-1]:
                ms[k].append(chip_smoke.graph_ms(
                    [lambda fn=fns[k]: fn(rows, lengths)]))
            print(f"chip_probe: k4 cut short (timing only: none = no walk, "
                  f"skip = up to the first skip state, test = and its "
                  f"word's test) B={B} L={L}: device ms in turns (there and "
                  f"back): " + ", ".join(f"{k} {ms[k][0]:.5f} / "
                                         f"{ms[k][1]:.5f}" for k in seq),
                  flush=True)
    return 0


# -- K7 and K5 against another tree's ----------------------------------------

K7_STAMPS = 11


def other_root(src: str) -> str:
    """The checkout that holds the kernel source ``src`` (``<root>/
    loongcollector_tpu_torch/ops/kernels/csrc/<name>``)."""
    root = os.path.abspath(src)
    for _ in range(5):
        root = os.path.dirname(root)
    if not os.path.isdir(os.path.join(root, "loongcollector_tpu_torch")):
        raise SystemExit(f"chip_probe: {src} is not inside a checkout")
    return root


def other_package(root: str, alias: str):
    """The port package of the checkout ``root``, imported as ``alias``
    beside this tree's (its modules import each other relatively), so its
    own host code packs what its own kernels read."""
    import importlib.util
    pkg = os.path.join(root, "loongcollector_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def k7_stamped(src: str) -> str:
    """K7 with ``clock64()`` stamps by thread 0 of each block: entry (0),
    its rows staged (6), the barrier after the rows and the descriptor (1),
    the end of the extract stage's walk (2), the end of ``write_warp_caps``
    (3), the end of the keep stage (4), and exit (5) (with several stages
    of a kind, the last one's); inside the keep, for its first two
    conditions, the record loaded (7, 9: the stamp waits on its words) and
    the condition's result (8, 10), where thread 0 evaluates them."""
    src = edit(src, "namespace {\n", "namespace {\n"
               f"__device__ long long g_stamp[65536 * {K7_STAMPS}];\n"
               "#define STAMP(k) do { if (threadIdx.x == 0) "
               f"g_stamp[blockIdx.x * {K7_STAMPS} + (k)] = clock64(); "
               "} while (0)\n")
    src = edit(src, "  extern __shared__ __align__(16) int32_t smem[];\n",
               "  extern __shared__ __align__(16) int32_t smem[];\n"
               "  STAMP(0);\n")
    src = edit(src, "  stage_warp_rows(rows, row0, wrow, wrows, lane, L, len, "
               "tile, ws);\n  desc_copy_wait();\n  __syncthreads();\n",
               "  stage_warp_rows(rows, row0, wrow, wrows, lane, L, len, "
               "tile, ws);\n  STAMP(6);\n  desc_copy_wait();\n"
               "  __syncthreads();\n  STAMP(1);\n")
    src = edit(src, "      ext_ok |= static_cast<uint32_t>(ok) << si;\n",
               "      STAMP(2);\n      ext_ok |= static_cast<uint32_t>(ok) "
               "<< si;\n")
    src = edit(src, "    } else if (kind == ST_SCAN) {\n",
               "      STAMP(3);\n    } else if (kind == ST_SCAN) {\n")
    ck = "(7 + 2 * (ci - st[S_SEC]))"
    src = edit(src, "        const int4 c0 = cr[0], c1 = cr[1], c2 = cr[2], "
               "c3 = cr[3];\n",
               "        const int4 c0 = cr[0], c1 = cr[1], c2 = cr[2], "
               "c3 = cr[3];\n"
               f"        if (threadIdx.x == 0 && {ck} < 11 && (c0.x | c1.x "
               "| c2.x | c3.x) != -7) "
               f"g_stamp[blockIdx.x * 11 + {ck}] = clock64();\n")
    src = edit(src, "        keep = c0.y ? !ok : ok;\n",
               "        keep = c0.y ? !ok : ok;\n"
               f"        if (threadIdx.x == 0 && {ck} + 1 < 11 && "
               f"(int)keep != 7) g_stamp[blockIdx.x * 11 + {ck} + 1] = clock64();\n")
    src = edit(src, "      out[B * st[S_OUT0] + bshift + row0 + tid] = keep;"
               "\n    }\n  }\n}\n",
               "      out[B * st[S_OUT0] + bshift + row0 + tid] = keep;\n"
               "      STAMP(4);\n    }\n  }\n  STAMP(5);\n}\n")
    return edit(src, 'extern "C" {\n', 'extern "C" {\n'
                "int probe_stamps(void* dst, size_t n) {\n"
                "  return (int)cudaMemcpyFromSymbol(dst, g_stamp, n);\n}\n"
                "int probe_clear(void) {\n  void* p = nullptr;\n"
                "  cudaError_t e = cudaGetSymbolAddress(&p, g_stamp);\n"
                "  return (int)(e ? e : cudaMemset(p, 0, sizeof(g_stamp)));"
                "\n}\n")


# The descriptor's other copy: one 1-D TMA bulk copy issued by thread 0,
# completing on an mbarrier that thread 0 waits on before the barrier.
TMA_COPY = """__shared__ __align__(8) uint64_t desc_bar;

__device__ __forceinline__ void desc_copy_begin(int32_t* dst,
                                                const int32_t* src,
                                                int32_t words, int32_t tid,
                                                int32_t T) {
  if (tid != 0) return;
  const uint32_t bar =
      static_cast<uint32_t>(__cvta_generic_to_shared(&desc_bar));
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const uint32_t bytes = 4u * static_cast<uint32_t>(words);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];"
               :: "r"(d), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void desc_copy_wait() {
  if (threadIdx.x != 0) return;
  const uint32_t bar =
      static_cast<uint32_t>(__cvta_generic_to_shared(&desc_bar));
  uint32_t done = 0;
  while (!done)
    asm volatile("{\\n .reg .pred p;\\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\\n"
                 " selp.u32 %0, 1, 0, p;\\n}"
                 : "=r"(done) : "r"(bar) : "memory");
}
"""


def tma_copy(src: str) -> str:
    """``fused_program.cu`` with its descriptor copy taken by ``TMA_COPY``
    in place of the 16-byte cp.async copies; the barrier's static shared
    memory comes off the dynamic budget each instantiation opts into."""
    a = src.index("__device__ __forceinline__ void desc_copy_begin(")
    b = src.index("__device__ __forceinline__ void desc_copy_wait() {")
    b = src.index("}\n", b) + 2
    src = src[:a] + TMA_COPY + src[b:]
    return edit(src, "                             kSmemBudget);",
                "                             kSmemBudget - 16);")


def k5_direct(src: str) -> str:
    """``struct_index.cu`` with its row staging taken out: the walk reads
    each step's bytes from device memory (``__ldg``), as the parent's did,
    and keeps the exit at the length and the coalesced stores."""
    a = src.index("  uint8_t* const tb = tile")
    b = src.index("  struct_row<MODE>(")
    src = src[:a] + src[b:]
    return edit(src, "struct_row<MODE>([tb](int32_t p) { return tb[p]; }",
                "struct_row<MODE>([r](int32_t p) { return __ldg(r + p); }")


def with_occupancy(src: str, kernel: str) -> str:
    """``src`` with ``probe_occupancy(n, a, b, threads, smem)`` exported:
    the blocks an SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) of ``kernel``, a C
    expression of the ints ``a`` and ``b``."""
    return edit(src, 'extern "C" {\n', 'extern "C" {\n'
                "int probe_occupancy(int* n, int a, int b, int threads, "
                "int smem) {\n"
                "  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor("
                f"n, {kernel}, threads, smem);\n}}\n")


def occupancy(lib, a: int, b: int, threads: int, smem: int) -> int:
    """``with_occupancy``'s query of ``lib``."""
    n = ctypes.c_int(0)
    lib.probe_occupancy.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    if lib.probe_occupancy(ctypes.byref(n), a, b, threads, smem):
        raise SystemExit("chip_probe: the occupancy query failed")
    return n.value


def bind_k7(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    fn = lib.lct_fused_program
    fn.restype = ctypes.c_int
    fn.argtypes = [vp, vp, ctypes.c_int64, i32, vp, i32, i32, vp, i32, i32,
                   vp, vp, vp]


def stamp_phases(lib, n_stamps, blocks, real_blocks):
    """The stamped build's clock stamps, [real_blocks, n_stamps]."""
    import numpy as np
    buf = np.zeros(65536 * n_stamps, np.int64)
    lib.probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    if lib.probe_stamps(buf.ctypes.data, buf.nbytes):
        raise SystemExit("chip_probe: cannot read the stamps")
    return buf[:blocks * n_stamps].reshape(blocks, n_stamps)[:real_blocks]


def k7_gate(src: str) -> str:
    """``fused_program.cu`` with K3's length gate in its span condition: a
    walked length outside the hull of the automaton's accepted lengths
    (``dfa_scan.length_gate`` to the largest bucket, in the record's last
    two words, which ``gate_descriptor`` fills) gives false before the
    walk.  Measured
    slower than the condition without it on both filter chunks (PERF.md
    §6), so K7 keeps its walk ungated."""
    return edit(src, """          ok = sl >= 0 &&
               dfa_resolved(b, c3.y, c3.x, c2.w, c2.y, c2.z, r.w, lo,
                            hi) != 0;""", """          const int32_t n = hi > lo ? hi - lo : 0;
          ok = sl >= 0 && n >= c3.z && n <= c3.w &&
               dfa_resolved(b, c3.y, c3.x, c2.w, c2.y, c2.z, r.w, lo,
                            hi) != 0;""")


def gate_descriptor(fpc, desc, stages):
    """``desc`` with each span condition's record holding its automaton's
    accepted-length hull in its last two words, for ``k7_gate``."""
    import dataclasses
    from loongcollector_tpu_torch.ops.device_batch import LENGTH_BUCKETS
    from loongcollector_tpu_torch.ops.kernels.dfa_scan import length_gate
    blob = desc.blob.copy()
    conds = fpc.HEADER_WORDS + fpc.RECORD_WORDS * len(stages)
    for si, st in enumerate(stages):
        first = int(blob[fpc.HEADER_WORDS + fpc.RECORD_WORDS * si + 1])
        for k, c in enumerate(st.conds):
            if c.kind == "span_match":
                at = conds + fpc.COND_WORDS * (first + k)
                g = length_gate(c.obj, LENGTH_BUCKETS[-1])
                blob[at + fpc.COND_WORDS - 2:at + fpc.COND_WORDS] = \
                    (g.lo, g.hi)
    return dataclasses.replace(desc, blob=blob)


def k7_compare(other: str) -> int:
    """K7 built from ``other`` (with its own host code packing its
    descriptors) against this tree's K7 and its TMA-copy form, in turns;
    this tree's cycles by phase beside K1's, registers, shared memory and
    occupancy."""
    import numpy as np
    import torch
    import chip_smoke
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops import fused_pipeline as fp
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    from loongcollector_tpu_torch.ops.kernels import fused_program_cuda as fpc
    from loongcollector_tpu_torch.ops.kernels.field_extract import \
        ExtractKernel
    from loongcollector_tpu_torch.ops.regex.program import compile_tier1
    print(f"chip_probe: card: {chip_smoke.nvidia_smi()}", flush=True)
    other_package(other_root(other), "other_port")
    from other_port.ops.kernels import fused_program_cuda as ofpc
    with open(other) as f:
        other_src = f.read()
    with open(fpc._SRC) as f:
        src = f.read()
    # a: the first extract stage's pivot kind (FIRST), b: GENERAL
    occ = "kKernels[a + 1][b]"
    libs, logs = {}, {}
    for name, text, inc in (
            ("other", with_occupancy(other_src, occ),
             os.path.dirname(os.path.abspath(other))),
            ("this", with_occupancy(src, occ), ""),
            ("this_tma", with_occupancy(tma_copy(src), occ), ""),
            ("this_gate", with_occupancy(k7_gate(src), occ), ""),
            ("this_stamped", k7_stamped(src), ""),
            ("gate_stamped", k7_stamped(k7_gate(src)), ""),
            ("other_stamped", k7_stamped(other_src),
             os.path.dirname(os.path.abspath(other)))):
        libs[name], logs[name] = compile_so(fxc, "k7_" + name, text, inc)
        bind_k7(libs[name])
    for name in ("other", "this", "this_tma", "this_gate"):
        rep = fpc.ptxas_report(logs[name])
        print(f"chip_probe: k7_{name}: ptxas " + ", ".join(
            f"{k} {r.get('registers')} registers, {r.get('stack')} stack, "
            f"{r.get('spill_stores')} spills"
            for k, r in sorted(rep.items()) if k in ("d0_p0", "d0_p0_g",
                                                     "none")), flush=True)
    with open(fxc._SRC) as f:
        k1_src = f.read()
    # a: the depth-0 program's pivot kind
    k1_kernel = ("(a == 0 ? field_extract_kernel<false, 0, false> : a == 1 ? "
                 "field_extract_kernel<false, 1, false> : "
                 "field_extract_kernel<false, 2, false>)")
    k1_lib, k1_log = compile_so(fxc, "k1_occupancy",
                                with_occupancy(k1_src, k1_kernel))
    k1_stamp_lib = build(fxc, "k1_stamped", stamped(k1_src))
    k7_regs = fpc.ptxas_report(logs["this"])
    k1_regs = fxc.ptxas_report(k1_log)
    apache = dict((n, s) for n, s, _ in td.fused_stage_lists())[
        "apache_filter"]
    delim = dict((n, s) for n, s, _ in td.struct_stage_lists())[
        "delim_struct_keep"]
    pipe_lines = td.gen_pipe_log(8192, seed=23)
    n_pipe = int((np.cumsum([len(x) + 1 for x in pipe_lines])
                  <= 512 * 1024).sum())
    cases = [("apache_filter", apache, td.gen_lines(5500, seed=5)),
             ("delimiter_filter", [delim[0], delim[2]],
              pipe_lines[:n_pipe])]
    B, L = 8192, 128
    for tag, specs, lines in cases:
        program = fp.FusedProgramKernel(specs, tag)
        stages = fp.kernel_stages(specs)
        descs = {"other": ofpc.pack_descriptor(stages),
                 "this": program.descriptor}
        descs["this_tma"] = descs["this_stamped"] = descs["this"]
        descs["this_gate"] = descs["gate_stamped"] = gate_descriptor(
            fpc, descs["this"], stages)
        descs["other_stamped"] = descs["other"]
        geoms = {k: (ofpc if k.startswith("other") else fpc).launch_geometry(
            B, L, d) for k, d in descs.items()}
        blobs = {k: torch.from_numpy(d.blob).cuda() for k, d in descs.items()}
        batch, rows, lengths = dfa_batch(lines, B, L)

        def k7_launcher(k):
            lib, desc, blob = libs[k], descs[k], blobs[k]
            threads, smem = geoms[k]

            def call(r=rows, n=lengths):
                out = torch.empty(desc.flat_bytes(B, L), dtype=torch.uint8,
                                  device=r.device)
                rc = lib.lct_fused_program(
                    r.data_ptr(), n.data_ptr(), B, L, blob.data_ptr(),
                    desc.first, int(desc.general), out.data_ptr(), threads,
                    smem, torch.cuda.current_stream().cuda_stream, None,
                    None)
                if rc:
                    raise SystemExit(f"chip_probe: K7 {k} launch failed "
                                     f"({rc})")
                return out
            return call
        calls = {k: k7_launcher(k) for k in libs}
        want = [t.cpu().numpy() for t in program.plain(rows, lengths)]
        for k, fn in calls.items():
            got = [t.cpu().numpy() for t in program.split(fn(), B)]
            if not all((g.reshape(w.shape) == w).all()
                       for g, w in zip(got, want)):
                raise SystemExit(f"chip_probe: K7 {k} != plain on {tag}")
        order = ("other", "this", "this_tma", "this_gate", "this_gate",
                 "this_tma", "this", "other") * 2
        turns = [(k, chip_smoke.graph_ms([calls[k]])) for k in order]
        threads = geoms["this"][0]
        print(f"chip_probe: k7 {tag} B={B} L={L} ({len(lines)} rows, "
              f"{-(-B // threads)} blocks of {threads}; descriptor "
              f"{descs['other'].shared_words} / {descs['this'].shared_words} "
              f"shared words other / this): device ms per launch in turns: "
              + ", ".join(f"{k} {ms:.5f}" for k, ms in turns), flush=True)
        # stamps of one launch only: clock64 is an SM's own counter, so a
        # stamp left by another launch does not compare with this one's;
        # the other tree's K7 stamped beside this one's (the keep's split
        # before and after)
        for stamped_name in ("other_stamped", "this_stamped", "gate_stamped"):
            if libs[stamped_name].probe_clear():
                raise SystemExit("chip_probe: cannot clear the stamps")
            calls[stamped_name]()
            torch.cuda.synchronize()
            threads = geoms[stamped_name][0]
            blocks = -(-B // threads)
            st = stamp_phases(libs[stamped_name], K7_STAMPS, blocks,
                              -(-len(lines) // threads))
            phases = {"staging": st[:, 1] - st[:, 0],
                      "rows staged": st[:, 6] - st[:, 0],
                      "descriptor wait": st[:, 1] - st[:, 6],
                      "extract walk": st[:, 2] - st[:, 1],
                      "write caps": st[:, 3] - st[:, 2],
                      "keep": st[:, 4] - st[:, 3],
                      "exit": st[:, 5] - st[:, 4],
                      "block": st[:, 5] - st[:, 0]}
            # the keep's first condition, and its second where thread 0's
            # row reached it
            two = (st[:, 9] > 0) & (st[:, 10] > 0)
            phases.update({"keep: first record": st[:, 7] - st[:, 3],
                           "keep: first condition": st[:, 8] - st[:, 7]})
            if two.any():
                phases.update({
                    "keep: second record": (st[:, 9] - st[:, 8])[two],
                    "keep: second condition": (st[:, 10] - st[:, 9])[two]})
            print(f"chip_probe: k7 {tag} {stamped_name.split('_')[0]} "
                  f"cycles per block (median / largest, {len(st)} blocks "
                  f"with real rows): "
                  + "; ".join(f"{k} {int(np.median(v))} / {int(v.max())}"
                              for k, v in phases.items()), flush=True)
        threads = geoms["this"][0]
        k1 = ExtractKernel(compile_tier1(chip_smoke.APACHE if tag ==
                                         "apache_filter" else td.PIPE_PATTERN))
        kp = k1.kernel_program
        k1_threads, k1_smem = fxc.launch_geometry(B, L, kp.num_caps,
                                                  kp.pivot, len(kp.blob))
        # K1 alone on the same chunk, stamped as the default mode stamps
        # it, for the same call's comparison
        prog = torch.from_numpy(kp.blob).cuda()
        launcher(fxc, k1_stamp_lib, k1, prog)(rows, lengths)
        torch.cuda.synchronize()
        k1st = stamp_phases(k1_stamp_lib, STAMPS, -(-B // k1_threads),
                            -(-len(lines) // k1_threads))
        k1_phases = {"staging": k1st[:, 1] - k1st[:, 0],
                     "walk": k1st[:, 2] - k1st[:, 1],
                     "write-back": k1st[:, 3] - k1st[:, 2],
                     "block": k1st[:, 3] - k1st[:, 0]}
        print(f"chip_probe: k7 {tag}: K1 alone on the chunk, cycles per "
              f"block (median / largest): " + "; ".join(
                  f"{k} {int(np.median(v))} / {int(v.max())}"
                  for k, v in k1_phases.items()), flush=True)
        k1_key = kp.entry_point.replace("lct_field_extract_", "")
        desc = descs["this"]
        smem = geoms["this"][1]
        n7 = occupancy(libs["this"], desc.first, int(desc.general), threads,
                       smem)
        n1 = occupancy(k1_lib, kp.pivot, 0, k1_threads, k1_smem)
        print(f"chip_probe: k7 {tag}: K7 {desc.instantiation} "
              f"{k7_regs.get(desc.instantiation, {}).get('registers')} "
              f"registers, {smem} bytes of dynamic shared memory a block of "
              f"{threads}, {n7} blocks an SM; K1 {k1_key} "
              f"{k1_regs.get(k1_key, {}).get('registers')} registers, "
              f"{k1_smem} bytes a block of {k1_threads}, {n1} blocks an SM",
              flush=True)
    return 0


def k5_compare(other: str) -> int:
    """K5 built from ``other`` (a ``struct_index.cu`` with its header
    beside it) against this tree's, checked against the plain version and
    timed in turns (other, this, direct, direct, this, other) on the CSV
    path's shapes (``B=4096``, ``L=512`` and ``256``, 2,439 quote-mode CSV
    rows, as a path group), at ``L=128`` (``B=8192`` and ``65536``) and on
    long JSON rows at ``B=1024, L=4096``, beside the bound."""
    import numpy as np
    import torch
    import chip_smoke
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    from loongcollector_tpu_torch.ops.kernels import struct_index as si
    from loongcollector_tpu_torch.ops.kernels import struct_index_cuda as sic
    print(f"chip_probe: card: {chip_smoke.nvidia_smi()}", flush=True)
    with open(other) as f:
        other_src = f.read()
    with open(sic._SRC) as f:
        this_src = f.read()
    libs = {}
    for name, text, inc in (("other", other_src,
                             os.path.dirname(os.path.abspath(other))),
                            ("this", this_src, ""),
                            ("direct", k5_direct(this_src), "")):
        lib, log = compile_so(fxc, "k5_" + name, text, inc)
        rep = sic.ptxas_report(log)
        print(f"chip_probe: k5_{name}: ptxas " + ", ".join(
            f"{k} {r.get('registers')} registers, {r.get('stack')} stack, "
            f"{r.get('spill_stores')} spills"
            for k, r in sorted(rep.items())), flush=True)
        vp, i32 = ctypes.c_void_p, ctypes.c_int32
        fn = lib.lct_struct_index_cuda
        fn.restype = ctypes.c_int
        fn.argtypes = [vp, vp, ctypes.c_int64, i32, i32, i32, vp, vp, vp, vp]
        libs[name] = lib
    rng = np.random.default_rng(5)
    json_rows = td.gen_json_events(1024, seed=29)
    json_rows = [(r * (4096 // max(len(r), 1) + 1))[:int(rng.integers(
        1, 4097))] for r in json_rows]
    points = [("csv path", si.MODE_DELIM, 0x2C,
               td.gen_quoted_csv(2439, seed=7), 4096, 512),
              ("csv path", si.MODE_DELIM, 0x2C,
               td.gen_quoted_csv(2439, seed=7), 4096, 256),
              ("csv", si.MODE_DELIM, 0x2C, td.gen_quoted_csv(8192, seed=7),
               8192, 128),
              ("csv", si.MODE_DELIM, 0x2C, td.gen_quoted_csv(65536, seed=7),
               65536, 128),
              ("json long", si.MODE_JSON, 0x2C, json_rows, 1024, 4096)]
    for tag, mode, sep, lines, B, L in points:
        mat, lens = chip_smoke.k5_matrix(lines, L, B - len(lines))
        lens[1] = len(lines[1][:L])
        lens[len(lines) // 2] = len(lines[len(lines) // 2][:L])
        rd = torch.from_numpy(mat).cuda()
        ld = torch.from_numpy(lens).cuda()
        kern = si.StructIndexKernel(mode, sep)
        want = np.stack([t.cpu().numpy() for t in kern.plain(rd, ld)])

        def caller(lib):
            def call():
                out = torch.empty((4, B, sic.words16(L)), dtype=torch.int32,
                                  device=rd.device)
                rc = lib.lct_struct_index_cuda(
                    rd.data_ptr(), ld.data_ptr(), B, L, sic.MODES[mode], sep,
                    out.data_ptr(), torch.cuda.current_stream().cuda_stream,
                    None, None)
                if rc:
                    raise SystemExit(f"chip_probe: K5 launch failed ({rc})")
                return out
            return call
        calls = {k: caller(lib) for k, lib in libs.items()}
        for k, fn in calls.items():
            if not np.array_equal(fn().cpu().numpy(), want):
                raise SystemExit(f"chip_probe: K5 {k} != plain on {tag} "
                                 f"B={B} L={L}")
        turns = [(k, chip_smoke.graph_ms([calls[k]]))
                 for k in ("other", "this", "direct", "direct", "this",
                           "other")]
        row_bytes = int(np.clip(lens, 0, L).sum())
        b_ms, by = chip_smoke.k5_bound_ms(B, L, row_bytes)
        print(f"chip_probe: k5 {tag} B={B} L={L} ({len(lines)} rows, "
              f"{row_bytes} row bytes): device ms per launch in turns: "
              + ", ".join(f"{k} {ms:.5f}" for k, ms in turns)
              + f"; bound {b_ms:.6f} ms ({by})", flush=True)
    return 0


# -- K6: this tree's against another's, and the forms measured against it --

K6_FORMS = r"""// K6 forms that hold the segments on the chip, or fold in one launch,
// measured against the three-kernel global form (chip_probe.py k6); each
// was slower at the rollup path's folds, so none is in segment_reduce.cu.
//   cluster (2): one cluster; block k owns segments [k R, k R + R) in its
//     shared memory; rows fold into the owner with distributed
//     shared-memory reductions (red.shared::cluster via mapa);
//   shared (1): P blocks, each the owner of a range in its own shared
//     memory, each reading the whole batch and folding the rows it owns
//     with shared-memory atomics, a warp's lanes of one segment combined;
//   cluster_global (3): one cluster over device memory, the empty values,
//     the fold and the last values split by two cluster barriers.
// Appended to segment_reduce.cu; with K6_STAMPS, thread 0 of each block
// stamps clock64() at entry, after the empty values, after the fold and
// at exit.

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kRows = 4;
constexpr uint32_t kPosInf = 0x7f800000u;
constexpr uint32_t kNegInf = 0xff800000u;

#ifdef K6_STAMPS
__device__ long long g_stamp[65536 * 4];
#define STAMP(k) do { if (threadIdx.x == 0) \
    g_stamp[blockIdx.x * 4 + (k)] = clock64(); } while (0)
#else
#define STAMP(k) do {} while (0)
#endif

// -- the cluster tier -------------------------------------------------------
//
// A block's shared memory for its R segments, Rp = R rounded up to 4 so
// that every section starts on 16 bytes, in 32-bit words:
//   last row + 1 [Rp] | sum [Rp] | count [Rp] | min [Rp] | max [Rp] |
//   hist [R n_hist]
// in bytes 20 Rp + 4 R n_hist (chip_probe.cluster_smem).

__host__ __device__ __forceinline__ int64_t round4(int64_t r) {
    return (r + 3) & ~int64_t(3);
}

__host__ __device__ __forceinline__ int64_t cluster_smem_bytes(
    int64_t R, int32_t n_hist) {
    return 20 * round4(R) + 4 * R * n_hist;
}

// The address of the same shared-memory byte in block `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(out) : "r"(addr), "r"(rank));
    return out;
}

__device__ __forceinline__ void red_add_f32(uint32_t a, float v) {
    asm volatile("red.relaxed.cluster.shared::cluster.add.f32 [%0], %1;"
                 :: "r"(a), "f"(v) : "memory");
}

__device__ __forceinline__ void red_add_u32(uint32_t a, uint32_t v) {
    asm volatile("red.relaxed.cluster.shared::cluster.add.u32 [%0], %1;"
                 :: "r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ void red_min_s32(uint32_t a, int32_t v) {
    asm volatile("red.relaxed.cluster.shared::cluster.min.s32 [%0], %1;"
                 :: "r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ void red_max_s32(uint32_t a, int32_t v) {
    asm volatile("red.relaxed.cluster.shared::cluster.max.s32 [%0], %1;"
                 :: "r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ void red_min_u32(uint32_t a, uint32_t v) {
    asm volatile("red.relaxed.cluster.shared::cluster.min.u32 [%0], %1;"
                 :: "r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ void red_max_u32(uint32_t a, uint32_t v) {
    asm volatile("red.relaxed.cluster.shared::cluster.max.u32 [%0], %1;"
                 :: "r"(a), "r"(v) : "memory");
}

// n words from shared memory (16-byte aligned) to dst: 16-byte stores when
// dst is 16-byte aligned too, else 4-byte ones; neighbouring threads take
// neighbouring words either way.
__device__ __forceinline__ void store_words(int32_t* __restrict__ dst,
                                            const int32_t* src, int64_t n) {
    int64_t i = threadIdx.x;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        const int64_t n4 = n >> 2;
        for (; i < n4; i += blockDim.x)
            reinterpret_cast<int4*>(dst)[i] =
                reinterpret_cast<const int4*>(src)[i];
        i = 4 * n4 + threadIdx.x;
    }
    for (; i < n; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(kClusterThreads, 1)
cluster_kernel(const float* __restrict__ values,
               const int32_t* __restrict__ seg,
               const int32_t* __restrict__ buckets,
               const uint8_t* __restrict__ valid, int64_t B, int64_t G,
               int32_t n_hist, int32_t* __restrict__ out) {
    extern __shared__ __align__(16) int32_t sm[];
    STAMP(0);
    cg::cluster_group cluster = cg::this_cluster();
    const uint32_t rank = cluster.block_rank();
    const uint32_t C = cluster.num_blocks();
    const int64_t R = (G + C - 1) / C;
    const int64_t Rp = round4(R);

    // empty values over the block's own range: every section is a whole
    // number of 16-byte words (Rp a multiple of 4), so one vector store
    // never straddles two sections
    const int64_t words = 5 * Rp + R * n_hist;
    const int64_t n4 = words >> 2;
    for (int64_t q = threadIdx.x; q < n4; q += blockDim.x) {
        const int64_t w = 4 * q;
        const uint32_t e = (w >= 3 * Rp && w < 4 * Rp) ? kPosInf
                         : (w >= 4 * Rp && w < 5 * Rp) ? kNegInf : 0u;
        reinterpret_cast<uint4*>(sm)[q] = make_uint4(e, e, e, e);
    }
    for (int64_t w = 4 * n4 + threadIdx.x; w < words; w += blockDim.x)
        sm[w] = 0;                             // the histogram's tail
    cluster.sync();
    STAMP(1);

    // the fold: every thread of the cluster takes rows C * blockDim apart
    const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
    const int64_t stride = static_cast<int64_t>(C) * blockDim.x;
    const uint32_t r32 = static_cast<uint32_t>(R);
    for (int64_t i = static_cast<int64_t>(rank) * blockDim.x + threadIdx.x;
         i < B; i += stride) {
        if (!valid[i]) continue;
        const int64_t s = seg[i];
        if (s < 0 || s >= G) continue;
        const float v = values[i];
        const int32_t b = buckets[i];
        const uint32_t owner = static_cast<uint32_t>(s) / r32;
        const uint32_t k = static_cast<uint32_t>(s) - owner * r32;
        const uint32_t a = map_rank(base, owner);
        const uint32_t rp = static_cast<uint32_t>(Rp);
        red_max_u32(a + 4 * k, static_cast<uint32_t>(i) + 1u);
        red_add_f32(a + 4 * (rp + k), v);
        red_add_u32(a + 4 * (2 * rp + k), 1u);
        if (__float_as_int(v) >= 0) {
            red_min_s32(a + 4 * (3 * rp + k), __float_as_int(v));
            red_max_s32(a + 4 * (4 * rp + k), __float_as_int(v));
        } else {
            red_max_u32(a + 4 * (3 * rp + k), __float_as_uint(v));
            red_min_u32(a + 4 * (4 * rp + k), __float_as_uint(v));
        }
        if (b >= 0 && b < n_hist)
            red_add_u32(a + 4 * (5 * rp + k * n_hist + b), 1u);
    }
    cluster.sync();
    STAMP(2);

    // write-back of the block's range of each section
    const int64_t r0 = static_cast<int64_t>(rank) * R;
    const int64_t n = r0 < G ? (G - r0 < R ? G - r0 : R) : 0;
    const int32_t* sec = sm + Rp;              // sum, count, min, max
    for (int j = 0; j < 4; ++j)
        store_words(out + j * G + r0, sec + j * Rp, n);
    for (int64_t j = threadIdx.x; j < n; j += blockDim.x) {
        const uint32_t row = static_cast<uint32_t>(sm[j]);  // 0: empty
        out[4 * G + r0 + j] = row ? __float_as_int(values[row - 1]) : 0;
    }
    store_words(out + 5 * G + r0 * n_hist, sm + 5 * Rp, n * n_hist);
    STAMP(3);
}

// -- the shared tier ---------------------------------------------------------
//
// P blocks, each the owner of segments [k R, k R + R), R = ceil(G / P),
// held in its own shared memory (the cluster tier's layout, min and max as
// order keys, then a float a thread of scratch): every block reads the
// whole batch's segment ids and folds the rows it owns with shared-memory
// atomics, no block touching another's memory.  Lanes of a warp that fold
// into one segment are combined first (__match_any_sync, the __reduce_*_sync
// of the keys and rows, the sum through the scratch) so that a hot segment
// costs one atomic a warp, not one a row.

// An order key of a float: unsigned order of keys is the float order,
// -0.0 below +0.0 (NaN never reaches the kernel).
__device__ __forceinline__ uint32_t float_key(float v) {
    const uint32_t b = __float_as_uint(v);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ uint32_t key_bits(uint32_t k) {
    return (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k;
}

__host__ __device__ __forceinline__ int64_t shared_smem_bytes(
    int64_t R, int32_t n_hist, int32_t threads) {
    return 20 * round4(R) + 4 * R * n_hist + 4 * threads;
}

__global__ void __launch_bounds__(kClusterThreads, 1)
shared_kernel(const float* __restrict__ values,
              const int32_t* __restrict__ seg,
              const int32_t* __restrict__ buckets,
              const uint8_t* __restrict__ valid, int64_t B, int64_t G,
              int32_t n_hist, int32_t* __restrict__ out) {
    extern __shared__ __align__(16) int32_t sm[];
    STAMP(0);
    const int64_t P = gridDim.x;
    const int64_t R = (G + P - 1) / P;
    const int64_t Rp = round4(R);
    const int64_t r0 = static_cast<int64_t>(blockIdx.x) * R;
    const int64_t n = r0 < G ? (G - r0 < R ? G - r0 : R) : 0;
    uint32_t* last = reinterpret_cast<uint32_t*>(sm);
    float* sum = reinterpret_cast<float*>(sm + Rp);
    uint32_t* cnt = reinterpret_cast<uint32_t*>(sm + 2 * Rp);
    uint32_t* kmin = reinterpret_cast<uint32_t*>(sm + 3 * Rp);
    uint32_t* kmax = reinterpret_cast<uint32_t*>(sm + 4 * Rp);
    uint32_t* hist = reinterpret_cast<uint32_t*>(sm + 5 * Rp);
    float* scratch = reinterpret_cast<float*>(sm + 5 * Rp + R * n_hist);

    // empty values: the key of +inf over min, of -inf over max, 0 elsewhere
    const int64_t words = 5 * Rp + R * n_hist;
    const int64_t n4 = words >> 2;
    const uint32_t kinf = float_key(__int_as_float(0x7f800000));
    const uint32_t kninf = float_key(__int_as_float(0xff800000));
    for (int64_t q = threadIdx.x; q < n4; q += blockDim.x) {
        const int64_t w = 4 * q;
        const uint32_t e = (w >= 3 * Rp && w < 4 * Rp) ? kinf
                         : (w >= 4 * Rp && w < 5 * Rp) ? kninf : 0u;
        reinterpret_cast<uint4*>(sm)[q] = make_uint4(e, e, e, e);
    }
    for (int64_t w = 4 * n4 + threadIdx.x; w < words; w += blockDim.x)
        sm[w] = 0;
    __syncthreads();
    STAMP(1);

    // the fold: kRows rows a thread per round, their four loads all in
    // flight at once (a block reads the whole batch), then each row in
    // turn with the whole warp converged: lanes whose rows fall in one of
    // this block's segments match on it, and one lane a segment folds the
    // group's values; the others (key ~0u) stay in step and fold nothing
    const int lane = threadIdx.x & 31;
    float* mine = scratch + (threadIdx.x & ~31);
    const int64_t step = static_cast<int64_t>(kRows) * blockDim.x;
    for (int64_t base = 0; base < B; base += step) {
        int32_t sg[kRows], bk[kRows];
        float vl[kRows];
        uint8_t ok[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
            const int64_t i = base + static_cast<int64_t>(j) * blockDim.x +
                              threadIdx.x;
            const bool in = i < B;
            sg[j] = in ? seg[i] : -1;
            ok[j] = in ? valid[i] : 0;
            vl[j] = in ? values[i] : 0.0f;
            bk[j] = in ? buckets[i] : 0;
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
            const int64_t d = static_cast<int64_t>(sg[j]) - r0;
            const bool own = d >= 0 && d < n && ok[j];
            const uint32_t k = own ? static_cast<uint32_t>(d) : ~0u;
            const float v = vl[j];
            const uint32_t i = static_cast<uint32_t>(
                base + static_cast<int64_t>(j) * blockDim.x + threadIdx.x);
            const unsigned peers = __match_any_sync(0xffffffffu, k);
            const uint32_t lo = __reduce_min_sync(peers, float_key(v));
            const uint32_t hi = __reduce_max_sync(peers, float_key(v));
            const uint32_t row = __reduce_max_sync(peers, i + 1u);
            mine[lane] = v;
            __syncwarp();
            if (own && lane == __ffs(peers) - 1) {
                float acc = 0.0f;
                for (unsigned m = peers; m; m &= m - 1)
                    acc += mine[__ffs(m) - 1];
                atomicAdd(sum + k, acc);
                atomicAdd(cnt + k, static_cast<uint32_t>(__popc(peers)));
                atomicMin(kmin + k, lo);
                atomicMax(kmax + k, hi);
                atomicMax(last + k, row);
            }
            if (own && bk[j] >= 0 && bk[j] < n_hist)
                atomicAdd(hist + k * n_hist + bk[j], 1u);
            __syncwarp();
        }
    }
    __syncthreads();
    STAMP(2);

    store_words(out + r0, sm + Rp, n);                    // sum
    store_words(out + G + r0, sm + 2 * Rp, n);            // count
    for (int64_t j = threadIdx.x; j < n; j += blockDim.x) {
        out[2 * G + r0 + j] = static_cast<int32_t>(key_bits(kmin[j]));
        out[3 * G + r0 + j] = static_cast<int32_t>(key_bits(kmax[j]));
        const uint32_t r = last[j];                       // 0: empty
        out[4 * G + r0 + j] = r ? __float_as_int(values[r - 1]) : 0;
    }
    store_words(out + 5 * G + r0 * n_hist, sm + 5 * Rp, n * n_hist);
    STAMP(3);
}

// -- one cluster over device memory ------------------------------------------
//
// The global tier in one launch: one cluster of C blocks writes the empty
// values over the whole output, syncs, folds every row with device-memory
// reductions (last as a 32-bit max of row + 1 in its own section), syncs,
// and turns each last row into its value.  The cluster barrier stands in
// for the two launch boundaries.

__global__ void __launch_bounds__(kClusterThreads, 1)
cluster_global_kernel(const float* __restrict__ values,
                      const int32_t* __restrict__ seg,
                      const int32_t* __restrict__ buckets,
                      const uint8_t* __restrict__ valid, int64_t B,
                      int64_t G, int32_t n_hist, int32_t* __restrict__ out) {
    cg::cluster_group cluster = cg::this_cluster();
    STAMP(0);
    const int64_t t0 = static_cast<int64_t>(cluster.block_rank()) *
                       blockDim.x + threadIdx.x;
    const int64_t nt = static_cast<int64_t>(cluster.num_blocks()) *
                       blockDim.x;
    const int64_t total = 5 * G + G * n_hist;
    for (int64_t i = t0; i < total; i += nt) {
        int32_t v = 0;
        if (i >= 2 * G && i < 3 * G)
            v = static_cast<int32_t>(kPosInf);
        else if (i >= 3 * G && i < 4 * G)
            v = static_cast<int32_t>(kNegInf);
        out[i] = v;
    }
    cluster.sync();
    STAMP(1);
    for (int64_t i = t0; i < B; i += nt) {
        if (!valid[i]) continue;
        const int64_t s = seg[i];
        if (s < 0 || s >= G) continue;
        const float v = values[i];
        atomicAdd(reinterpret_cast<float*>(out) + s, v);
        atomicAdd(out + G + s, 1);
        atomic_min_f32(reinterpret_cast<float*>(out + 2 * G) + s, v);
        atomic_max_f32(reinterpret_cast<float*>(out + 3 * G) + s, v);
        atomicMax(reinterpret_cast<unsigned int*>(out + 4 * G + s),
                  static_cast<unsigned int>(i) + 1u);
        const int32_t b = buckets[i];
        if (b >= 0 && b < n_hist) atomicAdd(out + 5 * G + s * n_hist + b, 1);
    }
    cluster.sync();
    STAMP(2);
    for (int64_t s = t0; s < G; s += nt) {
        const uint32_t r = static_cast<uint32_t>(__ldcg(out + 4 * G + s));
        out[4 * G + s] = r ? __float_as_int(values[r - 1]) : 0;
    }
    STAMP(3);
}

cudaLaunchConfig_t cluster_config(int32_t cluster, int32_t threads,
                                  int32_t smem, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(cluster), 1, 1);
    cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = st;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = static_cast<unsigned>(cluster);
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

int launch_shared(const float* values, const int32_t* seg,
                  const int32_t* buckets, const uint8_t* valid, int64_t B,
                  int64_t G, int32_t n_hist, int32_t* out, int32_t blocks,
                  int32_t threads, int32_t smem, cudaStream_t st) {
    const int64_t R = (G + blocks - 1) / blocks;
    if (blocks < 1 || threads < 32 || threads > kClusterThreads
        || threads % 32 || smem < shared_smem_bytes(R, n_hist, threads))
        return static_cast<int>(cudaErrorInvalidValue);
    shared_kernel<<<static_cast<unsigned>(blocks), threads, smem, st>>>(
        values, seg, buckets, valid, B, G, n_hist, out);
    return static_cast<int>(cudaGetLastError());
}

int launch_cluster(const float* values, const int32_t* seg,
                   const int32_t* buckets, const uint8_t* valid, int64_t B,
                   int64_t G, int32_t n_hist, int32_t* out, int32_t cluster,
                   int32_t threads, int32_t smem, cudaStream_t st) {
    const int64_t R = (G + cluster - 1) / cluster;
    if (cluster > kMaxCluster || threads < 32 || threads > kClusterThreads
        || threads % 32 || smem < cluster_smem_bytes(R, n_hist))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(cluster, threads, smem, st, &attr);
    return static_cast<int>(cudaLaunchKernelEx(&cfg, cluster_kernel, values,
                                               seg, buckets, valid, B, G,
                                               n_hist, out));
}

int launch_cluster_global(const float* values, const int32_t* seg,
                          const int32_t* buckets, const uint8_t* valid,
                          int64_t B, int64_t G, int32_t n_hist, int32_t* out,
                          int32_t cluster, int32_t threads, cudaStream_t st) {
    if (cluster < 1 || cluster > kMaxCluster || threads < 32
        || threads > kClusterThreads || threads % 32)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(cluster, threads, 0, st, &attr);
    return static_cast<int>(cudaLaunchKernelEx(&cfg, cluster_global_kernel,
                                               values, seg, buckets, valid,
                                               B, G, n_hist, out));
}


}  // namespace

extern "C" {

int probe_k6_prepare(void) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&optin,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   dev);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(cluster_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(shared_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(cluster_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(cluster_global_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
    return static_cast<int>(e);
}

// One reduce by a form: tier 1 shared, 2 cluster, 3 cluster_global, at
// `blocks` blocks (the cluster's size for 2 and 3).
int probe_k6_form(int32_t tier, const float* values, const int32_t* seg,
                  const int32_t* buckets, const uint8_t* valid, int64_t B,
                  int64_t G, int32_t n_hist, int32_t* out, int32_t blocks,
                  int32_t threads, int32_t smem, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (tier == 1)
        return launch_shared(values, seg, buckets, valid, B, G, n_hist, out,
                             blocks, threads, smem, st);
    if (tier == 2)
        return launch_cluster(values, seg, buckets, valid, B, G, n_hist, out,
                              blocks, threads, smem, st);
    if (tier == 3)
        return launch_cluster_global(values, seg, buckets, valid, B, G,
                                     n_hist, out, blocks, threads, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Clusters of the cluster form (`smem` a block) the card holds at once.
int probe_k6_active_clusters(int32_t cluster, int32_t threads, int32_t smem) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(cluster, threads, smem, nullptr,
                                            &attr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, cluster_kernel, &cfg)
        != cudaSuccess) {
        cudaGetLastError();
        return -1;
    }
    return n;
}

#ifdef K6_STAMPS
int probe_stamps(void* dst, size_t n) {
    return (int)cudaMemcpyFromSymbol(dst, g_stamp, n);
}
#endif

}  // extern "C"
"""

#: the forms' codes in ``probe_k6_form``
K6_FORM_CODES = {"shared": 1, "cluster": 2, "cluster_global": 3}
K6_THREADS = 1024             # kClusterThreads: a form's block
K6_MAX_CLUSTER = 16           # kMaxCluster; 8 is the largest portable size
K6_SMEM_MAX = 232_448         # the shared memory one H100 block may take


def cluster_smem(R: int, n_hist: int) -> int:
    """Shared-memory bytes of a block of the cluster form that owns ``R``
    segments: its last row + 1, sum, count, min and max over ``R`` rounded
    up to 4 (each section on 16 bytes), then the ``R x n_hist`` histogram,
    in 32-bit words (``cluster_smem_bytes`` in ``K6_FORMS``)."""
    Rp = -(-R // 4) * 4
    return 20 * Rp + 4 * R * n_hist


def shared_smem(R: int, n_hist: int, threads: int = K6_THREADS) -> int:
    """The shared form's block: ``cluster_smem``'s sections and a float a
    thread of scratch (``shared_smem_bytes``)."""
    return cluster_smem(R, n_hist) + 4 * threads


def owned_range(rank: int, blocks: int, G: int):
    """(first segment, segments) that block ``rank`` of ``blocks`` owns:
    ``R = ceil(G / blocks)`` each, the last ranges cut at ``G``."""
    R = -(-G // blocks)
    r0 = rank * R
    return r0, max(0, min(R, G - r0))


def form_plan(form: str, G: int, n_hist: int, blocks: int,
              smem_max: int = K6_SMEM_MAX):
    """(blocks, threads, shared-memory bytes a block) of a K6 form at
    ``blocks`` blocks, or None where its owned ranges do not fit
    ``smem_max`` (``cluster_global`` holds nothing on the chip)."""
    R = -(-G // blocks)
    smem = {"cluster": cluster_smem, "shared": shared_smem}.get(
        form, lambda R, n: 0)(R, n_hist)
    if smem > smem_max or form != "shared" and blocks > K6_MAX_CLUSTER:
        return None
    return blocks, K6_THREADS, smem


def smallest_cluster(G: int, n_hist: int, max_cluster: int = K6_MAX_CLUSTER,
                     smem_max: int = K6_SMEM_MAX):
    """The fewest blocks of the cluster form whose ranges fit, or None."""
    return next((c for c in range(1, max_cluster + 1)
                 if cluster_smem(-(-G // c), n_hist) <= smem_max), None)


def cluster_capacity(n_hist: int, max_cluster: int = K6_MAX_CLUSTER,
                     smem_max: int = K6_SMEM_MAX) -> int:
    """The largest ``G`` the cluster form holds at ``n_hist`` buckets."""
    R = smem_max // (20 + 4 * n_hist)
    while R and cluster_smem(R, n_hist) > smem_max:
        R -= 1
    return R * max_cluster


def k6_binding(lib) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    fn = lib.lct_segment_reduce
    fn.restype = ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, i64, i64, i32, vp, vp, i32, vp, vp, vp]
    lib.lct_segment_reduce_prepare.restype = ctypes.c_int
    lib.lct_segment_reduce_prepare.argtypes = []
    if lib.lct_segment_reduce_prepare():
        raise SystemExit("chip_probe: K6 prepare failed")


def k6_caller(lib, n_hist: int, form=None, blocks=0):
    """A launch of K6 through ``lib``: its three-kernel entry point, or
    (``form``) one of ``K6_FORMS`` at ``blocks`` blocks."""
    import torch
    from loongcollector_tpu_torch.ops.kernels import segment_reduce_cuda as src

    def call(vals, seg, buckets, valid, G):
        B = vals.shape[0]
        out = torch.empty(src.out_words(G, n_hist), dtype=torch.int32,
                          device=vals.device)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (vals.data_ptr(), seg.data_ptr(), buckets.data_ptr(),
                valid.data_ptr())
        if form:
            b, threads, smem = form_plan(form, G, n_hist, blocks)
            rc = lib.probe_k6_form(K6_FORM_CODES[form], *ptrs, B, G, n_hist,
                                   out.data_ptr(), b, threads, smem, stream)
        else:
            last = torch.empty(G, dtype=torch.int64, device=vals.device)
            rc = lib.lct_segment_reduce(*ptrs, B, G, n_hist, out.data_ptr(),
                                        last.data_ptr(),
                                        src.init_blocks(G, n_hist), stream,
                                        None, None)
        if rc:
            raise SystemExit(f"chip_probe: K6 launch failed ({form}, {rc})")
        return out
    return call


def forms_lib(fxc, name: str, src: str, stamps: bool = False):
    """This tree's ``segment_reduce.cu`` with ``K6_FORMS`` appended (with
    ``stamps``, ``K6_STAMPS`` defined), compiled and bound."""
    text = ("#define K6_STAMPS 1\n" if stamps else "") + src + K6_FORMS
    lib, log = compile_so(fxc, name, text)
    k6_binding(lib)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.probe_k6_form.restype = ctypes.c_int
    lib.probe_k6_form.argtypes = [i32, vp, vp, vp, vp, i64, i64, i32, vp,
                                  i32, i32, i32, vp]
    lib.probe_k6_active_clusters.restype = ctypes.c_int
    lib.probe_k6_active_clusters.argtypes = [i32, i32, i32]
    lib.probe_k6_prepare.restype = ctypes.c_int
    if lib.probe_k6_prepare():
        raise SystemExit("chip_probe: preparing the K6 forms failed")
    return lib, log


def sass_atomics(so: str, kernel: str) -> list:
    """The atomic and reduction instructions of ``kernel`` in the SASS of
    the library ``so`` (``cuobjdump -sass``), counted by opcode."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode:
        return [f"cuobjdump failed: {proc.stderr[-300:]}"]
    ops, inside = {}, False
    for ln in proc.stdout.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
            continue
        m = re.search(r"\b((?:RED|ATOM|ATOMS|ATOMG)[A-Z0-9_.]*)\b", ln)
        if inside and m:
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return sorted(ops.items())


K6_FORM_SIZES = {"cluster": (2, 4, 8, 16), "shared": (8, 16, 32, 64, 128),
                 "cluster_global": (4, 8, 16)}


def k6_compare(other: str) -> int:
    """K6 built from ``other`` against this tree's, in turns, then the
    forms of ``K6_FORMS`` at each size in turns beside this tree's, and the
    stamped forms' cycles a block by phase."""
    import numpy as np
    import torch
    import chip_smoke
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    from loongcollector_tpu_torch.ops.kernels import segment_reduce as sr
    from loongcollector_tpu_torch.ops.kernels import segment_reduce_cuda as src
    print(f"chip_probe: card: {chip_smoke.nvidia_smi()}", flush=True)
    with open(other) as f:
        other_src = f.read()
    with open(src._SRC) as f:
        this_src = f.read()
    lib_o, _ = compile_so(fxc, "k6_other", other_src,
                          os.path.dirname(os.path.abspath(other)))
    k6_binding(lib_o)
    lib_t, log = forms_lib(fxc, "k6_forms", this_src)
    lib_s, _ = forms_lib(fxc, "k6_forms_stamped", this_src, stamps=True)
    print("chip_probe: k6 ptxas " + ", ".join(
        f"{k} {r.get('registers')} registers, {r.get('stack')} stack, "
        f"{r.get('spill_stores')} spills"
        for k, r in sorted(src.ptxas_report(log).items())), flush=True)
    so = os.path.join(OUT, "k6_forms.so")
    print("chip_probe: k6 SASS atomics: " + "; ".join(
        f"{k} {sass_atomics(so, k)}" for k in (
            "cluster_kernel", "shared_kernel", "cluster_global_kernel",
            "scatter_kernel")), flush=True)
    kern = sr.SegmentReduceKernel(41)
    for label, (B, G), (n_real, n_seg) in chip_smoke.K6_TIMED:
        vals, seg, buckets, valid = td.k6_batch(7, B, n_seg, 41,
                                                n_real=n_real)
        seg[n_real:] = G
        args = [torch.from_numpy(a).cuda() for a in (vals, seg, buckets,
                                                     valid)]
        want = [t.cpu().numpy() for t in kern.plain(*args, G)]
        calls = {"other": k6_caller(lib_o, 41), "this": k6_caller(lib_t, 41)}
        stamped = {}
        for form, sizes in K6_FORM_SIZES.items():
            for c in sizes:
                plan = form_plan(form, G, 41, c)
                if plan is None or form != "shared" and \
                        lib_t.probe_k6_active_clusters(c, *plan[1:]) < 1:
                    continue
                calls[f"{form}{c}"] = k6_caller(lib_t, 41, form, c)
                stamped[f"{form}{c}"] = (k6_caller(lib_s, 41, form, c), c)
        for k, fn in calls.items():
            got = [t.cpu().numpy() for t in sr.split_outputs(
                fn(*args, G), G, 41)]
            chip_smoke._k6_compare(got, want, f"K6 {k} {label}")
        b_ms, by = chip_smoke.k6_bound_ms(B, int(valid.sum()), G, 41)
        seq = list(calls)
        ms = {k: [] for k in seq}
        for k in seq + seq[::-1]:
            ms[k].append(chip_smoke.graph_ms([lambda fn=calls[k]: fn(*args,
                                                                     G)]))
        print(f"chip_probe: k6 {label} B={B} Gq={G} ({n_real} rows over "
              f"{n_seg} segments): device ms per launch in turns (there and "
              f"back): " + ", ".join(f"{k} {ms[k][0]:.5f} / {ms[k][1]:.5f}"
                                     for k in seq)
              + f"; bound {b_ms:.6f} ms ({by})", flush=True)
        if label != "path":
            continue
        lib_s.probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        for k, (fn, c) in stamped.items():
            fn(*args, G)
            torch.cuda.synchronize()
            st = stamp_phases(lib_s, 4, c, c)
            phases = {"empty values": st[:, 1] - st[:, 0],
                      "fold": st[:, 2] - st[:, 1],
                      "write-back": st[:, 3] - st[:, 2],
                      "block": st[:, 3] - st[:, 0]}
            print(f"chip_probe: k6 stamps {k} (path, {c} blocks): cycles a "
                  f"block (median / largest) " + ", ".join(
                      f"{p} {int(np.median(v))} / {int(v.max())}"
                      for p, v in phases.items()), flush=True)
    return 0


def main() -> int:
    sys.path.insert(0, REPO)
    if sys.argv[1:] == ["dispatch"]:
        return dispatch_cost()
    if sys.argv[1:2] == ["k8"] and len(sys.argv) == 3:
        return k8_compare(sys.argv[2])
    if sys.argv[1:2] == ["k3"] and len(sys.argv) == 3:
        return k3_compare(sys.argv[2])
    if sys.argv[1:2] == ["k7"] and len(sys.argv) == 3:
        return k7_compare(sys.argv[2])
    if sys.argv[1:2] == ["k5"] and len(sys.argv) == 3:
        return k5_compare(sys.argv[2])
    if sys.argv[1:2] == ["k6"] and len(sys.argv) == 3:
        return k6_compare(sys.argv[2])
    if sys.argv[1:2] == ["k2"] and len(sys.argv) == 3:
        return k2_compare(sys.argv[2])
    if sys.argv[1:2] == ["ab"] and len(sys.argv) == 3:
        return ab(sys.argv[2])
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_probe: no CUDA device")
    import chip_smoke
    from loongcollector_tpu_torch.ops.device_batch import pack_rows
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    from loongcollector_tpu_torch.ops.kernels.field_extract import \
        ExtractKernel
    from loongcollector_tpu_torch.ops.regex.program import compile_tier1
    from loongcollector_tpu_torch.testdata import gen_lines
    print(f"chip_probe: card: {chip_smoke.nvidia_smi()}", flush=True)
    with open(fxc._SRC) as f:
        src = f.read()
    kern = ExtractKernel(compile_tier1(chip_smoke.APACHE))
    prog = torch.from_numpy(kern.kernel_program.blob).cuda()
    kernel = launcher(fxc, build(fxc, "kernel", src), kern, prog)
    stamp_lib = build(fxc, "stamped", stamped(src))
    stamp_lib.probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    stamp = launcher(fxc, stamp_lib, kern, prog)
    base = gen_lines(65536, seed=5)
    for B, n_real in ((8192, 5500), (65536, 65536)):
        lines = base[:n_real]
        lens = np.array([len(x) for x in lines], np.int32)
        arena = np.frombuffer(b"".join(lines), np.uint8)
        offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
        batch = pack_rows(arena, offs, lens, 128, B)
        rows = torch.from_numpy(batch.rows).cuda()
        lengths = torch.from_numpy(batch.lengths).cuda()
        want = [t.cpu() for t in kern.plain(rows, lengths)]
        got = [t.cpu() for t in kernel(rows, lengths)[:3]]
        if not all(bool((g == w).all()) for g, w in zip(got, want)):
            raise SystemExit(f"chip_probe: kernel != plain at B={B}")
        ms = chip_smoke.graph_ms([lambda: kernel(rows, lengths)])
        threads = stamp(rows, lengths)[3]
        torch.cuda.synchronize()
        blocks = -(-B // threads)
        buf = np.zeros(65536 * STAMPS, np.int64)
        if stamp_lib.probe_stamps(buf.ctypes.data, buf.nbytes):
            raise SystemExit("chip_probe: cannot read the stamps")
        st = buf[:blocks * STAMPS].reshape(blocks, STAMPS)
        st = st[:-(-n_real // threads)]          # blocks with real rows
        phases = {"staging": st[:, 1] - st[:, 0], "walk": st[:, 2] - st[:, 1],
                  "write-back": st[:, 3] - st[:, 2], "block": st[:, 3] - st[:, 0]}
        print(f"chip_probe: B={B} L=128 ({n_real} Apache rows, {blocks} blocks "
              f"of {threads}): device ms per launch {ms:.5f}", flush=True)
        print(f"chip_probe: B={B} cycles per block (median / largest): " +
              "; ".join(f"{k} {int(np.median(v))} / {int(v.max())}"
                        for k, v in phases.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
