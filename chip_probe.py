#!/usr/bin/env python3
"""Where the CUDA field-extraction kernel spends its time, on one H100.

    python3 chip_probe.py            # run from the repo root
    python3 chip_probe.py dispatch   # the host cost of one plane dispatch
    python3 chip_probe.py ab OTHER/field_extract.cu   # K1 built two ways
    python3 chip_probe.py k8         # K8's epilogue and its memset, timed

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

``k8`` splits what K8 (``lct_sharded_extract_*``, K1's walk with the count
epilogue) costs over K1: it builds this tree's source and ``nomemset``, a
copy whose launcher skips the ``cudaMemsetAsync`` that zeroes the counts
(its counts then accumulate; its ok, cap_off and cap_len stay K1's), checks
K8's outputs bit-exact with K1's, and times K1, K8 and K8 without the
memset in turns (K1, K8, nomemset, nomemset, K8, K1) at phase 4's shapes.
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
    src = edit(src, "\n  if constexpr (STATS) {\n    // the whole warp",
               "\n  STAMP(3);\n  if constexpr (STATS) {\n    // the whole "
               "warp")
    return edit(src, 'extern "C" {\n', 'extern "C" {\n'
                "int probe_stamps(void* dst, size_t n) {\n"
                "  return (int)cudaMemcpyFromSymbol(dst, g_stamp, n);\n}\n")


def build(fxc, name: str, src: str, include: str = ""):
    """``src`` compiled into ``build/probe/<name>.so``; ``include`` is the
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
    report = fxc.ptxas_report(proc.stdout + proc.stderr)
    print(f"chip_probe: {name}: ptxas d0_p0 {report.get('d0_p0')}; "
          f"registers " + ", ".join(
              f"{k} {r.get('registers')}" for k, r in sorted(report.items())
              if k in ("d0_p0", "d0_p1", "d0_p2", "d1_p0", "d1_p1",
                       "d1_p2")), flush=True)
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    for entry in fxc.ENTRY_POINTS:
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [vp, vp, ctypes.c_int64, i32, vp, i32, vp, vp, vp, i32,
                       i32, vp]
    for entry in fxc.STATS_ENTRY_POINTS:
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [vp, vp, ctypes.c_int64, i32, vp, i32, vp, vp, vp, vp,
                       i32, i32, vp]
    return lib


def launcher(fxc, lib, kern, prog, stats: bool = False):
    """K1's entry point of ``lib`` for ``kern``'s program, or with
    ``stats`` K8's (its counts then come back as a fifth output)."""
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
        if stats:
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


def k8_split() -> int:
    """K1, K8 and K8 without its memset, timed in turns."""
    import torch
    import chip_smoke
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    from loongcollector_tpu_torch.ops.kernels.field_extract import \
        ExtractKernel
    from loongcollector_tpu_torch.ops.regex.program import compile_tier1
    print(f"chip_probe: card: {chip_smoke.nvidia_smi()}", flush=True)
    kern = ExtractKernel(compile_tier1(chip_smoke.APACHE))
    prog = torch.from_numpy(kern.kernel_program.blob).cuda()
    with open(fxc._SRC) as f:
        src = f.read()
    nomemset = edit(src, "  if constexpr (STATS) {\n    cudaError_t z",
                    "  if constexpr (false) {\n    cudaError_t z")
    lib, lib_nm = build(fxc, "k8", src), build(fxc, "nomemset", nomemset)
    calls = {"K1": launcher(fxc, lib, kern, prog),
             "K8": launcher(fxc, lib, kern, prog, stats=True),
             "nomemset": launcher(fxc, lib_nm, kern, prog, stats=True)}
    for B, n_real, rows, lengths in apache_batches():
        outs = {k: [t.cpu() for t in fn(rows, lengths)[:3]]
                for k, fn in calls.items()}
        if not all(bool((a == b).all()) for k in ("K8", "nomemset")
                   for a, b in zip(outs["K1"], outs[k])):
            raise SystemExit(f"chip_probe: K8 differs from K1 at B={B}")
        turns = [(k, chip_smoke.graph_ms([lambda fn=calls[k]: fn(rows,
                                                                 lengths)]))
                 for k in ("K1", "K8", "nomemset", "nomemset", "K8", "K1")]
        print(f"chip_probe: k8 B={B} L=128 ({n_real} Apache rows): device "
              f"ms per launch in turns: " + ", ".join(
                  f"{k} {ms:.5f}" for k, ms in turns), flush=True)
    return 0


def main() -> int:
    sys.path.insert(0, REPO)
    if sys.argv[1:] == ["dispatch"]:
        return dispatch_cost()
    if sys.argv[1:] == ["k8"]:
        return k8_split()
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
