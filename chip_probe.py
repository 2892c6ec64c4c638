#!/usr/bin/env python3
"""Where the CUDA kernels spend their time, on one H100.

    python3 chip_probe.py            # run from the repo root
    python3 chip_probe.py dispatch   # the host cost of one plane dispatch
    python3 chip_probe.py ab OTHER/field_extract.cu   # K1 built two ways
    python3 chip_probe.py k8         # K8's epilogue and its memset, timed
    python3 chip_probe.py k2 OTHER/dfa_scan.cu   # K2/K4 against another build
    python3 chip_probe.py k7 OTHER/fused_program.cu  # K7 against another
    python3 chip_probe.py k5 OTHER/struct_index.cu   # K5 against another

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

``k7 OTHER/fused_program.cu`` builds K7 from ``OTHER`` (with its headers
beside it, e.g. the parent commit's, unpacked with ``git archive`` under
``build/``) and packs its descriptors with that checkout's own host code,
beside this tree's K7 and a form of it whose descriptor copy is one TMA
bulk copy (``TMA_COPY``); checks all three against the plain version and
times them in turns (other, this, TMA, TMA, this, other) on the
Apache-filter program's ``B=8192, L=128`` chunk (5,500 rows) and on the
delimiter filter's (the pipe log's first 512 KB).  A copy of this tree's
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


# -- K2: this tree's walk against another's ---------------------------------

def dfa_binding(lib, src: str) -> bool:
    """Binds K2's and K4's entry points of a ``dfa_scan.cu`` build by that
    source's own signature; True when it takes the first settled state
    (since the settled exit), False for the older one."""
    import re
    m = re.search(r"int lct_dfa_match\(([^)]*)\)", src)
    new = "first_settled" in m.group(1)
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    for name in ("lct_dfa_match", "lct_fused_scan"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [vp, vp, ctypes.c_int64, i32, vp, i32, vp, i32] + (
            [i32, vp, i32, i32] if new else [vp, i32, i32]) \
            + [vp, vp, vp]
    return new


def dfa_caller(dsc, lib, new: bool, kern):
    """A launch of ``kern``'s walk (K2 or K4) through ``lib``, with the
    first settled state for a build that takes it."""
    import torch
    entry = getattr(lib, dsc.ENTRY_POINTS[kern.mode])
    a = kern.arrays
    S = a.num_states

    def call(rows, lengths):
        B, L = rows.shape
        t256, accept = kern.tables(rows.device)
        threads, smem = dsc.launch_geometry(B), dsc.smem_bytes(S)
        out = torch.empty(B, dtype=torch.int32 if kern.mode == "tags"
                          else torch.uint8, device=rows.device)
        head = (rows.data_ptr(), lengths.data_ptr(), B, L, t256.data_ptr(),
                S, accept.data_ptr(), a.start)
        stream = torch.cuda.current_stream().cuda_stream
        tail = (out.data_ptr(), threads, smem, stream, None, None)
        rc = entry(*head, a.first_settled, *tail) if new \
            else entry(*head, *tail)
        if rc:
            raise SystemExit(f"chip_probe: DFA launch failed ({rc})")
        return out
    return call


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


def k2_compare(other: str) -> int:
    """K2 and K4 built from ``other`` against this tree's, in turns."""
    import numpy as np
    import chip_smoke
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda as dsc
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    from loongcollector_tpu_torch.ops.kernels.dfa_scan import (
        DFAMatchKernel, FusedScanKernel, settle_points)
    from loongcollector_tpu_torch.ops.regex.dfa import compile_dfa
    from loongcollector_tpu_torch.ops.regex.fuse import compile_fused
    print(f"chip_probe: card: {chip_smoke.nvidia_smi()}", flush=True)
    with open(other) as f:
        other_src = f.read()
    with open(dsc._SRC) as f:
        this_src = f.read()
    libs = {}
    for name, src, inc in (("other", other_src,
                            os.path.dirname(os.path.abspath(other))),
                           ("this", this_src, "")):
        lib, log = compile_so(fxc, "dfa_" + name, src, inc)
        rep = dsc.ptxas_report(log)
        print(f"chip_probe: dfa_{name}: ptxas " + ", ".join(
            f"{k} {r.get('registers')} registers, {r.get('stack')} stack, "
            f"{r.get('spill_stores')} spills"
            for k, r in sorted(rep.items())), flush=True)
        libs[name] = (lib, dfa_binding(lib, src))
    java = td.gen_java_log(chip_smoke.MAIN_PATH_LINES, seed=13)
    msgs = [r["message"].encode()
            for r in td.java_oracle(td.java_records(java, td.JAVA_CONTINUE))
            if "message" in r]
    k2 = DFAMatchKernel(compile_dfa(td.JAVA_FILTER))
    k4 = FusedScanKernel(compile_fused([td.JAVA_START, td.JAVA_CONTINUE]))
    points = [("K2 path", k2, chip_smoke.path_rows(msgs, 2048, 4096),
               2048, 4096),
              ("K2 adversarial", k2, chip_smoke.adversarial_rows(2048, 4096),
               2048, 4096),
              ("K2 bench", k2, chip_smoke.bench_rows(msgs, 8192, 128),
               8192, 128),
              ("K2 bench", k2, chip_smoke.bench_rows(msgs, 65536, 128),
               65536, 128),
              ("K4 path", k4, chip_smoke.path_rows(java, 8192, 256),
               8192, 256)]
    for tag, kern, lines, B, L in points:
        batch, rows, lengths = dfa_batch(lines, B, L)
        calls = {k: dfa_caller(dsc, lib, new, kern)
                 for k, (lib, new) in libs.items()}
        want = kern.plain(rows, lengths).cpu().numpy()
        for k, fn in calls.items():
            got = kern._epilogue(fn(rows, lengths)).cpu().numpy()
            if not (got == want).all():
                raise SystemExit(f"chip_probe: {tag} {k} != plain at "
                                 f"B={B} L={L}")
        turns = [(k, chip_smoke.graph_ms([lambda fn=calls[k]: fn(rows,
                                                                 lengths)]))
                 for k in ("other", "this", "this", "other")]
        walked = int(settle_points(kern.arrays, batch.rows,
                                   batch.lengths).sum())
        out_b = 1 if kern.mode == "match" else 4
        S = kern.arrays.num_states
        b_ms, _ = chip_smoke.dfa_bound_ms(B, S, walked, out_b)
        b_len, _ = chip_smoke.dfa_bound_ms(B, S, int(batch.lengths.sum()),
                                           out_b)
        print(f"chip_probe: k2 {tag} B={B} L={L} ("
              f"{int(batch.lengths.sum())} row bytes, {walked} to the "
              f"settle points): device ms per launch in turns: "
              + ", ".join(f"{k} {ms:.5f}" for k, ms in turns)
              + f"; bound {b_ms:.6f} ms (settle points), {b_len:.6f} ms "
              f"(lengths)", flush=True)
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
            ("this_stamped", k7_stamped(src), "")):
        libs[name], logs[name] = compile_so(fxc, "k7_" + name, text, inc)
        bind_k7(libs[name])
    for name in ("other", "this", "this_tma"):
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
        geoms = {k: (ofpc if k == "other" else fpc).launch_geometry(B, L, d)
                 for k, d in descs.items()}
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
        order = ("other", "this", "this_tma", "this_tma", "this", "other")
        turns = [(k, chip_smoke.graph_ms([calls[k]])) for k in order]
        threads = geoms["this"][0]
        print(f"chip_probe: k7 {tag} B={B} L={L} ({len(lines)} rows, "
              f"{-(-B // threads)} blocks of {threads}; descriptor "
              f"{descs['other'].shared_words} / {descs['this'].shared_words} "
              f"shared words other / this): device ms per launch in turns: "
              + ", ".join(f"{k} {ms:.5f}" for k, ms in turns), flush=True)
        # stamps of one launch only: clock64 is an SM's own counter, so a
        # stamp left by another launch does not compare with this one's
        if libs["this_stamped"].probe_clear():
            raise SystemExit("chip_probe: cannot clear the stamps")
        calls["this_stamped"]()
        torch.cuda.synchronize()
        blocks = -(-B // threads)
        st = stamp_phases(libs["this_stamped"], K7_STAMPS, blocks,
                          -(-len(lines) // threads))
        phases = {"staging": st[:, 1] - st[:, 0],
                  "rows staged": st[:, 6] - st[:, 0],
                  "descriptor wait": st[:, 1] - st[:, 6],
                  "extract walk": st[:, 2] - st[:, 1],
                  "write caps": st[:, 3] - st[:, 2],
                  "keep": st[:, 4] - st[:, 3], "exit": st[:, 5] - st[:, 4],
                  "block": st[:, 5] - st[:, 0]}
        # the keep's first condition, and its second where thread 0's row
        # reached it
        two = (st[:, 9] > 0) & (st[:, 10] > 0)
        phases.update({"keep: first record": st[:, 7] - st[:, 3],
                       "keep: first condition": st[:, 8] - st[:, 7]})
        if two.any():
            phases.update({"keep: second record": (st[:, 9] - st[:, 8])[two],
                           "keep: second condition":
                               (st[:, 10] - st[:, 9])[two]})
        print(f"chip_probe: k7 {tag} cycles per block (median / largest, "
              f"{len(st)} blocks with real rows): "
              + "; ".join(f"{k} {int(np.median(v))} / {int(v.max())}"
                          for k, v in phases.items()), flush=True)
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


def main() -> int:
    sys.path.insert(0, REPO)
    if sys.argv[1:] == ["dispatch"]:
        return dispatch_cost()
    if sys.argv[1:] == ["k8"]:
        return k8_split()
    if sys.argv[1:2] == ["k7"] and len(sys.argv) == 3:
        return k7_compare(sys.argv[2])
    if sys.argv[1:2] == ["k5"] and len(sys.argv) == 3:
        return k5_compare(sys.argv[2])
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
