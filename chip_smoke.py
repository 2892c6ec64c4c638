#!/usr/bin/env python3
"""On-card smoke check of loongcollector_tpu_torch (one NVIDIA H100).

    python3 chip_smoke.py            # run from the repo root

Phases, each of which exits non-zero on failure:

1. build: compile the CUDA field-extraction kernel from
   ``loongcollector_tpu_torch/ops/kernels/csrc/`` (into ``build/kernels/``,
   keyed on the source hash) and the repo's native host library; print the
   build seconds, ptxas's registers, stack frame and spills for each kernel
   instantiation, the torch version and the card's name and power limit.
   Fails if the depth-0, pivot-free instantiation (the Apache program's)
   has a stack frame or spills.
2. parity: the kernel against its plain PyTorch version, on the card, on
   the test patterns, a seeded generative set (double pivots included), the
   Apache pattern, and a depth-8 nested pattern and a 32-capture pattern on
   rows of up to 2048 and 4096 bytes (the largest shared-memory blocks), at
   every length bucket, with rows exactly L bytes long, empty rows and
   padding rows.  Bit-exact on (ok, cap_off, cap_len), and both agree with
   a ``re.fullmatch`` oracle.  Every kernel instantiation must launch, as
   ``field_extract_cuda.launch()`` records its launches.
3. main path: a seeded 600,000-line Apache access log runs through
   ``python -m loongcollector_tpu_torch --config DIR --once`` on the card
   (``example_config/quick_start/file_regex_apache.yaml`` with FilePaths
   pointed at the log and a flusher_file sink): the input pushes into the
   bounded process queue, the processor runner's workers dispatch through
   the device plane.  It runs twice, at the default one worker and at
   ``LOONG_PROCESS_THREADS=4``.  Each time every record must equal the
   ``re`` oracle's fields in file order, the kernel's launches (counted from
   0 in that process) must equal its device batches and the plane's
   dispatches and be > 0, no row may be routed to ``re``, and the plane's
   in-flight bytes, the ring's leased slots and the memory ledger's live
   bytes must be back at 0 at exit.  Prints the end-to-end MB/s, the kernel
   seconds (the timeline's exec legs), the median of each leg, the traced
   busy share and the geometry of the launches (from ``--stats``).
4. timing: kernel, plain version and bound at the main path's geometry
   (B=8192, L=128, C=9) and at the bench geometry (B=65536, L=128); the
   kernel warm (the same inputs launch after launch) and cold (launches
   rotate over enough copies of the inputs to pass twice the 50 MB L2).
5. plane, on the real kernel: (a) ``PendingParse.dispatch`` of six chunks
   under ``torch.cuda.set_sync_debug_mode("error")``, results checked
   after; (b) 200 seeded chunks at depth 3 with two ring slots per
   geometry, every chunk bit-exact with the plain version; (c) a
   ``StallableKernel`` around the staged CUDA kernel with a budget of two
   chunks: the third submit blocks until the device is unstalled, and
   every result is then bit-exact; (d) the count of dispatches of (b)
   whose H2D ran under the previous dispatch's kernel, from the timeline
   (printed; the phase does not fail on it).

In every phase each recorded launch must be whole warps within the block
limit and the shared-memory budget, with a block for each SM once a batch
holds 32 rows an SM; the geometry in the ``kernels`` line is the one
``launch()`` passed to the kernel in this run.

The line before the last is the ``kernels`` JSON line, the last line the
``{"ok": true, "device": ...}`` object.  It imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
MAIN_PATH_LINES = 600_000   # the size of bench.py:bench_pipeline_e2e

# H100 SXM peaks from NVIDIA's data sheet (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12          # non-tensor 32-bit rate, fp32 column
L2_BYTES = 50 * 2**20

# tests/test_pallas_kernel.py PATTERNS: every op family, a pivot program
APACHE = (r'(\S+) (\S+) (\S+) \[([^\]]+)\] '
          r'"(\S+) (\S+) ([^"]*)" (\d{3}) (\d+)')
PATTERNS = [
    APACHE,
    r"(\d+)-(\w+)",
    r"(a+)(?: opt(\d+))? end",                      # optional group
    r"(cat|dog|bird) says (\S+)",                   # alternation
    r"(\d{3}) fixed",                               # counted repeat
    r"pre (.*) post",                               # pivot: ambiguous span
    r"\[([^\]]*)\] (.*)",                           # pivot with class prefix
]
# more pivot forms; their inputs come from a seed of their own, so the
# batches of the set above stay the same
MORE_PATTERNS = [
    r"(\w+) (.*?) - (.*?) end",                     # double pivot
    r"(cat|dog) (.*?) - (.*?) end",                 # nested double pivot
]
# the largest shared-memory footprints: the deepest nesting the kernel
# takes, the most captures with a pivot (two copies of the state), and
# those captures with a program blob near the budget (full_pattern)
DEEP = r"(\w+)" + r"(?:-(\w+)" * 8 + ")?" * 8 + " end"
WIDE = r"(\w+)," * 30 + r"(.*);(\d+)"


def full_pattern(rng) -> str:
    """WIDE with its first group an Alt of "x" and 18 literals of 4000
    bytes: about 74 KB of program, a 230 KB block at L=4096."""
    import numpy as np
    chars = np.frombuffer(b"abcdefgh", np.uint8)
    lits = [rng.choice(chars, 4000).tobytes().decode() for _ in range(18)]
    return "(x|" + "|".join(lits) + ")," + r"(\w+)," * 29 + r"(.*);(\d+)"
SEEDS = [
    b'1.2.3.4 - frank [10/Oct/2000:13:55:36 -0700] "GET /a HTTP/1.0" 200 23',
    b"123-abc", b"aaa opt7 end", b"aaa end", b"cat says hi",
    b"dog says x", b"421 fixed", b"pre middle bit post",
    b"[tag] rest of line", b"pre  post",
]
MORE_SEEDS = [b"ab x - y end", b"cat  -  end", b"dog a - b - c end"]

# tests/test_fuzz_generative.py grammar (copied: the port's checks may not
# import the JAX package's tests)
CLASSES = [r"\d", r"\w", r"\S", r"[a-c]", r"[^x]", r"[0-9a-f]", r"[^,;]",
           r"[A-Z]", r"."]
LITERALS = ["x", "-", ",", ";", ":", "ab", "GET", "=", "q7"]
QUANTS = ["", "+", "*", "{2}", "{1,3}", "?"]
PREFIX_FAMILIES = [["GET", "GETX"], ["WARN", "WARNING"], ["ab", "abab"],
                   ["x", "xq7"]]
PIVOT_FORMS = ["(.*?)", "(.*)", r"(\S*?)", r"([^,]*)", r"([^;]*?)"]
ALPHABET = b"abcxq7GET09f,;:=- \tXZWARNI"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def gen_pattern(rng) -> str:
    parts = []
    n = int(rng.integers(1, 7))
    pivot_budget = 2 if rng.integers(4) == 0 else 1
    pivot_kind = int(rng.integers(3))
    for _ in range(n):
        kind = rng.integers(0, 13)
        if kind == 12:
            fam = PREFIX_FAMILIES[int(rng.integers(len(PREFIX_FAMILIES)))]
            order = list(fam) if rng.integers(2) else list(reversed(fam))
            parts.append("(" + "|".join(order) + ")")
            continue
        if kind >= 10 and pivot_budget:
            pivot_budget -= 1
            parts.append(["(.*?)", "(.*)", r"(\S*?)"][pivot_kind])
            continue
        if kind < 3:
            parts.append(re.escape(LITERALS[int(rng.integers(len(LITERALS)))]))
        elif kind < 7:
            cls = CLASSES[int(rng.integers(len(CLASSES)))]
            seg = cls + QUANTS[int(rng.integers(len(QUANTS)))]
            parts.append(f"({seg})" if rng.integers(2) else seg)
        elif kind < 8:
            lit = re.escape(LITERALS[int(rng.integers(len(LITERALS)))])
            cls = CLASSES[int(rng.integers(len(CLASSES)))]
            parts.append(f"(?:{lit}{cls}+)?")
        else:
            alts = []
            for _ in range(int(rng.integers(2, 4))):
                if rng.integers(2):
                    alts.append(re.escape(
                        LITERALS[int(rng.integers(len(LITERALS)))]))
                else:
                    alts.append(CLASSES[int(rng.integers(len(CLASSES)))] + "+")
            parts.append("(" + "|".join(alts) + ")")
    return "".join(parts)


def gen_double_pivot(rng) -> str:
    pk = int(rng.integers(len(PIVOT_FORMS)))
    p1 = PIVOT_FORMS[pk]
    p2 = (PIVOT_FORMS[pk] if rng.integers(4)
          else PIVOT_FORMS[int(rng.integers(len(PIVOT_FORMS)))])
    lit = re.escape(LITERALS[int(rng.integers(len(LITERALS)))])
    pre = (re.escape(LITERALS[int(rng.integers(len(LITERALS)))])
           if rng.integers(2) else CLASSES[int(rng.integers(len(CLASSES)))] + "+")
    suf = re.escape(LITERALS[int(rng.integers(len(LITERALS)))])
    if rng.integers(2):
        suf += CLASSES[int(rng.integers(len(CLASSES)))] + "+"
    return f"{pre}{p1}{lit}{p2}{suf}"


def gen_inputs(rng, pattern: str, count: int):
    """Random byte strings + mutations toward strings that match."""
    out = []
    for _ in range(count):
        ln = int(rng.integers(0, 24))
        out.append(bytes(ALPHABET[i]
                         for i in rng.integers(0, len(ALPHABET), ln)))
    rx = re.compile(pattern.encode())
    for cand in list(out[:40]):
        if rx.fullmatch(cand):
            continue
        for _ in range(4):
            if not cand:
                break
            pos = int(rng.integers(len(cand)))
            cand = cand[:pos] + bytes([ALPHABET[int(
                rng.integers(len(ALPHABET)))]]) + cand[pos + 1:]
            if rx.fullmatch(cand):
                out.append(cand)
                break
    return out


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def time_cuda(fn, iters: int) -> float:
    """Mean ms per call over `iters` calls, CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fns, reps: int = 50, iters: int = 20,
             keep_outputs: bool = False) -> float:
    """Device ms per call: `reps` calls, taking the callables `fns` in
    turn, captured in one CUDA graph, the graph replayed `iters` times
    between CUDA events, so the host's per-call Python and launch overhead
    stays out of the figure.  With `keep_outputs` every captured call
    writes its own outputs; else one call's are freed for the next."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(graph):
        for i in range(reps):
            out = fns[i % len(fns)]()
            if keep_outputs:
                outs.append(out)
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (iters * reps)


# -- phases -----------------------------------------------------------------

def phase_build(fxc, native) -> dict:
    import torch
    t0 = time.perf_counter()
    try:
        fxc.build()
    except Exception as e:  # noqa: BLE001 — reported, then exit non-zero
        fail(f"kernel build: {e}")
    kernel_s = time.perf_counter() - t0
    ptxas = fxc.ptxas_report(fxc.build_log)
    for name, r in sorted(ptxas.items()):
        log(f"ptxas {name}: {r.get('registers')} registers, "
            f"{r.get('stack')} bytes stack frame, {r.get('spill_stores')} "
            f"bytes spill stores, {r.get('spill_loads')} bytes spill loads")
    missing = [e for e in fxc.ENTRY_POINTS
               if e.replace("lct_field_extract_", "") not in ptxas]
    if missing:
        fail(f"no ptxas report for {missing}")
    flat = ptxas["d0_p0"]
    if flat.get("stack", 1) or flat.get("spill_stores", 1) \
            or flat.get("spill_loads", 1):
        fail(f"the depth-0, pivot-free instantiation has local memory: "
             f"{flat}")
    t0 = time.perf_counter()
    if native.get_lib() is None:
        fail("native host library did not build")
    native_s = time.perf_counter() - t0
    log(f"build: kernel {kernel_s:.2f} s, native library {native_s:.2f} s; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"python {sys.version.split()[0]}")
    log(f"card: {nvidia_smi()}; {torch.cuda.get_device_name(0)}")
    return {"kernel_build_s": kernel_s, "native_build_s": native_s,
            "ptxas": ptxas}


def checked_shapes(shapes, phase: str) -> list:
    """The launches a phase recorded (``field_extract_cuda.launch_shapes``,
    or the agent's ``--stats``), as (shape, launches) pairs; fails unless
    every launch was whole warps within the block limit and shared-memory
    budget, and every batch of at least 32 rows an SM gave each SM a
    block."""
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    out = sorted(shapes.items(), key=lambda kv: (kv[0].entry_point,
                                                 kv[0].B, kv[0].L))
    for sh, n in out:
        if (sh.threads % 32 or not fxc.MIN_THREADS <= sh.threads
                <= fxc.MAX_THREADS or sh.smem > fxc.SMEM_BUDGET
                or sh.B >= 32 * fxc.NUM_SMS and sh.blocks < fxc.NUM_SMS):
            fail(f"{phase}: launch outside the card's limits: {sh}")
    if not out:
        fail(f"{phase}: no kernel launch recorded")
    return out


def check_batch(kern, pattern, lines, L, stats, misalign=False) -> None:
    """Kernel vs plain on the card, and both vs re, for one (pattern, L).
    With `misalign` the rows start one byte past a 16-byte boundary."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch.ops.device_batch import pack_rows
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines) or b"\0", np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    batch = pack_rows(arena, offs, lens, L)
    rows = torch.from_numpy(batch.rows).cuda()
    if misalign:
        buf = torch.zeros(rows.numel() + 1, dtype=torch.uint8,
                          device=rows.device)
        rows = buf[1:].view(rows.shape).copy_(rows)
    lengths = torch.from_numpy(batch.lengths).cuda()
    got = [t.cpu().numpy() for t in kern(rows, lengths)]
    torch.cuda.synchronize()
    want = [t.cpu().numpy() for t in kern.plain(rows, lengths)]
    for g, w, what in zip(got, want, ("ok", "cap_off", "cap_len")):
        if g.shape != w.shape or not (g == w).all():
            bad = np.nonzero((g != w).reshape(len(g), -1).any(axis=1))[0]
            fail(f"kernel != plain on {what} for {pattern!r} at L={L}, "
                 f"rows {bad[:5].tolist()}")
        stats["max_abs_err"] = max(stats["max_abs_err"], int(np.abs(
            g.astype(np.int64) - w.astype(np.int64)).max(initial=0)))
    ok, off, ln = got
    rx = re.compile(pattern.encode())
    for i, line in enumerate(lines):
        m = rx.fullmatch(line)
        if bool(ok[i]) != (m is not None):
            fail(f"kernel disagrees with re on {pattern!r} {line!r}")
        if m:
            for gi in range(rx.groups):
                s, e = m.span(gi + 1)
                exp = (0, -1) if s < 0 else (s, e - s)
                if s < 0 and ln[i, gi] != -1 or s >= 0 and \
                        (off[i, gi], ln[i, gi]) != exp:
                    fail(f"capture {gi} of {pattern!r} on {line!r}: kernel "
                         f"({off[i, gi]}, {ln[i, gi]}) re {exp}")
    if (ok[len(lines):]).any() and not rx.fullmatch(b""):
        fail(f"a padding row matched {pattern!r}")
    stats["checks"] += 1
    stats["rows"] += len(lines)


def exact_length_lines(rng, lines, L):
    """Rows exactly L bytes long: matching Apache lines padded in the URL,
    and random rows."""
    out = []
    for ln in lines[:8]:
        if ln.count(b" HTTP/") == 1 and len(ln) <= L:
            out.append(ln.replace(b" HTTP/", b"x" * (L - len(ln)) + b" HTTP/"))
    for _ in range(4):
        out.append(bytes(rng.integers(32, 127, L, dtype="u1")))
    return out


def wide_lines(rng, pattern: str, lo: int, hi: int, count: int):
    """Rows of the DEEP, WIDE or full_pattern pattern between lo and hi
    bytes long, most of them matching, some broken in one byte."""
    import numpy as np
    chars = np.frombuffer(b"abcXYZ0189_", np.uint8)
    word = lambda n: rng.choice(chars, n).tobytes()
    out = []
    while len(out) < count:
        n = int(rng.integers(lo, hi + 1))
        if pattern == DEEP:
            k = int(rng.integers(1, 10))
            parts = [word(max(1, (n - 3 - k) // k)) for _ in range(k)]
            line = b"-".join(parts) + b" end"
        else:
            head = b",".join(word(int(rng.integers(1, 40)))
                             for _ in range(30)) + b","
            if pattern.startswith("(x|"):
                head = b"x," + head.split(b",", 1)[1]
            tail = b";" + word(int(rng.integers(1, 6))).translate(
                bytes.maketrans(b"abcXYZ_", b"2345670"))
            mid = bytes(rng.integers(32, 127, max(0, n - len(head)
                                                  - len(tail)),
                                     dtype="u1"))
            line = head + mid + tail
        line = line[:hi]
        if rng.integers(4) == 0:
            p = int(rng.integers(len(line)))
            line = line[:p] + b" " + line[p + 1:]
        out.append(line)
    return out


def phase_parity() -> dict:
    import numpy as np
    from loongcollector_tpu_torch.ops.device_batch import (LENGTH_BUCKETS,
                                                            pick_length_bucket)
    from loongcollector_tpu_torch.ops.kernels.field_extract import \
        ExtractKernel
    from loongcollector_tpu_torch.ops.regex.program import (Tier1Unsupported,
                                                            compile_tier1)
    from loongcollector_tpu_torch.testdata import gen_lines
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    stats = {"checks": 0, "rows": 0, "max_abs_err": 0, "patterns": 0}
    rng = np.random.default_rng(20240607)
    cases = []
    for pat in PATTERNS:
        noise = [bytes(rng.integers(32, 127, int(rng.integers(0, 40)),
                                    dtype="u1")) for _ in range(40)]
        extra = gen_lines(64, seed=3) if pat == APACHE else []
        cases.append((pat, SEEDS + noise + extra))
    n_gen, n_dp = 40, 16
    while n_gen:
        pat = gen_pattern(rng)
        try:
            compile_tier1(pat)
        except (Tier1Unsupported, re.error):
            continue
        n_gen -= 1
        cases.append((pat, gen_inputs(rng, pat, 120)))
    while n_dp:
        pat = gen_double_pivot(rng)
        try:
            prog = compile_tier1(pat)
        except (Tier1Unsupported, re.error):
            continue
        if prog.pivot2 is None:
            continue
        n_dp -= 1
        cases.append((pat, gen_inputs(rng, pat, 100)))
    more = np.random.default_rng(20261017)
    for pat in MORE_PATTERNS:
        noise = [bytes(more.integers(32, 127, int(more.integers(0, 40)),
                                     dtype="u1")) for _ in range(40)]
        cases.append((pat, SEEDS + MORE_SEEDS + noise))
    for pat in (DEEP, WIDE, full_pattern(more)):
        # rows that fit L=2048 (run at 2048 and 4096), then rows that only
        # fit L=4096
        cases.append((pat, SEEDS + wide_lines(more, pat, 1025, 2048, 48)))
        cases.append((pat, wide_lines(more, pat, 2049, 4096, 48)))
    fxc.reset_launch_shapes()
    for pat, lines in cases:
        kern = ExtractKernel(compile_tier1(pat))
        stats["patterns"] += 1
        lines = list(lines) + [b"", b""]
        need = pick_length_bucket(max(len(x) for x in lines))
        for L in (L for L in LENGTH_BUCKETS if L >= need):
            check_batch(kern, pat, lines + exact_length_lines(rng, lines, L),
                        L, stats)
    # a width that is not a multiple of 16 bytes, and rows that do not
    # start on a 16-byte boundary, take the kernel's byte-copy staging
    odd = [x for x in gen_lines(300, seed=7) if len(x) <= 100] + [b""]
    kern = ExtractKernel(compile_tier1(APACHE))
    check_batch(kern, APACHE, odd, 100, stats)
    check_batch(kern, APACHE, odd, 128, stats, misalign=True)
    log(f"parity: {stats['checks']} (pattern, L) batches over "
        f"{stats['patterns']} patterns, {stats['rows']} rows: kernel "
        f"bit-exact with the plain version and with re")
    shapes = checked_shapes(dict(fxc.launch_shapes), "parity")
    if sum(n for _, n in shapes) != stats["checks"]:
        fail(f"parity: {sum(n for _, n in shapes)} launches recorded for "
             f"{stats['checks']} batches")
    by_entry = {}
    for sh, n in shapes:
        by_entry[sh.entry_point] = by_entry.get(sh.entry_point, 0) + n
    log(f"parity: launches by instantiation (as launched) {by_entry}")
    idle = [e for e in fxc.ENTRY_POINTS if e not in by_entry]
    if idle:
        fail(f"instantiations never launched in parity: {idle}")
    big = max((sh for sh, _ in shapes), key=lambda sh: sh.smem)
    log(f"parity: largest block launched {big.threads} threads, {big.smem} "
        f"bytes of shared memory ({big.entry_point}, B={big.B}, L={big.L})")
    stats["largest_smem"] = big.smem
    return stats


def write_config(tmp: str, log_path: str, out_path: str) -> str:
    try:
        import yaml
    except ImportError:
        fail("PyYAML is needed to load file_regex_apache.yaml")
    src = os.path.join(REPO, "example_config", "quick_start",
                       "file_regex_apache.yaml")
    with open(src) as f:
        text = f.read()
    text = text.replace("/tmp/loongcollector_demo/access.log", log_path)
    text = text.replace("  - Type: flusher_stdout",
                        f"  - Type: flusher_file\n    FilePath: {out_path}")
    cfg = yaml.safe_load(text)
    if (cfg["inputs"][0]["FilePaths"] != [log_path]
            or cfg["flushers"] != [{"Type": "flusher_file",
                                    "FilePath": out_path}]):
        fail("could not rewrite file_regex_apache.yaml")
    cfg_dir = os.path.join(tmp, "config")
    os.makedirs(cfg_dir)
    with open(os.path.join(cfg_dir, "file_regex_apache.yaml"), "w") as f:
        f.write(text)
    return cfg_dir


def main_path_log():
    """The seeded main-path log, written once for both runs."""
    from loongcollector_tpu_torch.testdata import gen_lines
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    log_path = os.path.join(tmp, "access.log")
    t0 = time.perf_counter()
    lines = gen_lines(MAIN_PATH_LINES, seed=11)
    data = b"\n".join(lines) + b"\n"
    with open(log_path, "wb") as f:
        f.write(data)
    log(f"main path: {len(lines)} lines, {len(data)} bytes written in "
        f"{time.perf_counter() - t0:.1f} s")
    return tmp, log_path, lines, len(data)


def phase_main_path(tmp: str, log_path: str, lines, n_bytes: int,
                    threads: int) -> dict:
    from loongcollector_tpu_torch.ops.xprof import LEGS
    from loongcollector_tpu_torch.testdata import APACHE_KEYS
    run_dir = os.path.join(tmp, f"threads{threads}")
    os.makedirs(run_dir)
    out_path = os.path.join(run_dir, "out.json")
    stats_path = os.path.join(run_dir, "stats.json")
    cfg_dir = write_config(run_dir, log_path, out_path)
    tag = f"main path, {threads} worker{'s' if threads > 1 else ''}"
    env = dict(os.environ, LOONG_PROCESS_THREADS=str(threads))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "loongcollector_tpu_torch", "--config",
         cfg_dir, "--once", "--stats", stats_path],
        cwd=REPO, capture_output=True, text=True, timeout=900, env=env)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{tag}: agent exited {proc.returncode}:\n"
             f"{proc.stderr[-4000:]}")
    with open(stats_path) as f:
        st = json.load(f)
    if st["device"] != "cuda":
        fail(f"{tag}: agent ran on {st['device']}")
    if st["threads"] != threads:
        fail(f"{tag}: the agent ran {st['threads']} workers")
    rx = re.compile(APACHE.encode())
    n = 0
    with open(out_path, "rb") as f:
        for n, rec in enumerate(f, 1):
            if n > len(lines):
                fail("more records than lines")
            obj = json.loads(rec)
            m = rx.fullmatch(lines[n - 1])
            want = {k: v.decode() for k, v in zip(APACHE_KEYS, m.groups())}
            got = {k: obj.get(k) for k in APACHE_KEYS}
            if got != want:
                fail(f"record {n}: {got} != re {want}")
    if n != len(lines):
        fail(f"{tag}: {n} records for {len(lines)} lines")
    plane, ring = st["plane"], st["ring"]
    if not 0 < st["launches"] == st["device_batches"] == plane["dispatches"]:
        fail(f"{tag}: launches {st['launches']} vs device batches "
             f"{st['device_batches']} vs plane dispatches "
             f"{plane['dispatches']}")
    if st["re_oversize_rows"] or st["re_tier_rows"]:
        fail(f"{tag}: rows routed to re: {st}")
    if plane["inflight_bytes"] or ring["leased"] \
            or st["device_memory"]["total_live_bytes"] \
            or ring["leases"] != ring["returns"]:
        fail(f"{tag}: the plane did not settle: in flight "
             f"{plane['inflight_bytes']} bytes, ring {ring}, memory "
             f"{st['device_memory']}")
    legs = st["timeline"]["legs"]
    if legs.get("exec", {}).get("count") != st["launches"] \
            or legs["exec"]["clock"] != "device":
        fail(f"{tag}: the timeline has no device exec leg for every "
             f"launch: {legs}")
    from loongcollector_tpu_torch.ops.kernels.field_extract_cuda import \
        LaunchShape
    shapes = checked_shapes({LaunchShape(**{k: v for k, v in d.items()
                                            if k != "launches"}):
                             d["launches"] for d in st["launch_shapes"]},
                            tag)
    if sum(n for _, n in shapes) != st["launches"]:
        fail(f"{tag}: launch shapes {st['launch_shapes']} do not add up "
             f"to {st['launches']} launches")
    if not any(sh.B == 8192 for sh, _ in shapes):
        fail(f"{tag}: no launch at B=8192: {st['launch_shapes']}")
    for sh, k in shapes:
        log(f"{tag}: {k} launches of {sh.entry_point} at B={sh.B} "
            f"L={sh.L}: {sh.blocks} blocks of {sh.threads} threads, "
            f"{sh.smem} bytes of shared memory")
    mbps = n_bytes / st["seconds"] / 1e6
    log(f"{tag}: {n} records equal the re oracle in order; "
        f"{st['launches']} launches = {st['device_batches']} device "
        f"batches = {plane['dispatches']} plane dispatches; pipeline "
        f"{st['seconds']:.3f} s = {mbps:.2f} MB/s end to end (agent "
        f"process {wall:.1f} s); kernel {st['kernel_seconds']:.6f} s "
        f"(exec legs)")
    log(f"{tag}: stage seconds (host): " + json.dumps(st["stage_seconds"]))
    log(f"{tag}: legs (median ms / sum s / count): " + ", ".join(
        f"{leg} {legs[leg]['median_s'] * 1e3:.4f} / {legs[leg]['sum_s']:.4f}"
        f" / {legs[leg]['count']} ({legs[leg]['clock']})"
        for leg in LEGS if leg in legs))
    log(f"{tag}: traced device busy share (union of exec legs / pipeline "
        f"s): {st['busy_share']:.6f}; overlapped dispatches "
        f"{st['timeline']['overlapped_dispatches']}; peak in flight "
        f"{plane['peak_inflight_bytes']} bytes, budget waits "
        f"{plane['budget_waits']}; ring {ring['leases']} leases, "
        f"{ring['returns']} returns; depth {st['depth']}; tuner "
        f"{json.dumps(st['tuner']['buckets'])}")
    os.unlink(out_path)
    return {"stats": st, "mbps": mbps, "wall_s": wall, "shapes": shapes}


def bound_ms(B: int, C: int, prog_words: int, row_bytes: int):
    """Least time for the work: bytes moved at HBM rate vs one 32-bit op per
    examined row byte at the non-tensor rate; returns (ms, bound_by).  The
    function reads only the bytes below each row's length (`row_bytes`, the
    sum of the lengths), plus the lengths and the program, and writes
    ok/cap_off/cap_len for all B rows."""
    moved = row_bytes + 4 * B + 4 * prog_words + B * (8 * C + 1)
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = row_bytes / INT_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def phase_timing() -> dict:
    import numpy as np
    import torch
    from loongcollector_tpu_torch.ops.device_batch import pack_rows
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    from loongcollector_tpu_torch.ops.kernels.field_extract import \
        ExtractKernel
    from loongcollector_tpu_torch.ops.regex.program import compile_tier1
    from loongcollector_tpu_torch.testdata import gen_lines
    kern = ExtractKernel(compile_tier1(APACHE))
    prog_words = len(kern.kernel_program.blob)
    out = {}
    base = gen_lines(65536, seed=5)
    for B, n_real in ((8192, 5500), (65536, 65536)):
        lines = base[:n_real]
        lens = np.array([len(x) for x in lines], np.int32)
        arena = np.frombuffer(b"".join(lines), np.uint8)
        offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
        batch = pack_rows(arena, offs, lens, 128, B)
        rows = torch.from_numpy(batch.rows).cuda()
        lengths = torch.from_numpy(batch.lengths).cuda()
        fxc.reset_launch_shapes()
        got = [t.cpu().numpy() for t in kern(rows, lengths)]
        want = [t.cpu().numpy() for t in kern.plain(rows, lengths)]
        if not all((g == w).all() for g, w in zip(got, want)):
            fail(f"kernel != plain at B={B}")
        if not got[0][:n_real].all():
            fail(f"Apache rows failed to match at B={B}")
        call_ms = time_cuda(lambda: kern(rows, lengths), 200)
        ms = graph_ms([lambda: kern(rows, lengths)])
        # cold: every launch reads its own copy, and the other copies'
        # traffic (inputs and outputs) between two uses passes 2x the L2
        touched = int(lens.sum()) + 4 * B + B * (8 * 9 + 1)
        n_copies = max(8, -(-2 * L2_BYTES // touched))
        copies = [(rows.clone(), lengths.clone()) for _ in range(n_copies)]
        cold_ms = graph_ms([lambda r=r, n=n: kern(r, n) for r, n in copies],
                           reps=n_copies * -(-50 // n_copies), iters=5,
                           keep_outputs=True)
        del copies
        plain_ms = time_cuda(lambda: kern.plain(rows, lengths), 20)
        b_ms, by = bound_ms(B, 9, prog_words, int(lens.sum()))
        mbps = int(lens.sum()) / (ms * 1e-3) / 1e6
        shapes = checked_shapes(dict(fxc.launch_shapes), f"timing B={B}")
        if len(shapes) != 1:
            fail(f"timing B={B}: launches of more than one shape: {shapes}")
        sh = shapes[0][0]
        out[B] = {"ms": ms, "cold_ms": cold_ms, "call_ms": call_ms,
                  "parse_mbps": mbps, "plain_ms": plain_ms,
                  "bound_ms": b_ms, "bound_by": by, "real_rows": n_real,
                  "blocks": sh.blocks, "threads": sh.threads,
                  "smem": sh.smem, "copies": n_copies}
        log(f"timing B={B} L=128 C=9 ({n_real} Apache rows; as launched: "
            f"{sh.blocks} blocks of {sh.threads} threads, {sh.smem} bytes "
            f"of shared memory): kernel {ms:.5f} ms warm and {cold_ms:.5f} "
            f"ms cold ({n_copies} copies) on the device (graph replay), "
            f"{call_ms:.4f} ms per wrapper call, plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.5f} ms ({by}); regex-parse {mbps:.1f} MB/s")
    return out


def _layout(lines):
    import numpy as np
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines), np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    return arena, offs, lens


def _same(got, want, what: str, chunk_rows: int) -> None:
    import numpy as np
    for g, w, name in zip((got.ok, got.cap_off, got.cap_len),
                          (want.ok, want.cap_off, want.cap_len),
                          ("ok", "cap_off", "cap_len")):
        if g.shape != w.shape or not (g == w).all():
            rows = np.nonzero((g != w).reshape(len(g), -1).any(axis=1))[0]
            fail(f"plane {what}: {name} differs from the plain version in "
                 f"chunks {sorted(set((rows // chunk_rows).tolist()))[:10]}")


def phase_plane() -> dict:
    """The plane on the real kernel: no hidden synchronisation in a
    dispatch, slot reuse under stress, back-pressure, overlap."""
    import threading
    import numpy as np
    import torch
    from loongcollector_tpu_torch.ops import device_stream, xprof
    from loongcollector_tpu_torch.ops.device_plane import (DevicePlane,
                                                           StallableKernel)
    from loongcollector_tpu_torch.ops.device_stream import (StagedKernel,
                                                            batch_ring)
    from loongcollector_tpu_torch.ops.regex import engine as engine_mod
    from loongcollector_tpu_torch.testdata import gen_lines
    dev = torch.device("cuda", torch.cuda.current_device())
    eng = engine_mod.RegexEngine(APACHE, dev)
    plain = engine_mod.RegexEngine(APACHE, dev)
    # the plain version on the card, through the same staged path
    plain.set_device_kernel_override(StagedKernel(plain.kernel.plain, dev))
    rng = np.random.default_rng(20261017)
    out = {}

    # (a) no hidden synchronisation between submit and result
    chunk = 8192
    engine_mod.MAX_BATCH = chunk
    lines = gen_lines(6 * chunk - 100, seed=21)
    arena, offs, lens = _layout(lines)
    n = len(lines)
    C = eng.num_caps
    pending = engine_mod.PendingParse(
        eng, arena, offs, lens, np.zeros(n, bool),
        np.zeros((n, C), np.int32), np.full((n, C), -1, np.int32),
        np.arange(0), depth=8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending.dispatch(np.arange(n))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = pending.result()
    _same(got, plain.parse_batch(arena, offs, lens), "(a)", chunk)
    if not got.ok.all():
        fail("plane (a): Apache rows failed to match")
    log(f"plane (a): PendingParse.dispatch of 6 chunks ({n} rows) ran "
        f"under set_sync_debug_mode('error') with no synchronisation; "
        f"bit-exact with the plain version")

    # (b) slot reuse: 200 chunks at depth 3, two slots per geometry; the
    # timeline is on for (d)
    chunk = 1024
    engine_mod.MAX_BATCH = chunk
    device_stream.reset_for_testing(slots_per_geometry=2)
    lines = gen_lines(200 * chunk, seed=22)
    for i in rng.choice(len(lines), 2000, replace=False):
        lines[i] = bytes(rng.integers(32, 127, int(rng.integers(0, 200)),
                                      dtype=np.uint8))
    arena, offs, lens = _layout(lines)
    want = plain.parse_batch(arena, offs, lens)
    with xprof.active(dev) as timeline:
        got = eng.parse_batch_async(arena, offs, lens, depth=3).result()
    _same(got, want, "(b)", chunk)
    ring = batch_ring().totals()
    if ring["leased"] or ring["leases"] != ring["returns"]:
        fail(f"plane (b): ring did not settle: {ring}")
    st = batch_ring().stats()
    reuses = sum(g["slot_reuses"] for g in st.values())
    log(f"plane (b): 200 chunks of {chunk} rows at depth 3 with two slots "
        f"per geometry bit-exact with the plain version; ring {ring['leases']}"
        f" leases, {reuses} slot reuses, geometries {sorted(st)}")
    out["stress_chunks"] = 200
    out["stress_reuses"] = reuses

    # (d) overlap, from the timeline of (b)
    overlapped = timeline.overlapped_dispatches()
    legs = timeline.leg_summary()
    log(f"plane (d): {overlapped} of {timeline.stats()['closed']} "
        f"dispatches had their H2D under the previous dispatch's kernel; "
        f"legs (median ms): " + ", ".join(
            f"{k} {v['median_s'] * 1e3:.4f}" for k, v in legs.items()))
    out["overlapped"] = overlapped
    out["overlap_dispatches"] = timeline.stats()["closed"]

    # (c) back-pressure: a budget of two chunks, the device stalled
    ring = batch_ring()
    slots = []
    B, L = 1024, 128
    for i in range(3):
        slot = ring.lease(B, L, pinned=True)
        sel = np.arange(i * B, (i + 1) * B)
        slot.pack(arena, offs[sel], lens[sel])
        slots.append((slot, sel))
    nbytes = B * L
    plane = DevicePlane.reset_for_testing(budget_bytes=2 * nbytes)
    stall = StallableKernel(eng._device_kernel())
    stall.stall()
    futs = [plane.submit(stall, (slots[i][0], C), nbytes) for i in range(2)]
    third = []
    t = threading.Thread(target=lambda: third.append(
        plane.submit(stall, (slots[2][0], C), nbytes)))
    t.start()
    time.sleep(0.5)
    if third:
        fail("plane (c): a third submit over the budget did not block")
    blocked_inflight = plane.inflight_bytes()
    stall.unstall()
    results = [futs[0].result(), futs[1].result()]
    t.join(10)
    if t.is_alive() or not third:
        fail("plane (c): the third submit did not proceed once unstalled")
    results.append(third[0].result())
    for (slot, sel), (k_ok, k_off, k_len) in zip(slots, results):
        w_ok, w_off, w_len = (x.cpu().numpy() for x in eng.kernel.plain(
            slot.rows.to(dev), slot.lengths.to(dev)))
        if not ((k_ok == w_ok).all() and (k_off == w_off).all()
                and (k_len == w_len).all()):
            fail("plane (c): a result after the stall differs from the "
                 "plain version")
        slot.release()
    if plane.inflight_bytes():
        fail(f"plane (c): {plane.inflight_bytes()} bytes left in flight")
    log(f"plane (c): with the device stalled and a budget of two chunks "
        f"({2 * nbytes} bytes, {blocked_inflight} in flight) the third "
        f"submit blocked until unstalled; all three results bit-exact")
    DevicePlane.reset_for_testing()
    device_stream.reset_for_testing()
    engine_mod.MAX_BATCH = 65536
    return out


def main() -> int:
    if len(sys.argv) > 1:
        fail("takes no arguments")
    if not os.path.isdir(os.path.join(REPO, "loongcollector_tpu_torch")):
        fail("run from a checkout of the repo (loongcollector_tpu_torch/ "
             "not found beside this script)")
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from loongcollector_tpu_torch import native
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    build = phase_build(fxc, native)
    parity = phase_parity()
    tmp, log_path, lines, n_bytes = main_path_log()
    main_path = phase_main_path(tmp, log_path, lines, n_bytes, threads=1)
    main_path4 = phase_main_path(tmp, log_path, lines, n_bytes, threads=4)
    os.unlink(log_path)
    timing = phase_timing()
    plane = phase_plane()
    mp = main_path["stats"]
    t8, t64 = timing[8192], timing[65536]
    kernels = {"kernels": [{
        "name": "field_extract",
        "route": "cuda",
        "source": "loongcollector_tpu_torch/ops/kernels/csrc/field_extract.cu",
        "replaces": "loongcollector_tpu/ops/kernels/field_extract_pallas.py:54",
        "parity": "bit-exact",
        "geometry": [8192, 128, 9],
        "launches": mp["launches"],
        "max_abs_err": parity["max_abs_err"],
        "ms": t8["ms"],
        "kernel_ms": t8["ms"],
        "cold_ms": t8["cold_ms"],
        "call_ms": t8["call_ms"],
        "plain_ms": t8["plain_ms"],
        "bound_ms": t8["bound_ms"],
        "bound_by": t8["bound_by"],
        # no single PyTorch call computes a segment-program match
        "library_ms": None,
        "bench_geometry": [65536, 128, 9],
        "bench_ms": t64["ms"],
        "bench_cold_ms": t64["cold_ms"],
        "bench_call_ms": t64["call_ms"],
        "parse_mbps": t8["parse_mbps"],
        "bench_parse_mbps": t64["parse_mbps"],
        "bench_plain_ms": t64["plain_ms"],
        "bench_bound_ms": t64["bound_ms"],
        "main_path_kernel_s": mp["kernel_seconds"],
        "main_path_mbps": main_path["mbps"],
        "main_path_mbps_4_workers": main_path4["mbps"],
        "main_path_busy_share": mp["busy_share"],
        "main_path_leg_median_ms": {
            k: v["median_s"] * 1e3 for k, v in mp["timeline"]["legs"].items()},
        "main_path_overlapped_dispatches":
            mp["timeline"]["overlapped_dispatches"],
        "plane_stress_chunks": plane["stress_chunks"],
        "plane_overlapped": [plane["overlapped"],
                             plane["overlap_dispatches"]],
        "build_s": build["kernel_build_s"],
        "blocks": [t8["blocks"], t64["blocks"]],
        "threads": [t8["threads"], t64["threads"]],
        "smem_bytes": [t8["smem"], t64["smem"]],
        "largest_smem_bytes": parity["largest_smem"],
        "main_path_blocks": sorted({sh.blocks for sh, _ in
                                    main_path["shapes"]}),
        "ptxas": build["ptxas"],
    }]}
    print(nvidia_smi())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
