#!/usr/bin/env python3
"""On-card smoke check of loongcollector_tpu_torch (one NVIDIA H100).

    python3 chip_smoke.py            # run from the repo root

Phases, each of which exits non-zero on failure:

1. build: compile the CUDA field-extraction kernel (K1), the DFA walk
   (K2, K3, K4), the fused stage program (K7) and the segment reduce (K6)
   from
   ``loongcollector_tpu_torch/ops/kernels/csrc/`` (into ``build/kernels/``,
   keyed on the hash of each source and the headers it includes), one nvcc
   each, started together, and the repo's native host library; print the
   build seconds, ptxas's registers, stack frame and spills for each
   kernel instantiation, the torch version and the card's name and power
   limit.  Fails if K1's depth-0, pivot-free instantiation (the Apache
   program's), a DFA walker, a K7 instantiation without the general
   walker (the Apache-filter program's is ``d0_p0``) or one of K6's three
   kernels has a stack frame or spills.
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
   ``LOONG_PROCESS_THREADS=4``, then once more at one worker with the
   event-conservation ledger on (``LOONG_LEDGER=1``; every other agent run
   has it off), whose residual must be 0; the ledger-on run's MB/s beside
   the one-worker run's is the ledger's cost.  Each time every record must
   equal the
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

6. DFA parity: K2 and K4 against their plain versions on the card,
   bit-exact, at every length bucket (rows exactly L long, empty rows,
   padding rows) and at L=100 and on misaligned rows (the byte walk), on
   the patterns and sets of the JAX package's DFA and fusion tests
   (copied), the multiline paths' own, a single DFA at 64 states and 32
   classes, a fused set of 124 states and 48 classes, and a 32-member set
   whose bit 31 is set on real rows; both agree with ``re.fullmatch``, and
   both entry points launch.
7. multiline paths on a seeded 600,000-line Java log
   (``testdata.gen_java_log``): path 1, the stock ``multiline_java.yaml``
   (K1 as the start gate and the parse), at one worker; path 2, start and
   continue patterns with an exception filter
   (``testdata.java_filter_config``: K4 classifies lines, K1 parses
   records, K2 gates messages), at one and four workers.  Each run: every
   record equals the ``re`` oracle (``testdata.java_records`` and
   ``java_oracle``) in file order, the last record from the stop-time
   drain included; K4's and K2's launches equal their device batches and
   their exec legs on the dispatch timeline, and are > 0; rows routed to
   the host equal the oracle's lines, records and messages over 4096
   bytes; the plane settles.  Prints MB/s, records, each kernel's seconds
   (its exec legs), the traced busy share and the launch geometries.
8. grok: ``grok_nginx.yaml`` as shipped on phase 3's Apache log; every
   record equals ``re`` with ``expand("%{COMMONAPACHELOG}")``'s named
   groups, and K1's launches equal its device batches.  Prints MB/s.
9. DFA at the paths' shapes, and timing: at every (B, L) that K4 and K2
   launched in phase 7's path-2 runs, a batch of that run's own rows (Java
   lines for K4, record messages for K2: consecutive rows in file order no
   longer than L, from a row over L/2, with padding rows) through the
   kernel and its plain version, bit-exact, and against ``re.fullmatch``;
   then each kernel warm and cold, its plain version and bound, at each of
   those shapes, and on the path-2 automata at B=8192 and B=65536, L=128,
   and for K2 at L=1024.  The ``kernels`` line gives K2 and K4 at the
   shape path 2 launched most.
10. K3 parity (before phase 7): ``lct_dfa_span_match`` against its plain
   version, bit-exact, and against ``re.fullmatch`` of each span cut at its
   row's length, at every length bucket, at L=100 and on misaligned rows,
   on phase 6's single automata: spans at a row's start, middle and end,
   past its length, from a negative start, absent (-1) and empty, padding
   rows.
11. K7 parity (before phase 7): each stage list of
   ``testdata.fused_stage_lists`` (THREE_STAGE; extract + extract_ok;
   match + grok's scan + the multiline terminal scan; the Apache-filter
   program; a keep stage whose tables pass the shared-memory budget at
   L=4096; a 32-member scan, bit 31; a nested program) through the kernel,
   its plain version and ``FusedProgramKernel.staged_run`` (one
   K1/K2/K3/K4 launch a stage), bit-exact on every output at every bucket,
   at L=100 and on misaligned rows; then ``FusedDispatch.dispatch()`` of
   six chunks under ``torch.cuda.set_sync_debug_mode("error")``, equal to
   the same dispatch on the CPU.
12. the Apache-filter path (after phase 8): ``testdata.apache_filter_config``
   (parse, keep 4xx/5xx, drop ``/health``) on phase 3's log at one and four
   workers: every record equals ``testdata.apache_filter_oracle`` in file
   order; K7 launches = fused dispatches = plane dispatches = groups > 0,
   standalone K1/K2/K3 launches 0; the plane settles.  Prints MB/s, K7's
   exec legs (sum, median, largest), the busy share and the geometry.
   Phase 7's path 2 runs with fusion on (the default on the card): its
   groups fuse unless they hold a record over 4096 bytes, and the groups of
   each kind must be those the log's chunks give
   (``testdata.java_groups``).
13. K7 and K3 timing: K7 on the Apache-filter program and K3 on its
   status condition over the status spans, at B=8192 and B=65536, L=128,
   warm and cold, beside the plain versions and the bounds.
14. K6 parity (after phase 11): ``lct_segment_reduce`` against its plain
   version on the card over ``testdata.k6_cases`` (B 256..65536, Gq
   16..65536, 41 buckets and 1, invalid shares 0 / 10% / 100%, a hot
   segment, +-inf and both zeros): count, min, max, last and hist exact,
   sums within rtol = atol = 1e-5 (the reference's device tolerance,
   ``scripts/agg_equivalence.py:163``: atomics add in a changing order);
   and ``SegmentReduceKernel.fold_batch`` on the card against the host
   numpy twin on the gate's device corpora (``testdata.agg_batch_corpus``)
   at 41 and 1 buckets: group ids, rows, counts and histograms exact, min,
   max and last equal to the twin's through f32, sums within tolerance.
15. the metric-rollup path (after phase 12): ``testdata.metric_rollup_config``
   (parse_json, parse_timestamp, ``aggregator_metric_rollup`` with
   ``Substrate: device``, flusher_file) on a seeded 600,000-line
   ``testdata.gen_metrics_jsonl`` corpus at one and four workers, at one
   worker with ``LOONG_AGG_SUBSTRATE=numpy``, and at one worker with the
   ledger on (residual 0, its ingest the log's reader chunks): the rows
   equal the
   script's own f64 fold of the corpus (``testdata.metrics_oracle``; keys,
   counts and histograms exact, min / max / last through f32 on the
   device runs, sums within the tolerance), and the device runs' rows
   equal the numpy run's; invalid rows are the corpus's, late rows 0, no
   parse row falls back; on the device runs K6 launches = folds = groups
   (the log's reader chunks) = K6's exec legs on the timeline and no fold
   ran on the host; on the
   numpy run no K6 launch.  Prints MB/s, rows/s, the fold's host seconds,
   K6's h2d, exec and d2h leg medians and the busy share.
16. K6 timing (last): at the path's fold shape (B=8192, 5,000 real rows
   over 1,600 segments, Gq=2048) and at B = Gq = 65536, 41 buckets, warm
   and cold (graph replay), beside the plain version graph-replayed (its
   ``index_add_`` / ``scatter_reduce_`` calls are also the library
   yardstick) and the bound ``B + 12 V + 20 Gq + 4 n_hist Gq`` bytes (V
   the batch's valid rows: K6 reads only the flag of an invalid row) at
   3.35 TB/s.
17. K6 on the path's own folds (after phase 15): each reader chunk of the
   metrics log, keyed and staged as the device substrate stages it
   (``testdata.metrics_fold_rows``, ``segment_reduce.key_fold``), through
   K6 and its plain version on the card, held as in phase 14; the folds'
   (B, Gq, n_hist) must be those the device runs of phase 15 launched,
   fold for fold.

In every phase each recorded launch must be whole warps within the block
limit and the shared-memory budget, with a block for each SM once a batch
holds 32 rows an SM; the geometry in the ``kernels`` line is the one
``launch()`` passed to the kernel in this run.

An earlier line prints the script's total seconds.  The line before the
last is the ``kernels`` JSON line (K1, K2, K4, K3, K7 and K6), the last line
the ``{"ok": true, "device": ...}`` object.  It imports nothing of JAX or of
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

def phase_build(fxc, dsc, fpc, src, native) -> dict:
    """The four kernel libraries, one nvcc each, started together."""
    import threading
    import torch
    t0 = time.perf_counter()
    errors, secs = {}, {}

    def build(name, mod):
        t = time.perf_counter()
        try:
            mod.build()
        except Exception as e:  # noqa: BLE001 — reported, then exit 1
            errors[name] = e
        secs[name] = time.perf_counter() - t
    threads = [threading.Thread(target=build, args=a)
               for a in (("field_extract", fxc), ("dfa_scan", dsc),
                         ("fused_program", fpc), ("segment_reduce", src))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail(f"kernel build: {errors}")
    kernel_s = time.perf_counter() - t0
    ptxas = fxc.ptxas_report(fxc.build_log)
    dfa_ptxas = dsc.ptxas_report(dsc.build_log)
    k7_ptxas = fpc.ptxas_report(fpc.build_log)
    k6_ptxas = src.ptxas_report(src.build_log)
    for name, r in sorted(ptxas.items()) + sorted(dfa_ptxas.items()) + [
            (f"fused_program {k}", v) for k, v in sorted(k7_ptxas.items())] \
            + [(f"segment_reduce {k}", v) for k, v in sorted(k6_ptxas.items())]:
        log(f"ptxas {name}: {r.get('registers')} registers, "
            f"{r.get('stack')} bytes stack frame, {r.get('spill_stores')} "
            f"bytes spill stores, {r.get('spill_loads')} bytes spill loads")
    missing = [e for e in fxc.ENTRY_POINTS
               if e.replace("lct_field_extract_", "") not in ptxas]
    missing += [m for m in dsc.ENTRY_POINTS if m not in dfa_ptxas]
    missing += [k for k in fpc.INSTANTIATIONS if k not in k7_ptxas]
    missing += [k for k in src.KERNELS if k not in k6_ptxas]
    if missing:
        fail(f"no ptxas report for {missing}")
    # the depth-0 walkers: K1's Apache instantiation, the DFA walks (K2,
    # K3, K4), K7's instantiations without the general walker (the Apache
    # filter program's is d0_p0), and K6's three kernels
    for name, r in [("d0_p0", ptxas["d0_p0"])] + [
            (m, dfa_ptxas[m]) for m in dsc.ENTRY_POINTS] + [
            (f"fused_program {k}", k7_ptxas[k]) for k in fpc.INSTANTIATIONS
            if not k.endswith("_g")] + [
            (f"segment_reduce {k}", k6_ptxas[k]) for k in src.KERNELS]:
        if r.get("stack", 1) or r.get("spill_stores", 1) \
                or r.get("spill_loads", 1):
            fail(f"the {name} walker has local memory: {r}")
    t0 = time.perf_counter()
    if native.get_lib() is None:
        fail("native host library did not build")
    native_s = time.perf_counter() - t0
    log(f"build: four kernels {kernel_s:.2f} s in parallel (field_extract "
        f"{secs['field_extract']:.2f} s, dfa_scan {secs['dfa_scan']:.2f} s, "
        f"fused_program {secs['fused_program']:.2f} s, segment_reduce "
        f"{secs['segment_reduce']:.2f} s), native library "
        f"{native_s:.2f} s; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; python {sys.version.split()[0]}")
    log(f"card: {nvidia_smi()}; {torch.cuda.get_device_name(0)}")
    return {"kernel_build_s": kernel_s, "native_build_s": native_s,
            "build_s": secs, "ptxas": ptxas, "dfa_ptxas": dfa_ptxas,
            "k7_ptxas": k7_ptxas, "k6_ptxas": k6_ptxas}


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
                    threads: int, ledger: bool = False) -> dict:
    from loongcollector_tpu_torch.ops.xprof import LEGS
    from loongcollector_tpu_torch.testdata import APACHE_KEYS
    run_dir = os.path.join(tmp, f"threads{threads}{'ledger' * ledger}")
    os.makedirs(run_dir)
    out_path = os.path.join(run_dir, "out.json")
    stats_path = os.path.join(run_dir, "stats.json")
    cfg_dir = write_config(run_dir, log_path, out_path)
    tag = (f"main path, {threads} worker{'s' if threads > 1 else ''}"
           f"{', ledger on' * ledger}")
    st, wall = run_agent(tag, cfg_dir, stats_path, threads, ledger)
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
    shapes = check_settled(tag, st)
    if st["re_oversize_rows"] or st["re_tier_rows"]:
        fail(f"{tag}: rows routed to re: {st}")
    legs = st["timeline"]["legs"]
    if legs.get("exec", {}).get("count") != st["launches"] \
            or legs["exec"]["clock"] != "device":
        fail(f"{tag}: the timeline has no device exec leg for every "
             f"launch: {legs}")
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


# -- the DFA tier (K2, K4) ---------------------------------------------------

# tests/test_dfa_engine.py and tests/test_fuse.py patterns and sets, copied
# (the port's checks may not import the JAX package's tests), with the
# multiline paths' own and the automata at the kernels' limits
DFA_PATTERNS = [
    r"(?:GET|POST|PUT) /\S*", r"(?:ab)+x", r"(?:GET|POST|DELETE|PUT|HEAD) .*",
    r"[a-z]+\d*(?:-[a-z0-9]+)*", r"(?:ERROR|WARN|INFO|DEBUG):.*",
    r"(?:ERROR|WARN):\d+ .*",
]
FUSED_SETS = [
    [r"\d{4}-\d{2}-\d{2} .*", r"\s+at .*", r"(\w+)=(\d+)", r"\d+", r"[a-z]+"],
    [r"\d+", r"[a-z]+", r"\d+[a-z]+", r"x.*", r"-"],
]
DFA_ALPHABET = b"GETPOSTabcz0123 :-ERRORWANIF.*/=x\tExceptionat"


def dfa_lines(rng, patterns, java, L):
    """Rows for one (automaton, L): the patterns' own words, seeded noise,
    Java lines and records (long rows), rows exactly L long, empty rows."""
    import numpy as np
    words = sorted({w for p in patterns
                    for w in re.findall(r"[A-Za-z0-9]{2,}", p)}) + [
        "2024-03-01 12:00:01 INFO x", "\tat a.B(C.java:1)", "Caused by: x",
        "GET /a", "ERROR:12 x", "abab", "k=12"]
    out = []
    for _ in range(60):
        line = words[int(rng.integers(len(words)))].encode() \
            + [b"", b"123", b" x y", b"=7", b"-ab", b"x"][int(rng.integers(6))]
        if rng.integers(4) == 0:
            i = int(rng.integers(len(line)))
            line = line[:i] + bytes([DFA_ALPHABET[int(rng.integers(
                len(DFA_ALPHABET)))]]) + line[i + 1:]
        out.append(line)
    out += [bytes(DFA_ALPHABET[i] for i in rng.integers(
        0, len(DFA_ALPHABET), int(rng.integers(0, 40)))) for _ in range(40)]
    out += java[:40]
    k = int(rng.integers(len(java) - 200))
    out += [b"\n".join(java[k:k + n]) for n in (5, 20, 60, 200)]
    out = [x[:L] for x in out]
    out += [bytes(rng.integers(32, 127, L, dtype=np.uint8)),
            (b"1" * L), (java[0] * (L // len(java[0]) + 1))[:L], b"", b""]
    return out


def check_dfa_batch(kern, patterns, lines, L, stats, misalign=False):
    """K2/K4 against its plain version on the card, bit-exact, and both
    against re.fullmatch, for one (automaton, L) batch."""
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
    got = kern(rows, lengths).cpu().numpy()
    torch.cuda.synchronize()
    want = kern.plain(rows, lengths).cpu().numpy()
    if got.shape != want.shape or got.dtype != want.dtype \
            or not (got == want).all():
        bad = np.nonzero(got != want)[0]
        fail(f"{kern.mode} kernel != plain for {patterns!r} at L={L}, "
             f"rows {bad[:5].tolist()}")
    stats["max_abs_err"] = max(stats["max_abs_err"], int(np.abs(
        got.astype(np.int64) - want.astype(np.int64)).max(initial=0)))
    rxs = [re.compile(p.encode("latin-1")) for p in patterns]
    for i, line in enumerate(lines):
        if kern.mode == "match":
            ok = rxs[0].fullmatch(line) is not None
            if bool(got[i]) != ok:
                fail(f"K2 disagrees with re on {patterns[0]!r} {line!r}")
        else:
            tags = sum(1 << b for b, r in enumerate(rxs) if r.fullmatch(line))
            if int(got.view(np.uint32)[i]) != tags:
                fail(f"K4 disagrees with re on {patterns!r} {line!r}")
    stats["checks"] += 1
    stats["rows"] += len(lines)
    if kern.mode == "tags":
        stats["bit31_rows"] += int((got.view(np.uint32)[:len(lines)]
                                    >> 31 & 1).sum())


def checked_dfa_shapes(shapes, phase: str) -> list:
    """K2/K4 launches as (shape, launches): whole warps within the block
    limit, a block for every ``threads`` rows and for each SM once a batch
    holds 32 rows an SM, the tables within 48 KB."""
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda as dsc
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    out = sorted(shapes.items(), key=lambda kv: (kv[0].entry_point,
                                                 kv[0].B, kv[0].L))
    for sh, _n in out:
        if (sh.threads % 32 or not dsc.MIN_THREADS <= sh.threads
                <= dsc.MAX_THREADS or sh.S > dsc.MAX_STATES
                or sh.smem != dsc.smem_bytes(sh.S) or sh.smem > 48 * 1024
                or sh.blocks != -(-sh.B // sh.threads)
                or sh.B >= 32 * fxc.NUM_SMS and sh.blocks < fxc.NUM_SMS):
            fail(f"{phase}: DFA launch outside the card's limits: {sh}")
    if not out:
        fail(f"{phase}: no DFA kernel launch recorded")
    return out


def phase_dfa_parity(java) -> dict:
    import numpy as np
    from loongcollector_tpu_torch.ops.device_batch import LENGTH_BUCKETS
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda as dsc
    from loongcollector_tpu_torch.ops.kernels.dfa_scan import (
        DFAMatchKernel, FusedScanKernel)
    from loongcollector_tpu_torch.ops.regex.dfa import compile_dfa
    from loongcollector_tpu_torch.ops.regex.fuse import compile_fused
    from loongcollector_tpu_torch import testdata as td
    stats = {"checks": 0, "rows": 0, "max_abs_err": 0, "bit31_rows": 0,
             "automata": []}
    rng = np.random.default_rng(20261017)
    cases = []
    for pat in DFA_PATTERNS + [td.JAVA_FILTER, td.JAVA_CONTINUE,
                               td.LIMIT_DFA]:
        dfa = compile_dfa(pat)
        cases.append((DFAMatchKernel(dfa), [pat]))
        stats["automata"].append(("K2", dfa.num_states, dfa.num_classes))
    for pats in FUSED_SETS + [[td.JAVA_START, td.JAVA_CONTINUE],
                              td.NEAR_CAP_SET, td.BIT31_SET]:
        fd = compile_fused(pats)
        if not fd.device_ok or fd.demoted:
            fail(f"fused set {pats!r} is not device_ok or demoted a member")
        cases.append((FusedScanKernel(fd), fd.patterns))
        stats["automata"].append(("K4", fd.num_states, fd.num_classes))
    if ("K2", 64, 32) not in stats["automata"] \
            or ("K4", 124, 48) not in stats["automata"]:
        fail(f"the limit automata changed: {stats['automata']}")
    dsc.reset_launch_shapes()
    for kern, pats in cases:
        extra = [p.encode() for p in td.BIT31_SET] \
            if pats == td.BIT31_SET else []
        for L in LENGTH_BUCKETS:
            check_dfa_batch(kern, pats, dfa_lines(rng, pats, java, L) + extra,
                            L, stats)
        # a width that is not a multiple of 16 and rows off a 16-byte
        # boundary take the byte-by-byte walk
        check_dfa_batch(kern, pats, dfa_lines(rng, pats, java, 100), 100,
                        stats)
        check_dfa_batch(kern, pats, dfa_lines(rng, pats, java, 128), 128,
                        stats, misalign=True)
    if not stats["bit31_rows"]:
        fail("no row set tag bit 31")
    shapes = checked_dfa_shapes(dict(dsc.launch_shapes), "dfa parity")
    if sum(n for _, n in shapes) != stats["checks"]:
        fail(f"dfa parity: {sum(n for _, n in shapes)} launches recorded "
             f"for {stats['checks']} batches")
    launched = {sh.entry_point for sh, _ in shapes}
    walks = {dsc.ENTRY_POINTS[m] for m in ("match", "tags")}
    if launched != walks:
        fail(f"DFA entry points never launched: {walks - launched}")
    log(f"dfa parity: {stats['checks']} (automaton, L) batches over "
        f"{len(cases)} automata {stats['automata']}, {stats['rows']} rows: "
        f"K2 and K4 bit-exact with their plain versions and with re; "
        f"{stats['bit31_rows']} rows with tag bit 31; entry points "
        f"launched {sorted(launched)}")
    return stats


def java_log():
    """The seeded Java log of the multiline paths, written once."""
    from loongcollector_tpu_torch.testdata import gen_java_log
    tmp = tempfile.mkdtemp(prefix="chip_smoke_java_")
    log_path = os.path.join(tmp, "app.log")
    t0 = time.perf_counter()
    lines = gen_java_log(MAIN_PATH_LINES, seed=13)
    data = b"\n".join(lines) + b"\n"
    with open(log_path, "wb") as f:
        f.write(data)
    log(f"java log: {len(lines)} lines, {len(data)} bytes written in "
        f"{time.perf_counter() - t0:.1f} s")
    return tmp, log_path, lines, len(data)


def run_agent(tag, cfg_dir, stats_path, threads, ledger=False,
              **env_vars):
    """One ``--once`` agent run on the card with ``threads`` workers; fails
    unless the run exits 0 and ran on CUDA.  With ``ledger`` the
    event-conservation ledger is on (``LOONG_LEDGER=1``) and every
    pipeline's residual must be 0; without it the ledger must be off."""
    env = dict(os.environ, LOONG_PROCESS_THREADS=str(threads), **env_vars)
    env.pop("LOONG_LEDGER", None)
    if ledger:
        env["LOONG_LEDGER"] = "1"
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
    if st["device"] != "cuda" or st["threads"] != threads:
        fail(f"{tag}: the agent ran on {st['device']} with {st['threads']} "
             f"workers")
    if not ledger:
        if st["ledger"] is not None:
            fail(f"{tag}: the ledger was on in a run without it")
        return st, wall
    res = (st["ledger"] or {}).get("residuals")
    if not res or any(res.values()):
        fail(f"{tag}: ledger residuals {res} (want 0 for every pipeline)")
    return st, wall


def check_settled(tag, st, k1=True) -> list:
    """K1's launches (> 0 unless ``k1`` is false) equal its device batches
    and, with the fused runs' K7 launches, the plane's dispatches; the
    plane, ring and memory ledger are back at 0, and the launch shapes add
    up; returns K1's shapes."""
    from loongcollector_tpu_torch.ops.kernels.field_extract_cuda import \
        LaunchShape
    plane, ring, fu = st["plane"], st["ring"], st["fusion"]
    if not (0 < st["launches"] if k1 else st["launches"] == 0) \
            or st["launches"] != st["device_batches"] \
            or plane["dispatches"] != st["device_batches"] \
            + fu["fused_dispatches"] \
            or fu["k7_launches"] != fu["fused_dispatches"]:
        fail(f"{tag}: K1 launches {st['launches']} vs device batches "
             f"{st['device_batches']}, K7 launches {fu['k7_launches']} vs "
             f"fused dispatches {fu['fused_dispatches']}, plane dispatches "
             f"{plane['dispatches']}")
    if plane["inflight_bytes"] or ring["leased"] \
            or st["device_memory"]["total_live_bytes"] \
            or ring["leases"] != ring["returns"]:
        fail(f"{tag}: the plane did not settle: in flight "
             f"{plane['inflight_bytes']} bytes, ring {ring}, memory "
             f"{st['device_memory']}")
    if not k1:
        return []
    shapes = checked_shapes({LaunchShape(**{k: v for k, v in d.items()
                                            if k != "launches"}):
                             d["launches"] for d in st["launch_shapes"]},
                            tag)
    if sum(n for _, n in shapes) != st["launches"]:
        fail(f"{tag}: K1 launch shapes do not add up to its launches")
    return shapes


def dfa_stats_line(tag, name, k) -> list:
    from loongcollector_tpu_torch.ops.kernels.dfa_scan_cuda import \
        LaunchShape
    shapes = checked_dfa_shapes(
        {LaunchShape(**{f: v for f, v in d.items() if f != "launches"}):
         d["launches"] for d in k["launch_shapes"]}, f"{tag} {name}")
    if sum(n for _, n in shapes) != k["launches"]:
        fail(f"{tag}: {name} launch shapes do not add up to its launches")
    if k["exec_legs"] != k["launches"]:
        fail(f"{tag}: {name} has {k['exec_legs']} exec legs on the timeline "
             f"for {k['launches']} launches")
    log(f"{tag}: {name} {k['launches']} launches = {k['device_batches']} "
        f"device batches = its exec legs, {k['host_rows']} host-routed rows, "
        f"kernel {k['kernel_seconds']:.6f} s (exec legs; median "
        f"{k['exec_median_s'] * 1e3:.5f} ms, largest "
        f"{k['exec_max_s'] * 1e3:.5f} ms); "
        + ", ".join(f"{n} at B={sh.B} L={sh.L} S={sh.S} ({sh.blocks} "
                    f"blocks of {sh.threads}, {sh.smem} bytes)"
                    for sh, n in shapes))
    return shapes


def check_java_fusion(tag, st, lines, path) -> dict:
    """Path 1 plans no fused run.  Path 2 plans one (the parse and the
    filter on its message): each group the reader's chunks give either
    fuses (one K7 launch) or, holding a record over 4096 bytes, runs
    per-stage; the groups of each kind are counted from the log itself
    (``testdata.java_groups``)."""
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.input.file.reader import DEFAULT_CHUNK
    fu = st["fusion"]
    if path == 1:
        if fu["runs_planned"] or fu["fused_dispatches"]:
            fail(f"{tag}: fused runs on path 1: {fu}")
        return {}
    groups = td.java_groups(lines, DEFAULT_CHUNK)
    long_groups = sum(any(len(r) > 4096 for r in g) for g in groups)
    empty = sum(not g for g in groups)
    got = (fu["runs_planned"], fu["fused_groups"], fu["long_row_groups"],
           fu["other_groups"])
    want = (1, len(groups) - long_groups - empty, long_groups, empty)
    if got != want or not fu["enabled"] == [True] \
            or fu["fused_dispatches"] != fu["fused_groups"] \
            or fu["exec_legs"] != fu["k7_launches"]:
        fail(f"{tag}: fused run (planned, fused, per-stage over 4096, "
             f"other) groups {got}, from the log {want}; {fu}")
    log(f"{tag}: fusion on: {len(groups)} groups = {fu['fused_groups']} "
        f"fused ({fu['k7_launches']} K7 launches, exec legs "
        f"{fu['kernel_seconds']:.6f} s) + {fu['long_row_groups']} per-stage "
        f"for a record over 4096 bytes, as the log's chunks give them")
    return {"groups": len(groups), "fused": fu["fused_groups"],
            "long": fu["long_row_groups"]}


def phase_multiline(tmp, log_path, lines, n_bytes, path, threads) -> dict:
    """Path 1 (the stock multiline_java.yaml) or path 2 (start+continue
    and the exception filter) on the Java log, every record against the
    re oracle in file order."""
    from loongcollector_tpu_torch import testdata as td
    tag = f"path {path}, {threads} worker{'s' if threads > 1 else ''}"
    run_dir = os.path.join(tmp, f"path{path}_threads{threads}")
    cfg_dir = os.path.join(run_dir, "config")
    os.makedirs(cfg_dir)
    out_path = os.path.join(run_dir, "out.json")
    if path == 1:
        with open(os.path.join(REPO, "example_config", "quick_start",
                               "multiline_java.yaml")) as f:
            text = f.read()
        text = text.replace("/tmp/loongcollector_demo/app.log", log_path)
        text = text.replace("  - Type: flusher_stdout",
                            f"  - Type: flusher_file\n    FilePath: "
                            f"{out_path}")
        if log_path not in text or out_path not in text:
            fail("could not rewrite multiline_java.yaml")
    else:
        text = td.java_filter_config(log_path, out_path)
    with open(os.path.join(cfg_dir, "java.yaml"), "w") as f:
        f.write(text)
    st, wall = run_agent(tag, cfg_dir, os.path.join(run_dir, "stats.json"),
                         threads)
    records = td.java_records(lines, td.JAVA_CONTINUE if path == 2 else None)
    want = td.java_oracle(records, td.JAVA_FILTER if path == 2 else None)
    keys = ("time", "level", "message", "rawLog")
    n = 0
    with open(out_path, "rb") as f:
        for n, rec in enumerate(f, 1):
            if n > len(want):
                fail(f"{tag}: more records than the oracle's {len(want)}")
            obj = json.loads(rec)
            got = {k: obj[k] for k in keys if k in obj}
            if got != want[n - 1]:
                fail(f"{tag}: record {n}: {str(got)[:300]} != re "
                     f"{str(want[n - 1])[:300]}")
    if n != len(want) or st["events"] != n:
        fail(f"{tag}: {n} records ({st['events']} events) for the oracle's "
             f"{len(want)}")
    if st["drained_groups"] != 1:
        fail(f"{tag}: {st['drained_groups']} groups from the stop-time "
             f"drain, not the file's last record")
    check_settled(tag, st)
    fusion = check_java_fusion(tag, st, lines, path)
    long_lines = sum(len(x) > 4096 for x in lines)
    long_records = sum(len(r) > 4096 for r in records)
    long_msgs = sum(len(r["message"]) > 4096
                    for r in td.java_oracle(records) if "message" in r)
    k2, k4 = st["k2"], st["k4"]
    k_shapes = {}
    if path == 1:
        if st["re_oversize_rows"] != long_lines + long_records \
                or k2["launches"] or k4["launches"]:
            fail(f"{tag}: re rows {st['re_oversize_rows']} (oracle "
                 f"{long_lines} lines + {long_records} records over 4096), "
                 f"K2 {k2['launches']}, K4 {k4['launches']} launches")
    else:
        if not 0 < k4["launches"] == k4["device_batches"] \
                or not 0 < k2["launches"] == k2["device_batches"]:
            fail(f"{tag}: K4 {k4['launches']} launches / "
                 f"{k4['device_batches']} batches, K2 {k2['launches']} / "
                 f"{k2['device_batches']}")
        if (st["re_oversize_rows"], k4["host_rows"], k2["host_rows"]) \
                != (long_records, long_lines, long_msgs):
            fail(f"{tag}: host-routed rows: K1 {st['re_oversize_rows']}, "
                 f"K4 {k4['host_rows']}, K2 {k2['host_rows']}; oracle "
                 f"{long_records} records, {long_lines} lines, {long_msgs} "
                 f"messages over 4096 bytes")
        k_shapes = {"K4": dfa_stats_line(tag, "K4", k4),
                    "K2": dfa_stats_line(tag, "K2", k2)}
    mbps = n_bytes / st["seconds"] / 1e6
    k1_s = st["kernel_seconds"] - (k2["kernel_seconds"]
                                   + k4["kernel_seconds"]
                                   + st["fusion"]["kernel_seconds"])
    log(f"{tag}: {len(lines)} lines in, {len(records)} records, {n} out, "
        f"equal to the re oracle in order (the last from the stop-time "
        f"drain); {mbps:.2f} MB/s end to end ({st['seconds']:.3f} s, agent "
        f"process {wall:.1f} s); exec legs of every kernel "
        f"{st['kernel_seconds']:.6f} s, traced busy share "
        f"{st['busy_share'] * 100:.2f}%; K1 {st['launches']} launches, "
        f"kernel {k1_s:.6f} s, {st['re_oversize_rows']}"
        f" rows on re; K1 geometry " + ", ".join(
            f"{d['launches']}x {d['entry_point']} B={d['B']} L={d['L']}"
            for d in st["launch_shapes"]))
    log(f"{tag}: stage seconds (host): " + json.dumps(st["stage_seconds"]))
    os.unlink(out_path)
    return {"stats": st, "mbps": mbps, "records": len(records), "out": n,
            "shapes": k_shapes, "fusion": fusion}


def phase_grok(tmp, log_path, lines, n_bytes) -> dict:
    """Path 3: grok_nginx.yaml as shipped on the Apache log."""
    from loongcollector_tpu_torch.ops.regex.grok import expand
    tag = "path 3 (grok)"
    run_dir = os.path.join(tmp, "grok")
    cfg_dir = os.path.join(run_dir, "config")
    os.makedirs(cfg_dir)
    out_path = os.path.join(run_dir, "out.json")
    with open(os.path.join(REPO, "example_config", "quick_start",
                           "grok_nginx.yaml")) as f:
        text = f.read()
    text = text.replace("/tmp/loongcollector_demo/nginx.log", log_path)
    text = text.replace("  - Type: flusher_stdout",
                        f"  - Type: flusher_file\n    FilePath: {out_path}")
    if log_path not in text or out_path not in text:
        fail("could not rewrite grok_nginx.yaml")
    with open(os.path.join(cfg_dir, "grok_nginx.yaml"), "w") as f:
        f.write(text)
    st, wall = run_agent(tag, cfg_dir, os.path.join(run_dir, "stats.json"), 1)
    rx = re.compile(expand("%{COMMONAPACHELOG}").encode())
    names = list(rx.groupindex)
    n = 0
    with open(out_path, "rb") as f:
        for n, rec in enumerate(f, 1):
            if n > len(lines):
                fail(f"{tag}: more records than lines")
            m = rx.fullmatch(lines[n - 1])
            obj = json.loads(rec)
            want = {k: v.decode() for k, v in m.groupdict().items()
                    if v is not None}
            got = {k: obj[k] for k in names if k in obj}
            if got != want:
                fail(f"{tag}: record {n}: {got} != re {want}")
    if n != len(lines):
        fail(f"{tag}: {n} records for {len(lines)} lines")
    check_settled(tag, st)
    if st["re_oversize_rows"] or st["re_tier_rows"]:
        fail(f"{tag}: rows routed to re")
    mbps = n_bytes / st["seconds"] / 1e6
    log(f"{tag}: {n} records equal re with the named groups of "
        f"%{{COMMONAPACHELOG}} in order; K1 {st['launches']} launches = "
        f"{st['device_batches']} device batches; {mbps:.2f} MB/s end to end "
        f"({st['seconds']:.3f} s, agent process {wall:.1f} s); kernel "
        f"{st['kernel_seconds']:.6f} s; geometry " + ", ".join(
            f"{d['launches']}x {d['entry_point']} B={d['B']} L={d['L']}"
            for d in st["launch_shapes"]))
    os.unlink(out_path)
    return {"stats": st, "mbps": mbps}


def dfa_bound_ms(B, S, row_bytes, out_bytes):
    """Least time for one DFA walk: the bytes the inputs need once (row
    bytes below each length, the lengths, the table and the per-state
    outputs) and the outputs, at the HBM rate, against one 32-bit op per
    row byte at the non-tensor rate; returns (ms, bound_by)."""
    moved = row_bytes + 4 * B + S * 256 + 4 * S + out_bytes * B
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = row_bytes / INT_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def path_rows(pool, B, L):
    """A batch like one the path launched at (B, L): consecutive rows of the
    run's own pool in file order, each no longer than L, starting at a row
    over L/2 (so the batch needs its bucket), cycled to 7/8 of B; the rest
    are padding rows."""
    fit = [x for x in pool if len(x) <= L]
    first = next(i for i, x in enumerate(fit) if len(x) > L // 2)
    n = B - B // 8
    return [fit[(first + i) % len(fit)] for i in range(n)]


def bench_rows(pool, B, L):
    """B rows of the pool within (lo, L], lo 128 for L=1024 else 0, cycled:
    the fixed bench points at L=128 and L=1024."""
    lo = 128 if L == 1024 else 0
    src = [x for x in pool if lo < len(x) <= L]
    return (src * (B // max(len(src), 1) + 1))[:B]


def phase_dfa_path_shapes(java, path2_runs) -> dict:
    """K2 and K4 at every (B, L) path 2 launched, on that run's own rows,
    against the plain version (bit-exact) and re, then warm and cold
    timing there and at the fixed bench points."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.device_batch import pack_rows
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda as dsc
    from loongcollector_tpu_torch.ops.kernels.dfa_scan import (
        DFAMatchKernel, FusedScanKernel)
    from loongcollector_tpu_torch.ops.regex.dfa import compile_dfa
    from loongcollector_tpu_torch.ops.regex.fuse import compile_fused
    fd = compile_fused([td.JAVA_START, td.JAVA_CONTINUE])
    k4 = FusedScanKernel(fd)
    k2 = DFAMatchKernel(compile_dfa(td.JAVA_FILTER))
    msgs = [r["message"].encode()
            for r in td.java_oracle(td.java_records(java, td.JAVA_CONTINUE))
            if "message" in r]
    kerns = {"K4": (k4, java, fd.patterns), "K2": (k2, msgs,
                                                    [td.JAVA_FILTER])}
    points = []
    for name in ("K4", "K2"):
        shapes = sorted({(sh.B, sh.L) for run in path2_runs
                         for sh, _ in run["shapes"][name]})
        points += [(name, B, L, "path") for B, L in shapes]
    points += [(name, B, L, "bench") for name, L in
               (("K4", 128), ("K2", 128), ("K2", 1024))
               for B in (8192, 65536)]
    out = {}
    for name, B, L, kind in points:
        kern, pool, pats = kerns[name]
        lines = (path_rows if kind == "path" else bench_rows)(pool, B, L)
        lens = np.array([len(x) for x in lines], np.int32)
        arena = np.frombuffer(b"".join(lines), np.uint8)
        offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
        batch = pack_rows(arena, offs, lens, L, B)
        rows = torch.from_numpy(batch.rows).cuda()
        lengths = torch.from_numpy(batch.lengths).cuda()
        dsc.reset_launch_shapes()
        got = kern(rows, lengths).cpu().numpy()
        want = kern.plain(rows, lengths).cpu().numpy()
        if got.dtype != want.dtype or not (got == want).all():
            bad = np.nonzero(got != want)[0]
            fail(f"{name} {kind} B={B} L={L}: kernel != plain, rows "
                 f"{bad[:5].tolist()}")
        rxs = [re.compile(p.encode()) for p in pats]
        for i, line in enumerate(lines):
            if name == "K2":
                ok = bool(got[i]) == (rxs[0].fullmatch(line) is not None)
            else:
                ok = int(got.view(np.uint32)[i]) == sum(
                    1 << b for b, r in enumerate(rxs) if r.fullmatch(line))
            if not ok:
                fail(f"{name} {kind} B={B} L={L}: disagrees with re on "
                     f"{line[:200]!r}")
        (sh, _n), = checked_dfa_shapes(dict(dsc.launch_shapes),
                                       f"{name} B={B} L={L}")
        call_ms = time_cuda(lambda: kern(rows, lengths), 200)
        ms = graph_ms([lambda: kern(rows, lengths)])
        out_bytes = 1 if name == "K2" else 4
        touched = int(lens.sum()) + 4 * B + out_bytes * B
        n_copies = max(8, -(-2 * L2_BYTES // touched))
        copies = [(rows.clone(), lengths.clone()) for _ in range(n_copies)]
        cold_ms = graph_ms([lambda r=r, n=n: kern(r, n) for r, n in copies],
                           reps=n_copies * -(-50 // n_copies), iters=5,
                           keep_outputs=True)
        del copies
        plain_ms = time_cuda(lambda: kern.plain(rows, lengths), 5)
        b_ms, by = dfa_bound_ms(B, kern.arrays.num_states, int(lens.sum()),
                                out_bytes)
        out[(name, B, L, kind)] = {
            "ms": ms, "cold_ms": cold_ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "rows": len(lines), "row_bytes": int(lens.sum()),
            "longest": int(lens.max()), "blocks": sh.blocks,
            "threads": sh.threads, "smem": sh.smem, "S": sh.S,
            "copies": n_copies}
        log(f"{name} {kind} B={B} L={L} S={sh.S} ({len(lines)} rows, longest "
            f"{int(lens.max())}, {int(lens.sum())} row bytes; {sh.blocks} "
            f"blocks of {sh.threads} threads, {sh.smem} bytes of shared "
            f"memory): bit-exact with the plain version and re; kernel "
            f"{ms:.5f} ms warm and {cold_ms:.5f} ms cold ({n_copies} copies) "
            f"on the device (graph replay), {call_ms:.4f} ms per wrapper "
            f"call, plain {plain_ms:.3f} ms, bound {b_ms:.6f} ms ({by}); "
            f"{int(lens.sum()) / (ms * 1e-3) / 1e6:.1f} MB/s walked")
    return out


# -- K3 and K7 ----------------------------------------------------------------

def span_cases(rng, lens, L):
    """Spans for each row of one batch: at the row's start (the whole row),
    in its middle, at its end, past its length, from a negative start,
    absent (-1) and empty (0), and seeded random ones."""
    import numpy as np
    B = len(lens)
    ln = lens.astype(np.int64)
    starts = rng.integers(-3, L + 5, B).astype(np.int32)
    spans = rng.integers(-2, L + 5, B).astype(np.int32)
    kind = np.arange(B) % 8
    starts[kind == 0], spans[kind == 0] = 0, ln[kind == 0]
    starts[kind == 1] = ln[kind == 1] // 2
    spans[kind == 1] = ln[kind == 1] - starts[kind == 1]
    starts[kind == 2] = np.maximum(ln[kind == 2] - 3, 0)
    spans[kind == 2] = 3
    starts[kind == 3], spans[kind == 3] = 2, ln[kind == 3] + 40
    starts[kind == 4], spans[kind == 4] = -2, ln[kind == 4] + 2
    spans[kind == 5] = -1
    spans[kind == 6] = 0
    return starts, spans


def phase_span_parity(java) -> dict:
    """K3 (``lct_dfa_span_match``) against its plain version, bit-exact, and
    against ``re.fullmatch`` of each span cut at its row's length, at every
    length bucket (rows exactly L long, empty and padding rows), at L=100
    and on misaligned rows, on phase 6's single automata."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.device_batch import (LENGTH_BUCKETS,
                                                            pack_rows)
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda as dsc
    from loongcollector_tpu_torch.ops.kernels.dfa_scan import \
        DFASpanMatchKernel
    from loongcollector_tpu_torch.ops.regex.dfa import compile_dfa
    rng = np.random.default_rng(20261018)
    stats = {"checks": 0, "rows": 0, "max_abs_err": 0, "matched": 0}
    dsc.reset_launch_shapes()
    pats = DFA_PATTERNS + [td.JAVA_FILTER, td.JAVA_CONTINUE, td.LIMIT_DFA,
                           td.APACHE_FILTER_INCLUDE["status"],
                           td.APACHE_FILTER_EXCLUDE["url"]]
    for pat in pats:
        kern = DFASpanMatchKernel(compile_dfa(pat))
        rx = re.compile(pat.encode())
        for L, mis in [(L, False) for L in LENGTH_BUCKETS] + [
                (100, False), (128, True)]:
            lines = dfa_lines(rng, [pat], java, L) + [
                b"404", b"/health", b"500", b"x/health"]
            lens = np.array([len(x) for x in lines], np.int32)
            arena = np.frombuffer(b"".join(lines), np.uint8)
            offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(
                np.int64)
            batch = pack_rows(arena, offs, lens, L, len(lines) + 40)
            rows = torch.from_numpy(batch.rows).cuda()
            if mis:
                buf = torch.zeros(rows.numel() + 1, dtype=torch.uint8,
                                  device=rows.device)
                rows = buf[1:].view(rows.shape).copy_(rows)
            lengths = torch.from_numpy(batch.lengths).cuda()
            starts, spans = span_cases(rng, batch.lengths, L)
            st_d = torch.from_numpy(starts).cuda()
            sp_d = torch.from_numpy(spans).cuda()
            got = kern(rows, lengths, st_d, sp_d).cpu().numpy()
            torch.cuda.synchronize()
            want = kern.plain(rows, lengths, st_d, sp_d).cpu().numpy()
            if got.dtype != want.dtype or not (got == want).all():
                bad = np.nonzero(got != want)[0]
                fail(f"K3 != plain for {pat!r} at L={L} (misaligned {mis}), "
                     f"rows {bad[:5].tolist()}")
            for i, line in enumerate(lines):
                lo, sl = max(int(starts[i]), 0), int(spans[i])
                hi = min(int(starts[i]) + max(sl, 0), len(line), L)
                exp = sl >= 0 and rx.fullmatch(
                    line[lo:hi] if hi > lo else b"") is not None
                if bool(got[i]) != exp:
                    fail(f"K3 disagrees with re on {pat!r}: {line[:80]!r} "
                         f"span ({starts[i]}, {spans[i]})")
            stats["checks"] += 1
            stats["rows"] += len(lines)
            stats["matched"] += int(got.sum())
    shapes = checked_dfa_shapes(dict(dsc.launch_shapes), "span parity")
    if sum(n for sh, n in shapes if sh.entry_point
           == dsc.ENTRY_POINTS["span"]) != stats["checks"]:
        fail(f"span parity: launches recorded {shapes} for "
             f"{stats['checks']} batches")
    log(f"span parity: {stats['checks']} (automaton, L) batches over "
        f"{len(pats)} automata, {stats['rows']} rows ({stats['matched']} "
        f"spans matched): K3 bit-exact with its plain version and with re")
    return stats


def checked_fused_shapes(shapes, phase: str) -> list:
    """K7 launches as (shape, launches): whole warps within the block limit
    and the shared-memory budget, a block for every ``threads`` rows and
    for each SM once a batch holds 32 rows an SM."""
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    out = sorted(shapes.items(), key=lambda kv: (kv[0].instantiation,
                                                 kv[0].B, kv[0].L))
    for sh, _n in out:
        if (sh.threads % 32 or not fxc.MIN_THREADS <= sh.threads
                <= fxc.MAX_THREADS or sh.smem > fxc.SMEM_BUDGET
                or sh.blocks != -(-sh.B // sh.threads)
                or sh.B >= 32 * fxc.NUM_SMS and sh.blocks < fxc.NUM_SMS):
            fail(f"{phase}: K7 launch outside the card's limits: {sh}")
    if not out:
        fail(f"{phase}: no K7 launch recorded")
    return out


def _oracle_keep(name, line):
    """The keep bit ``re`` gives a row of the three_stage and
    apache_filter stage lists."""
    from loongcollector_tpu_torch import testdata as td
    if name == "three_stage":
        m = re.fullmatch(td.THREE_STAGE_RX.encode(), line)
        return (re.fullmatch(td.THREE_STAGE_SOURCE.encode(), line)
                is not None, m is not None and re.fullmatch(
                    td.THREE_STAGE_NUM.encode(), m.group(2)) is not None)
    m = re.fullmatch(APACHE.encode(), line)
    return (m is not None and re.fullmatch(rb"[45]\d\d", m.group(8))
            is not None and re.fullmatch(rb"/health", m.group(6)) is None,)


def phase_fused_parity() -> dict:
    """K7 on each stage list of ``testdata.fused_stage_lists`` against its
    plain version and against ``staged_run`` (one K1/K2/K3/K4 launch a
    stage), bit-exact on every output, at every length bucket, at L=100
    and on misaligned rows; the keep bits of the THREE_STAGE and
    Apache-filter lists against re.  Then one FusedDispatch of six chunks
    under ``set_sync_debug_mode("error")``, equal to the same dispatch on
    the CPU."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops import fused_pipeline as fp
    from loongcollector_tpu_torch.ops.device_batch import (LENGTH_BUCKETS,
                                                            pack_rows)
    from loongcollector_tpu_torch.ops.kernels import fused_program_cuda as fpc
    rng = np.random.default_rng(20261019)
    stats = {"checks": 0, "rows": 0, "max_abs_err": 0, "bit31_rows": 0,
             "lists": {}}
    fpc.reset_launch_shapes()
    programs = {}
    for name, specs, rows_fn in td.fused_stage_lists():
        program = fp.FusedProgramKernel(specs, name)
        programs[name] = program
        for L, mis in [(L, False) for L in LENGTH_BUCKETS] + [
                (100, False), (128, True)]:
            lines = rows_fn(rng, 1500 if L <= 1024 else 600, L)
            lens = np.array([len(x) for x in lines], np.int32)
            arena = np.frombuffer(b"".join(lines), np.uint8)
            offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(
                np.int64)
            batch = pack_rows(arena, offs, lens, L)
            B = batch.rows.shape[0]
            rows = torch.from_numpy(batch.rows).cuda()
            if mis:
                buf = torch.zeros(rows.numel() + 1, dtype=torch.uint8,
                                  device=rows.device)
                rows = buf[1:].view(rows.shape).copy_(rows)
            lengths = torch.from_numpy(batch.lengths).cuda()
            (flat,) = program(rows, lengths)
            got = [t.cpu().numpy() for t in program.split(flat, B)]
            torch.cuda.synchronize()
            want = [t.cpu().numpy() for t in program.plain(rows, lengths)]
            staged = [t.cpu().numpy() for tup in
                      program.staged_run(rows, lengths) for t in tup]
            for o, g, w, st in zip(program.descriptor.outputs, got, want,
                                   staged):
                g = g.reshape(w.shape)
                for other, what in ((w, "plain version"),
                                    (st, "staged run")):
                    if g.dtype != other.dtype or not (g == other).all():
                        bad = np.nonzero((g != other).reshape(B, -1)
                                         .any(axis=1))[0]
                        fail(f"K7 != {what} for {name} stage {o.stage} "
                             f"{o.name} at L={L} (misaligned {mis}), rows "
                             f"{bad[:5].tolist()}")
                stats["max_abs_err"] = max(stats["max_abs_err"], int(np.abs(
                    g.astype(np.int64) - w.astype(np.int64)).max(initial=0)))
                if o.name == "tags":
                    stats["bit31_rows"] += int((g.view(np.uint32)
                                                >> 31 & 1).sum())
            if name in ("three_stage", "apache_filter"):
                keeps = [g for o, g in zip(program.descriptor.outputs, got)
                         if o.name == "keep"]
                for i, line in enumerate(lines):
                    exp = _oracle_keep(name, line)
                    if tuple(bool(k[i]) for k in keeps) != exp:
                        fail(f"K7 {name} keep disagrees with re on "
                             f"{line[:100]!r}")
            stats["checks"] += 1
            stats["rows"] += len(lines)
        d = program.descriptor
        stats["lists"][name] = {"instantiation": d.instantiation,
                                "descriptor_words": len(d.blob),
                                "shared_words": d.shared_words,
                                "launches": program.launches}
        log(f"fused parity {name}: {program.launches} launches of "
            f"{d.instantiation} bit-exact with the plain version and "
            f"staged_run; descriptor {len(d.blob)} words, {d.shared_words} "
            f"in shared memory; placement {d.placement}")
    if not stats["bit31_rows"]:
        fail("fused parity: no row set tag bit 31")
    shapes = checked_fused_shapes(dict(fpc.launch_shapes), "fused parity")
    if sum(n for _, n in shapes) != stats["checks"]:
        fail(f"fused parity: {sum(n for _, n in shapes)} launches recorded "
             f"for {stats['checks']} batches")
    over = [sh for sh, _ in shapes if sh.device_words > 0
            and sh.L == LENGTH_BUCKETS[-1]]
    if not over:
        fail("fused parity: no launch at L=4096 with tables in device "
             "memory")
    log(f"fused parity: {stats['checks']} (stage list, L) batches, "
        f"{stats['rows']} rows, {stats['bit31_rows']} rows with tag bit 31; "
        f"instantiations launched "
        f"{sorted({sh.instantiation for sh, _ in shapes})}; at L=4096 the "
        f"over-budget list ran {over[0].threads} threads with "
        f"{over[0].smem} bytes of shared memory and {over[0].device_words} "
        f"descriptor words in device memory")
    stats["sync_debug"] = phase_fused_dispatch(programs["apache_filter"])
    return stats


def phase_fused_dispatch(program) -> int:
    """One FusedDispatch of six chunks under set_sync_debug_mode("error"):
    no hidden synchronisation between dispatch and result; its stage
    outputs equal the same dispatch on the CPU."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch.ops import fused_pipeline as fp
    from loongcollector_tpu_torch.testdata import gen_lines
    dev = torch.device("cuda", torch.cuda.current_device())
    program.warm(dev)
    chunk = 8192
    fp.MAX_BATCH = chunk
    try:
        lines = gen_lines(6 * chunk - 100, seed=23)
        arena, offs, lens = _layout(lines)
        d = fp.FusedDispatch(program, arena, offs, lens, dev, depth=8)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            d.dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = d.result()
        want = fp.FusedDispatch(program, arena, offs, lens,
                                torch.device("cpu")).dispatch().result()
    finally:
        fp.MAX_BATCH = 65536
    for si, (g, w) in enumerate(zip(got.stages, want.stages)):
        for a, b in zip(g, w):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                fail(f"fused dispatch: stage {si} differs from the CPU run")
    log(f"fused dispatch: FusedDispatch.dispatch of 6 chunks "
        f"({len(lines)} rows) ran under set_sync_debug_mode('error'); "
        f"stage outputs equal the CPU run's")
    return len(lines)


def phase_apache_filter(tmp, log_path, lines, n_bytes, threads) -> dict:
    """The Apache-filter path (``testdata.apache_filter_config``) on the
    main path's log: every record equals the re oracle in file order; K7
    launches = fused dispatches = plane dispatches = groups > 0, and K1's
    and K2's standalone launches are 0; the plane, ring and memory ledger
    settle."""
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.kernels.fused_program_cuda import \
        LaunchShape
    tag = f"apache filter, {threads} worker{'s' if threads > 1 else ''}"
    run_dir = os.path.join(tmp, f"filter{threads}")
    cfg_dir = os.path.join(run_dir, "config")
    os.makedirs(cfg_dir)
    out_path = os.path.join(run_dir, "out.json")
    with open(os.path.join(cfg_dir, "apache_filter.yaml"), "w") as f:
        f.write(td.apache_filter_config(log_path, out_path))
    st, wall = run_agent(tag, cfg_dir, os.path.join(run_dir, "stats.json"),
                         threads)
    want = td.apache_filter_oracle(lines)
    n = 0
    with open(out_path, "rb") as f:
        for n, rec in enumerate(f, 1):
            if n > len(want):
                fail(f"{tag}: more records than the oracle's {len(want)}")
            obj = json.loads(rec)
            got = {k: obj.get(k) for k in td.APACHE_KEYS}
            if got != want[n - 1]:
                fail(f"{tag}: record {n}: {got} != re {want[n - 1]}")
    if n != len(want) or st["events"] != n:
        fail(f"{tag}: {n} records ({st['events']} events) for the oracle's "
             f"{len(want)}")
    check_settled(tag, st, k1=False)
    fu, plane = st["fusion"], st["plane"]
    if not (0 < fu["k7_launches"] == fu["fused_dispatches"]
            == plane["dispatches"] == fu["fused_groups"]
            == fu["exec_legs"]) or fu["runs_planned"] != 1 \
            or fu["long_row_groups"] or fu["other_groups"] \
            or st["launches"] or st["k2"]["launches"] \
            or st["k4"]["launches"] or fu["k3_launches"]:
        fail(f"{tag}: K7 launches {fu['k7_launches']}, fused dispatches "
             f"{fu['fused_dispatches']}, plane dispatches "
             f"{plane['dispatches']}, groups {fu['fused_groups']} fused / "
             f"{fu['long_row_groups']} per-stage, standalone K1 "
             f"{st['launches']}, K2 {st['k2']['launches']}, K3 "
             f"{fu['k3_launches']}")
    shapes = checked_fused_shapes(
        {LaunchShape(**{k: v for k, v in d.items() if k != "launches"}):
         d["launches"] for d in fu["launch_shapes"]}, tag)
    if sum(n_ for _, n_ in shapes) != fu["k7_launches"]:
        fail(f"{tag}: K7 launch shapes do not add up to its launches")
    mbps = n_bytes / st["seconds"] / 1e6
    log(f"{tag}: {len(lines)} lines in, {n} records out ({n / len(lines):.1%}"
        f" kept), equal to the re oracle in order; {fu['k7_launches']} K7 "
        f"launches = fused dispatches = plane dispatches = groups, 0 "
        f"standalone K1/K2 launches; {mbps:.2f} MB/s end to end "
        f"({st['seconds']:.3f} s, agent process {wall:.1f} s); K7 exec legs "
        f"{fu['kernel_seconds']:.6f} s, median "
        f"{fu['exec_median_s'] * 1e3:.5f} ms, largest "
        f"{fu['exec_max_s'] * 1e3:.5f} ms; traced busy share "
        f"{st['busy_share'] * 100:.3f}%; geometry " + ", ".join(
            f"{k}x {sh.instantiation} B={sh.B} L={sh.L}: {sh.blocks} blocks "
            f"of {sh.threads} threads, {sh.smem} bytes of shared memory"
            for sh, k in shapes))
    log(f"{tag}: stage seconds (host): " + json.dumps(st["stage_seconds"]))
    legs = st["timeline"]["legs"]
    log(f"{tag}: legs (median ms / sum s / count): " + ", ".join(
        f"{leg} {v['median_s'] * 1e3:.4f} / {v['sum_s']:.4f} / {v['count']}"
        f" ({v['clock']})" for leg, v in legs.items()))
    os.unlink(out_path)
    return {"stats": st, "mbps": mbps, "wall_s": wall, "shapes": shapes,
            "records": n}


def fused_bound_ms(B, row_bytes, walked, desc_words, C, n_keep):
    """Least time for one K7 launch of the Apache-filter program: the bytes
    it must move (row bytes below each length, the lengths, the descriptor,
    B * (1 + 8C) extract outputs and B keep bytes) at the HBM rate, against
    one 32-bit op per byte walked (the row, then each span) at the
    non-tensor rate; returns (ms, bound_by)."""
    moved = row_bytes + 4 * B + 4 * desc_words + B * (1 + 8 * C) \
        + n_keep * B
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = walked / INT_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def span_bound_ms(B, S, span_bytes):
    """Least time for one K3 launch: K2's count over the bytes the spans
    hold (row bytes below each length, cut to the span), plus 8B for the
    starts and lengths of the spans."""
    moved = span_bytes + 4 * B + S * 256 + 4 * S + B + 8 * B
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = span_bytes / INT_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def phase_fused_timing() -> dict:
    """K7 on the Apache-filter program and K3 on the status condition over
    the status spans, at B=8192 (5,500 Apache rows: one main-path chunk)
    and B=65536, L=128: warm and cold (graph replay), each beside its plain
    version and bound."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops import fused_pipeline as fp
    from loongcollector_tpu_torch.ops.device_batch import pack_rows
    from loongcollector_tpu_torch.ops.kernels import fused_program_cuda as fpc
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda as dsc
    specs = dict((n, s) for n, s, _ in td.fused_stage_lists())[
        "apache_filter"]
    program = fp.FusedProgramKernel(specs, "apache_filter")
    span = specs[1].payload[0].staged.kernel
    status = td.APACHE_KEYS.index("status")
    out = {}
    base = td.gen_lines(65536, seed=5)
    for B, n_real in ((8192, 5500), (65536, 65536)):
        lines = base[:n_real]
        lens = np.array([len(x) for x in lines], np.int32)
        arena = np.frombuffer(b"".join(lines), np.uint8)
        offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
        batch = pack_rows(arena, offs, lens, 128, B)
        rows = torch.from_numpy(batch.rows).cuda()
        lengths = torch.from_numpy(batch.lengths).cuda()
        fpc.reset_launch_shapes()
        dsc.reset_launch_shapes()
        (flat,) = program(rows, lengths)
        got = [t.cpu().numpy() for t in program.split(flat, B)]
        want = [t.cpu().numpy() for t in program.plain(rows, lengths)]
        if not all((g.reshape(w.shape) == w).all()
                   for g, w in zip(got, want)):
            fail(f"fused timing B={B}: K7 != plain")
        ok, off, ln = want[0], want[1], want[2]
        starts = torch.from_numpy(np.ascontiguousarray(off[:, status])).cuda()
        spans = torch.from_numpy(np.ascontiguousarray(ln[:, status])).cuda()
        k3 = span(rows, lengths, starts, spans).cpu().numpy()
        if not (k3 == span.plain(rows, lengths, starts, spans)
                .cpu().numpy()).all():
            fail(f"fused timing B={B}: K3 != plain")
        row_bytes = int(lens.sum())
        span_bytes = int(np.clip(ln[:, 7], 0, None).sum())
        walked = row_bytes + span_bytes + int(np.clip(ln[:, 5], 0, None)
                                              .sum())
        res = {}
        for name, fn, plain, bound in (
                ("K7", lambda r, n: program(r, n),
                 lambda: program.plain(rows, lengths),
                 fused_bound_ms(B, row_bytes, walked,
                                len(program.descriptor.blob), 9, 1)),
                ("K3", lambda r, n: span(r, n, starts, spans),
                 lambda: span.plain(rows, lengths, starts, spans),
                 span_bound_ms(B, span.arrays.num_states, span_bytes))):
            call_ms = time_cuda(lambda: fn(rows, lengths), 200)
            ms = graph_ms([lambda: fn(rows, lengths)])
            touched = row_bytes + 4 * B + B * (
                program.descriptor.row_bytes if name == "K7" else 9)
            n_copies = max(8, -(-2 * L2_BYTES // touched))
            copies = [(rows.clone(), lengths.clone())
                      for _ in range(n_copies)]
            cold_ms = graph_ms([lambda r=r, n=n: fn(r, n) for r, n in copies],
                               reps=n_copies * -(-50 // n_copies), iters=5,
                               keep_outputs=True)
            del copies
            plain_ms = time_cuda(plain, 5)
            b_ms, by = bound
            res[name] = {"ms": ms, "cold_ms": cold_ms, "call_ms": call_ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": by, "copies": n_copies}
        (k7_sh, _), = checked_fused_shapes(dict(fpc.launch_shapes),
                                           f"fused timing B={B}")
        k3_sh = next(sh for sh in dsc.launch_shapes
                     if sh.entry_point == dsc.ENTRY_POINTS["span"])
        res["K7"].update(blocks=k7_sh.blocks, threads=k7_sh.threads,
                         smem=k7_sh.smem, instantiation=k7_sh.instantiation)
        res["K3"].update(blocks=k3_sh.blocks, threads=k3_sh.threads,
                         smem=k3_sh.smem, S=k3_sh.S)
        out[B] = res
        for name, r in res.items():
            log(f"{name} timing B={B} L=128 ({n_real} Apache rows; "
                f"{r['blocks']} blocks of {r['threads']} threads, {r['smem']}"
                f" bytes of shared memory): kernel {r['ms']:.5f} ms warm and "
                f"{r['cold_ms']:.5f} ms cold ({r['copies']} copies) on the "
                f"device (graph replay), {r['call_ms']:.4f} ms per wrapper "
                f"call, plain {r['plain_ms']:.3f} ms, bound "
                f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
    return out


# -- slice 6: the metric rollup and K6 ---------------------------------------

K6_TOL = 1e-5       # rtol = atol on sums: scripts/agg_equivalence.py:163
K6_PATH_SHAPE = (8192, 2048)       # B, Gq of a rollup-path fold
K6_BENCH_SHAPE = (65536, 65536)


def _k6_compare(got, want, what):
    """K6's six outputs against another's: sums within rtol = atol = 1e-5
    (atomics add in a changing order; NaN where inf meets -inf on both);
    count, min, max, last and hist equal.  Returns the largest absolute
    difference of the finite sums."""
    import numpy as np
    names = ("sum", "count", "min", "max", "last", "hist")
    for name, g, w in zip(names, got, want):
        if g.shape != w.shape:
            fail(f"{what}: {name} shape {g.shape} != {w.shape}")
        if name == "sum":
            if not np.allclose(g, w, rtol=K6_TOL, atol=K6_TOL,
                               equal_nan=True):
                bad = np.nonzero(~np.isclose(g, w, rtol=K6_TOL, atol=K6_TOL,
                                             equal_nan=True))[0]
                fail(f"{what}: sums differ at {bad[:5]}: {g[bad[:5]]} vs "
                     f"{w[bad[:5]]}")
        elif not np.array_equal(g, w):
            bad = np.nonzero((g != w).reshape(len(g), -1).any(axis=1))[0]
            fail(f"{what}: {name} differs at segments {bad[:5]}")
    fin = np.isfinite(got[0]) & np.isfinite(want[0])
    return float(np.max(np.abs(got[0][fin].astype(np.float64)
                               - want[0][fin]), initial=0.0))


def phase_k6_parity() -> dict:
    """K6 against its plain version on the card over the seeded batches of
    ``testdata.k6_cases`` (B 256..65536, G 16..65536, 41 and 1 buckets,
    invalid shares 0 / 10% / 100%, a hot segment, +-inf and both zeros),
    and the device fold (``SegmentReduceKernel.fold_batch`` on the card)
    against the host numpy twin on the equivalence gate's device corpora:
    group ids, representative rows, counts and histograms exact, min, max
    and last equal to the twin's through f32, sums within the tolerance."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.kernels import segment_reduce as sr
    from loongcollector_tpu_torch.ops.kernels import segment_reduce_cuda as src
    src.reset_launch_shapes()
    kerns = {n: sr.SegmentReduceKernel(n) for n in (41, 1)}
    max_err, checks = 0.0, 0
    for label, B, G, n_hist, invalid, hot, inf, spread in td.k6_cases():
        vals, seg, buckets, valid = td.k6_batch(B + G, B, G, n_hist,
                                                invalid, hot, inf,
                                                spread=spread)
        args = [torch.from_numpy(a).cuda() for a in (vals, seg, buckets,
                                                     valid)]
        kern = kerns[n_hist]
        got = [t.cpu().numpy() for t in kern(*args, G)]
        torch.cuda.synchronize()
        want = [t.cpu().numpy() for t in kern.plain(*args, G)]
        max_err = max(max_err, _k6_compare(got, want, f"K6 {label}"))
        if invalid == 1.0 and (got[1].any() or got[5].any()):
            fail(f"K6 {label}: an all-invalid batch counted rows")
        checks += 1
    folds = 0
    for label, rows, device_ok in td.agg_batch_corpus():
        if not device_ok:
            continue
        args = td.pack_agg_rows(rows)
        for n_hist, kern in kerns.items():
            dev = kern.fold_batch(*args, device=torch.device("cuda"))
            ref = sr.fold_batch_numpy(*args, n_hist=n_hist)
            for f in ("group_id", "rep_row", "count", "hist"):
                if not np.array_equal(getattr(dev, f), getattr(ref, f)):
                    fail(f"K6 fold [{label}] n_hist={n_hist}: {f} != the "
                         f"numpy twin's")
            for f in ("min", "max", "last"):
                if not np.array_equal(getattr(dev, f), getattr(ref, f)
                                      .astype(np.float32)
                                      .astype(np.float64)):
                    fail(f"K6 fold [{label}] n_hist={n_hist}: {f} != f32 of "
                         f"the numpy twin's")
            if not np.allclose(dev.sum, ref.sum, rtol=K6_TOL, atol=K6_TOL):
                fail(f"K6 fold [{label}] n_hist={n_hist}: sums out of "
                     f"tolerance")
            folds += 1
    launches = sum(k.launches for k in kerns.values())
    shapes = dict(src.launch_shapes)
    if launches != checks + folds or sum(shapes.values()) != launches:
        fail(f"K6 parity: {launches} launches, {sum(shapes.values())} in "
             f"the shapes, for {checks} batches and {folds} folds")
    big = max(shapes, key=lambda sh: (sh.B, sh.G))
    log(f"K6 parity: {checks} batches equal the plain version on the card "
        f"(count, min, max, last, hist exact; sums within rtol = atol = "
        f"{K6_TOL}, largest difference {max_err:.3g}), {folds} folds of the "
        f"gate's device corpora equal the numpy twin; {launches} launches "
        f"of {len(shapes)} shapes, the largest B={big.B} G={big.G}: "
        f"{big.blocks} scatter blocks, {big.init_blocks} init blocks")
    return {"checks": checks, "folds": folds, "max_abs_err": max_err}


def phase_k6_path_parity(fold_rows, runs) -> dict:
    """K6 against its plain version on the card on the rollup path's own
    fold inputs: each group of the metrics log (``testdata.
    metrics_fold_rows``, one a reader chunk) keyed and staged as the device
    substrate does it (``segment_reduce.key_fold``); count, min, max, last
    and hist exact, sums within the tolerance.  The (B, Gq, n_hist) of
    these folds must be those each run in ``runs`` launched, fold for
    fold."""
    from collections import Counter
    import numpy as np
    import torch
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.kernels import segment_reduce as sr
    kern = sr.SegmentReduceKernel(sr.N_HIST)
    shapes = Counter()
    max_err = 0.0
    for i, rows in enumerate(fold_rows):
        keyed = sr.key_fold(*td.pack_agg_rows(rows))
        if keyed is None:
            continue
        buf = np.empty(13 * keyed.B, np.uint8)
        keyed.stage(buf, sr.HIST_BASE, sr.N_HIST)
        args = [torch.from_numpy(a.copy()).cuda()
                for a in sr.staged_views(buf, keyed.B)]
        got = [t.cpu().numpy() for t in kern(*args, keyed.Gq)]
        want = [t.cpu().numpy() for t in kern.plain(*args, keyed.Gq)]
        max_err = max(max_err, _k6_compare(got, want, f"K6 path fold {i}"))
        shapes[(keyed.B, keyed.Gq, sr.N_HIST)] += 1
    for run in runs:
        launched = Counter({(sh["B"], sh["G"], sh["n_hist"]): sh["launches"]
                            for sh in run["stats"]["aggregation"]
                            ["launch_shapes"]})
        if launched != shapes:
            fail(f"K6 path parity: the path launched {dict(launched)}, its "
                 f"folds rebuilt give {dict(shapes)}")
    log(f"K6 path parity: {sum(shapes.values())} folds of the rollup "
        f"path's own inputs equal the plain version on the card (count, "
        f"min, max, last, hist exact; sums within rtol = atol = {K6_TOL}, "
        f"largest difference {max_err:.3g}); (B, Gq, n_hist): folds "
        f"{dict(shapes)}, as the {len(runs)} path runs launched")
    return {"folds": sum(shapes.values()), "max_abs_err": max_err}


def k6_bound_ms(B, n_valid, G, n_hist):
    """Bytes the reduce must move (the valid flag of each of the ``B``
    rows, 12 more bytes of each of the ``n_valid`` valid rows, whose value,
    segment and bucket the kernel reads, and 4 (5 + n_hist) a segment out)
    at HBM rate, against one 32-bit operation a row and ~8 more a valid row
    at the non-tensor rate; returns (ms, bound_by)."""
    t_bytes = (B + 12 * n_valid + 20 * G + 4 * n_hist * G) / HBM_BYTES_PER_S
    t_ops = (B + 8 * n_valid) / INT_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def phase_k6_timing() -> dict:
    """K6 at the rollup path's fold shape (B=8192 with 5,000 real rows over
    1,600 segments, Gq=2048) and at B = Gq = 65536 (every row real), 41
    buckets: warm (the same inputs launch after launch) and cold (the
    launches rotate over enough copies to pass twice the 50 MB L2), by
    graph replay, beside the plain version (also graph-replayed: its
    ``index_add_`` / ``scatter_reduce_`` calls are the library yardstick)
    and the bound (``k6_bound_ms``, from the timed batch's valid rows)."""
    import torch
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.kernels import segment_reduce as sr
    from loongcollector_tpu_torch.ops.kernels import segment_reduce_cuda as src
    kern = sr.SegmentReduceKernel(41)
    out = {}
    for (B, G), (n_real, n_seg) in ((K6_PATH_SHAPE, (5000, 1600)),
                                    (K6_BENCH_SHAPE, (65536, 65536))):
        vals, seg, buckets, valid = td.k6_batch(7, B, n_seg, 41,
                                                n_real=n_real)
        seg[n_real:] = G
        args = [torch.from_numpy(a).cuda() for a in (vals, seg, buckets,
                                                     valid)]
        src.reset_launch_shapes()
        got = [t.cpu().numpy() for t in kern(*args, G)]
        want = [t.cpu().numpy() for t in kern.plain(*args, G)]
        _k6_compare(got, want, f"K6 timing B={B} G={G}")

        def fn(v, s, b, ok):
            return kern.launch_flat(v, s, b, ok, G)
        call_ms = time_cuda(lambda: fn(*args), 200)
        ms = graph_ms([lambda: fn(*args)])
        touched = 13 * B + 4 * src.out_words(G, 41) + 8 * G
        n_copies = max(8, -(-2 * L2_BYTES // touched))
        copies = [tuple(a.clone() for a in args) for _ in range(n_copies)]
        cold_ms = graph_ms([lambda c=c: fn(*c) for c in copies],
                           reps=n_copies * -(-50 // n_copies), iters=5,
                           keep_outputs=True)
        del copies
        plain_ms = graph_ms([lambda: kern.plain(*args, G)], reps=10,
                            iters=5)
        plain_call_ms = time_cuda(lambda: kern.plain(*args, G), 20)
        b_ms, by = k6_bound_ms(B, int(valid.sum()), G, 41)
        sh = next((sh for sh in src.launch_shapes
                   if sh.B == B and sh.G == G), None)
        if sh is None:
            fail(f"K6 timing: no launch recorded at B={B} G={G}")
        out[(B, G)] = {"ms": ms, "cold_ms": cold_ms, "call_ms": call_ms,
                       "plain_ms": plain_ms, "plain_call_ms": plain_call_ms,
                       "bound_ms": b_ms, "bound_by": by, "copies": n_copies,
                       "blocks": sh.blocks, "init_blocks": sh.init_blocks,
                       "real_rows": n_real, "segments": n_seg}
        log(f"K6 timing B={B} Gq={G} n_hist=41 ({n_real} real rows over "
            f"{n_seg} segments; {sh.blocks} scatter blocks and "
            f"{sh.init_blocks} init blocks of {src.THREADS} threads): "
            f"kernel {ms:.5f} ms warm and {cold_ms:.5f} ms cold ({n_copies} "
            f"copies) on the device (graph replay), {call_ms:.4f} ms per "
            f"wrapper call; plain (= library: index_add_ / scatter_reduce_) "
            f"{plain_ms:.4f} ms graph-replayed, {plain_call_ms:.4f} ms per "
            f"call; bound {b_ms:.6f} ms ({by})")
    return out


def metrics_log():
    """The seeded 600,000-line metrics corpus, its f64 oracle and the
    fold rows of each reader chunk (``testdata.metrics_fold_rows``)."""
    from loongcollector_tpu_torch import testdata as td
    tmp = tempfile.mkdtemp(prefix="chip_smoke_metrics_")
    log_path = os.path.join(tmp, "metrics.jsonl")
    t0 = time.perf_counter()
    lines = td.gen_metrics_jsonl(MAIN_PATH_LINES, seed=17)
    data = b"\n".join(lines) + b"\n"
    with open(log_path, "wb") as f:
        f.write(data)
    oracle, invalid = td.metrics_oracle(lines)
    fold_rows = td.metrics_fold_rows(lines)
    log(f"metrics log: {len(lines)} lines, {len(data)} bytes, "
        f"{len(oracle)} rollup rows and {invalid} invalid rows by the f64 "
        f"oracle, {len(fold_rows)} reader chunks, in "
        f"{time.perf_counter() - t0:.1f} s")
    return tmp, log_path, lines, len(data), oracle, invalid, fold_rows


def phase_rollup(tmp, log_path, lines, n_bytes, oracle, invalid, groups,
                 threads, substrate=None, ledger=False) -> dict:
    """The metric-rollup path (``testdata.metric_rollup_config``: parse_json,
    parse_timestamp, aggregator_metric_rollup with ``Substrate: device``,
    flusher_file) on the metrics log: the emitted rows equal the f64
    oracle (keys, counts and histograms exact, min / max / last equal
    through f32, sums within rtol = atol = 1e-5); invalid rows are the
    corpus's and late rows 0; no parse row falls back; every fold is one
    K6 launch (launches = folds = ``groups``, the reader's chunks of the
    log, = K6's dispatches on the timeline) and none ran on the host.
    ``substrate`` (``numpy``) reruns it with ``LOONG_AGG_SUBSTRATE``: every
    fold on the numpy twin, no K6 launch, rows equal to the oracle with
    min / max / last exact.  With ``ledger`` the ledger is on, its
    residual must be 0 and its ingest the ``groups``."""
    from loongcollector_tpu_torch import testdata as td
    tag = (f"rollup{' ' + substrate if substrate else ''}, {threads} "
           f"worker{'s' if threads > 1 else ''}{', ledger on' * ledger}")
    run_dir = os.path.join(tmp, f"rollup{threads}{substrate or ''}"
                                f"{'ledger' * ledger}")
    cfg_dir = os.path.join(run_dir, "config")
    os.makedirs(cfg_dir)
    out_path = os.path.join(run_dir, "out.json")
    with open(os.path.join(cfg_dir, "rollup.yaml"), "w") as f:
        f.write(td.metric_rollup_config(log_path, out_path))
    env = {"LOONG_AGG_SUBSTRATE": substrate} if substrate else {}
    st, wall = run_agent(tag, cfg_dir, os.path.join(run_dir, "stats.json"),
                         threads, ledger, **env)
    with open(out_path, "rb") as f:
        rows = td.rollup_rows(f.read())
    os.unlink(out_path)
    bad = td.rollup_mismatches(rows, oracle, f32_want=substrate is None)
    if bad:
        fail(f"{tag}: rows differ from the f64 oracle: {bad}")
    agg = st["aggregation"]
    c = agg["counters"]
    if ledger and st["ledger"]["snapshot"]["rollup"]["ingest"]["events"] \
            != groups:
        fail(f"{tag}: the ledger's ingest is not the log's {groups} chunks")
    parse = st["parse"]["processor_parse_json_tpu/rollup"]
    if c["agg_invalid_rows_total"] != invalid or c["agg_late_rows_total"] \
            or c["agg_folded_rows_total"] + invalid != len(lines) \
            or c["agg_emitted_rows_total"] != len(oracle) \
            or parse["fallback_rows"] or parse["rows"] != len(lines):
        fail(f"{tag}: counters {c}, parse {parse}, for {len(lines)} lines, "
             f"{invalid} invalid, {len(oracle)} rollup rows")
    if st["device_memory"]["total_live_bytes"]:
        fail(f"{tag}: live bytes left at exit: {st['device_memory']}")
    legs = agg["legs"]
    if substrate is None:
        if not (0 < agg["k6_launches"] == agg["k6_dispatches"] == groups
                == legs["exec"]["count"]) \
                or agg["folds"] != {"device": agg["k6_launches"]}:
            fail(f"{tag}: K6 launches {agg['k6_launches']}, dispatches "
                 f"{agg['k6_dispatches']}, exec legs {legs['exec']['count']},"
                 f" folds {agg['folds']}, groups {groups}")
    elif agg["k6_launches"] or agg["folds"] != {substrate: groups}:
        fail(f"{tag}: K6 launches {agg['k6_launches']}, folds "
             f"{agg['folds']}, groups {groups}")
    secs = st["seconds"]
    mbps = n_bytes / secs / 1e6
    shapes = [(sh["B"], sh["G"], sh["n_hist"], sh["launches"])
              for sh in agg["launch_shapes"]]
    log(f"{tag}: {len(lines)} lines in, {len(rows)} rollup rows out, equal "
        f"to the f64 oracle; {c['agg_invalid_rows_total']} invalid rows (the "
        f"corpus's), 0 late, 0 parse fallback rows; {groups} groups, folds "
        f"{agg['folds']}, {agg['k6_launches']} K6 launches; {mbps:.2f} MB/s "
        f"and {len(lines) / secs:.0f} rows/s end to end ({secs:.3f} s, agent "
        f"process {wall:.1f} s); fold host seconds "
        f"{agg['fold_seconds']:.4f}{'; ledger residual 0' * ledger}")
    if substrate is None:
        log(f"{tag}: K6 legs median ms (sum s): " + ", ".join(
            f"{leg} {v['median_s'] * 1e3:.5f} ({v['sum_s']:.5f})"
            for leg, v in legs.items()) + f"; largest exec "
            f"{legs['exec']['max_s'] * 1e3:.5f} ms; traced busy share "
            f"{st['busy_share'] * 100:.3f}%; launch shapes (B, Gq, n_hist, "
            f"launches) {shapes}")
    log(f"{tag}: stage seconds (host): " + json.dumps(st["stage_seconds"]))
    return {"stats": st, "mbps": mbps, "wall_s": wall, "rows": rows,
            "groups": groups}


def k6_kernel_entry(parity, path_parity, timing, roll, roll4, roll_np,
                    roll_led, build) -> dict:
    """The ``kernels`` line's entry of K6: launches from the rollup path at
    one worker, times at its fold shape (B=8192, Gq=2048)."""
    t, tb = timing[K6_PATH_SHAPE], timing[K6_BENCH_SHAPE]
    agg = roll["stats"]["aggregation"]
    legs = agg["legs"]
    return {
        "name": "segment_reduce",
        "route": "cuda",
        "source": "loongcollector_tpu_torch/ops/kernels/csrc/"
                  "segment_reduce.cu",
        "replaces": "loongcollector_tpu/ops/kernels/segment_reduce.py:362",
        "parity": f"sums rtol=atol={K6_TOL}, the rest exact",
        "geometry": [*K6_PATH_SHAPE, 41],
        "launches": agg["k6_launches"],
        "max_abs_err": max(parity["max_abs_err"],
                           path_parity["max_abs_err"]),
        "ms": t["ms"],
        "cold_ms": t["cold_ms"],
        "call_ms": t["call_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        # the plain version's index_add_ / scatter_reduce_ calls compute
        # the program directly: one measurement for both columns
        "library_ms": t["plain_ms"],
        "plain_call_ms": t["plain_call_ms"],
        "bench_geometry": [*K6_BENCH_SHAPE, 41],
        "bench_ms": tb["ms"],
        "bench_cold_ms": tb["cold_ms"],
        "bench_plain_ms": tb["plain_ms"],
        "bench_bound_ms": tb["bound_ms"],
        "path_mbps": roll["mbps"],
        "path_mbps_4_workers": roll4["mbps"],
        "path_mbps_numpy_substrate": roll_np["mbps"],
        "path_mbps_ledger_on": roll_led["mbps"],
        "path_groups": roll["groups"],
        "path_rollup_rows": len(roll["rows"]),
        "path_fold_s": agg["fold_seconds"],
        "path_leg_median_ms": {k: v["median_s"] * 1e3
                               for k, v in legs.items()},
        "path_exec_max_ms": legs["exec"]["max_s"] * 1e3,
        "path_busy_share": roll["stats"]["busy_share"],
        "path_launch_shapes": [[sh["B"], sh["G"], sh["n_hist"],
                                sh["launches"]]
                               for sh in agg["launch_shapes"]],
        "path_launches_4_workers":
            roll4["stats"]["aggregation"]["k6_launches"],
        "parity_batches": parity["checks"],
        "parity_folds": parity["folds"],
        "path_parity_folds": path_parity["folds"],
        "blocks": t["blocks"],
        "init_blocks": t["init_blocks"],
        "threads": 256,
        "build_s": build["build_s"]["segment_reduce"],
        "ptxas": build["k6_ptxas"],
    }


def fused_kernel_entries(span_parity, fused_parity, timing, filt, filt4,
                         path2, build) -> list:
    """The ``kernels`` line's entries of K3 and K7: K7's launches from the
    Apache-filter path (one worker), K3's standalone launches there (0: on
    that path its walk runs inside each K7 launch); times at B=8192,
    L=128."""
    t8, t64 = timing[8192], timing[65536]
    fu = filt["stats"]["fusion"]
    return [{
        "name": "dfa_span_match",
        "route": "cuda",
        "source": "loongcollector_tpu_torch/ops/kernels/csrc/dfa_scan.cu",
        "replaces": "loongcollector_tpu/ops/kernels/dfa_scan.py:105",
        "parity": "bit-exact",
        "geometry": [8192, 128, t8["K3"]["S"]],
        "launches": fu["k3_launches"],
        "span_walks_inside_k7_launches": fu["k7_launches"],
        "max_abs_err": span_parity["max_abs_err"],
        "ms": t8["K3"]["ms"],
        "cold_ms": t8["K3"]["cold_ms"],
        "call_ms": t8["K3"]["call_ms"],
        "plain_ms": t8["K3"]["plain_ms"],
        "bound_ms": t8["K3"]["bound_ms"],
        "bound_by": t8["K3"]["bound_by"],
        # no single PyTorch call computes a DFA walk
        "library_ms": None,
        "bench_ms": t64["K3"]["ms"],
        "bench_cold_ms": t64["K3"]["cold_ms"],
        "bench_plain_ms": t64["K3"]["plain_ms"],
        "bench_bound_ms": t64["K3"]["bound_ms"],
        "parity_batches": span_parity["checks"],
        "threads": t8["K3"]["threads"],
        "blocks": t8["K3"]["blocks"],
        "build_s": build["build_s"]["dfa_scan"],
        "ptxas": build["dfa_ptxas"]["span"],
    }, {
        "name": "fused_program",
        "route": "cuda",
        "source": "loongcollector_tpu_torch/ops/kernels/csrc/"
                  "fused_program.cu",
        "replaces": "loongcollector_tpu/ops/fused_pipeline.py:156",
        "parity": "bit-exact",
        "geometry": [8192, 128, 9],
        "launches": fu["k7_launches"],
        "max_abs_err": fused_parity["max_abs_err"],
        "ms": t8["K7"]["ms"],
        "cold_ms": t8["K7"]["cold_ms"],
        "call_ms": t8["K7"]["call_ms"],
        "plain_ms": t8["K7"]["plain_ms"],
        "bound_ms": t8["K7"]["bound_ms"],
        "bound_by": t8["K7"]["bound_by"],
        # no single PyTorch call computes a stage program
        "library_ms": None,
        "bench_ms": t64["K7"]["ms"],
        "bench_cold_ms": t64["K7"]["cold_ms"],
        "bench_plain_ms": t64["K7"]["plain_ms"],
        "bench_bound_ms": t64["K7"]["bound_ms"],
        "path_mbps": filt["mbps"],
        "path_mbps_4_workers": filt4["mbps"],
        "path_records": filt["records"],
        "path_kernel_s": fu["kernel_seconds"],
        "path_exec_median_ms": fu["exec_median_s"] * 1e3,
        "path_exec_max_ms": fu["exec_max_s"] * 1e3,
        "path_busy_share": filt["stats"]["busy_share"],
        "path_launch_shapes": [[sh.B, sh.L, sh.blocks, sh.threads, n]
                               for sh, n in filt["shapes"]],
        "path_launches_4_workers":
            filt4["stats"]["fusion"]["k7_launches"],
        "java_filter_groups": path2["fusion"],
        "instantiation": t8["K7"]["instantiation"],
        "threads": t8["K7"]["threads"],
        "blocks": t8["K7"]["blocks"],
        "smem_bytes": t8["K7"]["smem"],
        "parity_batches": fused_parity["checks"],
        "stage_lists": fused_parity["lists"],
        "build_s": build["build_s"]["fused_program"],
        "ptxas": build["k7_ptxas"],
    }]


def dfa_kernel_entry(name, mode, replaces, parity, timing, path2, path2_4,
                     build, key):
    """The ``kernels`` line's entry of K2 (``key`` "K2") or K4 ("K4"): its
    numbers at the shape path 2 launched most (ties: the larger B)."""
    k = path2["stats"][key.lower()]
    (main_sh, _n) = max(path2["shapes"][key],
                        key=lambda kv: (kv[1], kv[0].B))
    t = timing[(key, main_sh.B, main_sh.L, "path")]
    bench = {f"{B}x{L}": {f: timing[(key, B, L, "bench")][f] for f in
                          ("ms", "cold_ms", "plain_ms", "bound_ms",
                           "blocks", "threads")}
             for (k_, B, L, kind) in sorted(timing) if k_ == key
             and kind == "bench"}
    return {
        "name": name,
        "route": "cuda",
        "source": "loongcollector_tpu_torch/ops/kernels/csrc/dfa_scan.cu",
        "replaces": replaces,
        "parity": "bit-exact",
        "geometry": [main_sh.B, main_sh.L, t["S"]],
        "launches": k["launches"],
        "max_abs_err": parity["max_abs_err"],
        "ms": t["ms"],
        "cold_ms": t["cold_ms"],
        "call_ms": t["call_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        # no single PyTorch call computes a DFA walk
        "library_ms": None,
        "path_points": {f"{B}x{L}": {f: v[f] for f in
                                     ("ms", "cold_ms", "plain_ms",
                                      "bound_ms", "blocks", "threads")}
                        for (k_, B, L, kind), v in sorted(timing.items())
                        if k_ == key and kind == "path"},
        "bench_points": bench,
        "path_device_batches": k["device_batches"],
        "path_host_rows": k["host_rows"],
        "path_kernel_s": k["kernel_seconds"],
        "path_exec_median_ms": k["exec_median_s"] * 1e3,
        "path_exec_max_ms": k["exec_max_s"] * 1e3,
        "path_launches_4_workers": path2_4["stats"][key.lower()]["launches"],
        "path_launch_shapes": [[sh.B, sh.L, sh.S, sh.blocks, n]
                               for sh, n in path2["shapes"][key]],
        "threads": t["threads"],
        "blocks": t["blocks"],
        "smem_bytes": t["smem"],
        "build_s": build["build_s"]["dfa_scan"],
        "ptxas": build["dfa_ptxas"][mode],
    }


def main() -> int:
    t_start = time.perf_counter()
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
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda as dsc
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    from loongcollector_tpu_torch.ops.kernels import fused_program_cuda as fpc
    from loongcollector_tpu_torch.ops.kernels import segment_reduce_cuda as src
    from loongcollector_tpu_torch.testdata import rollup_mismatches
    build = phase_build(fxc, dsc, fpc, src, native)
    parity = phase_parity()
    tmp, log_path, lines, n_bytes = main_path_log()
    main_path = phase_main_path(tmp, log_path, lines, n_bytes, threads=1)
    main_path4 = phase_main_path(tmp, log_path, lines, n_bytes, threads=4)
    main_led = phase_main_path(tmp, log_path, lines, n_bytes, threads=1,
                               ledger=True)
    timing = phase_timing()
    plane = phase_plane()
    jtmp, jlog_path, jlines, j_bytes = java_log()
    dfa_parity = phase_dfa_parity(jlines)
    span_parity = phase_span_parity(jlines)
    fused_parity = phase_fused_parity()
    k6_parity = phase_k6_parity()
    path1 = phase_multiline(jtmp, jlog_path, jlines, j_bytes, 1, 1)
    path2 = phase_multiline(jtmp, jlog_path, jlines, j_bytes, 2, 1)
    path2_4 = phase_multiline(jtmp, jlog_path, jlines, j_bytes, 2, 4)
    os.unlink(jlog_path)
    grok = phase_grok(tmp, log_path, lines, n_bytes)
    filt = phase_apache_filter(tmp, log_path, lines, n_bytes, threads=1)
    filt4 = phase_apache_filter(tmp, log_path, lines, n_bytes, threads=4)
    os.unlink(log_path)
    mtmp, mlog_path, mlines, m_bytes, oracle, invalid, fold_rows = \
        metrics_log()
    m_args = (mtmp, mlog_path, mlines, m_bytes, oracle, invalid,
              len(fold_rows))
    roll = phase_rollup(*m_args, 1)
    roll4 = phase_rollup(*m_args, 4)
    roll_np = phase_rollup(*m_args, 1, substrate="numpy")
    roll_led = phase_rollup(*m_args, 1, ledger=True)
    os.unlink(mlog_path)
    log(f"ledger cost (one worker, off / on): main path "
        f"{main_path['mbps']:.2f} / {main_led['mbps']:.2f} MB/s, rollup "
        f"{roll['mbps']:.2f} / {roll_led['mbps']:.2f} MB/s")
    for name, other in (("four workers", roll4), ("numpy substrate",
                                                   roll_np),
                        ("ledger-on", roll_led)):
        bad = rollup_mismatches(roll["rows"], other["rows"],
                                f32_want=other is roll_np)
        if bad:
            fail(f"rollup: the device run's rows differ from the {name} "
                 f"run's: {bad}")
    log(f"rollup: the device run's {len(roll['rows'])} rows equal the four-"
        f"worker run's, the numpy-substrate run's and the ledger-on run's "
        f"(sums within rtol = atol = {K6_TOL}, the rest exact)")
    k6_path = phase_k6_path_parity(fold_rows, [roll, roll4, roll_led])
    dfa_timing = phase_dfa_path_shapes(jlines, [path2, path2_4])
    fused_timing = phase_fused_timing()
    k6_timing = phase_k6_timing()
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
        "main_path_mbps_ledger_on": main_led["mbps"],
        "main_path_busy_share": mp["busy_share"],
        "main_path_leg_median_ms": {
            k: v["median_s"] * 1e3 for k, v in mp["timeline"]["legs"].items()},
        "main_path_overlapped_dispatches":
            mp["timeline"]["overlapped_dispatches"],
        "plane_stress_chunks": plane["stress_chunks"],
        "plane_overlapped": [plane["overlapped"],
                             plane["overlap_dispatches"]],
        "path_launches": {"multiline_java": path1["stats"]["launches"],
                          "java_filter": path2["stats"]["launches"],
                          "grok_nginx": grok["stats"]["launches"]},
        "path_mbps": {"multiline_java": path1["mbps"],
                      "java_filter": path2["mbps"],
                      "java_filter_4_workers": path2_4["mbps"],
                      "grok_nginx": grok["mbps"]},
        "build_s": build["build_s"]["field_extract"],
        "blocks": [t8["blocks"], t64["blocks"]],
        "threads": [t8["threads"], t64["threads"]],
        "smem_bytes": [t8["smem"], t64["smem"]],
        "largest_smem_bytes": parity["largest_smem"],
        "main_path_blocks": sorted({sh.blocks for sh, _ in
                                    main_path["shapes"]}),
        "ptxas": build["ptxas"],
    }, dfa_kernel_entry(
        "dfa_match", "match",
        "loongcollector_tpu/ops/kernels/dfa_scan.py:88", dfa_parity,
        dfa_timing, path2, path2_4, build, "K2"),
        dfa_kernel_entry(
        "fused_scan", "tags",
        "loongcollector_tpu/ops/kernels/dfa_scan.py:172", dfa_parity,
        dfa_timing, path2, path2_4, build, "K4")] + fused_kernel_entries(
        span_parity, fused_parity, fused_timing, filt, filt4, path2,
        build) + [k6_kernel_entry(k6_parity, k6_path, k6_timing, roll,
                                  roll4, roll_np, roll_led, build)]}
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
