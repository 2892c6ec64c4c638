#!/usr/bin/env python3
"""On-card smoke check of loongcollector_tpu_torch (one NVIDIA H100).

    python3 chip_smoke.py            # run from the repo root

Phases, each of which exits non-zero on failure:

1. build: compile the CUDA field-extraction kernel (K1), the DFA walk
   (K2, K3, K4), the fused stage program (K7), the segment reduce (K6) and
   the structural index (K5) from
   ``loongcollector_tpu_torch/ops/kernels/csrc/`` (into ``build/kernels/``,
   keyed on the hash of each source and the headers it includes), one nvcc
   each, started together, and the repo's native host library; print the
   build seconds, ptxas's registers, stack frame and spills for each
   kernel instantiation, the torch version and the card's name and power
   limit.  Fails if K1's depth-0, pivot-free instantiation (the Apache
   program's), a DFA walker, a K7 instantiation without the general
   walker (the Apache-filter program's is ``d0_p0``), one of K6's three
   kernels, one of K5's two modes or a depth-0 instantiation of K8
   (``stats_d0_*``) has a stack frame or spills, and unless K1's six
   instantiations keep the registers and stack they had before K8's
   epilogue joined their source (``K1_PTXAS_BEFORE_K8``).
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
   whose bit 31 is set on real rows; both agree with ``re.fullmatch``;
   then the settled exit's adversarial rows (``testdata.settle_rows``:
   rows that never settle, settle on their last byte or at 16- and
   512-byte edges +-1, lengths 0, 1, 511..513, 4096) for K2 and K4 and an
   automaton at the 128-state cap (``testdata.cap_automaton``), at L =
   128, 1024 and 4096; then K4's skip rows (``testdata.skip_rows``: an
   escape byte at each 16-byte word edge +-1, exactly at the length and
   one past it, inside the row, or none, the bytes past each length left
   in the tile) on the path's start/continue set and on ``SKIP4_SET``
   (states of exactly four and five escape bytes), at L = 128, 256 and
   4096 (K4's two kernels).  Both entry points launch.
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
   kernel and its plain version, bit-exact, and against
   ``re.fullmatch``; then the kernel warm and cold, the plain version and
   the bound (row bytes to each row's settle point, and beside it every
   byte below the lengths), at each of those shapes, on the path-2
   automata at B=8192 and B=65536, L=128, for K2 at L=1024, and for K2 at
   the adversarial point, B=2048, L=4096, no row settling.  The
   ``kernels`` line gives K2 and K4 at the shape path 2 launched most.
10. K3 parity (before phase 7): ``lct_dfa_span_match`` (its walk stopping
   at a settled state) against its plain version, bit-exact, and against
   ``re.fullmatch`` of each span cut at its row's length, at every length
   bucket, at L=100 and on misaligned rows, on phase 6's single automata
   and on automata whose length gate turns rows away (the two filter
   paths' literals, ``a{2,5}``, ``ab|abcd`` and ``(?:ab)*``, the last two
   through the gate's bitmap), beside words of the gated lengths and the
   lengths next to them: spans at a row's start, middle and end, past its
   length, from a negative start, absent (-1) and empty, padding rows.
11. K7 parity (before phase 7; its DFA conditions and scans stop at a
   settled state): each stage list of ``testdata.fused_stage_lists``
   (THREE_STAGE; extract + extract_ok; match + grok's scan + the
   multiline terminal scan; the Apache-filter
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
   status condition over the status spans (shape a: every row passes the
   length gate), and K3 on ``/health`` over the url spans (shape b: the
   gate turns most rows away; the share it turns away is printed), at
   B=8192 and B=65536, L=128, warm and cold, beside the plain versions and
   the bounds.
14. K6 parity (after phase 11): ``lct_segment_reduce`` against its plain
   version on the card over ``testdata.k6_cases`` (B 256..65536, Gq
   16..65536, 41 buckets and 1, invalid shares 0 / 10% / 100%, a hot
   segment, +-inf and both zeros): count, min, max, last and hist exact,
   sums within rtol = atol = 1e-5 (the reference's device tolerance,
   ``scripts/agg_equivalence.py:163``: atomics add in a changing order);
   and ``SegmentReduceKernel.fold_batch`` on the card against the host
   numpy twin on the gate's device corpora (``testdata.agg_batch_corpus``)
   at 41 and 1 buckets: group ids, rows, counts and histograms exact, min,
   max and last equal to the twin's through f32, sums within tolerance;
   and the edge batches (``testdata.k6_edge_batch``) at the smallest Gq,
   B = 0, the path's Gq 2048 and 4096, an odd G and B = Gq = 65536: rows
   over every segment with segments and buckets out of range, every row in
   one segment, rows on either side of every 1024th segment, no valid row.
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
16. K6 timing (last): at the path's fold shapes (B=8192, 5,000 real rows
   over 1,600 segments at Gq=2048 and over 3,200 at Gq=4096), with every
   row in one segment, and at B = Gq = 65536, 41 buckets, warm
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

18. K5 parity (after phase 14): ``lct_struct_index_cuda`` against its
   plain version on the card and the native ``lct_struct_index`` (as
   16-bit words), bit-exact, in JSON mode and in delimiter mode on ``,``
   and ``|``, at every length bucket and at L = 1, 15, 16, 17, 33, 100, on
   the reference's adversarial rows (backslash runs across the 32-byte
   step and the 16-bit word), seeded rows over ``ab\",{}[]: \t|``, the
   three paths' lines, absent rows (length -1), padding rows and a batch
   that is not whole blocks.
19. K7 with ``struct_index`` stages (after phase 18): the lists of
   ``testdata.struct_stage_lists`` (a JSON-mode stage, a ``,`` stage, and
   the pipe delimiter's extract + a ``|`` stage + the delimiter-filter
   keep) against the plain version and ``staged_run`` (K1, K5, K3), at
   L = 128, 512 and 4096, bit-exact.
20. quote-mode CSV (after phase 16): ``testdata.quoted_csv_config`` on
   ``gen_quoted_csv(300_000, seed=19)`` in the index tier
   (``LOONG_DISABLE_NATIVE=1``: K5 indexes each group) at one and four
   workers and in the native tier at one: every record equals the FSM
   oracle (``testdata.csv_oracle``) in order, the three runs' NDJSON bytes
   are equal (``__time__``, the read time, aside), K5 launches = its exec
   legs = the groups with no group left to the numpy twin, the fallback
   rows are the oracle's deviant rows (``testdata.csv_deviant``); then K5
   on the path's own groups against its plain version, whose (B, L) must
   be those the index runs launched.
21. the delimiter-filter path: ``testdata.pipe_filter_config`` on
   ``gen_pipe_log(600_000, seed=23)`` at one worker: the kept records equal
   the ``split`` + ``re`` oracle in order; one K7 launch a group, no
   standalone K1, K2, K3 or K5.
22. ``json_filter.yaml`` (``BASELINE.json`` config 4) with ``flusher_file``
   on ``gen_json_events(100_000, seed=29)``: the kept events equal the
   ``json.loads`` + ``re`` oracle in order; the filter's kernel (K1 for
   the Tier-1 ``ERROR|WARN``) launches once a group; no parse fallback.
23. K5 timing (last): at B=8192 and B=65536, L=128, and at the CSV path's
   most launched (B, L), warm and cold (graph replay), beside the plain
   version and the bound ``sum(lengths) + 4B + 16 ceil(L/16) B`` bytes at
   3.35 TB/s; no library time (no PyTorch call computes the bitmaps).

24. K8, the sharded parse step (run inside phases 2 and 4): every batch
   of phase 2, whole and cut to an odd row count, through
   ``ShardedKernel``'s direct call on meshes of 1, 3 and 4 shards that
   repeat the card (one ``lct_sharded_extract_*`` launch for the card's
   shards, the private pad buffer for an odd B), with an empty-matching
   pattern (``(\\w*)``) among them: ok, cap_off and cap_len bit-exact with
   K1, and each shard's counts (matched, padding rows included; events;
   bytes) exact with the plain K8's; every K8 instantiation launches.
   Then K8 at phase 4's shapes, warm and cold, beside K1 (the epilogue's
   cost), the plain K8 and the bound (K1's bytes and 24 a shard), and its
   launch over the four shards of a one-card mesh.
25. the sharded Apache main path (after phase 12): phase 3's run with
   ``LOONG_SHARDED=1`` at one worker, and at four with the ledger on
   (residual 0): every record equals ``re``; ``--stats`` ``mesh`` holds
   one kernel of one shard whose dispatches = K8 launches = device
   batches = plane dispatches = exec legs = shard 0's h2d legs, no
   standalone K1 launch, and totals equal to the log's lines (events),
   bytes and the records (matched).
26. logical lanes and shards on the card, in this process: four chip
   lanes over ``[cuda:0] * 4`` under four workers (lane dispatches = device
   batches = K1 launches, NDJSON byte-identical to phase 3's one-worker
   run), a four-shard mesh on the card (one K8 launch and one h2d leg a
   dispatch for the four shards, one exec leg, the same NDJSON), and the
   Apache-filter path
   on four lanes (K7 launches = fused dispatches = lane dispatches, the
   records of phase 12).

In every phase each recorded launch must be whole warps within the block
limit and the shared-memory budget, with a block for each SM once a batch
holds 32 rows an SM; the geometry in the ``kernels`` line is the one
``launch()`` passed to the kernel in this run.

An earlier line prints the script's total seconds.  The line before the
last is the ``kernels`` JSON line (K1, K2, K4, K3, K7, K6, K5 and K8), the
last line the ``{"ok": true, "device": ...}`` object.  It imports nothing of JAX
or of the JAX package.
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
# K1's ptxas figures on the H100 (nvcc for sm_90a) before K8's epilogue
# joined its source: registers and stack frame bytes, no spills
K1_PTXAS_BEFORE_K8 = {"d0_p0": (91, 0), "d0_p1": (91, 0), "d0_p2": (91, 0),
                      "d1_p0": (91, 3232), "d1_p1": (90, 3232),
                      "d1_p2": (89, 3232)}
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
EMPTY_MATCH = r"(\w*)"       # K8: padding rows match, and count
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

def phase_build(fxc, dsc, fpc, src, sic, native) -> dict:
    """The five kernel libraries, one nvcc each, started together."""
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
                         ("fused_program", fpc), ("segment_reduce", src),
                         ("struct_index", sic))]
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
    k5_ptxas = sic.ptxas_report(sic.build_log)
    for name, r in sorted(ptxas.items()) + sorted(dfa_ptxas.items()) + [
            (f"fused_program {k}", v) for k, v in sorted(k7_ptxas.items())] \
            + [(f"segment_reduce {k}", v) for k, v in sorted(k6_ptxas.items())] \
            + [(f"struct_index {k}", v) for k, v in sorted(k5_ptxas.items())]:
        log(f"ptxas {name}: {r.get('registers')} registers, "
            f"{r.get('stack')} bytes stack frame, {r.get('spill_stores')} "
            f"bytes spill stores, {r.get('spill_loads')} bytes spill loads")
    missing = [e for e in fxc.ENTRY_POINTS
               if e.replace("lct_field_extract_", "") not in ptxas]
    missing += [e for e in fxc.STATS_ENTRY_POINTS
                if e.replace("lct_sharded_extract_", "stats_") not in ptxas]
    missing += [m for m in dsc.KERNELS if m not in dfa_ptxas]
    missing += [k for k in fpc.INSTANTIATIONS if k not in k7_ptxas]
    missing += [k for k in src.KERNELS if k not in k6_ptxas]
    missing += [k for k in sic.MODES if k not in k5_ptxas]
    if missing:
        fail(f"no ptxas report for {missing}")
    # the depth-0 walkers: K1's Apache instantiation, the DFA walks (K2,
    # K3, K4), K7's instantiations without the general walker (the Apache
    # filter program's is d0_p0), K6's three kernels and K5's two modes
    # K8's epilogue sits behind `if constexpr`: K1's six instantiations
    # must compile to what they did before it
    for key, (regs, stack) in K1_PTXAS_BEFORE_K8.items():
        r = ptxas[key]
        if (r.get("registers"), r.get("stack"), r.get("spill_stores"),
                r.get("spill_loads")) != (regs, stack, 0, 0):
            fail(f"K1 {key} moved with K8's epilogue: {r}, before "
                 f"{regs} registers, {stack} bytes stack frame, no spills")
    log("ptxas: K1's six instantiations unchanged by K8 ("
        + ", ".join(f"{k} {v[0]}" for k, v in K1_PTXAS_BEFORE_K8.items())
        + " registers)")
    for name, r in [("d0_p0", ptxas["d0_p0"])] + [
            (f"K8 {k}", ptxas[k]) for k in sorted(ptxas)
            if k.startswith("stats_d0_")] + [
            (m, dfa_ptxas[m]) for m in dsc.KERNELS] + [
            (f"fused_program {k}", k7_ptxas[k]) for k in fpc.INSTANTIATIONS
            if not k.endswith("_g")] + [
            (f"segment_reduce {k}", k6_ptxas[k]) for k in src.KERNELS] + [
            (f"struct_index {k}", k5_ptxas[k]) for k in sic.MODES]:
        if r.get("stack", 1) or r.get("spill_stores", 1) \
                or r.get("spill_loads", 1):
            fail(f"the {name} walker has local memory: {r}")
    t0 = time.perf_counter()
    if native.get_lib() is None:
        fail("native host library did not build")
    native_s = time.perf_counter() - t0
    log(f"build: five kernels {kernel_s:.2f} s in parallel (field_extract "
        f"{secs['field_extract']:.2f} s, dfa_scan {secs['dfa_scan']:.2f} s, "
        f"fused_program {secs['fused_program']:.2f} s, segment_reduce "
        f"{secs['segment_reduce']:.2f} s, struct_index "
        f"{secs['struct_index']:.2f} s), native library "
        f"{native_s:.2f} s; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; python {sys.version.split()[0]}")
    log(f"card: {nvidia_smi()}; {torch.cuda.get_device_name(0)}")
    return {"kernel_build_s": kernel_s, "native_build_s": native_s,
            "build_s": secs, "ptxas": ptxas, "dfa_ptxas": dfa_ptxas,
            "k7_ptxas": k7_ptxas, "k6_ptxas": k6_ptxas, "k5_ptxas": k5_ptxas}


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


def check_batch(kern, pattern, lines, L, stats, misalign=False,
                k8=None) -> None:
    """Kernel vs plain on the card, and both vs re, for one (pattern, L).
    With `misalign` the rows start one byte past a 16-byte boundary.  With
    `k8`, a list of ``ShardedKernel``s over ``kern`` (meshes that repeat
    the card), each one's direct call (K8, one launch for the card's
    shards) must give K1's outputs bit for bit and, per shard, the plain
    K8's counts."""
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
    # the whole batch, and its first rows up to an odd count (the mesh's
    # private pad buffer then adds rows)
    odd = min(len(lines) | 1, batch.rows.shape[0])
    for sk in k8 or ():
        for n_rows in (batch.rows.shape[0], odd):
            check_k8(sk, pattern, batch.rows[:n_rows],
                     batch.lengths[:n_rows], [g[:n_rows] for g in got],
                     want[0][:n_rows], rx, stats)


def check_k8(sk, pattern, rows, lengths, k1_out, plain_ok, rx,
             stats) -> None:
    """K8 through ``ShardedKernel``'s direct call (its private pad buffer
    when B is not a mesh multiple) against K1's outputs of the same rows,
    and its counts against the plain K8's: the plain K1's ok (a padding
    row of the pad buffer is ok exactly when the pattern matches the empty
    string, as K1's own padding rows show) summed per shard with the
    lengths, as ``extract_stats_plain`` sums them — the totals through the
    kernel's counters, and each shard's vector through the plane's own
    direct step.  One launch a device (``DeviceMesh.runs``) each time."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch.ops.kernels.field_extract import \
        plain_counts
    m = sk.batch_multiple
    n_runs = len(sk.plane.mesh.runs())
    B = rows.shape[0]
    before = sk.launches
    base = sk.materialize_stats()
    ok, off, ln = (t.numpy() for t in sk(rows, lengths))
    if sk.launches - before != n_runs:
        fail(f"K8 on {m} shards made {sk.launches - before} launches, not "
             f"{n_runs} (one a device)")
    for g, w, what in zip((ok, off, ln), k1_out, ("ok", "cap_off",
                                                   "cap_len")):
        stats["k8_max_abs_err"] = max(stats["k8_max_abs_err"], int(np.abs(
            g[:B].astype(np.int64) - w.astype(np.int64)).max(initial=0)))
        if not (g[:B] == w).all():
            bad = np.nonzero((g[:B] != w).reshape(B, -1).any(axis=1))[0]
            fail(f"K8 ({m} shards) != K1 on {what} for {pattern!r} at "
                 f"L={rows.shape[1]}, B={B}, rows {bad[:5].tolist()}")
    Bp = ok.shape[0]
    want_ok = np.concatenate([plain_ok, np.full(Bp - B,
                                                rx.fullmatch(b"") is not None)])
    lens = np.concatenate([lengths, np.zeros(Bp - B, np.int32)])
    s = Bp // m
    per_shard = [plain_counts(torch.from_numpy(want_ok[i * s:(i + 1) * s]),
                              torch.from_numpy(lens[i * s:(i + 1) * s]))
                 for i in range(m)]
    want = sum(per_shard).tolist()
    tot = sk.materialize_stats()
    got = [tot[k] - base[k] for k in ("matched", "events", "bytes")]
    if got != want:
        fail(f"K8 ({m} shards) counts {got} != the plain K8's {want} for "
             f"{pattern!r} at L={rows.shape[1]}, B={B}")
    prows = np.zeros((Bp, rows.shape[1]), np.uint8)
    prows[:B] = rows
    *_, counts = sk.plane(torch.from_numpy(prows), torch.from_numpy(lens))
    if counts.tolist() != [c.tolist() for c in per_shard]:
        fail(f"K8 ({m} shards) per-shard counts {counts.tolist()} != the "
             f"plain K8's {[c.tolist() for c in per_shard]} for {pattern!r} "
             f"at L={rows.shape[1]}, B={B}")
    stats["k8_checks"] += 1
    stats["k8_pad_rows"] += Bp - B


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
    import torch
    from loongcollector_tpu_torch.parallel.mesh import (ShardedKernel,
                                                        make_mesh)
    stats = {"checks": 0, "rows": 0, "max_abs_err": 0, "patterns": 0,
             "k8_checks": 0, "k8_pad_rows": 0, "k8_max_abs_err": 0}
    card = torch.device("cuda", torch.cuda.current_device())
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
    # K8 (phase 24): an empty-matching pattern at an odd B, whose padding
    # rows are ok and counted
    cases.append((EMPTY_MATCH, [b"", b"abc", b"a b", b"x_9"] * 25 + [b"z"]))
    fxc.reset_launch_shapes()
    for pat, lines in cases:
        kern = ExtractKernel(compile_tier1(pat))
        k8 = [ShardedKernel(kern.program, make_mesh(devices=[card] * m),
                            kernel=kern) for m in (1, 3, 4)]
        stats["patterns"] += 1
        lines = list(lines) + [b"", b""]
        need = pick_length_bucket(max(len(x) for x in lines))
        for L in (L for L in LENGTH_BUCKETS if L >= need):
            check_batch(kern, pat, lines + exact_length_lines(rng, lines, L),
                        L, stats, k8=k8)
    # a width that is not a multiple of 16 bytes, and rows that do not
    # start on a 16-byte boundary, take the kernel's byte-copy staging
    odd = [x for x in gen_lines(300, seed=7) if len(x) <= 100] + [b""]
    kern = ExtractKernel(compile_tier1(APACHE))
    check_batch(kern, APACHE, odd, 100, stats, k8=[ShardedKernel(
        kern.program, make_mesh(devices=[card] * 4), kernel=kern)])
    check_batch(kern, APACHE, odd, 128, stats, misalign=True)
    log(f"parity: {stats['checks']} (pattern, L) batches over "
        f"{stats['patterns']} patterns, {stats['rows']} rows: kernel "
        f"bit-exact with the plain version and with re")
    log(f"K8 parity: {stats['k8_checks']} batches through meshes of 1, 3 "
        f"and 4 shards on {card} (one launch a mesh): ok, cap_off, cap_len "
        f"bit-exact with K1, each shard's counts exact with the plain K8 "
        f"({stats['k8_pad_rows']} padding rows of the pad buffer counted)")
    k8_shapes = {sh: n for sh, n in fxc.launch_shapes.items()
                 if sh.entry_point in fxc.STATS_ENTRY_POINTS}
    k8_launched = sorted({sh.entry_point for sh in k8_shapes})
    log(f"K8 parity: launches by instantiation {k8_launched}")
    if k8_launched != sorted(fxc.STATS_ENTRY_POINTS):
        fail(f"K8 instantiations never launched in parity: "
             f"{sorted(set(fxc.STATS_ENTRY_POINTS) - set(k8_launched))}")
    checked_shapes(k8_shapes, "K8 parity")
    stats["k8_launches"] = sum(k8_shapes.values())
    shapes = checked_shapes({sh: n for sh, n in fxc.launch_shapes.items()
                             if sh.entry_point in fxc.ENTRY_POINTS},
                            "parity")
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
                    threads: int, ledger: bool = False,
                    sharded: bool = False, keep: bool = False) -> dict:
    """The Apache main path through the agent; with ``sharded`` in
    ``LOONG_SHARDED=1`` mode (phase 25: K8 on the one-card mesh).  With
    ``keep`` the NDJSON stays on disk (``out_path`` in the result)."""
    from loongcollector_tpu_torch.ops.xprof import LEGS
    from loongcollector_tpu_torch.testdata import APACHE_KEYS
    run_dir = os.path.join(tmp, f"{'sharded' * sharded}threads{threads}"
                                f"{'ledger' * ledger}")
    os.makedirs(run_dir)
    out_path = os.path.join(run_dir, "out.json")
    stats_path = os.path.join(run_dir, "stats.json")
    cfg_dir = write_config(run_dir, log_path, out_path)
    tag = (f"{'sharded ' * sharded}main path, {threads} "
           f"worker{'s' if threads > 1 else ''}{', ledger on' * ledger}")
    env = {"LOONG_SHARDED": "1"} if sharded else {}
    st, wall = run_agent(tag, cfg_dir, stats_path, threads, ledger, **env)
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
    if st["re_oversize_rows"] or st["re_tier_rows"]:
        fail(f"{tag}: rows routed to re: {st}")
    legs = st["timeline"]["legs"]
    if sharded:
        shapes = check_sharded(tag, st, lines, n)
        launches = st["mesh"]["k8_launches"]
    else:
        shapes = check_settled(tag, st)
        launches = st["launches"]
        if st["mesh"] is not None:
            fail(f"{tag}: a mesh or a lane outside sharded mode: "
                 f"{st['mesh']}")
    if legs.get("exec", {}).get("count") != launches \
            or legs["exec"]["clock"] != "device":
        fail(f"{tag}: the timeline has no device exec leg for every "
             f"launch: {legs}")
    if not any(sh.B == 8192 for sh, _ in shapes):
        fail(f"{tag}: no launch at B=8192: {shapes}")
    for sh, k in shapes:
        log(f"{tag}: {k} launches of {sh.entry_point} at B={sh.B} "
            f"L={sh.L}: {sh.blocks} blocks of {sh.threads} threads, "
            f"{sh.smem} bytes of shared memory")
    mbps = n_bytes / st["seconds"] / 1e6
    log(f"{tag}: {n} records equal the re oracle in order; "
        f"{launches} launches = {st['device_batches']} device "
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
    if not keep:
        os.unlink(out_path)
    return {"stats": st, "mbps": mbps, "wall_s": wall, "shapes": shapes,
            "out_path": out_path if keep else None}


def check_sharded(tag, st, lines, n_records) -> list:
    """A sharded run on the card (``LOONG_SHARDED=1``, one card: a one-
    shard mesh): one sharded kernel, whose dispatches = K8 launches =
    device batches = plane dispatches = exec legs = h2d legs of shard 0,
    no standalone K1 launch, totals (events, bytes, matched) equal to the
    log's lines, bytes and the records; the plane settles.  Returns K8's
    launch shapes."""
    from loongcollector_tpu_torch.ops.kernels.field_extract_cuda import \
        LaunchShape
    mesh, plane, ring = st["mesh"], st["plane"], st["ring"]
    if mesh is None or len(mesh["kernels"]) != 1:
        fail(f"{tag}: want one sharded kernel: {mesh}")
    k = mesh["kernels"][0]
    legs = st["timeline"]["legs"]
    h2d = mesh["shard_legs"].get("h2d", {})
    if k["chips"] != 1 or len(k["devices"]) != 1 or mesh["router"] \
            or st["launches"] or st["launch_shapes"]:
        fail(f"{tag}: chips {k['chips']} on {k['devices']}, lanes "
             f"{mesh['router']}, standalone K1 launches {st['launches']}")
    if not (0 < k["dispatches"] == k["launches"] == mesh["k8_launches"]
            == st["device_batches"] == plane["dispatches"]
            == legs["exec"]["count"] == h2d.get("0", {}).get("count")):
        fail(f"{tag}: mesh dispatches {k['dispatches']}, K8 launches "
             f"{k['launches']}, device batches {st['device_batches']}, "
             f"plane dispatches {plane['dispatches']}, exec legs "
             f"{legs['exec']['count']}, shard h2d legs {h2d}")
    want = {"matched": n_records, "events": sum(1 for x in lines if x),
            "bytes": sum(len(x) for x in lines)}
    if k["totals"] != want:
        fail(f"{tag}: mesh totals {k['totals']}, from the log {want}")
    if plane["inflight_bytes"] or ring["leased"] \
            or st["device_memory"]["total_live_bytes"] \
            or ring["leases"] != ring["returns"]:
        fail(f"{tag}: the plane did not settle: in flight "
             f"{plane['inflight_bytes']} bytes, ring {ring}, memory "
             f"{st['device_memory']}")
    shapes = checked_shapes({LaunchShape(**{f: v for f, v in d.items()
                                            if f != "launches"}):
                             d["launches"] for d in mesh["launch_shapes"]},
                            tag)
    if sum(n for _, n in shapes) != k["launches"]:
        fail(f"{tag}: K8 launch shapes do not add up to its launches")
    log(f"{tag}: mesh of {k['chips']} shard on {k['devices']}: "
        f"{k['dispatches']} dispatches = {k['launches']} K8 launches = "
        f"device batches = plane dispatches = exec legs = shard-0 h2d legs "
        f"(median {h2d['0']['median_s'] * 1e3:.4f} ms); totals "
        f"{k['totals']} = the log's lines, bytes and records; per-chip row "
        f"occupancy {k['per_chip_row_occupancy']}, pad fallbacks "
        f"{k['pad_fallbacks']}")
    return shapes


def bound_ms(B: int, C: int, prog_words: int, row_bytes: int,
             shards: int = 0):
    """Least time for the work: bytes moved at HBM rate vs one 32-bit op per
    examined row byte at the non-tensor rate; returns (ms, bound_by).  The
    function reads only the bytes below each row's length (`row_bytes`, the
    sum of the lengths), plus the lengths and the program, and writes
    ok/cap_off/cap_len for all B rows; K8 (``shards`` > 0) also writes its
    three 8-byte counts a shard."""
    moved = row_bytes + 4 * B + 4 * prog_words + B * (8 * C + 1) \
        + 24 * shards
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
    from loongcollector_tpu_torch.ops.kernels.field_extract import (
        ExtractKernel, extract_stats_plain, fold_pieces, plain_counts)
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
        # K8 (phase 24) at the same shape: one shard, and the four shards of
        # the one-card mesh in the same launch; K1's walk and the count
        # epilogue, held against K1 and the plain K8 per shard first
        for m in (1, 4):
            s = B // m
            got8 = [t.cpu().numpy() for t in kern.with_stats(
                rows, lengths, shard_rows=s)]
            folded = fold_pieces(got8[3], B, s).numpy()
            want8 = np.stack([plain_counts(
                torch.from_numpy(want[0][i * s:(i + 1) * s]),
                lengths[i * s:(i + 1) * s].cpu()).numpy() for i in range(m)])
            if not all((g == w).all() for g, w in zip(got8, got)) \
                    or not (folded == want8).all():
                fail(f"K8 timing B={B}, {m} shards: K8 != K1 or counts "
                     f"{folded.tolist()} != {want8.tolist()}")
        k8_ms = graph_ms([lambda: kern.with_stats(rows, lengths)])
        k8_cold_ms = graph_ms([lambda r=r, n=n: kern.with_stats(r, n)
                               for r, n in copies],
                              reps=n_copies * -(-50 // n_copies), iters=5,
                              keep_outputs=True)
        k8_call_ms = time_cuda(lambda: kern.with_stats(rows, lengths), 200)
        k8_4_ms = graph_ms([lambda: kern.with_stats(rows, lengths,
                                                    shard_rows=B // 4)])
        del copies
        plain_ms = time_cuda(lambda: kern.plain(rows, lengths), 20)
        k8_plain_ms = time_cuda(lambda: extract_stats_plain(
            rows, lengths, kern.plain), 20)
        b_ms, by = bound_ms(B, 9, prog_words, int(lens.sum()))
        k8_b_ms, k8_by = bound_ms(B, 9, prog_words, int(lens.sum()),
                                  shards=1)
        mbps = int(lens.sum()) / (ms * 1e-3) / 1e6
        all_shapes = checked_shapes(dict(fxc.launch_shapes),
                                    f"timing B={B}")
        shapes = [(sh, n) for sh, n in all_shapes
                  if sh.entry_point in fxc.ENTRY_POINTS]
        k8_shapes = [(sh, n) for sh, n in all_shapes
                     if sh.entry_point in fxc.STATS_ENTRY_POINTS]
        if len(shapes) != 1 or len(k8_shapes) != 1:
            fail(f"timing B={B}: launches of more than one shape: "
                 f"{all_shapes}")
        sh = shapes[0][0]
        out[B] = {"ms": ms, "cold_ms": cold_ms, "call_ms": call_ms,
                  "parse_mbps": mbps, "plain_ms": plain_ms,
                  "bound_ms": b_ms, "bound_by": by, "real_rows": n_real,
                  "blocks": sh.blocks, "threads": sh.threads,
                  "smem": sh.smem, "copies": n_copies,
                  "k8": {"ms": k8_ms, "cold_ms": k8_cold_ms,
                         "call_ms": k8_call_ms, "plain_ms": k8_plain_ms,
                         "four_shards_ms": k8_4_ms,
                         "bound_ms": k8_b_ms, "bound_by": k8_by,
                         "over_k1": k8_ms / ms,
                         "cold_over_k1": k8_cold_ms / cold_ms,
                         "entry_point": k8_shapes[0][0].entry_point,
                         "blocks": k8_shapes[0][0].blocks,
                         "threads": k8_shapes[0][0].threads}}
        log(f"timing B={B} L=128 C=9 ({n_real} Apache rows; as launched: "
            f"{sh.blocks} blocks of {sh.threads} threads, {sh.smem} bytes "
            f"of shared memory): kernel {ms:.5f} ms warm and {cold_ms:.5f} "
            f"ms cold ({n_copies} copies) on the device (graph replay), "
            f"{call_ms:.4f} ms per wrapper call, plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.5f} ms ({by}); regex-parse {mbps:.1f} MB/s")
        log(f"K8 timing B={B} L=128 C=9 (one shard, same rows): "
            f"{k8_ms:.5f} ms warm and {k8_cold_ms:.5f} ms cold (graph "
            f"replay) = {k8_ms / ms:.3f} / {k8_cold_ms / cold_ms:.3f} x K1; "
            f"four shards in the launch {k8_4_ms:.5f} ms warm; "
            f"{k8_call_ms:.4f} ms per wrapper call, plain K8 "
            f"{k8_plain_ms:.3f} ms, bound {k8_b_ms:.5f} ms ({k8_by})")
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
    against re.fullmatch (``patterns`` None: no regex, the plain version
    alone), for one (automaton, L) batch."""
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
    stats["checks"] += 1
    stats["rows"] += len(lines)
    if patterns is None:
        return
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
    if kern.mode == "tags":
        stats["bit31_rows"] += int((got.view(np.uint32)[:len(lines)]
                                    >> 31 & 1).sum())


def checked_dfa_shapes(shapes, phase: str) -> list:
    """K2/K4 launches as (shape, launches): whole warps within the block
    limit, as ``dsc.geometry`` gives them (K2 and K3: a block for each SM
    once a batch holds 32 rows an SM; K4: 128 threads), a block for every
    ``threads`` rows, the tables within 48 KB."""
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda as dsc
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    mode_of = {e: m for m, e in dsc.ENTRY_POINTS.items()}
    out = sorted(shapes.items(), key=lambda kv: (kv[0].entry_point,
                                                 kv[0].B, kv[0].L))
    for sh, _n in out:
        mode = mode_of[sh.entry_point]
        if (sh.threads % 32 or not dsc.MIN_THREADS <= sh.threads
                <= dsc.MAX_THREADS or sh.S > dsc.MAX_STATES
                or sh.threads != dsc.geometry(mode, sh.B)
                or sh.smem != dsc.smem_bytes(sh.S, skip=mode == "tags")
                or sh.smem > 48 * 1024
                or sh.blocks != -(-sh.B // sh.threads)
                or mode != "tags" and sh.B >= 32 * fxc.NUM_SMS
                and sh.blocks < fxc.NUM_SMS):
            fail(f"{phase}: DFA launch outside the card's limits: {sh}")
    if not out:
        fail(f"{phase}: no DFA kernel launch recorded")
    return out


def table_kernel(cls, arrays):
    """A ``cls`` (K2 or K4 wrapper) over bare ``AutomatonArrays``."""
    from loongcollector_tpu_torch.ops.kernels.dfa_scan import \
        _TableWalkKernel
    kern = cls.__new__(cls)
    _TableWalkKernel.__init__(kern, arrays)
    return kern


def settle_batches(cases, stats) -> None:
    """The settled exit's adversarial batches (``testdata.settle_rows``:
    rows that never settle, settle on their last byte or at 16- and
    512-byte edges +-1, lengths 0, 1, 511..513 and 4096) for K2 on
    JAVA_FILTER and K4 on the start/continue set, and a seeded automaton at
    the 128-state cap (``testdata.cap_automaton``, held against the plain
    version only), at L = 128, 1024 and 4096."""
    import numpy as np
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.kernels.dfa_scan import (
        FusedScanKernel, settled_last)
    by_pats = {tuple(p): k for k, p in cases}
    rng = np.random.default_rng(9)
    stats["settle_rows"] = 0
    for L in (128, 1024, 4096):
        for kind, pats in (("java_filter", [td.JAVA_FILTER]),
                           ("java_start_continue",
                            [td.JAVA_START, td.JAVA_CONTINUE])):
            kern = by_pats[tuple(pats)]
            if kern.arrays.first_settled >= kern.arrays.num_states:
                fail(f"{kind}: no settled state to exit at")
            lines = td.settle_rows(kind, L, seed=L)
            check_dfa_batch(kern, pats, lines, L, stats)
            stats["settle_rows"] += len(lines)
        cap = table_kernel(FusedScanKernel,
                           settled_last(*td.cap_automaton(seed=L)))
        lines = [bytes(rng.integers(65, 91, int(n), dtype=np.uint8))
                 for n in rng.integers(0, L + 1, 200)]
        lines += [bytes(rng.integers(65, 90, n, dtype=np.uint8))
                  for n in (L, 511, 512, 513) if n <= L]
        check_dfa_batch(cap, None, lines, L, stats)
        stats["settle_rows"] += len(lines)
    stats["automata"].append(("cap", 128, cap.arrays.first_settled))


def skip_batches(cases, stats) -> None:
    """K4's skip rows (``testdata.skip_rows``: one escape byte at each
    16-byte word edge +-1, exactly at the length and one past it, inside
    the row, or none; bytes past each length left in the tile) for the
    path's start/continue set (header lines and frames, whose `.*` tails
    only `\\n` leaves) and for ``SKIP4_SET`` (a state of exactly four
    escape bytes, a skip state, and one of five, not one), at L = 128, 256
    and 4096: bit-exact with the plain version and with ``re.fullmatch``
    of each row cut at its length."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.kernels.dfa_scan import FusedScanKernel
    from loongcollector_tpu_torch.ops.regex.fuse import compile_fused
    by_pats = {tuple(p): k for k, p in cases}
    skip4 = FusedScanKernel(compile_fused(td.SKIP4_SET))
    if sorted(skip4.arrays.n_escapes[skip4.arrays.n_escapes > 0]) != [4]:
        fail(f"SKIP4_SET's skip states changed: {skip4.arrays.n_escapes}")
    stats["skip_rows"] = 0
    for L in (128, 256, 4096):
        for pats, kinds in (((td.JAVA_START, td.JAVA_CONTINUE),
                             ("java", "java_frame")),
                            (tuple(td.SKIP4_SET), ("skip4", "skip5"))):
            kern = by_pats.get(pats, skip4)
            pairs = [pr for k in kinds for pr in td.skip_rows(k, L, seed=L)]
            rows_h, lens_h = td.skip_matrix(pairs, L)
            rows = torch.from_numpy(rows_h).cuda()
            lengths = torch.from_numpy(lens_h).cuda()
            got = kern(rows, lengths).cpu().numpy()
            torch.cuda.synchronize()
            want = kern.plain(rows, lengths).cpu().numpy()
            if not (got == want).all():
                bad = np.nonzero(got != want)[0]
                fail(f"K4 skip rows {kinds} L={L}: kernel != plain at rows "
                     f"{bad[:5].tolist()}")
            rxs = [re.compile(p.encode("latin-1")) for p in pats]
            for i, (row, n) in enumerate(pairs):
                tags = sum(1 << b for b, r in enumerate(rxs)
                           if r.fullmatch(row[:n]))
                if int(got.view(np.uint32)[i]) != tags:
                    fail(f"K4 disagrees with re on {pats!r} {row[:n]!r}")
            stats["checks"] += 1
            stats["rows"] += len(pairs)
            stats["skip_rows"] += len(pairs)


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
    settle_batches(cases, stats)
    skip_batches(cases, stats)
    shapes = checked_dfa_shapes(dict(dsc.launch_shapes), "dfa parity")
    if sum(n for _, n in shapes) != stats["checks"]:
        fail(f"dfa parity: {sum(n for _, n in shapes)} launches recorded "
             f"for {stats['checks']} batches")
    launched = {sh.entry_point for sh, _ in shapes}
    walks = {dsc.ENTRY_POINTS[m] for m in ("match", "tags")}
    if launched != walks:
        fail(f"DFA entry points never launched: {walks - launched}")
    log(f"dfa parity: {stats['checks']} (automaton, L) batches over "
        f"{len(cases)} automata {stats['automata']}, {stats['rows']} rows "
        f"({stats['settle_rows']} of them the settled exit's, "
        f"{stats['skip_rows']} K4's skip rows): K2 and K4 "
        f"bit-exact with their plain versions and with re; "
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
    over L/2 (so the batch needs its bucket; at the pool's first row if
    none is), cycled to 7/8 of B; the rest are padding rows."""
    fit = [x for x in pool if len(x) <= L]
    first = next((i for i, x in enumerate(fit) if len(x) > L // 2), 0)
    n = B - B // 8
    return [fit[(first + i) % len(fit)] for i in range(n)]


def bench_rows(pool, B, L):
    """B rows of the pool within (lo, L], lo 128 for L=1024 else 0, cycled:
    the fixed bench points at L=128 and L=1024."""
    lo = 128 if L == 1024 else 0
    src = [x for x in pool if lo < len(x) <= L]
    return (src * (B // max(len(src), 1) + 1))[:B]


def adversarial_rows(B, L):
    """K2's adversarial point: ``B`` rows of ``L`` lowercase letters, none
    holding "Exception" or "Error", so no walk settles."""
    import numpy as np
    rng = np.random.default_rng(4096)
    data = rng.integers(0x61, 0x7B, (B, L), dtype=np.uint8)
    return [bytes(r) for r in data]


def phase_dfa_path_shapes(java, path2_runs) -> dict:
    """K2 and K4 at every (B, L) path 2 launched, on that run's own rows,
    against the plain version (bit-exact) and re, then warm and cold
    timing there, at the fixed bench points and (K2) at the adversarial
    point: B=2048, L=4096, every row 4096 bytes, none
    settling.  The bound counts the row bytes up to each row's settle point
    (``dfa_scan.settle_points``); ``bound_ms_lengths`` counts every byte
    below the lengths."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.device_batch import pack_rows
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda as dsc
    from loongcollector_tpu_torch.ops.kernels.dfa_scan import (
        DFAMatchKernel, FusedScanKernel, settle_points)
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
    points.append(("K2", 2048, 4096, "adversarial"))
    out = {}
    for name, B, L, kind in points:
        kern, pool, pats = kerns[name]
        lines = (adversarial_rows(B, L) if kind == "adversarial"
                 else (path_rows if kind == "path" else bench_rows)(
                     pool, B, L))
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
        walked = int(settle_points(kern.arrays, batch.rows,
                                   batch.lengths).sum())
        out_bytes = 1 if name == "K2" else 4
        touched = walked + 4 * B + out_bytes * B
        n_copies = max(8, -(-2 * L2_BYTES // touched))
        copies = [(rows.clone(), lengths.clone()) for _ in range(n_copies)]
        cold_ms = graph_ms([lambda r=r, n=n: kern(r, n) for r, n in copies],
                           reps=n_copies * -(-50 // n_copies), iters=5,
                           keep_outputs=True)
        del copies
        plain_ms = time_cuda(lambda: kern.plain(rows, lengths), 5)
        S = kern.arrays.num_states
        b_ms, by = dfa_bound_ms(B, S, walked, out_bytes)
        b_len_ms, by_len = dfa_bound_ms(B, S, int(lens.sum()), out_bytes)
        out[(name, B, L, kind)] = {
            "ms": ms, "cold_ms": cold_ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "bound_ms_lengths": b_len_ms, "bound_by_lengths": by_len,
            "rows": len(lines), "row_bytes": int(lens.sum()),
            "walked_bytes": walked,
            "longest": int(lens.max()), "blocks": sh.blocks,
            "threads": sh.threads, "smem": sh.smem, "S": sh.S,
            "first_settled": kern.arrays.first_settled,
            "copies": n_copies}
        log(f"{name} {kind} B={B} L={L} S={sh.S} ({len(lines)} rows, longest "
            f"{int(lens.max())}, {int(lens.sum())} row bytes, {walked} up "
            f"to the settle points; {sh.blocks} blocks of {sh.threads} "
            f"threads, {sh.smem} bytes of shared memory): bit-exact with the "
            f"plain version and re; kernel {ms:.5f} ms warm and "
            f"{cold_ms:.5f} ms cold ({n_copies} copies) on the device (graph "
            f"replay), {call_ms:.4f} ms per wrapper call, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.6f} ms ({by}; {b_len_ms:.6f} ms "
            f"over every byte below the lengths)")
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


# automata whose length gate turns rows away (phase 10): the delimiter
# filter's literals, a bounded repeat, and two whose accepted lengths have
# holes (the gate's bitmap; the second accepts the empty span); words of
# the gated lengths and of the lengths beside them
GATED_PATTERNS = ["ERROR|WARN", "healthcheck", "a{2,5}", "ab|abcd",
                  "(?:ab)*"]
GATED_WORDS = [b"ERROR", b"WARN", b"WARNS", b"ERRO", b"healthcheck",
               b"healthchecks", b"aa", b"aaaaa", b"aaaaaa", b"ab", b"abc",
               b"abcd", b"abab", b""]


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
    from loongcollector_tpu_torch.ops.kernels.dfa_scan import (
        DFASpanMatchKernel, length_gate)
    from loongcollector_tpu_torch.ops.regex.dfa import compile_dfa
    rng = np.random.default_rng(20261018)
    stats = {"checks": 0, "rows": 0, "max_abs_err": 0, "matched": 0}
    dsc.reset_launch_shapes()
    pats = DFA_PATTERNS + [td.JAVA_FILTER, td.JAVA_CONTINUE, td.LIMIT_DFA,
                           td.APACHE_FILTER_INCLUDE["status"],
                           td.APACHE_FILTER_EXCLUDE["url"]] + GATED_PATTERNS
    stats["gated"] = {}
    for pat in pats:
        kern = DFASpanMatchKernel(compile_dfa(pat))
        rx = re.compile(pat.encode())
        for L, mis in [(L, False) for L in LENGTH_BUCKETS] + [
                (100, False), (128, True)]:
            lines = dfa_lines(rng, [pat], java, L) + [
                b"404", b"/health", b"500", b"x/health"] + GATED_WORDS
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
            if pat in GATED_PATTERNS:
                # the rows the gate turns away: a span present, its walked
                # length outside the accepted lengths
                ln = np.clip(batch.lengths.astype(np.int64), 0, L)
                lo = np.maximum(starts.astype(np.int64), 0)
                hi = np.minimum(starts.astype(np.int64)
                                + np.maximum(spans, 0), ln)
                gate = length_gate(kern.arrays, L)
                away = (spans >= 0) & ~gate.passes(np.maximum(hi - lo, 0))
                g = stats["gated"].setdefault(pat, [0, 0])
                g[0] += int(away.sum())
                g[1] += len(spans)
    shapes = checked_dfa_shapes(dict(dsc.launch_shapes), "span parity")
    if sum(n for sh, n in shapes if sh.entry_point
           == dsc.ENTRY_POINTS["span"]) != stats["checks"]:
        fail(f"span parity: launches recorded {shapes} for "
             f"{stats['checks']} batches")
    log(f"span parity: {stats['checks']} (automaton, L) batches over "
        f"{len(pats)} automata, {stats['rows']} rows ({stats['matched']} "
        f"spans matched): K3 bit-exact with its plain version and with re; "
        f"rows the length gate turned away / rows, by gated automaton: "
        + ", ".join(f"{p!r} {a} / {n}" for p, (a, n) in
                    stats["gated"].items()))
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
    # programs and automata in device memory, and a keep of three or more
    # conditions, among the lists the kernel held
    placed = {k for p in programs.values()
              for k, where in p.descriptor.placement.items()
              if where == "device"}
    if not any("." not in k for k in placed) \
            or not any(".cond" in k for k in placed):
        fail(f"fused parity: no stage list left a program and an automaton "
             f"in device memory: {sorted(placed)}")
    if max(len(st.conds) for _, specs, _ in td.fused_stage_lists()
           for st in fp.kernel_stages(specs)) < 3:
        fail("fused parity: no keep stage of three or more conditions")
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


def phase_logical_mesh(tmp, log_path, lines, base_out, filt) -> dict:
    """Phase 26, in this process: the JAX tests' multiple-device scenario
    (``tests/test_loongmesh.py:212-260``) on the one card, whose device
    list repeats ``cuda:0``.  (a) Four chip lanes
    (``chip_lanes.reset_for_testing([cuda:0] * 4)``) under four workers:
    the lanes' dispatches add up to the engines' device batches and K1's
    launches, and the NDJSON is byte-identical to phase 3's one-worker
    run.  (b) A four-shard mesh on the card (the engine's sharded kernel
    over ``[cuda:0] * 4``): one K8 launch a dispatch for the card's four
    shards, one h2d leg (one copy an input), one exec leg a dispatch,
    totals equal to the log's, the NDJSON byte-identical again.  (c) The Apache-filter config with four lanes:
    K7 launches = fused dispatches = the lanes' dispatches, and the records
    equal phase 12's."""
    import torch
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.application import run_once
    from loongcollector_tpu_torch.ops import chip_lanes
    from loongcollector_tpu_torch.ops.regex import engine as engine_mod
    from loongcollector_tpu_torch.parallel.mesh import (ShardedKernel,
                                                        make_mesh)
    from loongcollector_tpu_torch.utils.device import resolve_device
    device = resolve_device(None)
    card = torch.device("cuda", torch.cuda.current_device())
    with open(base_out, "rb") as f:
        base = f.read()
    out = {}

    def run(tag, threads, cfg_text=None):
        run_dir = os.path.join(tmp, f"logical_{tag}")
        os.makedirs(run_dir)
        out_path = os.path.join(run_dir, "out.json")
        if cfg_text is None:
            cfg_dir = write_config(run_dir, log_path, out_path)
        else:
            cfg_dir = os.path.join(run_dir, "config")
            os.makedirs(cfg_dir)
            with open(os.path.join(cfg_dir, "p.yaml"), "w") as f:
                f.write(cfg_text(out_path))
        old = os.environ.get("LOONG_PROCESS_THREADS")
        os.environ["LOONG_PROCESS_THREADS"] = str(threads)
        try:
            st = run_once(cfg_dir, device)
        finally:
            if old is None:
                os.environ.pop("LOONG_PROCESS_THREADS")
            else:
                os.environ["LOONG_PROCESS_THREADS"] = old
        with open(out_path, "rb") as f:
            data = f.read()
        os.unlink(out_path)
        return data, st

    def lanes_of(st):
        router = (st["mesh"] or {}).get("router")
        if not router or router["lane_count"] != 4:
            fail(f"logical lanes: no four lanes in the run's stats: "
                 f"{st['mesh']}")
        return router["lanes"]

    # (a) four lanes on the card, four workers
    engine_mod.clear_engine_cache()
    chip_lanes.reset_for_testing([card] * 4)
    data, st = run("lanes", 4)
    lanes = lanes_of(st)
    per_lane = [ln["dispatches"] for ln in lanes]
    if data != base \
            or not (0 < st["launches"] == st["device_batches"]
                    == sum(per_lane) == st["plane"]["dispatches"]) \
            or any(ln["inflight_bytes"] for ln in lanes) or st["mesh"][
                "kernels"]:
        fail(f"logical lanes (a): NDJSON equal {data == base}, lane "
             f"dispatches {per_lane}, device batches "
             f"{st['device_batches']}, K1 launches {st['launches']}")
    log(f"logical lanes (a): four lanes on {card}, four workers: NDJSON "
        f"byte-identical to the one-worker run ({len(data)} bytes); lane "
        f"dispatches {per_lane} = {st['device_batches']} device batches = "
        f"K1 launches; pipeline {st['seconds']:.3f} s")
    out["lanes_dispatches"] = per_lane
    out["lanes_seconds"] = st["seconds"]

    # (b) a four-shard mesh on the card, one worker
    engine_mod.clear_engine_cache()
    chip_lanes.reset_for_testing()
    eng = engine_mod.get_engine(APACHE, device)
    eng._sharded = ShardedKernel(eng.kernel.program,
                                 make_mesh(devices=[card] * 4),
                                 kernel=eng.kernel)
    # the mesh counters are the process's, per chip count (phase 24's
    # four-shard meshes added to them): this run's are the differences
    before = eng._sharded.status()
    data, st = run("mesh4", 1)
    mesh = st["mesh"] or {"kernels": []}
    k4 = [k for k in mesh["kernels"] if k["chips"] == 4
          and k["launches"]]
    if len(k4) != 1:
        fail(f"logical mesh (b): the agent did not run the four-shard "
             f"kernel: {st['mesh']}")
    k = dict(k4[0])
    for key in ("dispatches", "pad_fallbacks"):
        k[key] -= before[key]
    k["totals"] = {key: v - before["totals"][key]
                   for key, v in k["totals"].items()}
    h2d = mesh["shard_legs"].get("h2d", {})
    legs = st["timeline"]["legs"]
    want = {"matched": len(lines), "events": len(lines),
            "bytes": sum(len(x) for x in lines)}
    if data != base or k["totals"] != want \
            or not (0 < k["dispatches"] == st["device_batches"]
                    == st["plane"]["dispatches"] == legs["exec"]["count"])\
            or k["launches"] != k["dispatches"] \
            or sorted(h2d) != ["0"] \
            or any(v["count"] != k["dispatches"] for v in h2d.values()) \
            or st["launches"] or k["pad_fallbacks"]:
        fail(f"logical mesh (b): NDJSON equal {data == base}, {k}, h2d "
             f"legs {h2d}, exec legs {legs['exec']}, device batches "
             f"{st['device_batches']}, standalone K1 {st['launches']}")
    out["mesh4"] = {"dispatches": k["dispatches"], "launches": k["launches"],
                    "seconds": st["seconds"],
                    "submit_median_ms": legs["submit"]["median_s"] * 1e3,
                    "h2d_median_ms": {s_: v["median_s"] * 1e3
                                      for s_, v in h2d.items()},
                    "exec_median_ms": legs["exec"]["median_s"] * 1e3,
                    "stage_seconds": st["stage_seconds"]}
    log(f"logical mesh (b): four shards on {card}: NDJSON byte-identical; "
        f"{k['dispatches']} dispatches = {k['launches']} K8 launches (one a "
        f"dispatch for the four shards), one h2d leg a dispatch (medians ms "
        + ", ".join(f"{s_} {v['median_s'] * 1e3:.4f}"
                    for s_, v in sorted(h2d.items()))
        + f"), exec legs {legs['exec']['count']} (median "
        f"{legs['exec']['median_s'] * 1e3:.4f} ms), submit median "
        f"{legs['submit']['median_s'] * 1e3:.4f} ms; totals {k['totals']}; "
        f"pipeline {st['seconds']:.3f} s; stage seconds "
        + json.dumps(st["stage_seconds"]))

    # (c) the Apache-filter path on four lanes
    engine_mod.clear_engine_cache()
    chip_lanes.reset_for_testing([card] * 4)
    data, st = run("filter_lanes", 4,
                   lambda o: td.apache_filter_config(log_path, o))
    lanes = lanes_of(st)
    fu = st["fusion"]
    recs = [json.loads(r) for r in data.splitlines()]
    got = [{k_: r.get(k_) for k_ in td.APACHE_KEYS} for r in recs]
    per_lane = [ln["dispatches"] for ln in lanes]
    if len(got) != filt["records"] or got != td.apache_filter_oracle(lines) \
            or not (0 < fu["k7_launches"] == fu["fused_dispatches"]
                    == sum(per_lane) == st["plane"]["dispatches"]) \
            or st["launches"]:
        fail(f"logical lanes (c): {len(got)} records (phase 12: "
             f"{filt['records']}), K7 {fu['k7_launches']}, fused "
             f"{fu['fused_dispatches']}, lanes {per_lane}, standalone K1 "
             f"{st['launches']}")
    log(f"logical lanes (c): the Apache-filter path on four lanes: "
        f"{len(got)} records equal phase 12's; {fu['k7_launches']} K7 "
        f"launches = fused dispatches = lane dispatches {per_lane}")
    chip_lanes.reset_for_testing()
    engine_mod.clear_engine_cache()
    out["filter_lanes_dispatches"] = per_lane
    return out


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


def span_gate_bound_ms(B, S, walked_bytes, n_walked):
    """Least time for one K3 launch counting only what a gated launch must
    read: the lengths, starts and span lengths of every row (12B), the
    bytes of the spans that pass the gate, the table where a row walks,
    and B bytes out — a second column beside ``span_bound_ms``."""
    moved = 12 * B + walked_bytes + (S * 256 + 4 * S if n_walked else 0) + B
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = walked_bytes / INT_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def phase_fused_timing() -> dict:
    """K7 on the Apache-filter program, K3 on the status condition over
    the status spans (shape a) and K3 on the url condition (``/health``)
    over the url spans (shape b), at B=8192 (5,500 Apache rows: one
    main-path chunk) and B=65536, L=128: warm and cold (graph replay),
    each beside its plain version and bound; for K3 the share of rows its
    length gate turns away."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops import fused_pipeline as fp
    from loongcollector_tpu_torch.ops.device_batch import pack_rows
    from loongcollector_tpu_torch.ops.kernels import fused_program_cuda as fpc
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda as dsc
    from loongcollector_tpu_torch.ops.kernels.dfa_scan import length_gate
    specs = dict((n, s) for n, s, _ in td.fused_stage_lists())[
        "apache_filter"]
    program = fp.FusedProgramKernel(specs, "apache_filter")
    span = specs[1].payload[0].staged.kernel
    span_b = specs[1].payload[1].staged.kernel
    status = td.APACHE_KEYS.index("status")
    url = td.APACHE_KEYS.index("url")
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
        k3_in = {}
        for name, kern, cap in (("K3", span, status), ("K3b", span_b, url)):
            st_h = np.ascontiguousarray(off[:, cap])
            sp_h = np.ascontiguousarray(ln[:, cap])
            st_d = torch.from_numpy(st_h).cuda()
            sp_d = torch.from_numpy(sp_h).cuda()
            k3 = kern(rows, lengths, st_d, sp_d).cpu().numpy()
            if not (k3 == kern.plain(rows, lengths, st_d, sp_d)
                    .cpu().numpy()).all():
                fail(f"fused timing B={B}: {name} != plain")
            # the spans lie inside the rows: the walked length is the span's
            walk = (sp_h >= 0) & length_gate(kern.arrays, 128).passes(
                np.maximum(sp_h, 0))
            k3_in[name] = (kern, st_d, sp_d,
                           int(np.clip(sp_h, 0, None).sum()),
                           int(np.clip(sp_h, 0, None)[walk].sum()),
                           int(walk.sum()), int((sp_h >= 0).sum()))
        row_bytes = int(lens.sum())
        span_bytes = k3_in["K3"][3]
        walked = row_bytes + span_bytes + k3_in["K3b"][3]
        cases = [("K7", lambda r, n: program(r, n),
                  lambda: program.plain(rows, lengths),
                  fused_bound_ms(B, row_bytes, walked,
                                 len(program.descriptor.blob), 9, 1))]
        for name in ("K3", "K3b"):
            kern, st_d, sp_d, sb, _, _, _ = k3_in[name]
            cases.append((name,
                          lambda r, n, k=kern, a=st_d, b=sp_d: k(r, n, a, b),
                          lambda k=kern, a=st_d, b=sp_d: k.plain(
                              rows, lengths, a, b),
                          span_bound_ms(B, kern.arrays.num_states, sb)))
        res = {}
        for name, fn, plain, bound in cases:
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
        res["K7"].update(blocks=k7_sh.blocks, threads=k7_sh.threads,
                         smem=k7_sh.smem, instantiation=k7_sh.instantiation)
        for name in ("K3", "K3b"):
            kern, _, _, _, walked_b, n_walk, n_present = k3_in[name]
            k3_sh = next(sh for sh in dsc.launch_shapes
                         if sh.entry_point == dsc.ENTRY_POINTS["span"]
                         and sh.S == kern.arrays.num_states)
            g_ms, g_by = span_gate_bound_ms(B, kern.arrays.num_states,
                                            walked_b, n_walk)
            res[name].update(blocks=k3_sh.blocks, threads=k3_sh.threads,
                             smem=k3_sh.smem, S=k3_sh.S,
                             walked_rows=n_walk, span_rows=n_present,
                             gated_share=1 - n_walk / B,
                             gated_span_share=1 - n_walk / max(n_present, 1),
                             gate_bound_ms=g_ms, gate_bound_by=g_by)
        out[B] = res
        for name, r in res.items():
            log(f"{name} timing B={B} L=128 ({n_real} Apache rows; "
                f"{r['blocks']} blocks of {r['threads']} threads, {r['smem']}"
                f" bytes of shared memory): kernel {r['ms']:.5f} ms warm and "
                f"{r['cold_ms']:.5f} ms cold ({r['copies']} copies) on the "
                f"device (graph replay), {r['call_ms']:.4f} ms per wrapper "
                f"call, plain {r['plain_ms']:.3f} ms, bound "
                f"{r['bound_ms']:.6f} ms ({r['bound_by']})"
                + ("" if name == "K7" else
                   f"; {r['walked_rows']} of {B} rows walk ("
                   f"{r['span_rows']} with a span): the gate turns away "
                   f"{r['gated_span_share']:.4f} of the spans, bound of "
                   f"what a gated launch reads {r['gate_bound_ms']:.6f} ms"))
    return out


# -- slice 6: the metric rollup and K6 ---------------------------------------

K6_TOL = 1e-5       # rtol = atol on sums: scripts/agg_equivalence.py:163
K6_PATH_SHAPE = (8192, 2048)       # B, Gq of a rollup-path fold
K6_PATH_SHAPE_4096 = (8192, 4096)  # the path's other fold shape
K6_BENCH_SHAPE = (65536, 65536)
# (label, (B, Gq), (real rows, segments they take; 1: one hot segment))
K6_TIMED = (("path", K6_PATH_SHAPE, (5000, 1600)),
            ("path_4096", K6_PATH_SHAPE_4096, (5000, 3200)),
            ("hot", K6_PATH_SHAPE, (5000, 1)),
            ("bench", K6_BENCH_SHAPE, (65536, 65536)))


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
    edges, edge_err = k6_edge_parity(kerns[41])
    max_err = max(max_err, edge_err)
    launches = sum(k.launches for k in kerns.values())
    shapes = dict(src.launch_shapes)
    if launches != checks + folds + edges \
            or sum(shapes.values()) != launches:
        fail(f"K6 parity: {launches} launches, {sum(shapes.values())} in "
             f"the shapes, for {checks} batches, {folds} folds and {edges} "
             f"edge batches")
    big = max(shapes, key=lambda sh: (sh.B, sh.G))
    log(f"K6 parity: {checks} batches equal the plain version on the card "
        f"(count, min, max, last, hist exact; sums within rtol = atol = "
        f"{K6_TOL}, largest difference {max_err:.3g}), {folds} folds of the "
        f"gate's device corpora equal the numpy twin, {edges} edge batches "
        f"equal the plain version; {launches} launches of {len(shapes)} "
        f"shapes, the largest B={big.B} G={big.G}: {big.blocks} scatter "
        f"blocks, {big.init_blocks} init blocks")
    return {"checks": checks, "folds": folds, "edges": edges,
            "max_abs_err": max_err}


# (B, G) of K6's edge batches at 41 buckets: the smallest Gq (16), an empty
# batch, the path's Gq 2048 and 4096, an odd G, and B = G = 65536; their
# "boundaries" rows sit on either side of every K6_EDGE_RANGE-th segment
K6_EDGE_GEOMETRIES = ((8192, 16), (0, 2048), (8192, 2048), (8192, 4096),
                      (4096, 2049), (65536, 65536))
K6_EDGE_RANGE = 1024


def k6_edge_parity(kern):
    """K6 against its plain version on the card on the edge batches
    (``testdata.k6_edge_batch``: mixed rows with segments and buckets out of
    range, every row in one segment, rows on either side of every 1024th
    segment with the others empty, no valid row) at
    ``K6_EDGE_GEOMETRIES``.  Returns (batches, largest sum difference)."""
    import torch
    from loongcollector_tpu_torch import testdata as td
    n, max_err = 0, 0.0
    for B, G in K6_EDGE_GEOMETRIES:
        for kind in td.K6_EDGE_KINDS if B else ("empty",):
            arrays = td.k6_edge_batch(kind, B + G, B, G, 41, K6_EDGE_RANGE)
            args = [torch.from_numpy(a).cuda() for a in arrays]
            got = [t.cpu().numpy() for t in kern(*args, G)]
            torch.cuda.synchronize()
            want = [t.cpu().numpy() for t in kern.plain(*args, G)]
            max_err = max(max_err, _k6_compare(
                got, want, f"K6 edge {kind} B={B} G={G}"))
            n += 1
    return n, max_err


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
    for label, (B, G), (n_real, n_seg) in K6_TIMED:
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
        out[label] = {"ms": ms, "cold_ms": cold_ms, "call_ms": call_ms,
                      "plain_ms": plain_ms, "plain_call_ms": plain_call_ms,
                      "bound_ms": b_ms, "bound_by": by, "copies": n_copies,
                      "blocks": sh.blocks, "init_blocks": sh.init_blocks,
                      "B": B, "G": G, "real_rows": n_real,
                      "segments": n_seg}
        log(f"K6 timing {label} B={B} Gq={G} n_hist=41 ({n_real} real rows "
            f"over {n_seg} segments; {sh.blocks} scatter blocks and "
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
    t, tb = timing["path"], timing["bench"]
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
        "points": {label: {k: v[k] for k in (
            "B", "G", "real_rows", "segments", "ms", "cold_ms", "plain_ms",
            "bound_ms", "bound_by")}
            for label, v in timing.items()},
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
        "parity_edge_batches": parity["edges"],
        "path_parity_folds": path_parity["folds"],
        "blocks": t["blocks"],
        "init_blocks": t["init_blocks"],
        "threads": 256,
        "build_s": build["build_s"]["segment_reduce"],
        "ptxas": build["k6_ptxas"],
    }


def fused_kernel_entries(span_parity, fused_parity, timing, filt, filt4,
                         path2, build, k7_struct, pipe) -> list:
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
        # the bound of what a gated launch must read, beside the bound
        "gate_bound_ms": t8["K3"]["gate_bound_ms"],
        # shape b: /health over the url spans, most rows turned away by
        # the length gate before a byte is read
        "shape_b_ms": t8["K3b"]["ms"],
        "shape_b_cold_ms": t8["K3b"]["cold_ms"],
        "shape_b_bound_ms": t8["K3b"]["bound_ms"],
        "shape_b_gate_bound_ms": t8["K3b"]["gate_bound_ms"],
        "shape_b_bench_ms": t64["K3b"]["ms"],
        "gated_row_share": [t8["K3"]["gated_share"], t8["K3b"]["gated_share"],
                            t64["K3"]["gated_share"],
                            t64["K3b"]["gated_share"]],
        "gated_span_share": [t8["K3"]["gated_span_share"],
                             t8["K3b"]["gated_span_share"]],
        "gated_parity_rows": span_parity["gated"],
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
        "stage_kinds": ["extract", "scan", "keep", "struct_index"],
        "struct_index_parity_batches": k7_struct["checks"],
        "struct_index_stage_lists": k7_struct["lists"],
        "delimiter_filter_launches": pipe["stats"]["fusion"]["k7_launches"],
        "delimiter_filter_mbps": pipe["mbps"],
        "build_s": build["build_s"]["fused_program"],
        "ptxas": build["k7_ptxas"],
    }]


def dfa_kernel_entry(name, mode, replaces, parity, timing, path2, path2_4,
                     build, key):
    """The ``kernels`` line's entry of K2 (``key`` "K2") or K4 ("K4"): its
    numbers at the shape path 2 launched most (ties: the larger B)."""
    k = path2["stats"][key.lower()]
    shapes = path2["shapes"][key]
    (main_sh, _n) = max(shapes, key=lambda kv: (kv[1], kv[0].B))
    t = timing[(key, main_sh.B, main_sh.L, "path")]
    fields = ("ms", "cold_ms", "plain_ms", "bound_ms", "bound_ms_lengths",
              "blocks", "threads")

    def points(kind):
        return {f"{B}x{L}": {g: v[g] for g in fields}
                for (k_, B, L, kd), v in sorted(timing.items())
                if k_ == key and kd == kind}
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
        "bound_ms_lengths": t["bound_ms_lengths"],
        "walked_bytes": t["walked_bytes"],
        "row_bytes": t["row_bytes"],
        # no single PyTorch call computes a DFA walk
        "library_ms": None,
        "path_points": points("path"),
        "bench_points": points("bench"),
        "adversarial_points": points("adversarial"),
        "path_device_batches": k["device_batches"],
        "path_host_rows": k["host_rows"],
        "path_kernel_s": k["kernel_seconds"],
        "path_exec_median_ms": k["exec_median_s"] * 1e3,
        "path_exec_max_ms": k["exec_max_s"] * 1e3,
        "path_launches_4_workers": path2_4["stats"][key.lower()]["launches"],
        "path_launch_shapes": [[sh.B, sh.L, sh.S, sh.blocks, n]
                               for sh, n in shapes],
        "threads": main_sh.threads,
        "blocks": main_sh.blocks,
        "smem_bytes": main_sh.smem,
        "build_s": build["build_s"]["dfa_scan"],
        "ptxas": build["dfa_ptxas"][mode],
        **({"skip_states": skip_states(), "parity_skip_rows":
            parity["skip_rows"]} if key == "K4" else {}),
    }


def skip_states() -> list:
    """K4's skip states on path 2's start/continue set, as (state, escape
    bytes)."""
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.kernels.dfa_scan import FusedScanKernel
    from loongcollector_tpu_torch.ops.regex.fuse import compile_fused
    a = FusedScanKernel(compile_fused([td.JAVA_START,
                                       td.JAVA_CONTINUE])).arrays
    return [[int(st), int(a.n_escapes[st])]
            for st in range(a.num_states) if a.n_escapes[st]]


# -- the structural index (K5), K7's struct_index stage, and the
# -- quote-mode CSV, delimiter-filter and json_filter.yaml paths -----------

K5_ODD_L = (1, 15, 16, 17, 33, 100)
K5_EDGE_L = (16, 128, 512, 4096)
K5_SHAPES = ((8192, 128), (65536, 128))
CSV_LINES = 300_000
PIPE_LINES = 600_000
JSON_EVENTS = 100_000
_TIME_FIELD = re.compile(rb'"__time__": \d+')


def k5_rows(rng):
    """Rows for K5's parity: the reference's adversarial rows, seeded rows
    over ``ab\\",{}[]: \\t|``, the three paths' lines, long backslash and
    quote runs, and random bytes."""
    import numpy as np
    from loongcollector_tpu_torch import testdata as td
    rows = td.struct_adversarial_rows()
    rows += [bytes(rng.choice(list(b'ab\\",{}[]: \t|'),
                              size=int(rng.integers(0, 4200))).astype(
                                  np.uint8)) for _ in range(60)]
    rows += td.gen_quoted_csv(60, seed=int(rng.integers(1000)))
    rows += td.gen_pipe_log(60, seed=int(rng.integers(1000)))
    rows += td.gen_json_events(20, seed=int(rng.integers(1000)))
    rows += [b"\\" * k + b'"' * j for k in (31, 32, 33, 63, 64, 65)
             for j in (1, 2)]
    rows += [bytes(rng.integers(0, 256, int(rng.integers(0, 5000)),
                                dtype=np.uint8)) for _ in range(20)]
    return rows


def k5_matrix(rows, L, extra):
    """rows cut to L (a row of exactly L bytes among them), ``extra``
    padding rows, two rows absent (length -1)."""
    import numpy as np
    B = len(rows) + extra
    mat = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, r in enumerate(rows):
        r = r[:L]
        if r:
            mat[i, :len(r)] = np.frombuffer(r, np.uint8)
        lens[i] = len(r)
    lens[1] = lens[len(rows) // 2] = -1
    return mat, lens


def k5_edge_matrix(rng, L):
    """Rows for K5's walk exit: one at each 32-byte step edge and one byte
    either side, at 0, L, L - 1 and -1 (absent), over ``ab\\",{}[]:|``;
    the bytes past each length are quotes and backslashes, which change
    every mask if a walk read them."""
    import numpy as np
    lens = sorted({e for k in range(0, L + 33, 32) for e in (k - 1, k, k + 1)
                   if 0 <= e <= L} | {0, L - 1, L}) + [-1]
    alpha = np.frombuffer(b'ab\\",{}[]:|', np.uint8)
    mat = alpha[rng.integers(0, len(alpha), (len(lens), L))]
    junk = np.frombuffer(b'"\\', np.uint8)[np.arange(L) % 2]
    for i, n in enumerate(lens):
        mat[i, max(n, 0):] = junk[max(n, 0):]
    return mat, np.array(lens, np.int32)


def phase_k5_parity() -> dict:
    """K5 (``lct_struct_index_cuda``) against its plain version on the card
    and the native ``lct_struct_index`` (as 16-bit words), bit-exact, in
    JSON mode and in delimiter mode on ``,`` and ``|``, at every length
    bucket and at L = 1, 15, 16, 17, 33, 100, on ``k5_rows``, with absent
    rows, padding rows and a batch that is not a multiple of the eight rows
    a block.  Then the walk's exit: ``k5_edge_matrix`` rows at L = 16,
    128, 512 and 4096, in both modes, against the plain version, the numpy
    twin of the kernel's schedule (``struct_index_cuda.schedule_twin``) and
    the native index."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch import native
    from loongcollector_tpu_torch.ops.device_batch import LENGTH_BUCKETS
    from loongcollector_tpu_torch.ops.kernels import struct_index as si
    from loongcollector_tpu_torch.ops.kernels import struct_index_cuda as sic
    rng = np.random.default_rng(18)
    rows = k5_rows(rng)
    sic.reset_launch_shapes()
    checks = 0
    for L in K5_ODD_L + LENGTH_BUCKETS:
        mat, lens = k5_matrix(rows, L, 13)
        B = len(mat)
        rd = torch.from_numpy(mat).cuda()
        ld = torch.from_numpy(lens).cuda()
        arena = mat.reshape(-1)
        offs = np.arange(B, dtype=np.int64) * L
        for mode, sep in ((si.MODE_JSON, 0x2C), (si.MODE_DELIM, 0x2C),
                          (si.MODE_DELIM, 0x7C)):
            kern = si.StructIndexKernel(mode, sep)
            got = [t.cpu().numpy() for t in kern(rd, ld)]
            torch.cuda.synchronize()
            want = [t.cpu().numpy() for t in kern.plain(rd, ld)]
            nat = native.struct_index(
                arena, offs, lens, native.STRUCT_MODE_JSON
                if mode == si.MODE_JSON else native.STRUCT_MODE_DELIM, sep,
                W=-(-L // 64))
            for k, name in enumerate(("in_string", "structural", "escaped",
                                      "quote")):
                nw = si.native_masks_as_words16(nat[k])[:, :got[k].shape[1]]
                if not (np.array_equal(got[k], want[k])
                        and np.array_equal(got[k], nw)):
                    bad = np.nonzero((got[k] != want[k]).any(axis=1)
                                     | (got[k] != nw).any(axis=1))[0]
                    fail(f"K5 parity: {mode} sep={sep:#x} L={L}: {name} "
                         f"differs on rows {bad[:8].tolist()}")
            checks += 1
    edges = 0
    for L in K5_EDGE_L:
        mat, lens = k5_edge_matrix(rng, L)
        B = len(mat)
        rd = torch.from_numpy(mat).cuda()
        ld = torch.from_numpy(lens).cuda()
        for mode, sep in ((si.MODE_JSON, 0x2C), (si.MODE_DELIM, 0x7C)):
            kern = si.StructIndexKernel(mode, sep)
            got = np.stack([t.cpu().numpy() for t in kern(rd, ld)])
            torch.cuda.synchronize()
            want = np.stack([t.cpu().numpy() for t in kern.plain(rd, ld)])
            twin, steps = sic.schedule_twin(mat, lens, mode, sep)
            if not np.array_equal(steps, (np.clip(lens, 0, L) + 31) // 32):
                fail(f"K5 twin: steps past the length at L={L}")
            nat = native.struct_index(
                mat.reshape(-1), np.arange(B, dtype=np.int64) * L, lens,
                native.STRUCT_MODE_JSON if mode == si.MODE_JSON
                else native.STRUCT_MODE_DELIM, sep, W=-(-L // 64))
            nw = np.stack([si.native_masks_as_words16(nat[k])[
                :, :got.shape[2]] for k in range(4)])
            for other, what in ((want, "plain version"),
                                (twin, "schedule twin"), (nw, "native")):
                if not np.array_equal(got, other):
                    bad = np.nonzero((got != other).any(axis=(0, 2)))[0]
                    fail(f"K5 step edges: {mode} L={L} != {what} on rows "
                         f"with lengths {lens[bad[:8]].tolist()}")
            checks += 1
            edges += B
    launched = sum(sic.launch_shapes.values())
    if launched != checks:
        fail(f"K5 parity: {launched} launches recorded for {checks} batches")
    log(f"K5 parity: {checks} batches ({len(rows) + 13} rows each, JSON "
        f"and delimiter modes, L {list(K5_ODD_L + LENGTH_BUCKETS)}) "
        f"bit-exact with the plain version and the native lct_struct_index "
        f"on the card; {edges} step-edge rows at L {list(K5_EDGE_L)} equal "
        f"to the plain version, the schedule twin and the native index; "
        f"{launched} launches")
    return {"checks": checks, "edge_rows": edges, "max_abs_err": 0}


def phase_k7_struct_parity() -> dict:
    """K7 with ``struct_index`` stages (``testdata.struct_stage_lists``:
    JSON mode alone, delimiter mode alone, and the pipe delimiter's extract
    + a ``|`` index + the delimiter-filter keep) against the plain
    ``build_fused_fn`` and ``staged_run`` (K1, K5 and K3 launches), bit-exact
    on every output, at L = 128, 512 and 4096, on 301 rows (not whole
    blocks) with padding and absent rows."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops import fused_pipeline as fp
    rng = np.random.default_rng(19)
    checks = 0
    names = []
    for name, specs, rows_fn in td.struct_stage_lists():
        program = fp.FusedProgramKernel(specs, name)
        names.append(name)
        for L in (128, 512, 4096):
            B = 301
            lines = rows_fn(rng, B - 9, L)
            mat, lens = k5_matrix(lines, L, 9)
            rd = torch.from_numpy(mat).cuda()
            ld = torch.from_numpy(lens).cuda()
            (flat,) = program(rd, ld)
            got = [t.cpu() for t in program.split(flat, B)]
            want = [t.cpu() for t in program.plain(rd, ld)]
            staged = [t.cpu() for tup in program.staged_run(rd, ld)
                      for t in tup]
            for k, (g, w, s) in enumerate(zip(got, want, staged)):
                if not (torch.equal(g.reshape(w.shape), w)
                        and torch.equal(s, w)):
                    fail(f"K7 struct parity: {name} L={L}: output {k} "
                         f"({program.descriptor.outputs[k].name}) differs")
            checks += 1
        if program.launches != 3:
            fail(f"K7 struct parity: {name}: {program.launches} K7 launches")
    torch.cuda.synchronize()
    log(f"K7 struct_index parity: {checks} batches of {names} at L 128, "
        f"512, 4096 bit-exact with the plain version and staged_run")
    return {"checks": checks, "lists": names, "max_abs_err": 0}


def write_log(prefix, name, lines):
    tmp = tempfile.mkdtemp(prefix=prefix)
    log_path = os.path.join(tmp, name)
    data = b"\n".join(lines) + b"\n"
    with open(log_path, "wb") as f:
        f.write(data)
    return tmp, log_path, len(data)


def path_run(tmp, tag, config, log_path, threads, **env):
    """One agent run of a config; returns (stats, NDJSON bytes, wall)."""
    run_dir = os.path.join(tmp, re.sub(r"\W+", "_", tag))
    cfg_dir = os.path.join(run_dir, "config")
    os.makedirs(cfg_dir)
    out_path = os.path.join(run_dir, "out.json")
    with open(os.path.join(cfg_dir, "p.yaml"), "w") as f:
        f.write(config(log_path, out_path))
    st, wall = run_agent(tag, cfg_dir, os.path.join(run_dir, "stats.json"),
                         threads, **env)
    with open(out_path, "rb") as f:
        out = f.read()
    os.unlink(out_path)
    return st, out, wall


def check_records(tag, out, want, keys=None) -> int:
    """Every record of ``out`` equals the oracle's, in order, on the
    oracle's keys (``keys``, else each oracle record's own)."""
    recs = out.splitlines()
    if len(recs) != len(want):
        fail(f"{tag}: {len(recs)} records for the oracle's {len(want)}")
    for n, (rec, w) in enumerate(zip(recs, want), 1):
        obj = json.loads(rec)
        got = {k: obj.get(k) for k in (keys or w)}
        if got != w:
            fail(f"{tag}: record {n}: {got} != the oracle's {w}")
    return len(recs)


def k5_stats_line(tag, st) -> dict:
    from collections import Counter
    k5 = st["k5"]
    shapes = Counter({(d["B"], d["L"]): d["launches"]
                      for d in k5["launch_shapes"]})
    legs = k5["legs"]
    log(f"{tag}: K5 {k5['launches']} launches = {k5['device_batches']} "
        f"groups indexed = {legs['exec']['count']} exec legs, host groups "
        f"{k5['host_groups']}, fallback rows {k5['fallback_rows']}; legs "
        f"median ms (sum s): " + ", ".join(
            f"{leg} {v['median_s'] * 1e3:.5f} ({v['sum_s']:.5f})"
            for leg, v in legs.items() if v["count"])
        + f"; shapes (B, L): {dict(shapes)}")
    return shapes


def phase_csv_path() -> dict:
    """Quote-mode CSV (``testdata.quoted_csv_config``) on
    ``gen_quoted_csv(300_000, seed=19)``: the index tier
    (``LOONG_DISABLE_NATIVE=1``) at one and four workers, then the native
    tier at one.  Every record equals the FSM oracle (``csv_oracle``) in
    order; the NDJSON bytes of the three runs are equal (the read time in
    ``__time__`` aside); on the index runs K5 launches = its exec legs =
    the groups (the log's reader chunks), no group is left to the numpy
    twin and the fallback rows are the oracle's deviant rows; the native
    run launches no K5.  Then K5 on the path's own groups: each reader
    chunk packed as ``index_batch`` packs it, through K5 and its plain
    version on the card, bit-exact, and the (B, L) of these batches must be
    those the index runs launched, group for group."""
    from collections import Counter
    import numpy as np
    import torch
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.device_batch import (
        pack_rows, pad_batch, pick_length_bucket)
    from loongcollector_tpu_torch.ops.kernels import struct_index as si
    t0 = time.perf_counter()
    lines = td.gen_quoted_csv(CSV_LINES, seed=19)
    tmp, log_path, n_bytes = write_log("chip_smoke_csv_", "audit.csv", lines)
    want = td.csv_oracle(lines)
    deviant = sum(td.csv_deviant(ln) for ln in lines)
    groups = td.reader_chunks(lines)
    log(f"csv log: {len(lines)} lines, {n_bytes} bytes, {deviant} deviant "
        f"rows, {len(groups)} reader chunks, in "
        f"{time.perf_counter() - t0:.1f} s")
    runs = {}
    outs = {}
    for tag, threads, env in (("csv index tier, 1 worker", 1,
                               {"LOONG_DISABLE_NATIVE": "1"}),
                              ("csv index tier, 4 workers", 4,
                               {"LOONG_DISABLE_NATIVE": "1"}),
                              ("csv native tier, 1 worker", 1, {})):
        st, out, wall = path_run(tmp, tag, td.quoted_csv_config, log_path,
                                 threads, **env)
        n = check_records(tag, out, want)
        check_settled(tag, st, k1=False)
        k5 = st["k5"]
        index = "LOONG_DISABLE_NATIVE" in env
        if index and not (0 < k5["launches"] == k5["device_batches"]
                          == k5["dispatches"] == len(groups)
                          == k5["legs"]["exec"]["count"]) \
                or index and (k5["host_groups"]
                              or k5["fallback_rows"] != deviant) \
                or not index and (k5["launches"] or k5["fallback_rows"]):
            fail(f"{tag}: K5 {k5}, groups {len(groups)}, deviant {deviant}")
        shapes = k5_stats_line(tag, st) if index else None
        mbps = n_bytes / st["seconds"] / 1e6
        log(f"{tag}: {n} records equal to the FSM oracle in order; "
            f"{mbps:.2f} MB/s end to end ({st['seconds']:.3f} s, agent "
            f"process {wall:.1f} s); traced busy share "
            f"{st['busy_share'] * 100:.4f}%; stage seconds (host): "
            + json.dumps(st["stage_seconds"]))
        runs[tag] = {"stats": st, "mbps": mbps, "shapes": shapes}
        outs[tag] = _TIME_FIELD.sub(b'"__time__": 0', out)
    first = next(iter(outs.values()))
    if any(o != first for o in outs.values()):
        fail("csv path: the three runs' NDJSON bytes differ")
    # K5 on the path's own groups
    kern = si.StructIndexKernel(si.MODE_DELIM, 0x2C)
    shapes = Counter()
    for i, rows in enumerate(groups):
        lens = np.array([len(r) for r in rows], np.int32)
        arena = np.frombuffer(b"".join(rows), np.uint8)
        offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
        L = pick_length_bucket(int(lens.max()))
        B = pad_batch(len(rows))
        batch = pack_rows(arena, offs, lens, L, B)
        rd = torch.from_numpy(batch.rows).cuda()
        ld = torch.from_numpy(batch.lengths).cuda()
        got = [t.cpu().numpy() for t in kern(rd, ld)]
        want_m = [t.cpu().numpy() for t in kern.plain(rd, ld)]
        if not all(np.array_equal(g, w) for g, w in zip(got, want_m)):
            fail(f"csv path: K5 differs from its plain version on group {i}")
        shapes[(B, L)] += 1
    for tag, run in runs.items():
        if run["shapes"] is not None and run["shapes"] != shapes:
            fail(f"{tag}: K5 launched {dict(run['shapes'])}, the path's "
                 f"groups give {dict(shapes)}")
    log(f"csv path: the three runs' NDJSON bytes are equal; K5 on the "
        f"path's own {len(groups)} groups bit-exact with its plain version, "
        f"(B, L) {dict(shapes)} as both index runs launched")
    os.unlink(log_path)
    return {"runs": runs, "groups": len(groups), "deviant": deviant,
            "shapes": shapes, "lines": len(lines), "bytes": n_bytes}


def phase_pipe_filter() -> dict:
    """The delimiter-filter path (``testdata.pipe_filter_config``: the
    non-quote ``|`` parse, then keep ``level`` ERROR or WARN and drop
    ``service`` healthcheck) on ``gen_pipe_log(600_000, seed=23)`` at one
    worker: the kept records equal the ``split`` + ``re.fullmatch`` oracle
    in order; one K7 launch a group (= fused dispatches = plane dispatches
    = groups), no standalone K1, K2 or K3 launch."""
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.kernels.fused_program_cuda import \
        LaunchShape
    t0 = time.perf_counter()
    lines = td.gen_pipe_log(PIPE_LINES, seed=23)
    tmp, log_path, n_bytes = write_log("chip_smoke_pipe_", "svc.log", lines)
    want = td.pipe_filter_oracle(lines)
    groups = len(td.reader_chunks(lines))
    log(f"pipe log: {len(lines)} lines, {n_bytes} bytes, {len(want)} kept "
        f"by the oracle, {groups} reader chunks, in "
        f"{time.perf_counter() - t0:.1f} s")
    tag = "delimiter filter, 1 worker"
    st, out, wall = path_run(tmp, tag, td.pipe_filter_config, log_path, 1)
    n = check_records(tag, out, want, td.PIPE_KEYS)
    check_settled(tag, st, k1=False)
    fu, plane = st["fusion"], st["plane"]
    if not (0 < fu["k7_launches"] == fu["fused_dispatches"]
            == plane["dispatches"] == fu["fused_groups"] == groups
            == fu["exec_legs"]) or fu["runs_planned"] != 1 \
            or fu["long_row_groups"] or fu["other_groups"] \
            or st["launches"] or st["k2"]["launches"] or fu["k3_launches"] \
            or st["k5"]["launches"]:
        fail(f"{tag}: K7 launches {fu['k7_launches']}, fused dispatches "
             f"{fu['fused_dispatches']}, plane {plane['dispatches']}, groups "
             f"{fu['fused_groups']} of {groups}, standalone K1 "
             f"{st['launches']}, K2 {st['k2']['launches']}, K3 "
             f"{fu['k3_launches']}, K5 {st['k5']['launches']}")
    shapes = checked_fused_shapes(
        {LaunchShape(**{k: v for k, v in d.items() if k != "launches"}):
         d["launches"] for d in fu["launch_shapes"]}, tag)
    mbps = n_bytes / st["seconds"] / 1e6
    log(f"{tag}: {n} records equal to the oracle in order; "
        f"{fu['k7_launches']} K7 launches = fused dispatches = plane "
        f"dispatches = groups, 0 standalone K1/K2/K3; {mbps:.2f} MB/s end to "
        f"end ({st['seconds']:.3f} s, agent process {wall:.1f} s); K7 exec "
        f"legs {fu['kernel_seconds']:.6f} s, median "
        f"{fu['exec_median_s'] * 1e3:.5f} ms; traced busy share "
        f"{st['busy_share'] * 100:.3f}%; stages "
        f"{fu['programs'][0]['stages']}; geometry " + ", ".join(
            f"{k}x {sh.instantiation} B={sh.B} L={sh.L}" for sh, k in shapes)
        + "; stage seconds (host): " + json.dumps(st["stage_seconds"]))
    os.unlink(log_path)
    return {"stats": st, "mbps": mbps, "records": n, "groups": groups}


def phase_json_filter() -> dict:
    """``example_config/quick_start/json_filter.yaml`` (``BASELINE.json``
    config 4) with ``flusher_file`` on ``gen_json_events(100_000,
    seed=29)``: the kept events equal the ``json.loads`` +
    ``re.fullmatch`` oracle in order; the filter's kernel and launches come
    from ``--stats`` (K1 for a Tier-1 ``level`` pattern, K2 for a DFA one),
    one launch a group; no parse row falls back."""
    from loongcollector_tpu_torch import testdata as td
    t0 = time.perf_counter()
    lines = td.gen_json_events(JSON_EVENTS, seed=29)
    tmp, log_path, n_bytes = write_log("chip_smoke_json_", "events.json",
                                       lines)
    want = td.json_filter_oracle(lines)
    groups = len(td.reader_chunks(lines))
    log(f"json log: {len(lines)} events, {n_bytes} bytes, {len(want)} kept "
        f"by the oracle, {groups} reader chunks, in "
        f"{time.perf_counter() - t0:.1f} s")
    tag = "json_filter.yaml, 1 worker"
    st, out, wall = path_run(tmp, tag, td.json_filter_config, log_path, 1)
    n = check_records(tag, out, want)
    check_settled(tag, st, k1=st["launches"] > 0)
    k1, k2 = st["launches"], st["k2"]["launches"]
    kernel = "K1" if k1 else "K2"
    launches = k1 or k2
    parse = st["parse"].get("processor_parse_json_tpu/p", {})
    if launches != groups or (k1 and k2) \
            or parse.get("fallback_rows") or parse.get("rows") != len(lines):
        fail(f"{tag}: K1 {k1} and K2 {k2} launches for {groups} groups; "
             f"parse {parse}")
    mbps = n_bytes / st["seconds"] / 1e6
    log(f"{tag}: {n} events equal to the oracle in order; the filter ran on "
        f"{kernel}, {launches} launches = groups; 0 parse fallback rows; "
        f"{mbps:.2f} MB/s end to end ({st['seconds']:.3f} s, agent process "
        f"{wall:.1f} s); traced busy share {st['busy_share'] * 100:.3f}%; "
        f"stage seconds (host): " + json.dumps(st["stage_seconds"]))
    os.unlink(log_path)
    return {"stats": st, "mbps": mbps, "records": n, "kernel": kernel,
            "launches": launches, "groups": groups}


def k5_bound_ms(B, L, row_bytes):
    """Bytes K5 must move (each row's bytes below its length and the
    lengths in, four masks of ceil(L / 16) i32 words a row out) at HBM
    rate, against one 32-bit operation a byte at the non-tensor rate;
    returns (ms, bound_by)."""
    t_bytes = (row_bytes + 4 * B + 16 * -(-L // 16) * B) / HBM_BYTES_PER_S
    t_ops = row_bytes / INT_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def phase_k5_timing(csv) -> dict:
    """K5 (delimiter mode, ``,``) on CSV rows at B=8192 and B=65536, L=128
    (rows cut to L), and at the CSV path's most launched (B, L) on that
    many of the path's own lines: warm (the same inputs launch after
    launch) and cold (the launches rotate over enough copies to pass twice
    the 50 MB L2), by graph replay, beside the plain version graph-replayed
    and the bound (``k5_bound_ms``).  No single PyTorch call computes the
    bitmaps, so there is no library time."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops.kernels import struct_index as si
    from loongcollector_tpu_torch.ops.kernels import struct_index_cuda as sic
    kern = si.StructIndexKernel(si.MODE_DELIM, 0x2C)
    path_shape = max(csv["shapes"].items(), key=lambda kv: kv[1])[0]
    out = {}
    for B, L in K5_SHAPES + (path_shape,):
        n_real = B if (B, L) != path_shape else \
            CSV_LINES // csv["groups"]
        lines = td.gen_quoted_csv(n_real, seed=7)
        mat, lens = k5_matrix(lines, L, B - n_real)
        lens[1] = len(lines[1][:L])
        lens[n_real // 2] = len(lines[n_real // 2][:L])
        rd = torch.from_numpy(mat).cuda()
        ld = torch.from_numpy(lens).cuda()
        sic.reset_launch_shapes()
        got = [t.cpu().numpy() for t in kern(rd, ld)]
        want = [t.cpu().numpy() for t in kern.plain(rd, ld)]
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            fail(f"K5 timing: B={B} L={L} differs from the plain version")
        call_ms = time_cuda(lambda: kern.launch(rd, ld), 200)
        ms = graph_ms([lambda: kern.launch(rd, ld)])
        touched = mat.nbytes + 4 * B + 16 * sic.words16(L) * B
        n_copies = max(8, -(-2 * L2_BYTES // touched))
        copies = [(rd.clone(), ld.clone()) for _ in range(n_copies)]
        cold_ms = graph_ms([lambda c=c: kern.launch(*c) for c in copies],
                           reps=n_copies * -(-50 // n_copies), iters=5,
                           keep_outputs=True)
        del copies
        plain_ms = graph_ms([lambda: kern.plain(rd, ld)], reps=10, iters=5)
        plain_call_ms = time_cuda(lambda: kern.plain(rd, ld), 20)
        row_bytes = int(np.clip(lens, 0, L).sum())
        b_ms, by = k5_bound_ms(B, L, row_bytes)
        (sh,) = sic.launch_shapes
        out[(B, L)] = {"ms": ms, "cold_ms": cold_ms, "call_ms": call_ms,
                       "plain_ms": plain_ms, "plain_call_ms": plain_call_ms,
                       "bound_ms": b_ms, "bound_by": by, "blocks": sh.blocks,
                       "real_rows": n_real, "row_bytes": row_bytes,
                       "copies": n_copies}
        log(f"K5 timing B={B} L={L} ({n_real} CSV rows, {row_bytes} bytes; "
            f"{sh.blocks} blocks of {sic.THREADS} threads): kernel "
            f"{ms:.5f} ms warm and {cold_ms:.5f} ms cold ({n_copies} copies) "
            f"on the device (graph replay), {call_ms:.4f} ms per wrapper "
            f"call; plain {plain_ms:.4f} ms graph-replayed, "
            f"{plain_call_ms:.4f} ms per call; bound {b_ms:.6f} ms ({by}); "
            f"library: none (no PyTorch call computes the bitmaps)")
    out["path_shape"] = path_shape
    return out


def k5_kernel_entry(parity, k7_parity, csv, timing, build) -> dict:
    """The ``kernels`` line's entry of K5: launches from the quote-mode CSV
    path's index tier at one worker, times at B=8192, L=128 and at the
    path's shape."""
    runs = csv["runs"]
    one = runs["csv index tier, 1 worker"]
    k5 = one["stats"]["k5"]
    t = timing[K5_SHAPES[0]]
    tb = timing[K5_SHAPES[1]]
    tp = timing[timing["path_shape"]]
    legs = k5["legs"]
    return {
        "name": "struct_index",
        "route": "cuda",
        "source": "loongcollector_tpu_torch/ops/kernels/csrc/"
                  "struct_index.cu",
        "replaces": "loongcollector_tpu/ops/kernels/struct_index.py:119",
        "parity": "bit-exact",
        "geometry": list(K5_SHAPES[0]),
        "launches": k5["launches"],
        "max_abs_err": parity["max_abs_err"],
        "ms": t["ms"],
        "cold_ms": t["cold_ms"],
        "call_ms": t["call_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        # no single PyTorch call computes the structural bitmaps
        "library_ms": None,
        "bench_geometry": list(K5_SHAPES[1]),
        "bench_ms": tb["ms"],
        "bench_cold_ms": tb["cold_ms"],
        "bench_plain_ms": tb["plain_ms"],
        "bench_bound_ms": tb["bound_ms"],
        "path_geometry": list(timing["path_shape"]),
        "path_ms": tp["ms"],
        "path_cold_ms": tp["cold_ms"],
        "path_plain_ms": tp["plain_ms"],
        "path_bound_ms": tp["bound_ms"],
        "path_groups": csv["groups"],
        "path_fallback_rows": k5["fallback_rows"],
        "path_host_groups": k5["host_groups"],
        "path_launch_shapes": [[b, l, n] for (b, l), n in
                               sorted(csv["shapes"].items())],
        "path_leg_median_ms": {k: v["median_s"] * 1e3
                               for k, v in legs.items() if v["count"]},
        "path_mbps": {tag: r["mbps"] for tag, r in runs.items()},
        "path_busy_share": one["stats"]["busy_share"],
        "path_launches_4_workers":
            runs["csv index tier, 4 workers"]["stats"]["k5"]["launches"],
        "parity_batches": parity["checks"],
        "k7_struct_parity_batches": k7_parity["checks"],
        "blocks": t["blocks"],
        "threads": 256,
        "build_s": build["build_s"]["struct_index"],
        "ptxas": build["k5_ptxas"],
    }


def k8_kernel_entry(parity, timing, sharded, sharded4, logical, main_path,
                    build) -> dict:
    """The ``kernels`` line's K8 entry: timed at K1's shapes (phase 24),
    launched on the sharded main path (phase 25) and on the four-shard
    mesh of phase 26."""
    t8, t64 = timing[8192]["k8"], timing[65536]["k8"]
    st = sharded["stats"]
    k = st["mesh"]["kernels"][0]
    return {
        "name": "sharded_extract",
        "route": "cuda",
        "source": "loongcollector_tpu_torch/ops/kernels/csrc/field_extract.cu",
        "replaces": "loongcollector_tpu/parallel/mesh.py:73",
        "parity": "bit-exact",
        "geometry": [8192, 128, 9],
        "shards": 1,
        "launches": st["mesh"]["k8_launches"],
        "max_abs_err": parity["k8_max_abs_err"],
        "ms": t8["ms"],
        "kernel_ms": t8["ms"],
        "cold_ms": t8["cold_ms"],
        "call_ms": t8["call_ms"],
        "plain_ms": t8["plain_ms"],
        "bound_ms": t8["bound_ms"],
        "bound_by": t8["bound_by"],
        # no single PyTorch call computes a segment-program match; the
        # torch.sum of the counts is the plain version's last step
        "library_ms": None,
        "over_k1": t8["over_k1"],
        "cold_over_k1": t8["cold_over_k1"],
        "entry_point": t8["entry_point"],
        "blocks": [t8["blocks"], t64["blocks"]],
        "threads": [t8["threads"], t64["threads"]],
        "bench_geometry": [65536, 128, 9],
        "bench_ms": t64["ms"],
        "bench_cold_ms": t64["cold_ms"],
        "bench_call_ms": t64["call_ms"],
        "bench_plain_ms": t64["plain_ms"],
        "bench_bound_ms": t64["bound_ms"],
        "bench_over_k1": t64["over_k1"],
        "parity_batches": parity["k8_checks"],
        "parity_launches": parity["k8_launches"],
        "parity_pad_rows": parity["k8_pad_rows"],
        "sharded_path_mbps": sharded["mbps"],
        "sharded_path_mbps_4_workers_ledger_on": sharded4["mbps"],
        "main_path_mbps": main_path["mbps"],
        "sharded_path_kernel_s": st["kernel_seconds"],
        "sharded_path_busy_share": st["busy_share"],
        "sharded_path_totals": k["totals"],
        "sharded_path_leg_median_ms": {
            n: v["median_s"] * 1e3 for n, v in st["timeline"]["legs"].items()},
        "logical_mesh4": logical["mesh4"],
        # the four-shard dispatch on one card: one launch, its exec leg
        "four_shard_dispatch_exec_ms": logical["mesh4"]["exec_median_ms"],
        "four_shard_launch_ms": t8["four_shards_ms"],
        "bench_four_shard_launch_ms": t64["four_shards_ms"],
        "logical_lane_dispatches": logical["lanes_dispatches"],
        "logical_filter_lane_dispatches": logical["filter_lanes_dispatches"],
        "build_s": build["build_s"]["field_extract"],
        "ptxas": {n: v for n, v in build["ptxas"].items()
                  if n.startswith("stats_")},
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
    from loongcollector_tpu_torch.ops.kernels import struct_index_cuda as sic
    from loongcollector_tpu_torch.testdata import rollup_mismatches
    build = phase_build(fxc, dsc, fpc, src, sic, native)
    parity = phase_parity()
    tmp, log_path, lines, n_bytes = main_path_log()
    main_path = phase_main_path(tmp, log_path, lines, n_bytes, threads=1,
                                keep=True)
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
    k5_parity = phase_k5_parity()
    k7_struct = phase_k7_struct_parity()
    path1 = phase_multiline(jtmp, jlog_path, jlines, j_bytes, 1, 1)
    path2 = phase_multiline(jtmp, jlog_path, jlines, j_bytes, 2, 1)
    path2_4 = phase_multiline(jtmp, jlog_path, jlines, j_bytes, 2, 4)
    os.unlink(jlog_path)
    grok = phase_grok(tmp, log_path, lines, n_bytes)
    filt = phase_apache_filter(tmp, log_path, lines, n_bytes, threads=1)
    filt4 = phase_apache_filter(tmp, log_path, lines, n_bytes, threads=4)
    sharded = phase_main_path(tmp, log_path, lines, n_bytes, threads=1,
                              sharded=True)
    sharded4 = phase_main_path(tmp, log_path, lines, n_bytes, threads=4,
                               ledger=True, sharded=True)
    logical = phase_logical_mesh(tmp, log_path, lines,
                                 main_path["out_path"], filt)
    os.unlink(main_path["out_path"])
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
    csv = phase_csv_path()
    pipe = phase_pipe_filter()
    jsonf = phase_json_filter()
    k5_timing = phase_k5_timing(csv)
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
                          "grok_nginx": grok["stats"]["launches"],
                          "json_filter": jsonf["stats"]["launches"]},
        "path_mbps": {"multiline_java": path1["mbps"],
                      "java_filter": path2["mbps"],
                      "java_filter_4_workers": path2_4["mbps"],
                      "grok_nginx": grok["mbps"],
                      "json_filter": jsonf["mbps"]},
        "build_s": build["build_s"]["field_extract"],
        "blocks": [t8["blocks"], t64["blocks"]],
        "threads": [t8["threads"], t64["threads"]],
        "smem_bytes": [t8["smem"], t64["smem"]],
        "largest_smem_bytes": parity["largest_smem"],
        "main_path_blocks": sorted({sh.blocks for sh, _ in
                                    main_path["shapes"]}),
        "ptxas": {n: v for n, v in build["ptxas"].items()
                  if not n.startswith("stats_")},
    }, dfa_kernel_entry(
        "dfa_match", "match",
        "loongcollector_tpu/ops/kernels/dfa_scan.py:88", dfa_parity,
        dfa_timing, path2, path2_4, build, "K2"),
        dfa_kernel_entry(
        "fused_scan", "tags",
        "loongcollector_tpu/ops/kernels/dfa_scan.py:172", dfa_parity,
        dfa_timing, path2, path2_4, build, "K4")] + fused_kernel_entries(
        span_parity, fused_parity, fused_timing, filt, filt4, path2,
        build, k7_struct, pipe) + [k6_kernel_entry(
            k6_parity, k6_path, k6_timing, roll, roll4, roll_np, roll_led,
            build), k5_kernel_entry(k5_parity, k7_struct, csv, k5_timing,
                                    build),
        k8_kernel_entry(parity, timing, sharded, sharded4, logical,
                        main_path, build)]}

    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
