#!/usr/bin/env python3
"""On-card smoke check of loongcollector_tpu_torch (one NVIDIA H100).

    python3 chip_smoke.py            # run from the repo root

Phases, each of which exits non-zero on failure:

1. build: compile the CUDA field-extraction kernel from
   ``loongcollector_tpu_torch/ops/kernels/csrc/`` (into ``build/kernels/``,
   keyed on the source hash) and the repo's native host library; print the
   build seconds, the torch version and the card's name and power limit.
2. parity: the kernel against its plain PyTorch version, on the card, on
   the test patterns, a seeded generative set (double pivots included) and
   the Apache pattern, at every length bucket, with rows exactly L bytes
   long, empty rows and padding rows.  Bit-exact on (ok, cap_off,
   cap_len), and both agree with a ``re.fullmatch`` oracle.
3. main path: a seeded 600,000-line Apache access log runs through
   ``python -m loongcollector_tpu_torch --config DIR --once`` on the card
   (``example_config/quick_start/file_regex_apache.yaml`` with FilePaths
   pointed at the log and a flusher_file sink).  Every record must equal
   the ``re`` oracle's fields, the kernel's launches (counted from 0 in
   that process) must equal its device batches and be > 0, and no row may
   be routed to ``re``.  Prints the end-to-end MB/s and the kernel seconds.
4. timing: kernel, plain version and bound at the main path's geometry
   (B=8192, L=128, C=9) and at the bench geometry (B=65536, L=128).

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
SEEDS = [
    b'1.2.3.4 - frank [10/Oct/2000:13:55:36 -0700] "GET /a HTTP/1.0" 200 23',
    b"123-abc", b"aaa opt7 end", b"aaa end", b"cat says hi",
    b"dog says x", b"421 fixed", b"pre middle bit post",
    b"[tag] rest of line", b"pre  post",
]

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


def graph_ms(fn, reps: int = 50, iters: int = 20) -> float:
    """Device ms per call: `reps` calls captured in one CUDA graph, the
    graph replayed `iters` times between CUDA events, so the host's
    per-call Python and launch overhead stays out of the figure."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
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
    for ln in fxc.build_log.splitlines():
        if "registers" in ln or "bytes stack frame" in ln or "spill" in ln:
            log(f"ptxas: {ln.strip()}")
    t0 = time.perf_counter()
    if native.get_lib() is None:
        fail("native host library did not build")
    native_s = time.perf_counter() - t0
    log(f"build: kernel {kernel_s:.2f} s, native library {native_s:.2f} s; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"python {sys.version.split()[0]}")
    log(f"card: {nvidia_smi()}; {torch.cuda.get_device_name(0)}")
    return {"kernel_build_s": kernel_s, "native_build_s": native_s}


def check_batch(kern, pattern, lines, L, stats) -> None:
    """Kernel vs plain on the card, and both vs re, for one (pattern, L)."""
    import numpy as np
    import torch
    from loongcollector_tpu_torch.ops.device_batch import pack_rows
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines) or b"\0", np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    batch = pack_rows(arena, offs, lens, L)
    rows = torch.from_numpy(batch.rows).cuda()
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


def phase_parity() -> dict:
    import numpy as np
    from loongcollector_tpu_torch.ops.device_batch import (LENGTH_BUCKETS,
                                                            pick_length_bucket)
    from loongcollector_tpu_torch.ops.kernels.field_extract import \
        ExtractKernel
    from loongcollector_tpu_torch.ops.regex.program import (Tier1Unsupported,
                                                            compile_tier1)
    from loongcollector_tpu_torch.testdata import gen_lines
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
    for pat, lines in cases:
        kern = ExtractKernel(compile_tier1(pat))
        stats["patterns"] += 1
        lines = list(lines) + [b"", b""]
        need = pick_length_bucket(max(len(x) for x in lines))
        for L in (L for L in LENGTH_BUCKETS if L >= need):
            check_batch(kern, pat, lines + exact_length_lines(rng, lines, L),
                        L, stats)
    log(f"parity: {stats['checks']} (pattern, L) batches over "
        f"{stats['patterns']} patterns, {stats['rows']} rows: kernel "
        f"bit-exact with the plain version and with re")
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


def phase_main_path() -> dict:
    from loongcollector_tpu_torch.testdata import APACHE_KEYS, gen_lines
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    log_path = os.path.join(tmp, "access.log")
    out_path = os.path.join(tmp, "out.json")
    stats_path = os.path.join(tmp, "stats.json")
    t0 = time.perf_counter()
    lines = gen_lines(MAIN_PATH_LINES, seed=11)
    data = b"\n".join(lines) + b"\n"
    with open(log_path, "wb") as f:
        f.write(data)
    log(f"main path: {len(lines)} lines, {len(data)} bytes written in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg_dir = write_config(tmp, log_path, out_path)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "loongcollector_tpu_torch", "--config",
         cfg_dir, "--once", "--stats", stats_path],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"agent exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    with open(stats_path) as f:
        st = json.load(f)
    if st["device"] != "cuda":
        fail(f"agent ran on {st['device']}")
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
        fail(f"{n} records for {len(lines)} lines")
    if not 0 < st["launches"] == st["device_batches"]:
        fail(f"launches {st['launches']} vs device batches "
             f"{st['device_batches']}")
    if st["re_oversize_rows"] or st["re_tier_rows"]:
        fail(f"rows routed to re: {st}")
    mbps = len(data) / st["seconds"] / 1e6
    log(f"main path: {n} records equal the re oracle; {st['launches']} "
        f"launches = {st['device_batches']} device batches; pipeline "
        f"{st['seconds']:.3f} s = {mbps:.2f} MB/s end to end "
        f"(agent process {wall:.1f} s); kernel {st['kernel_seconds']:.6f} s")
    log("main path stage seconds (host): " + json.dumps(st["stage_seconds"]))
    log(f"main path device busy share (kernel s / pipeline s): "
        f"{st['kernel_seconds'] / st['seconds']:.6f}")
    for name in (log_path, out_path):
        os.unlink(name)
    return {"stats": st, "mbps": mbps, "bytes": len(data), "wall_s": wall}


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
        got = [t.cpu().numpy() for t in kern(rows, lengths)]
        want = [t.cpu().numpy() for t in kern.plain(rows, lengths)]
        if not all((g == w).all() for g, w in zip(got, want)):
            fail(f"kernel != plain at B={B}")
        if not got[0][:n_real].all():
            fail(f"Apache rows failed to match at B={B}")
        call_ms = time_cuda(lambda: kern(rows, lengths), 200)
        ms = graph_ms(lambda: kern(rows, lengths))
        plain_ms = time_cuda(lambda: kern.plain(rows, lengths), 20)
        b_ms, by = bound_ms(B, 9, prog_words, int(lens.sum()))
        mbps = int(lens.sum()) / (ms * 1e-3) / 1e6
        out[B] = {"ms": ms, "call_ms": call_ms, "parse_mbps": mbps, "plain_ms": plain_ms,
                  "bound_ms": b_ms, "bound_by": by, "real_rows": n_real}
        log(f"timing B={B} L=128 C=9 ({n_real} Apache rows): kernel "
            f"{ms:.4f} ms on the device (graph replay), {call_ms:.4f} ms "
            f"per wrapper call, plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.5f} ms ({by}); regex-parse {mbps:.1f} MB/s")
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
    main_path = phase_main_path()
    timing = phase_timing()
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
        "call_ms": t8["call_ms"],
        "plain_ms": t8["plain_ms"],
        "bound_ms": t8["bound_ms"],
        "bound_by": t8["bound_by"],
        # no single PyTorch call computes a segment-program match
        "library_ms": None,
        "bench_geometry": [65536, 128, 9],
        "bench_ms": t64["ms"],
        "bench_call_ms": t64["call_ms"],
        "parse_mbps": t8["parse_mbps"],
        "bench_parse_mbps": t64["parse_mbps"],
        "bench_plain_ms": t64["plain_ms"],
        "bench_bound_ms": t64["bound_ms"],
        "main_path_kernel_s": mp["kernel_seconds"],
        "main_path_mbps": main_path["mbps"],
        "build_s": build["kernel_build_s"],
    }]}
    print(nvidia_smi())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
