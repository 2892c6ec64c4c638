"""K2 and K4 in the port against the JAX package's programs, on the CPU.

The plain versions (``ops/kernels/dfa_scan.walk_plain`` behind
``DFAMatchKernel.plain`` / ``FusedScanKernel.plain``) must equal
``build_dfa_match_fn`` / ``build_fused_scan_fn`` of the JAX package, jitted
on the CPU, bit-exact (bools and u32 tag masks), on the same packed rows:
at every length bucket, with padding rows, empty rows and rows exactly
``L`` long; at the single-DFA caps (S = 64, K = 32), near the fused
device caps (S = 124, K = 48), and on a 32-member set whose bit 31 is set
on real rows.  The automata are the reference's own, carried over by
``automaton_arrays_from_reference``, and the port's compiles of the same
patterns.  Both also agree with ``re.fullmatch``.

The wrappers: a CUDA tensor goes to the kernel launch (counted), never to
the plain version; the build raises without nvcc; ``run_chunks`` splits at
``MAX_BATCH`` and each chunk takes its own bucket.  The launch geometry
gives every SM a block once a batch holds 32 rows an SM, the kernel's
constants are the wrapper's, and the dispatch timeline keeps each DFA
program's exec legs apart.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from loongcollector_tpu.ops.kernels.dfa_scan import (build_dfa_match_fn,
                                                     build_fused_scan_fn)
from loongcollector_tpu.ops.regex import fuse as ref_fuse
from loongcollector_tpu.ops.regex.dfa import compile_dfa as ref_compile_dfa
from loongcollector_tpu_torch.ops import device_batch
from loongcollector_tpu_torch.ops.device_batch import (LENGTH_BUCKETS,
                                                        pack_rows)
from loongcollector_tpu_torch.ops.kernels import dfa_scan
from loongcollector_tpu_torch.ops.kernels.dfa_scan import (
    DFAMatchKernel, FusedScanKernel, automaton_arrays_from_reference)
from loongcollector_tpu_torch.ops.regex.dfa import compile_dfa
from loongcollector_tpu_torch.ops.regex.fuse import compile_fused
from loongcollector_tpu_torch.testdata import (BIT31_SET, JAVA_CONTINUE,
                                               JAVA_FILTER, JAVA_START,
                                               LIMIT_DFA, NEAR_CAP_SET,
                                               gen_java_log)
from test_torch_alarms import alarms_left_empty  # noqa: F401

JAVA_SET = [JAVA_START, JAVA_CONTINUE]


def _members(rng, patterns, n):
    """Strings of the patterns' own words, some mutated in one byte."""
    words = sorted({w for p in patterns
                    for w in re.findall(r"[A-Za-z0-9]{2,}", p)})
    out = []
    for _ in range(n):
        s = words[int(rng.integers(len(words)))]
        tail = rng.choice([b"", b"123", b" x y", b"=v", b"-ab"])
        line = s.encode() + tail
        if rng.integers(4) == 0:
            p = int(rng.integers(len(line)))
            line = line[:p] + bytes([int(rng.integers(32, 127))]) \
                + line[p + 1:]
        out.append(line)
    return out


def _java_lines(rng, n):
    lines = gen_java_log(n, seed=int(rng.integers(1000)))
    # filter messages: a header's message with its frames
    return lines + [b"x java.lang.Error: " + lines[1], b"no match here"]


def _pack(rng, lines, L):
    """Rows of at most L bytes, plus rows exactly L long, empty rows, and
    padding rows (the batch is padded past the real rows)."""
    lines = [x[:L] for x in lines]
    lines += [bytes(rng.integers(32, 127, L, dtype=np.uint8)), b"", b""]
    if lines[0]:
        lines.append((lines[0] * (L // len(lines[0]) + 1))[:L])
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines) or b"\0", np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    batch = pack_rows(arena, offs, lens, L, B=len(lines) + 5)
    return lines, batch.rows, batch.lengths


def _check_match(pattern, lines, rows, lengths):
    ref = ref_compile_dfa(pattern)
    want = np.asarray(jax.jit(build_dfa_match_fn(ref))(rows, lengths))
    kern = DFAMatchKernel(compile_dfa(pattern))
    got = kern.plain(torch.from_numpy(rows), torch.from_numpy(lengths))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    rx = re.compile(pattern.encode("latin-1"))
    assert [bool(v) for v in want[:len(lines)]] \
        == [rx.fullmatch(x) is not None for x in lines]
    assert not want[len(lines):].any() or rx.fullmatch(b"")
    return want


def _check_tags(patterns, lines, rows, lengths):
    ref = ref_fuse.compile_fused(patterns, note_demotions=False)
    want = np.asarray(jax.jit(build_fused_scan_fn(ref))(rows, lengths))
    kern = FusedScanKernel(compile_fused(patterns, note_demotions=False))
    got = kern.plain(torch.from_numpy(rows), torch.from_numpy(lengths))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    tags = want.view(np.uint32)
    rxs = [re.compile(p.encode("latin-1")) for p in patterns]
    for i, x in enumerate(lines):
        assert int(tags[i]) == sum(1 << b for b, r in enumerate(rxs)
                                   if r.fullmatch(x)), x
    return tags


@pytest.mark.parametrize("L", LENGTH_BUCKETS)
def test_match_plain_equals_reference(L):
    rng = np.random.default_rng(L)
    lines = _java_lines(rng, 40) + _members(rng, [LIMIT_DFA], 20)
    lines, rows, lengths = _pack(rng, lines, L)
    for pattern in (JAVA_FILTER, JAVA_CONTINUE):
        want = _check_match(pattern, lines, rows, lengths)
        assert want.any() and not want.all()


@pytest.mark.parametrize("L", LENGTH_BUCKETS)
def test_fused_plain_equals_reference(L):
    rng = np.random.default_rng(100 + L)
    lines = _java_lines(rng, 60)
    lines, rows, lengths = _pack(rng, lines, L)
    tags = _check_tags(JAVA_SET, lines, rows, lengths)
    assert set(np.unique(tags[:len(lines)]).tolist()) >= {0, 1, 2}


@pytest.mark.parametrize("case", ["dfa_64x32", "fused_124x48", "bit31"])
def test_caps_and_bit31(case):
    rng = np.random.default_rng(7)
    if case == "dfa_64x32":
        dfa = compile_dfa(LIMIT_DFA)
        assert (dfa.num_states, dfa.num_classes) == (64, 32)
        for L in (128, 256):
            lines, rows, lengths = _pack(
                rng, _members(rng, [LIMIT_DFA], 120), L)
            assert _check_match(LIMIT_DFA, lines, rows, lengths).any()
        return
    patterns = NEAR_CAP_SET if case == "fused_124x48" else BIT31_SET
    fd = compile_fused(patterns, note_demotions=False)
    assert fd.device_ok and not fd.demoted
    if case == "fused_124x48":
        assert (fd.num_states, fd.num_classes) == (124, 48)
    lines = _members(rng, patterns, 150) + [p.encode() for p in BIT31_SET]
    lines, rows, lengths = _pack(rng, lines, 128)
    tags = _check_tags(patterns, lines, rows, lengths)
    if case == "bit31":
        assert (tags >> 31 & 1).any() and (tags & 1).any()


@pytest.mark.parametrize("kind", ["dfa", "fused"])
def test_automaton_arrays_from_reference(kind):
    """The reference's automaton, carried over, gives the port's own
    kernel inputs and the same walk."""
    if kind == "dfa":
        ref = ref_compile_dfa(JAVA_FILTER)
        ours = compile_dfa(JAVA_FILTER)
        got = automaton_arrays_from_reference(
            ref.byte_class, ref.transitions, ref.start, ref.accepting)
        mine = DFAMatchKernel(ours).arrays
    else:
        ref = ref_fuse.compile_fused(BIT31_SET, note_demotions=False)
        ours = compile_fused(BIT31_SET, note_demotions=False)
        got = automaton_arrays_from_reference(
            ref.byte_class, ref.transitions, ref.start, ref.accept_tags)
        mine = FusedScanKernel(ours).arrays
    np.testing.assert_array_equal(got.t256, mine.t256)
    np.testing.assert_array_equal(got.accept, mine.accept)
    assert got.start == mine.start and got.t256.dtype == np.uint8
    assert got.accept.dtype == np.int32
    if kind == "fused":
        assert got.accept.view(np.uint32).max() >= 1 << 31
    with pytest.raises(ValueError):
        automaton_arrays_from_reference(np.zeros(256, np.uint8),
                                        np.zeros((300, 1), np.int32), 0,
                                        np.zeros(300, bool))


class _FakeCudaTensor:
    device = torch.device("cuda", 0)


@pytest.mark.parametrize("mode", ["match", "tags"])
def test_cuda_tensor_launches_kernel_never_plain(monkeypatch, mode):
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda
    if mode == "match":
        kern = DFAMatchKernel(compile_dfa(JAVA_FILTER))
    else:
        kern = FusedScanKernel(compile_fused(JAVA_SET))

    def plain(*a):
        raise AssertionError("plain version ran for a CUDA tensor")

    calls = []
    kern.plain = plain
    monkeypatch.setattr(kern, "tables", lambda dev: ("t256", "accept"))
    if mode == "tags":                # K4 also reads its skip table
        monkeypatch.setattr(kern, "skips", lambda dev: "skips")
    monkeypatch.setattr(dfa_scan_cuda, "launch",
                        lambda *a, **kw: calls.append((a, kw)) or "out")
    rows = _FakeCudaTensor()
    assert kern(rows, rows) == "out" and kern(rows, rows) == "out"
    assert kern.launches == 2 and [c[0][0] for c in calls] == [mode, mode]
    assert [c[1].get("skips") for c in calls] == [
        "skips" if mode == "tags" else None] * 2
    kern.reset_counts()
    assert kern.launches == 0


def test_build_failure_raises(monkeypatch, tmp_path):
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    monkeypatch.setattr(dfa_scan_cuda, "_lib", None)
    monkeypatch.setattr(fxc, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(fxc.shutil, "which", lambda name: None)
    monkeypatch.setattr(fxc.os.path, "exists",
                        lambda p: False if "nvcc" in p else os.path.isfile(p))
    with pytest.raises(RuntimeError, match="nvcc"):
        dfa_scan_cuda.build()


def test_run_chunks_splits_at_max_batch(monkeypatch):
    monkeypatch.setattr(dfa_scan, "MAX_BATCH", 16)
    rng = np.random.default_rng(3)
    lines = _java_lines(rng, 50)
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines), np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    kern = DFAMatchKernel(compile_dfa(JAVA_FILTER))
    idx = np.nonzero(lens <= device_batch.LENGTH_BUCKETS[-1])[0]
    out = np.zeros(len(lines), bool)
    n = dfa_scan.run_chunks(kern, arena, offs, lens, idx,
                            torch.device("cpu"), out)
    assert n == -(-len(idx) // 16)
    rx = re.compile(JAVA_FILTER.encode())
    assert out[idx].tolist() == [rx.fullmatch(lines[i]) is not None
                                 for i in idx]
    assert kern.launches == 0         # the plain version is not a launch


@pytest.mark.parametrize("B", [1, 256, 1024, 2048, 4096, 4224, 8192, 16384,
                               32768, 65536])
def test_launch_geometry_gives_every_sm_a_block(B):
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda as dsc
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    t = dsc.launch_geometry(B)
    assert t % 32 == 0 and dsc.MIN_THREADS <= t <= dsc.MAX_THREADS
    blocks = -(-B // t)
    if B >= 32 * fxc.NUM_SMS:
        assert blocks >= fxc.NUM_SMS
    else:
        assert t == dsc.MIN_THREADS
    # the largest block that keeps every SM busy
    if t < dsc.MAX_THREADS:
        assert -(-B // (2 * t)) < fxc.NUM_SMS
    assert dsc.launch_geometry(8192) == 32 and dsc.launch_geometry(65536) == 128


def test_dfa_source_agrees_with_the_wrapper():
    from loongcollector_tpu_torch.ops.kernels import dfa_scan_cuda as dsc
    from loongcollector_tpu_torch.ops.regex import fuse
    with open(dsc._SRC) as f:
        src = f.read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kMaxThreads"]) == dsc.MAX_THREADS
    assert int(consts["kMaxStates"]) == dsc.MAX_STATES \
        == fuse.DEVICE_MAX_STATES
    # the largest automaton's tables fit the default 48 KB of a block
    assert dsc.smem_bytes(dsc.MAX_STATES) <= 48 * 1024
    assert "cudaFuncSetAttribute" not in src
    for name in dsc.ENTRY_POINTS.values():
        assert re.search(rf"int {name}\([^)]*void\* ev_start, void\* ev_end\)",
                         src)


def test_timeline_splits_exec_legs_by_program():
    from loongcollector_tpu_torch.ops import xprof
    with xprof.active() as tl:
        for program, dur in [("dfa_match", 0.002), ("fused_scan", 0.001),
                             ("dfa_match", 0.003), ("regex", 0.004)]:
            xid = xprof.begin_dispatch(64)
            xprof.annotate(xid, program, "8192x256")
            xprof.leg(xid, "exec", 0.0, dur)
            xprof.close_dispatch(xid)
    assert tl.leg_durations("exec", program="dfa_match") == pytest.approx(
        [0.002, 0.003])
    assert tl.leg_durations("exec", xprof.HOST, "fused_scan") == \
        pytest.approx([0.001])
    assert tl.leg_durations("exec", xprof.DEVICE, "fused_scan") == []
    assert tl.leg_seconds("exec") == pytest.approx(0.010)
    assert not xprof.is_active()
    xprof.annotate(1, "dfa_match", "-")      # off: a no-op


# -- the settled exit -------------------------------------------------------

def _reachable_settled(t256, accept):
    """Brute force: a state is settled when every state it reaches (itself
    included) has its accept value."""
    S = len(t256)
    out = np.zeros(S, bool)
    for s in range(S):
        seen, todo = {s}, [s]
        while todo:
            for v in set(t256[todo.pop()].tolist()) - seen:
                seen.add(v)
                todo.append(v)
        out[s] = all(accept[v] == accept[s] for v in seen)
    return out


def _settle_automata():
    from loongcollector_tpu_torch.testdata import (APACHE_FILTER_EXCLUDE,
                                                   APACHE_FILTER_INCLUDE)
    dfas = {"java_filter": JAVA_FILTER,
            "status": APACHE_FILTER_INCLUDE["status"],
            "health": APACHE_FILTER_EXCLUDE["url"], "limit_dfa": LIMIT_DFA}
    sets = {"java_start_continue": JAVA_SET, "near_cap": NEAR_CAP_SET,
            "bit31": BIT31_SET}
    return dfas, sets


@pytest.mark.parametrize("name", ["java_filter", "status", "health",
                                  "limit_dfa", "java_start_continue",
                                  "near_cap", "bit31"])
def test_settled_set_equals_reachability(name):
    """``settled_states`` equals a brute-force reachability set, on the
    port's automaton and the reference's; after the renumbering the settled
    states are exactly the ids from ``first_settled`` on."""
    dfas, sets = _settle_automata()
    if name in dfas:
        ours, ref = compile_dfa(dfas[name]), ref_compile_dfa(dfas[name])
        acc_of = lambda d: d.accepting                    # noqa: E731
    else:
        ours = compile_fused(sets[name], note_demotions=False)
        ref = ref_fuse.compile_fused(sets[name], note_demotions=False)
        acc_of = lambda d: d.accept_tags                  # noqa: E731
    for d in (ours, ref):
        t256 = np.asarray(d.transitions)[:, np.asarray(d.byte_class)]
        acc = np.asarray(acc_of(d))
        want = _reachable_settled(t256, acc)
        np.testing.assert_array_equal(dfa_scan.settled_states(t256, acc),
                                      want)
        arrays = automaton_arrays_from_reference(
            d.byte_class, d.transitions, d.start, acc)
        S = arrays.num_states
        assert arrays.first_settled == S - int(want.sum())
        np.testing.assert_array_equal(
            _reachable_settled(arrays.t256, arrays.accept),
            np.arange(S) >= arrays.first_settled)
        # the renumbering keeps the automaton: state s -> new_id[s]
        ids = np.concatenate([np.nonzero(~want)[0], np.nonzero(want)[0]])
        new_id = np.argsort(ids)
        np.testing.assert_array_equal(arrays.t256, new_id[t256[ids]])
        assert arrays.start == new_id[d.start]
    # what the exit can use, per automaton ("." is not "\n", so the
    # fused set's `.*` tails stay open: only its dead state is settled)
    assert {"java_filter": 17, "java_start_continue": 1}.get(
        name, arrays.num_states - arrays.first_settled) \
        == arrays.num_states - arrays.first_settled


def _batch(lines, L, B=None):
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines) or b"\0", np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    batch = pack_rows(arena, offs, lens, L, B or len(lines) + 3)
    return batch.rows, batch.lengths


@pytest.mark.parametrize("kernel", ["K2", "K3", "K4"])
def test_renumbered_plain_equals_reference_on_settle_rows(kernel):
    """The plain K2, K3 and K4 on renumbered tables against the JAX
    programs (``dfa_scan.py:88``, ``:105``, ``:172``) on the settled exit's
    adversarial rows at L=4096: rows that never settle, settle on their
    last byte or at 16- and 512-byte edges +-1, lengths 0, 1, 511..513,
    4096."""
    from loongcollector_tpu.ops.kernels.dfa_scan import \
        build_dfa_span_match_fn
    from loongcollector_tpu_torch.ops.kernels.dfa_scan import \
        DFASpanMatchKernel
    from loongcollector_tpu_torch.testdata import settle_rows
    L = 4096
    kind = "java_start_continue" if kernel == "K4" else "java_filter"
    lines = settle_rows(kind, L, seed=11)
    rows, lengths = _batch(lines, L)
    rt, rl = torch.from_numpy(rows), torch.from_numpy(lengths)
    if kernel == "K2":
        want = _check_match(JAVA_FILTER, lines, rows, lengths)
        assert want.any() and not want[:len(lines)].all()
        assert DFAMatchKernel(compile_dfa(JAVA_FILTER)).arrays.first_settled \
            < 30
    elif kernel == "K4":
        tags = _check_tags(JAVA_SET, lines, rows, lengths)
        assert (tags[:len(lines)] == 0).any()
    else:
        rng = np.random.default_rng(12)
        B = rows.shape[0]
        starts = rng.integers(-3, L, B).astype(np.int32)
        starts[:B // 3] = 0
        spans = rng.integers(-1, L + 1, B).astype(np.int32)
        spans[:B // 3] = lengths[:B // 3]
        ref = ref_compile_dfa(JAVA_FILTER)
        want = np.asarray(jax.jit(build_dfa_span_match_fn(ref))(
            rows, lengths, starts, spans))
        got = DFASpanMatchKernel(compile_dfa(JAVA_FILTER)).plain(
            rt, rl, torch.from_numpy(starts), torch.from_numpy(spans))
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.any() and not want.all()


def _exit_twin(arrays, rows, lengths):
    """The thread form's walk in numpy: byte by byte from the start state,
    checking for a settled state once a 16-byte word, as ``walk_prefix``
    does.  Returns accept[final state] per row and the bytes each row
    walked."""
    t = arrays.t256.astype(np.int64)
    fs = arrays.first_settled
    B, L = rows.shape
    out, walked = np.empty(B, np.int32), np.zeros(B, np.int64)
    for r in range(B):
        n = int(np.clip(lengths[r], 0, L))
        s, p = arrays.start, 0
        while p < n and s < fs:
            for b in rows[r, p:min(p + 16, n)]:
                s = int(t[s, b])
            p = min(p + 16, n)
        out[r], walked[r] = arrays.accept[s], p
    return out, walked


@pytest.mark.parametrize("S", [1, 30, 128])
@pytest.mark.parametrize("L", [1024, 4096])
def test_exit_walk_twin_equals_plain_walk(S, L):
    """The settled exit, checked once a word, gives the plain walk's result
    and walks each row to its settle point rounded up to a word."""
    from loongcollector_tpu_torch.testdata import (cap_automaton,
                                                   settle_rows)
    rng = np.random.default_rng(S + L)
    if S == 30:
        arrays = DFAMatchKernel(compile_dfa(JAVA_FILTER)).arrays
        lines = settle_rows("java_filter", L, seed=S + L)
    elif S == 128:
        arrays = dfa_scan.settled_last(*cap_automaton(seed=L))
        lines = [bytes(rng.integers(65, 91, int(n), dtype=np.uint8))
                 for n in rng.integers(0, L + 1, 24)]
        lines += [bytes(rng.integers(65, 90, n, dtype=np.uint8))
                  for n in (L, 511, 512, 513)]        # no Z: never settle
    else:
        arrays = dfa_scan.settled_last(np.zeros((1, 256), np.uint8),
                                       np.ones(1, np.int32), 0)
        lines = [b"", b"a", b"x" * 700, b"y" * L]
    assert arrays.num_states == S
    rows, lengths = _batch(lines, L)
    got, walked = _exit_twin(arrays, rows, lengths)
    want = dfa_scan.walk_plain(torch.from_numpy(arrays.t256),
                               torch.from_numpy(arrays.accept), arrays.start,
                               torch.from_numpy(rows),
                               torch.from_numpy(lengths)).numpy()
    np.testing.assert_array_equal(got, want)
    need = dfa_scan.settle_points(arrays, rows, lengths)
    lens = np.clip(lengths, 0, L)
    np.testing.assert_array_equal(walked, np.minimum(-(-need // 16) * 16,
                                                     lens))
    if S == 1:
        assert not walked.any()           # the start state is settled
    else:
        # some rows settle early, and (the cap) some never do
        assert (walked < lens).any()
    if S == 128:
        assert ((walked == lens) & (lens == L)).any()


def test_settle_points_are_where_the_state_settles():
    arrays = DFAMatchKernel(compile_dfa(JAVA_FILTER)).arrays
    lines = [b"", b"xx", b"an Error here", b"Error", b"x" * 600 + b"Error",
             b"no match at all"]
    rows, lengths = _batch(lines, 1024, B=len(lines))
    need = dfa_scan.settle_points(arrays, rows, lengths)
    assert need.tolist() == [0, 2, 8, 5, 605, 15]


# -- K4's skip ---------------------------------------------------------------

def _brute_escapes(t256, first_settled):
    """Each state's escape set {b : t256[s, b] != s}, and whether it is a
    skip state (below the settled ones, one to four escape bytes)."""
    out = []
    for s in range(len(t256)):
        esc = {b for b in range(256) if t256[s, b] != s}
        out.append((esc, s < first_settled and 1 <= len(esc) <= 4))
    return out


def _skip_automata():
    from loongcollector_tpu_torch.testdata import SKIP4_SET, cap_automaton
    dfas, sets = _settle_automata()
    out = {name: DFAMatchKernel(compile_dfa(p)).arrays
           for name, p in dfas.items()}
    out.update({name: FusedScanKernel(compile_fused(
        p, note_demotions=False)).arrays for name, p in sets.items()})
    out["cap"] = dfa_scan.settled_last(*cap_automaton(seed=3))
    out["skip4"] = FusedScanKernel(compile_fused(
        SKIP4_SET, note_demotions=False)).arrays
    return out


@pytest.mark.parametrize("name", ["java_filter", "status", "health",
                                  "limit_dfa", "java_start_continue",
                                  "near_cap", "bit31", "cap", "skip4"])
def test_skip_escapes_equal_brute_force(name):
    """``skip_escapes`` (in every ``AutomatonArrays``) gives each skip
    state its escape bytes, packed lowest first with the first repeated,
    and their count, and 0 / 0 to every other state; the skip table K4
    reads is ``count << 32 | bytes``."""
    arrays = _skip_automata()[name]
    brute = _brute_escapes(arrays.t256, arrays.first_settled)
    for s, (esc, skip) in enumerate(brute):
        n = int(arrays.n_escapes[s])
        packed = int(arrays.escapes[s])
        if not skip:
            assert n == 0 and packed == 0, (name, s)
            continue
        got = [(packed >> (8 * k)) & 0xFF for k in range(4)]
        assert n == len(esc) and set(got) == esc, (name, s)
        assert got[:n] == sorted(esc) and got[n:] == got[:1] * (4 - n)
    table = arrays.skip_table()
    assert table.dtype == np.uint64
    np.testing.assert_array_equal(table >> np.uint64(32), arrays.n_escapes)
    n_skip = int((arrays.n_escapes > 0).sum())
    assert n_skip == {"java_start_continue": 2, "skip4": 1, "cap": 0,
                      "bit31": 0, "near_cap": n_skip}.get(name, n_skip)


def test_five_escape_bytes_make_no_skip_state():
    """A state that five bytes leave is not a skip state; four is one."""
    t = np.zeros((3, 256), np.uint8)
    t[0] = 0
    t[0, [1, 2, 3, 4, 5]] = 1          # five escape bytes
    t[1] = 1
    t[1, [7, 8, 9, 10]] = 2            # four
    t[2] = 2                           # absorbing: settled
    esc, n = dfa_scan.skip_escapes(t, first_settled=2)
    assert n.tolist() == [0, 4, 0] and esc[0] == 0
    assert esc[1] == 7 | 8 << 8 | 9 << 16 | 10 << 24
    _, n1 = dfa_scan.skip_escapes(t[:, :], first_settled=1)
    assert n1.tolist() == [0, 0, 0]    # from first_settled on: no skip


def _skip_twin(arrays, rows, lengths, ignore_length=False,
               resume_late=False):
    """K4's walk in numpy, as ``fused_scan_walk`` runs it on aligned rows:
    a 16-byte word at a time; where a word starts in a settled state, stop;
    in a skip state, find the first escape byte below the length from this
    word on, in 16-byte words (none: stop), and walk that byte's word
    through the table from its first byte (the bytes before the escape
    leave the state as it is); else walk the word.  Returns the accept
    value per row and the bytes each row walked through the table.
    ``ignore_length`` scans to the row's end; ``resume_late`` walks from
    the byte after the escape byte."""
    t = arrays.t256.astype(np.int64)
    fs = arrays.first_settled
    B, L = rows.shape
    out, walked = np.empty(B, np.int32), np.zeros(B, np.int64)
    for r in range(B):
        n = int(np.clip(lengths[r], 0, L))
        limit = L if ignore_length else n
        s, w = arrays.start, 0
        while 16 * w < n and s < fs:
            a = 0
            if arrays.n_escapes[s]:
                esc = {(int(arrays.escapes[s]) >> (8 * k)) & 0xFF
                       for k in range(4)}
                hit = [p for p in range(16 * w, limit)
                       if rows[r, p] in esc]
                if not hit:
                    break
                w, a = divmod(hit[0], 16)
                a = a + 1 if resume_late else 0
            for p in range(16 * w + a, min(16 * w + 16, limit)):
                s = int(t[s, rows[r, p]])
                walked[r] += 1
            w += 1
        out[r] = arrays.accept[s]
    return out, walked


def _skip_batches(L):
    """(label, patterns, rows, lengths): path 2's Java lines, and the skip
    rows (``testdata.skip_rows``) of the start/continue set and of the
    four- and five-escape set."""
    from loongcollector_tpu_torch.testdata import (SKIP4_SET, skip_matrix,
                                                   skip_rows)
    java = [x[:L] for x in gen_java_log(300, seed=L)]
    lens = np.array([len(x) for x in java], np.int32)
    arena = np.frombuffer(b"".join(java), np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    batch = pack_rows(arena, offs, lens, L, len(java) + 5)
    out = [("path2", JAVA_SET, batch.rows, batch.lengths)]
    pairs = skip_rows("java", L, seed=L) + skip_rows("java_frame", L,
                                                     seed=L + 1)
    out.append(("skip_java", JAVA_SET, *skip_matrix(pairs, L)))
    pairs = skip_rows("skip4", L, seed=L) + skip_rows("skip5", L, seed=L)
    out.append(("skip_4_5", SKIP4_SET, *skip_matrix(pairs, L)))
    return out


@pytest.mark.parametrize("L", [128, 256])
def test_skip_walk_twin_equals_plain_and_jax(L):
    """The twin of K4's skip walk equals the plain K4 and the JAX
    ``build_fused_scan_fn`` on path 2's rows and on the skip rows (escape
    bytes at word edges +-1, at the length and one past it, inside the
    row); a Java header line walks ~a word through the table, not its
    length."""
    for label, pats, rows, lengths in _skip_batches(L):
        ref = ref_fuse.compile_fused(pats, note_demotions=False)
        want = np.asarray(jax.jit(build_fused_scan_fn(ref))(rows, lengths))
        kern = FusedScanKernel(compile_fused(pats, note_demotions=False))
        plain = kern.plain(torch.from_numpy(rows),
                           torch.from_numpy(lengths)).numpy()
        np.testing.assert_array_equal(plain, want, err_msg=label)
        got, walked = _skip_twin(kern.arrays, rows, lengths)
        np.testing.assert_array_equal(got, want, err_msg=label)
        lens = np.clip(lengths, 0, L)
        assert (walked <= lens).all()
        if label == "path2":
            heads = np.array([bool(re.match(rb"\d{4}-", bytes(rows[i, :5])))
                              for i in range(len(rows))])
            long_heads = heads & (lens >= 64)
            assert long_heads.any()
            assert (walked[long_heads] <= 32).all()


@pytest.mark.parametrize("mutation", ["ignore_length", "resume_late"])
def test_skip_walk_twin_mutations_fail(mutation):
    """Two faults of the twin each show on the skip rows: a scan that
    ignores the length (an escape byte past it resumes the walk), and a
    resume one byte after the escape byte (the escape byte never walked)."""
    failed = 0
    for L in (128, 256):
        for label, pats, rows, lengths in _skip_batches(L):
            kern = FusedScanKernel(compile_fused(pats, note_demotions=False))
            want = kern.plain(torch.from_numpy(rows),
                              torch.from_numpy(lengths)).numpy()
            got, _ = _skip_twin(kern.arrays, rows, lengths,
                                **{mutation: True})
            failed += int((got != want).any())
    assert failed >= 3
