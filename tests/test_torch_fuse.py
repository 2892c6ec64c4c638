"""The port's DFA compilers and fused-set execution against the JAX
package's, on the CPU.

* ``compile_dfa`` and ``compile_fused`` give the reference's tables:
  ``byte_class``, ``transitions``, ``start`` and the accept arrays, state
  numbering included (Hopcroft's partition order decides it), and the same
  members and demotions.
* ``FusedSetExec.classify`` equals the reference's on the host route and
  on the device route (``force=``; the port's device route on the CPU is
  K4's plain version, the reference's its jitted program), rows over the
  largest bucket included; the counts of device batches and host rows.
* ``ByteTableScanner`` with the native library and with its numpy walk.
* Demotion notes, ``fusion_status`` and the in-memory LRU.
"""

import re

import numpy as np
import pytest

from loongcollector_tpu.ops.regex import fuse as ref_fuse
from loongcollector_tpu.ops.regex.dfa import compile_dfa as ref_compile_dfa
from loongcollector_tpu.ops.regex.grok import expand as ref_expand
from loongcollector_tpu_torch import native
from loongcollector_tpu_torch.ops.regex import fuse
from loongcollector_tpu_torch.ops.regex.dfa import DFAUnsupported, compile_dfa
from loongcollector_tpu_torch.testdata import (BIT31_SET, JAVA_CONTINUE,
                                               JAVA_FILTER, JAVA_START,
                                               LIMIT_DFA, NEAR_CAP_SET,
                                               gen_java_log, gen_lines)

DFA_PATTERNS = [
    r"(?:GET|POST|PUT) /\S*", r"(?:ab)+x", r"(?:GET|POST|DELETE|PUT|HEAD) .*",
    r"[a-z]+\d*(?:-[a-z0-9]+)*", r"(?:ERROR|WARN|INFO|DEBUG):.*",
    r"(?:ERROR|WARN):\d+ .*", JAVA_FILTER, JAVA_CONTINUE, JAVA_START,
    LIMIT_DFA, r"^a{2,5}(?:b|cd)*$", r"\Aend[^x]?\Z",
]
SETS = {
    "mixed": [r"\d{4}-\d{2}-\d{2} .*", r"\s+at .*", r"(\w+)=(\d+)", r"\d+",
              r"[a-z]+"],
    "java": [JAVA_START, JAVA_CONTINUE],
    "java_end": [JAVA_START, JAVA_CONTINUE, r".*Exception.*"],
    "near_cap": NEAR_CAP_SET,
    "bit31": BIT31_SET,
    "grok": [ref_expand("%{COMMONAPACHELOG}"), r"\d{4}-\d{2}-\d{2} .*",
             r"\s+at .*", r"(\w+)=(\d+)"],
    "demoting": [r"\d+", r"(?P<a>x)\1", r"[a-z]+"],
}


@pytest.fixture(autouse=True)
def _fresh_fuse_state():
    fuse.reset_for_testing()
    ref_fuse.reset_for_testing()
    yield
    fuse.reset_for_testing()
    ref_fuse.reset_for_testing()


@pytest.mark.parametrize("pattern", DFA_PATTERNS)
def test_compile_dfa_tables_equal_reference(pattern):
    ref = ref_compile_dfa(pattern)
    got = compile_dfa(pattern)
    assert (got.num_states, got.num_classes, got.start, got.dead) \
        == (ref.num_states, ref.num_classes, ref.start, ref.dead)
    np.testing.assert_array_equal(got.byte_class, ref.byte_class)
    np.testing.assert_array_equal(got.transitions, ref.transitions)
    np.testing.assert_array_equal(got.accepting, ref.accepting)


@pytest.mark.parametrize("pattern", [r"(a+)b\1", r"a(?=b)", r"a{100}",
                                     r"\bword\b", r"a(?i:b)"])
def test_compile_dfa_refuses_as_reference(pattern):
    with pytest.raises(Exception) as ref_err:
        ref_compile_dfa(pattern)
    with pytest.raises(DFAUnsupported):
        compile_dfa(pattern)
    assert type(ref_err.value).__name__ == "DFAUnsupported"


def _assert_fused_equal(got, ref):
    assert got.patterns == ref.patterns and got.names == ref.names
    assert [d[:2] for d in got.demoted] == [d[:2] for d in ref.demoted]
    assert (got.num_states, got.num_classes, got.start, got.device_ok) \
        == (ref.num_states, ref.num_classes, ref.start, ref.device_ok)
    np.testing.assert_array_equal(got.byte_class, ref.byte_class)
    np.testing.assert_array_equal(got.transitions, ref.transitions)
    np.testing.assert_array_equal(got.accept_tags, ref.accept_tags)
    assert got.accept_tags.dtype == np.uint32


@pytest.mark.parametrize("name", sorted(SETS))
def test_compile_fused_tables_equal_reference(name):
    pats = SETS[name]
    _assert_fused_equal(fuse.compile_fused(pats),
                        ref_fuse.compile_fused(pats, alarm_demotions=False))


def test_budget_demotion_equals_reference():
    big = r"(?:ab){40,64}x"
    pats = [r"\d+", big, r"[a-z]+"]
    got = fuse.compile_fused(pats, max_states=64)
    ref = ref_fuse.compile_fused(pats, max_states=64, alarm_demotions=False)
    _assert_fused_equal(got, ref)
    assert got.patterns == [r"\d+", r"[a-z]+"]
    assert got.demoted[0][1] == big and big in fuse.demotions


def _layout(lines):
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines) or b"\0", np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    return arena, offs, lens


def _corpus(seed):
    rng = np.random.default_rng(seed)
    lines = gen_java_log(400, seed=seed) + gen_lines(60, seed=seed)
    lines += [b"a" * 5000, b"2024-01-01 " + b"x" * 4200, b"", b"ff31",
              b"k=12"]
    for i in range(0, len(lines), 7):
        if lines[i]:
            b = bytearray(lines[i])
            b[int(rng.integers(len(b)))] = int(rng.integers(256))
            lines[i] = bytes(b)
    return lines


@pytest.mark.parametrize("name", ["java", "grok", "bit31", "demoting"])
@pytest.mark.parametrize("route", ["host", "device"])
def test_classify_equals_reference(monkeypatch, name, route):
    monkeypatch.setenv("LOONG_NATIVE_T1", "0")
    pats = SETS[name]
    lines = _corpus(len(name))
    arena, offs, lens = _layout(lines)
    ref = ref_fuse.FusedSetExec(pats)
    want = ref.classify(arena, offs, lens, force=route)
    fs = fuse.FusedSetExec(pats, device="cpu")
    got = fs.classify(arena, offs, lens, force=route)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert fs.bit_of == ref.bit_of
    for g, w in zip(fs.member_masks(got), ref.member_masks(want)):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
    over = int((lens > 4096).sum())
    if route == "host":
        assert (fs.device_batches, fs.host_rows) == (0, len(lines))
    else:
        assert (fs.device_batches, fs.host_rows) == (1, over) and over == 2
    # the oracle
    rxs = [re.compile(p.encode("latin-1")) for p in fs.fdfa.patterns]
    for i, x in enumerate(lines):
        assert int(got[i]) == sum(1 << b for b, r in enumerate(rxs)
                                  if r.fullmatch(x))


def test_classify_default_route_is_the_device_when_device_ok():
    fs = fuse.FusedSetExec(SETS["java"], device="cpu")
    assert fs.fdfa.device_ok and fs.kernel is not None
    arena, offs, lens = _layout(_corpus(1))
    fs.classify(arena, offs, lens)
    assert fs.device_batches == 1 and fs.host_rows == 2
    fs.reset_counts()
    assert (fs.device_batches, fs.host_rows) == (0, 0)


@pytest.mark.parametrize("with_native", [True, False])
def test_byte_table_scanner(monkeypatch, with_native):
    if not with_native:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    lines = _corpus(5)
    arena, offs, lens = _layout(lines)
    lens[3] = -1                             # an absent span scans as empty
    offs[4] = len(arena) + 10                # outside the arena: tag 0
    for pats in (SETS["java"], SETS["bit31"]):
        got = fuse.ByteTableScanner.from_fused(
            fuse.compile_fused(pats)).scan(arena, offs, lens)
        want = ref_fuse.ByteTableScanner.from_fused(
            ref_fuse.compile_fused(pats, alarm_demotions=False)).scan(
                arena, offs, lens)
        np.testing.assert_array_equal(got, want)
        assert got[4] == 0
    dfa = compile_dfa(JAVA_FILTER)
    got = fuse.ByteTableScanner.from_dfa(dfa).scan(arena, offs, lens)
    rx = re.compile(JAVA_FILTER.encode())
    for i in range(10, len(lines)):
        assert bool(got[i]) == (rx.fullmatch(lines[i]) is not None)


def test_demotion_notes_and_status():
    before = fuse.fusion_status()["demotions"]
    pat = r"(?P<a>x)\1"
    fuse.note_demotion(pat, "test reason")
    fuse.note_demotion(pat, "test reason")
    st = fuse.fusion_status()
    assert st["demotions"] == before + 2
    assert fuse.demotions[pat] == "test reason"
    fs = fuse.try_build_set(SETS["demoting"], device="cpu")
    assert fs.bit_of == {0: 0, 2: 1} and fs.n_fused == 2
    assert "unsupported" in fuse.demotions[pat]
    assert fuse.try_build_set([pat], device="cpu") is None
    sets = fuse.fusion_status()["sets"]
    assert sets[-1]["demoted"][0][0] == "p1"


def test_load_or_compile_lru():
    a = fuse.load_or_compile(SETS["java"])
    b = fuse.load_or_compile(SETS["java"])
    assert a is b
    st = fuse.fusion_status()
    assert (st["compiles"], st["cache_hits"], st["cache_misses"]) == (1, 1, 1)
    c = fuse.load_or_compile(SETS["java"] + [r"\d+"])
    assert c is not a and len(c.patterns) == 3
