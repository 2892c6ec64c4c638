"""The port's RegexEngine against the JAX package's, on the CPU.

``parse_batch(device="cpu")`` in the port must return the same
arena-absolute spans as the reference ``RegexEngine.parse_batch`` on its
device route (``LOONG_NATIVE_T1=0``: packed [B, L] batches through the
XLA kernel, row origins added, oversize rows through ``re``), over an
Apache corpus mixed with rows longer than 4096 bytes and non-matching
noise.  Bit-exact: the outputs are bools and int32 spans.
"""

import re

import numpy as np
import pytest

from loongcollector_tpu.ops.regex.engine import RegexEngine as RefEngine
from loongcollector_tpu_torch.ops.regex import engine as port_engine
from loongcollector_tpu_torch.ops.regex.program import PatternTier
from loongcollector_tpu_torch.testdata import APACHE, gen_lines


def _layout(lines):
    lens = np.array([len(x) for x in lines], np.int32)
    arena = np.frombuffer(b"".join(lines), np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    return arena, offs, lens


def _corpus(seed):
    rng = np.random.default_rng(seed)
    lines = gen_lines(300, seed=seed)
    for i in range(0, 300, 37):
        # oversize rows: one matching (a long URL), one not
        lines[i] = lines[i].replace(b" HTTP/", b"x" * 5000 + b" HTTP/")
        lines[i + 1] = bytes(rng.integers(32, 127, 4200, dtype=np.uint8))
    for i in range(5, 300, 11):
        lines[i] = bytes(rng.integers(32, 127, int(rng.integers(0, 90)),
                                      dtype=np.uint8))
    return lines


@pytest.mark.parametrize("seed", range(2))
def test_parse_batch_matches_reference(monkeypatch, seed):
    monkeypatch.setenv("LOONG_NATIVE_T1", "0")
    lines = _corpus(seed)
    arena, offs, lens = _layout(lines)
    ref = RefEngine(APACHE).parse_batch(arena, offs, lens)
    eng = port_engine.RegexEngine(APACHE, device="cpu")
    assert eng.tier is PatternTier.SEGMENT
    got = eng.parse_batch(arena, offs, lens)
    np.testing.assert_array_equal(np.asarray(ref.ok), got.ok)
    np.testing.assert_array_equal(np.asarray(ref.cap_off), got.cap_off)
    np.testing.assert_array_equal(np.asarray(ref.cap_len), got.cap_len)
    assert got.ok.sum() > 250 and (~got.ok).sum() > 20
    assert eng.re_oversize_rows == int((lens > 4096).sum()) > 0
    assert eng.device_batches == 1 and eng.re_tier_rows == 0


def test_over_kernel_limits_takes_re_tier_at_build():
    """33 captures exceed the kernel's 32 (the caps-overflow case of
    tests/test_native_t1.py): decided once, when the engine is built,
    logged as a demotion, and every row is counted on the re route."""
    pattern = "".join(r"(\d)-" for _ in range(33))[:-1]
    eng = port_engine.RegexEngine(pattern, device="cpu")
    assert eng.tier is PatternTier.CPU and eng.kernel is None
    assert "33 captures" in port_engine.demotions[pattern]
    lines = [b"-".join(b"%d" % (i % 10) for i in range(33)), b"1-2", b""]
    arena, offs, lens = _layout(lines)
    got = eng.parse_batch(arena, offs, lens)
    assert eng.re_tier_rows == 3 and eng.device_batches == 0
    rx = re.compile(pattern.encode())
    assert got.ok.tolist() == [True, False, False]
    m = rx.fullmatch(lines[0])
    assert got.cap_off[0].tolist() == [m.start(g + 1) for g in range(33)]
    assert got.cap_len[0].tolist() == [1] * 33
    # the reference runs it at its SEGMENT tier: same matches and spans
    ref = RefEngine(pattern).parse_batch(arena, offs, lens)
    np.testing.assert_array_equal(np.asarray(ref.ok), got.ok)
    np.testing.assert_array_equal(np.asarray(ref.cap_len), got.cap_len)
    np.testing.assert_array_equal(np.asarray(ref.cap_off)[0], got.cap_off[0])


def test_get_engine_caches_per_device():
    a = port_engine.get_engine(APACHE, "cpu")
    assert port_engine.get_engine(APACHE.encode(), "cpu") is a
