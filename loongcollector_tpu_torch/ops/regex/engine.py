"""Regex engine: tier selection + synchronous batch orchestration.

The single entry point processors use.  Given a pattern and a device, it
picks the execution tier — the Tier-1 SEGMENT kernel, or Python ``re`` —
owns geometry bucketing and row packing, and returns arena-absolute capture
spans so downstream stays zero-copy.

Two routes send rows to ``re``, both part of the reference's semantics:
rows longer than ``LENGTH_BUCKETS[-1]``, and patterns with no device tier.
A pattern ``compile_tier1`` refuses runs on ``re`` here (the JAX package
would try its DFA tier; that kernel is not ported yet), and so does a
program over the CUDA kernel's build-time limits — decided once, when the
engine is built, logged and counted in ``demotions``.  The engine counts
the rows of each route (``re_oversize_rows``, ``re_tier_rows``) and its
device batches.

``parse_batch`` is synchronous: per chunk of at most ``MAX_BATCH`` rows it
picks the length bucket, packs ``[B, L]`` rows, copies them to the device,
launches the kernel, copies the spans back and adds the row origins.
"""

from __future__ import annotations

import re
import threading
from collections import OrderedDict
from typing import Dict, Optional, Union

import numpy as np
import torch

from ...utils.device import resolve_device
from ...utils.logger import get_logger
from ..device_batch import (LENGTH_BUCKETS, MAX_BATCH, pack_rows, pad_batch,
                            pick_length_bucket)
from ..kernels.field_extract import ExtractKernel
from .native_exec import NativeUnsupported
from .program import PatternTier, Tier1Unsupported, compile_tier1

log = get_logger("regex")

# pattern -> reason, for every pattern that fell off the device tier
demotions: Dict[str, str] = {}


def note_demotion(pattern: str, reason: str) -> None:
    if pattern not in demotions:
        log.warning("pattern %r runs on Python re: %s", pattern, reason)
    demotions[pattern] = reason


def _chunks(idx: np.ndarray, size: int):
    for i in range(0, len(idx), size):
        yield idx[i: i + size]


class BatchParseResult:
    """ok: bool [N]; cap_off/cap_len: int32 [N, C] arena-absolute spans
    (len -1 ⇒ no capture / failed parse)."""

    __slots__ = ("ok", "cap_off", "cap_len")

    def __init__(self, ok, cap_off, cap_len):
        self.ok = ok
        self.cap_off = cap_off
        self.cap_len = cap_len


_engine_cache: "OrderedDict" = OrderedDict()
_engine_cache_lock = threading.Lock()
_ENGINE_CACHE_MAX = 512


def cached_engines():
    with _engine_cache_lock:
        return list(_engine_cache.values())


def get_engine(pattern: Union[str, bytes],
               device: Union[str, torch.device, None] = None
               ) -> "RegexEngine":
    """Process-wide engine cache keyed by (pattern, device).  ``device``
    defaults to CUDA and raises when no CUDA device exists."""
    if isinstance(pattern, bytes):
        pattern = pattern.decode("latin-1")
    dev = resolve_device(device)
    key = (pattern, str(dev))
    with _engine_cache_lock:
        eng = _engine_cache.get(key)
        if eng is not None:
            _engine_cache.move_to_end(key)  # LRU touch
            return eng
    eng = RegexEngine(pattern, dev)
    with _engine_cache_lock:
        eng = _engine_cache.setdefault(key, eng)
        while len(_engine_cache) > _ENGINE_CACHE_MAX:
            _engine_cache.popitem(last=False)  # evict least-recently used
    return eng


class RegexEngine:
    def __init__(self, pattern: Union[str, bytes],
                 device: Union[str, torch.device, None] = None):
        if isinstance(pattern, bytes):
            pattern = pattern.decode("latin-1")
        self.pattern = pattern
        self.device = resolve_device(device)
        self._re = re.compile(pattern.encode("latin-1"))
        self.num_caps = self._re.groups
        self.group_names = {v - 1: k for k, v in self._re.groupindex.items()}
        self.kernel: Optional[ExtractKernel] = None
        self.tier = PatternTier.CPU
        self.device_batches = 0
        self.re_oversize_rows = 0
        self.re_tier_rows = 0
        try:
            self.kernel = ExtractKernel(compile_tier1(pattern))
            self.tier = PatternTier.SEGMENT
            self.kernel.warm(self.device)
        except Tier1Unsupported:
            note_demotion(pattern, "Tier-1 compile refused (the DFA tier "
                          "is not ported yet)")
        except NativeUnsupported as e:
            note_demotion(pattern, f"over the kernel's limits: {e}")

    def reset_counts(self) -> None:
        self.device_batches = 0
        self.re_oversize_rows = 0
        self.re_tier_rows = 0
        if self.kernel is not None:
            self.kernel.reset_counts()

    def parse_batch(self, arena: np.ndarray, offsets: np.ndarray,
                    lengths: np.ndarray) -> BatchParseResult:
        """Full-match + captures for N events over a shared arena."""
        offsets = np.asarray(offsets, dtype=np.int64)
        lengths = np.asarray(lengths, dtype=np.int32)
        n = len(offsets)
        C = max(self.num_caps, 1)
        ok = np.zeros(n, dtype=bool)
        cap_off = np.zeros((n, C), dtype=np.int32)
        cap_len = np.full((n, C), -1, dtype=np.int32)
        if n == 0:
            return BatchParseResult(ok, cap_off, cap_len)

        if self.kernel is None:
            cpu_idx = np.arange(n)
            device_idx = cpu_idx[:0]
            self.re_tier_rows += n
        else:
            over = lengths > LENGTH_BUCKETS[-1]
            device_idx = np.nonzero(~over)[0]
            cpu_idx = np.nonzero(over)[0]
            self.re_oversize_rows += len(cpu_idx)

        for chunk in _chunks(device_idx, MAX_BATCH):
            d_off = offsets[chunk]
            d_len = lengths[chunk]
            L = pick_length_bucket(int(d_len.max())) or LENGTH_BUCKETS[-1]
            batch = pack_rows(arena, d_off, d_len, L, pad_batch(len(chunk)))
            rows = torch.from_numpy(batch.rows).to(self.device)
            lens = torch.from_numpy(batch.lengths).to(self.device)
            k_ok, k_off, k_len = (t[: batch.n_real].cpu().numpy()
                                  for t in self.kernel(rows, lens))
            self.device_batches += 1
            ok[chunk] = k_ok
            # row-relative -> arena-absolute
            cap_off[chunk] = k_off + batch.origins[: batch.n_real, None]
            cap_len[chunk] = k_len
        self._cpu_fallback_rows(arena, offsets, lengths, cpu_idx,
                                ok, cap_off, cap_len)
        return BatchParseResult(ok, cap_off, cap_len)

    def _cpu_fallback_rows(self, arena, offsets, lengths, cpu_idx,
                           ok, cap_off, cap_len) -> None:
        for i in cpu_idx:
            o, ln = int(offsets[i]), int(lengths[i])
            m = self._re.fullmatch(bytes(arena[o: o + ln].tobytes()))
            if m is not None:
                ok[i] = True
                for g in range(self.num_caps):
                    s, e = m.span(g + 1)
                    if s >= 0:
                        cap_off[i, g] = o + s
                        cap_len[i, g] = e - s
