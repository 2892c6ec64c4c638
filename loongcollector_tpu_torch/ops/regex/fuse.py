"""loongfuse: ahead-of-time multi-pattern DFA fusion, reduced to the set form.

The port's copy of the JAX package's ``ops/regex/fuse.py``.  A pipeline's
pattern SET (multiline start/continue/end, grok ``Match`` lists) compiles
into one minimized multi-accept DFA, so a single scan classifies every
pattern at once:

1. **Compiler** (``compile_fused`` / ``load_or_compile``): per-pattern
   Thompson NFAs share one state space, a common ε-start forms the
   product, subset construction carries per-pattern accept TAGS, and
   Hopcroft minimization runs with the initial partition split by tag set.
   The tables equal the reference's, state numbering included
   (``tests/test_torch_fuse.py``).  A pattern that blows the budget is
   demoted with a recorded reason (``note_demotion``) and keeps its
   per-pattern path.  ``load_or_compile`` keeps the reference's in-memory
   LRU; its on-disk cache waits for tail mode.
2. **Host scanner** (``ByteTableScanner``): the byte-indexed table
   ``t256[s, b]`` walked by the native ``lct_dfa_scan`` (``native.py``), or
   by a numpy lockstep walk with the same tags when the library is absent.
3. **Set execution** (``FusedSetExec`` / ``try_build_set``): ``classify``
   sends every row within the length buckets to K4 (the CUDA table walk of
   ``ops/kernels/dfa_scan.py``) on the set's device when the automaton is
   ``device_ok``, in chunks of ``MAX_BATCH``; rows over the largest bucket
   and sets that are not ``device_ok`` go to the host scanner, counted in
   ``host_rows``.

Left out: ``FusedSingleExec`` and its variant machinery (the host-walker
routing, still queued) and the reference's latency-probe byte threshold.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ... import native
from ...utils.device import resolve_device
from ...utils.logger import get_logger
from .dfa import DFAUnsupported, _NFA, build_pattern_nfa

log = get_logger("fuse")

# Tiered caps (reference fuse.py:90-94).  The fused automaton may use the
# host caps; ``device_ok`` records whether it also fits the device tier's
# caps, kept from the reference so the two packages route the same sets.
FUSED_MAX_STATES = 2048
FUSED_MAX_CLASSES = 96
DEVICE_MAX_STATES = 128
DEVICE_MAX_CLASSES = 48
MAX_PATTERNS = 32            # accept tags ride a uint32 bitmask


class FuseUnsupported(Exception):
    pass


# ---------------------------------------------------------------------------
# Fused compile: product NFA -> multi-accept subset construction -> Hopcroft
# ---------------------------------------------------------------------------


@dataclass
class FusedDFA:
    patterns: List[str]           # fused members, priority order (bit i)
    names: List[str]
    num_states: int
    num_classes: int
    byte_class: np.ndarray        # [256] uint8
    transitions: np.ndarray       # [S, K] int32
    start: int
    accept_tags: np.ndarray       # [S] uint32 bitmask of accepting patterns
    demoted: List[Tuple[str, str, str]] = field(default_factory=list)
    stats: Dict[str, object] = field(default_factory=dict)

    @property
    def device_ok(self) -> bool:
        return (self.num_states <= DEVICE_MAX_STATES
                and self.num_classes <= DEVICE_MAX_CLASSES)

    def match_cpu(self, data: bytes) -> int:
        """Reference interpreter (tests): accept-tag bitmask for `data`."""
        s = self.start
        for b in data:
            s = int(self.transitions[s, self.byte_class[b]])
        return int(self.accept_tags[s])


def _closures(nfa: _NFA) -> List[frozenset]:
    closure: List[frozenset] = []
    for i in range(len(nfa.eps)):
        seen = {i}
        stack = [i]
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        closure.append(frozenset(seen))
    return closure


def _determinize(nfa: _NFA, starts: List[int], accepts: List[int],
                 max_states: int, max_classes: int
                 ) -> Tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """Multi-accept subset construction over a shared NFA.

    `starts[i]`/`accepts[i]` are pattern i's NFA entry/accept states; the
    DFA state containing accepts[i] carries tag bit i.  Returns
    (byte_class, transitions, start, accept_tags)."""
    closure = _closures(nfa)
    masks: List[np.ndarray] = [mask for trans in nfa.trans
                               for mask, _ in trans]
    if masks:
        sig = np.stack(masks).astype(np.uint8)
        _, byte_class = np.unique(sig.T, axis=0, return_inverse=True)
        byte_class = byte_class.astype(np.uint8)
    else:
        byte_class = np.zeros(256, dtype=np.uint8)
    num_classes = int(byte_class.max()) + 1
    if num_classes > max_classes:
        raise DFAUnsupported(f"{num_classes} byte classes > {max_classes}")
    class_rep = np.zeros(num_classes, dtype=np.int32)
    for k in range(num_classes):
        class_rep[k] = int(np.argmax(byte_class == k))

    def step(states: frozenset, byte: int) -> frozenset:
        out: set = set()
        for s in states:
            for mask, t in nfa.trans[s]:
                if mask[byte]:
                    out.update(closure[t])
        return frozenset(out)

    start_set = frozenset().union(*(closure[s] for s in starts)) \
        if starts else frozenset()
    dfa_states: Dict[frozenset, int] = {}
    order: List[frozenset] = []

    def intern(fs: frozenset) -> int:
        if fs not in dfa_states:
            if len(order) >= max_states:
                raise DFAUnsupported(f"fused DFA exceeds {max_states} states")
            dfa_states[fs] = len(order)
            order.append(fs)
        return dfa_states[fs]

    dead_id = intern(frozenset())
    start_id = intern(start_set)
    trans_rows: List[List[int]] = [[dead_id] * num_classes]
    i = 1
    while i < len(order):
        fs = order[i]
        trans_rows.append(
            [intern(step(fs, int(class_rep[k]))) for k in range(num_classes)])
        i += 1

    transitions = np.array(trans_rows, dtype=np.int32)
    accept_tags = np.zeros(len(order), dtype=np.uint32)
    for bit, acc in enumerate(accepts):
        for sid, fs in enumerate(order):
            if acc in fs:
                accept_tags[sid] |= np.uint32(1 << bit)
    return byte_class, transitions, start_id, accept_tags


def _hopcroft(transitions: np.ndarray, accept_tags: np.ndarray,
              start: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Partition-refinement minimization preserving accept TAG SETS (two
    states are distinguishable when their tag bitmasks differ).  The
    worklist and block numbering follow the reference step for step: the
    numbering is part of the tables the tests compare."""
    S, K = transitions.shape
    block_of = np.zeros(S, dtype=np.int64)
    blocks: Dict[int, int] = {}
    for s in range(S):
        t = int(accept_tags[s])
        if t not in blocks:
            blocks[t] = len(blocks)
        block_of[s] = blocks[t]
    n_blocks = len(blocks)

    # inverse transition lists: inv[k][s'] = states s with δ(s,k)=s'
    inv: List[List[List[int]]] = [[[] for _ in range(S)] for _ in range(K)]
    for s in range(S):
        for k in range(K):
            inv[k][int(transitions[s, k])].append(s)

    members: List[set] = [set() for _ in range(n_blocks)]
    for s in range(S):
        members[block_of[s]].add(s)
    worklist = set(range(n_blocks))
    while worklist:
        a = worklist.pop()
        splitter = list(members[a])
        for k in range(K):
            x = set()
            for sprime in splitter:
                x.update(inv[k][sprime])
            if not x:
                continue
            touched: Dict[int, set] = {}
            for s in x:
                touched.setdefault(block_of[s], set()).add(s)
            for b, inter in touched.items():
                if len(inter) == len(members[b]):
                    continue
                new_b = len(members)
                members.append(inter)
                members[b] -= inter
                for s in inter:
                    block_of[s] = new_b
                if b in worklist:
                    worklist.add(new_b)
                else:
                    worklist.add(
                        new_b if len(inter) <= len(members[b]) else b)

    n_final = len(members)
    new_trans = np.zeros((n_final, K), dtype=np.int32)
    new_tags = np.zeros(n_final, dtype=np.uint32)
    rep = [min(m) if m else 0 for m in members]
    for b in range(n_final):
        r = rep[b]
        new_tags[b] = accept_tags[r]
        for k in range(K):
            new_trans[b, k] = block_of[int(transitions[r, k])]
    return new_trans, new_tags, int(block_of[start])


def compile_fused(patterns: Sequence[Union[str, bytes]],
                  names: Optional[Sequence[str]] = None,
                  max_states: int = FUSED_MAX_STATES,
                  max_classes: int = FUSED_MAX_CLASSES,
                  note_demotions: bool = True) -> FusedDFA:
    """AOT-fuse `patterns` (priority order) into one multi-accept DFA.

    Patterns that cannot join (unsupported constructs, or the set blows the
    state/class budget) are demoted with a recorded reason; the remaining
    set still fuses.  Raises FuseUnsupported only when NO pattern
    survives."""
    t0 = time.perf_counter()
    names = list(names) if names is not None else \
        [f"p{i}" for i in range(len(patterns))]
    patterns = [p.decode("latin-1") if isinstance(p, bytes) else p
                for p in patterns]
    demoted: List[Tuple[str, str, str]] = []

    # individually validate + size each pattern (the demotion heuristic
    # needs per-pattern state counts to pick the budget-blowing culprit)
    sizes: Dict[int, int] = {}
    kept: List[int] = []
    for i, p in enumerate(patterns):
        try:
            nfa_i = _NFA()
            _, s_i, a_i = build_pattern_nfa(p, nfa_i)
            _, tr_i, _, _ = _determinize(nfa_i, [s_i], [a_i], max_states,
                                         max_classes)
            sizes[i] = tr_i.shape[0]
            kept.append(i)
        except DFAUnsupported as e:
            demoted.append((names[i], p, f"unsupported: {e}"))
    while len(kept) > MAX_PATTERNS:
        i = kept.pop()
        demoted.append((names[i], patterns[i],
                        f"pattern set exceeds {MAX_PATTERNS} accept tags"))

    byte_class = transitions = accept_tags = None
    start = 0
    while kept:
        nfa = _NFA()
        starts, accepts = [], []
        try:
            for i in kept:
                _, s_i, a_i = build_pattern_nfa(patterns[i], nfa)
                starts.append(s_i)
                accepts.append(a_i)
            byte_class, transitions, start, accept_tags = _determinize(
                nfa, starts, accepts, max_states, max_classes)
            transitions, accept_tags, start = _hopcroft(
                transitions, accept_tags, start)
            break
        except DFAUnsupported as e:
            # demote the largest individual contributor and retry
            worst = max(kept, key=lambda i: sizes[i])
            kept.remove(worst)
            demoted.append((names[worst], patterns[worst],
                            f"fused budget: {e}"))
    if note_demotions:
        for _nm, p, reason in demoted:
            note_demotion(p, reason)
    if not kept:
        raise FuseUnsupported("no pattern in the set is fusable")

    fdfa = FusedDFA(
        patterns=[patterns[i] for i in kept],
        names=[names[i] for i in kept],
        num_states=transitions.shape[0],
        num_classes=transitions.shape[1],
        byte_class=byte_class,
        transitions=transitions,
        start=start,
        accept_tags=accept_tags,
        demoted=demoted,
        stats={"compile_ms": round((time.perf_counter() - t0) * 1e3, 2),
               "states": int(transitions.shape[0]),
               "classes": int(transitions.shape[1]),
               "n_patterns": len(kept),
               "n_demoted": len(demoted)},
    )
    _note_compile(fdfa)
    return fdfa


# ---------------------------------------------------------------------------
# Host scanner: byte-indexed tables + native walk
# ---------------------------------------------------------------------------


class ByteTableScanner:
    """One automaton in runtime form: ``t256[s, b]`` with the class
    compression folded in, u8 state ids when S ≤ 256, u16 above."""

    def __init__(self, byte_class: np.ndarray, transitions: np.ndarray,
                 start: int, accept_tags: np.ndarray):
        S = transitions.shape[0]
        t256 = transitions[:, byte_class]            # [S, 256]
        self.wide = S > 256
        dtype = np.uint16 if self.wide else np.uint8
        self.t256 = np.ascontiguousarray(t256.astype(dtype))
        self.start = int(start)
        self.accept_tags = np.ascontiguousarray(
            accept_tags.astype(np.uint32))
        self.num_states = S

    @classmethod
    def from_fused(cls, fdfa: FusedDFA) -> "ByteTableScanner":
        return cls(fdfa.byte_class, fdfa.transitions, fdfa.start,
                   fdfa.accept_tags)

    @classmethod
    def from_dfa(cls, dfa) -> "ByteTableScanner":
        """Single-pattern Tier-2 DFA as a host scanner: bit 0 ⇔ match."""
        tags = np.where(dfa.accepting, 1, 0).astype(np.uint32)
        return cls(dfa.byte_class, dfa.transitions, dfa.start, tags)

    def scan(self, arena: np.ndarray, offsets: np.ndarray,
             lengths: np.ndarray) -> np.ndarray:
        """uint32 accept-tag bitmask per row.  Negative lengths (absent
        spans) scan as empty strings."""
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        n = len(offsets)
        out = np.zeros(n, dtype=np.uint32)
        if n == 0:
            return out
        arena = np.ascontiguousarray(arena, dtype=np.uint8)
        if native.dfa_scan(arena, offsets, lengths, self.t256,
                           self.num_states, self.wide, self.start,
                           self.accept_tags, out):
            return out
        return self._scan_numpy(arena, offsets, lengths, out)

    def _scan_numpy(self, arena, offsets, lengths, out) -> np.ndarray:
        """Lockstep walk when the native library is absent: all rows
        advance one byte column per step."""
        lens = np.maximum(lengths, 0)
        # native contract: a span outside the arena scans to tag 0
        oob = (offsets < 0) | (offsets + lens > len(arena))
        lens = np.where(oob, 0, lens)
        states = np.full(len(offsets), self.start, dtype=np.int64)
        max_len = int(lens.max()) if len(lens) else 0
        alive = np.nonzero(lens > 0)[0]
        for p in range(max_len):
            alive = alive[lens[alive] > p]
            if not len(alive):
                break
            b = arena[offsets[alive] + p]
            states[alive] = self.t256[states[alive], b]
        out[:] = self.accept_tags[states]
        out[oob] = 0
        return out


# ---------------------------------------------------------------------------
# Compile cache (in memory) and observability
# ---------------------------------------------------------------------------

# LRU-bounded: pattern-set churn must not pin every compiled automaton
_mem_cache: "OrderedDict[tuple, FusedDFA]" = OrderedDict()
_MEM_CACHE_MAX = 128

_stats_lock = threading.Lock()
_fusion_state: Dict[str, object] = {
    "compiles": 0, "cache_hits": 0, "cache_misses": 0, "demotions": 0,
    "sets": [],                 # last 8 compiled sets
}

# pattern -> reason, for every pattern that fell off a device tier
demotions: Dict[str, str] = {}

# every FusedSetExec alive, for the agent's counts
_live_sets: "weakref.WeakSet" = weakref.WeakSet()


def live_sets() -> List["FusedSetExec"]:
    with _stats_lock:
        return list(_live_sets)


def load_or_compile(patterns: Sequence[Union[str, bytes]],
                    names: Optional[Sequence[str]] = None,
                    max_states: int = FUSED_MAX_STATES,
                    max_classes: int = FUSED_MAX_CLASSES,
                    note_demotions: bool = True) -> FusedDFA:
    """``compile_fused`` behind the in-process LRU (pipelines built from
    one config reuse the object)."""
    patterns = [p.decode("latin-1") if isinstance(p, bytes) else p
                for p in patterns]
    key = (tuple(patterns), max_states, max_classes)
    with _stats_lock:
        got = _mem_cache.get(key)
        if got is not None:
            _mem_cache.move_to_end(key)          # LRU touch
            _fusion_state["cache_hits"] += 1
            return got
        _fusion_state["cache_misses"] += 1
    fdfa = compile_fused(patterns, names=names, max_states=max_states,
                         max_classes=max_classes,
                         note_demotions=note_demotions)
    with _stats_lock:
        _mem_cache[key] = fdfa
        _mem_cache.move_to_end(key)
        while len(_mem_cache) > _MEM_CACHE_MAX:
            _mem_cache.popitem(last=False)
    return fdfa


def _note_compile(fdfa: FusedDFA) -> None:
    entry = {"names": list(fdfa.names), "states": fdfa.num_states,
             "classes": fdfa.num_classes, "device_ok": fdfa.device_ok,
             "demoted": [(nm, reason) for nm, _, reason in fdfa.demoted],
             **fdfa.stats}
    with _stats_lock:
        _fusion_state["compiles"] += 1
        sets = _fusion_state["sets"]
        sets.append(entry)
        del sets[:-8]


def note_demotion(pattern: str, reason: str) -> None:
    """A pattern fell off a device tier (fused budget, DFA caps, a
    capture-needing Tier-2 parse).  Counted always, logged once per
    pattern; the alarm plane is not ported yet."""
    with _stats_lock:
        _fusion_state["demotions"] += 1
        first = pattern not in demotions
        demotions[pattern] = reason
    if first:
        log.warning("pattern %r demoted off the device tier: %s", pattern,
                    reason)


def fusion_status() -> Dict[str, object]:
    with _stats_lock:
        return {k: ([dict(s) for s in v] if k == "sets" else v)
                for k, v in _fusion_state.items()}


def reset_for_testing() -> None:
    with _stats_lock:
        _mem_cache.clear()
        demotions.clear()
        _fusion_state.update(compiles=0, cache_hits=0, cache_misses=0,
                             demotions=0, sets=[])


# ---------------------------------------------------------------------------
# Set execution
# ---------------------------------------------------------------------------


class FusedSetExec:
    """One fused automaton over a whole pattern SET: a single scan
    classifies every pattern at once.  Demoted members keep their
    per-pattern path; `bit_of` maps original set positions to accept-tag
    bits.  ``device_batches`` counts K4 batches, ``host_rows`` the rows the
    host scanner walked; both under a lock (runner workers share the
    processor that owns the set)."""

    def __init__(self, patterns: Sequence[Union[str, bytes]],
                 names: Optional[Sequence[str]] = None,
                 device: Union[str, torch.device, None] = None):
        patterns = [p.decode("latin-1") if isinstance(p, bytes) else p
                    for p in patterns]
        self.patterns = patterns
        self.device = resolve_device(device)
        self.fdfa = load_or_compile(patterns, names=names)
        self.scanner = ByteTableScanner.from_fused(self.fdfa)
        self.bit_of: Dict[int, int] = {}
        nb = 0
        for i, p in enumerate(patterns):
            if nb < len(self.fdfa.patterns) and p == self.fdfa.patterns[nb]:
                self.bit_of[i] = nb
                nb += 1
        self.kernel = None
        if self.fdfa.device_ok:
            from ..kernels.dfa_scan import FusedScanKernel
            self.kernel = FusedScanKernel(self.fdfa)
            self.kernel.warm(self.device)
        self.device_batches = 0
        self.host_rows = 0
        self._count_lock = threading.Lock()
        with _stats_lock:
            _live_sets.add(self)

    @property
    def n_fused(self) -> int:
        return len(self.fdfa.patterns)

    def reset_counts(self) -> None:
        with self._count_lock:
            self.device_batches = 0
            self.host_rows = 0
        if self.kernel is not None:
            self.kernel.reset_counts()

    def _host(self, arena, offsets, lengths) -> np.ndarray:
        with self._count_lock:
            self.host_rows += len(offsets)
        return self.scanner.scan(arena, offsets, lengths)

    def classify(self, arena: np.ndarray, offsets: np.ndarray,
                 lengths: np.ndarray,
                 force: Optional[str] = None) -> np.ndarray:
        """uint32 accept-tag bitmask per row; bit b = fused member b
        full-matches.  `force` pins the route ("host"/"device") for
        tests."""
        from ..device_batch import LENGTH_BUCKETS
        from ..kernels.dfa_scan import run_chunks
        offsets = np.asarray(offsets, dtype=np.int64)
        lengths = np.asarray(lengths, dtype=np.int32)
        n = len(offsets)
        if n == 0:
            return np.zeros(0, dtype=np.uint32)
        use_device = force == "device" or (force is None
                                           and self.kernel is not None)
        if not use_device:
            return self._host(arena, offsets, lengths)
        if self.kernel is None:
            from ..kernels.dfa_scan import FusedScanKernel
            self.kernel = FusedScanKernel(self.fdfa)
        tags = np.zeros(n, dtype=np.uint32)
        over = lengths > LENGTH_BUCKETS[-1]
        device_idx = np.nonzero(~over)[0]
        batches = run_chunks(self.kernel, arena, offsets, lengths,
                             device_idx, self.device, tags)
        with self._count_lock:
            self.device_batches += batches
        over_idx = np.nonzero(over)[0]
        if len(over_idx):
            tags[over_idx] = self._host(arena, offsets[over_idx],
                                        lengths[over_idx])
        return tags

    def member_masks(self, tags: np.ndarray
                     ) -> List[Optional[np.ndarray]]:
        """Per ORIGINAL set position: bool match array, or None when the
        member was demoted (caller keeps its per-pattern path)."""
        out: List[Optional[np.ndarray]] = []
        for i in range(len(self.patterns)):
            bit = self.bit_of.get(i)
            if bit is None:
                out.append(None)
            else:
                out.append((tags & np.uint32(1 << bit)) != 0)
        return out


def try_build_set(patterns: Sequence[Union[str, bytes]],
                  names: Optional[Sequence[str]] = None,
                  device: Union[str, torch.device, None] = None
                  ) -> Optional[FusedSetExec]:
    """FusedSetExec, or None when nothing in the set can fuse."""
    try:
        return FusedSetExec(patterns, names=names, device=device)
    except (FuseUnsupported, DFAUnsupported):
        return None
