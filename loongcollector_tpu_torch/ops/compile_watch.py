"""compile_watch: build and first-launch accounting for the hand kernels.

Reference: loongcollector_tpu/ops/compile_watch.py, which wraps ``jax.jit``
so the first call at each geometry (trace and compile) is timed and
counted and every later call is a cache hit.  The port has no jit: each
kernel library is built once by ``nvcc`` into a directory keyed on its
source hash, and each (entry point, B, L) then pays its first launch.  So
two families are watched per library (``ops/kernels/field_extract_cuda.py``,
``dfa_scan_cuda.py`` and ``fused_program_cuda.py``, K7's, whose launch
geometry is keyed by its instantiation):

  * ``<module>.build`` — ``build()``: a compile is an ``nvcc`` run
    (geometry = the source hash), a cache hit a library loaded from the
    build directory without one.  ``build()`` holds a lock, so two
    workers reaching the first launch at once record one build;
  * ``<module>.launch`` — ``launch()``: the first launch of each
    (entry point, B, L) is recorded with its host wall time, every later
    launch at that geometry is a cache hit.

Per family: compiles, cache hits, compile milliseconds, per-geometry
compile counts and last wall ms (``compile_status()``), and the
reference's storm rule — more than ``STORM_COMPILES`` compiles inside
``STORM_WINDOW_S`` is a storm.  Until the alarm plane is ported a storm is
counted in ``storm_episodes`` and logged once per episode; the flag re-arms
only after the window drains empty.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict

from ..utils.logger import get_logger

log = get_logger("compile_watch")

#: sliding storm window and the compile count inside it that makes a storm
#: (read at every compile note, so tests may tighten them)
STORM_WINDOW_S = 60.0
STORM_COMPILES = 12


class _FamilyState:
    __slots__ = ("compiles", "cache_hits", "compile_ms_total",
                 "geometries", "seen", "recent", "alarmed", "episodes")

    def __init__(self) -> None:
        self.compiles = 0
        self.cache_hits = 0
        self.compile_ms_total = 0.0
        # geometry -> {"compiles": n, "last_ms": wall}
        self.geometries: Dict[str, dict] = {}
        self.seen: set = set()
        # (perf_counter, geometry) of recent compiles, window-evicted
        self.recent: deque = deque()
        self.alarmed = False
        self.episodes = 0


_lock = threading.Lock()
_families: Dict[str, _FamilyState] = {}


def note_hit(family: str) -> None:
    with _lock:
        _families.setdefault(family, _FamilyState()).cache_hits += 1


def note_compile(family: str, geometry: str, wall_ms: float) -> None:
    now = time.perf_counter()
    storm = None
    with _lock:
        st = _families.setdefault(family, _FamilyState())
        st.seen.add(geometry)
        st.compiles += 1
        st.compile_ms_total += wall_ms
        row = st.geometries.setdefault(geometry,
                                       {"compiles": 0, "last_ms": 0.0})
        row["compiles"] += 1
        row["last_ms"] = round(wall_ms, 3)
        # evict aged compiles first: an empty window ends the episode
        horizon = now - STORM_WINDOW_S
        while st.recent and st.recent[0][0] < horizon:
            st.recent.popleft()
        if not st.recent:
            st.alarmed = False
        st.recent.append((now, geometry))
        if len(st.recent) >= STORM_COMPILES and not st.alarmed:
            st.alarmed = True
            st.episodes += 1
            storm = (len(st.recent), len({g for _t, g in st.recent}))
    if storm is not None:
        log.warning("recompile storm: family=%s compiled %d times across %d "
                    "geometries in %.0f s; churning geometry %s", family,
                    storm[0], storm[1], STORM_WINDOW_S, geometry)


def note_call(family: str, geometry: str, t0: float) -> None:
    """A call at ``geometry`` that started at ``perf_counter()`` ``t0``
    returned: a compile the first time the geometry is seen, else a
    cache hit."""
    with _lock:
        st = _families.setdefault(family, _FamilyState())
        if geometry in st.seen:
            st.cache_hits += 1
            return
        st.seen.add(geometry)
    note_compile(family, geometry, (time.perf_counter() - t0) * 1e3)


def compile_status() -> Dict[str, dict]:
    """Per-family compile ledger (the agent's ``--stats`` ``compile``)."""
    with _lock:
        return {name: {"compiles": st.compiles,
                       "cache_hits": st.cache_hits,
                       "compile_ms_total": round(st.compile_ms_total, 3),
                       "storm_episodes": st.episodes,
                       "geometries": {g: dict(row) for g, row in
                                      sorted(st.geometries.items())}}
                for name, st in sorted(_families.items())}


def reset_for_testing() -> None:
    with _lock:
        _families.clear()
