"""Agent self-metrics: the port's copy of the JAX package's
``monitor/metrics.py``, unchanged in behaviour.

Reference: core/monitor/MetricManager.h:33-94 — WriteMetrics holds a chain of
MetricsRecords (created by every queue/runner/plugin/pipeline); ReadMetrics
snapshots them for export.  Categories follow monitor/metric_constants/:
agent / runner / pipeline / component / plugin.

Concurrency contract (the PR-3 race fix): a record's registration dicts and
every counter's read-and-reset are independently locked, so

  * `snapshot(reset_counters=True)` can run concurrently with `add()` on
    any counter without losing increments — collect-and-reset is atomic
    per counter;
  * `snapshot()` can run concurrently with first-touch registration
    (`counter()` / `gauge()` / `histogram()`) without the dict-mutation
    RuntimeError the old unlocked iteration could hit (the chaos plane
    registers ``faults_<action>_total`` lazily mid-storm, exactly when the
    self-monitor snapshots).

Metric names are validated at registration: snake_case, and unique within
the record across metric kinds (a name that is a counter in one place and
a gauge in another would export two conflicting Prometheus types) — the
static side of the same rule is loonglint's `metric-naming` checker.
"""

from __future__ import annotations

import itertools
import math
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} is not snake_case ([a-z][a-z0-9_]*)")
    return name


class Counter:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def collect(self) -> int:
        """Read and reset (delta semantics for export).  Atomic with
        respect to `add`: an increment either lands before the read (and
        is returned) or after the reset (and survives for the next
        collect) — never in between."""
        with self._lock:
            v = self._value
            self._value = 0
            return v


class Gauge:
    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = v

    @property
    def value(self) -> float:
        return self._value


#: default histogram geometry: first bucket ≤ 1 µs, log2 growth, 40
#: buckets → top finite bound ≈ 550 s; latencies above that land in +Inf
HIST_BASE = 1e-6
HIST_BUCKETS = 40


class Histogram:
    """Lock-cheap fixed-bucket latency histogram (log2 boundaries).

    `observe(seconds)` computes the bucket index OUTSIDE the lock (frexp,
    no log call) and holds the lock only for four scalar updates, so hot
    paths (queue waits, device round-trips) pay a handful of ns beyond
    the lock itself.  Percentiles are bucket-upper-bound estimates —
    monotone and conservative (never under-report), which is what a
    regression gate wants.
    """

    __slots__ = ("name", "base", "n_buckets", "_counts", "_sum", "_count",
                 "_max", "_lock")

    def __init__(self, name: str, base: float = HIST_BASE,
                 n_buckets: int = HIST_BUCKETS):
        self.name = name
        self.base = float(base)
        self.n_buckets = int(n_buckets)
        self._counts = [0] * (self.n_buckets + 1)   # [+Inf] is the last slot
        self._sum = 0.0
        self._count = 0
        self._max = 0.0
        self._lock = threading.Lock()

    def _index(self, v: float) -> int:
        if v <= self.base:
            return 0
        m, e = math.frexp(v / self.base)    # v/base = m * 2**e, m in [0.5, 1)
        idx = e - 1 if m == 0.5 else e      # = ceil(log2(v/base))
        return idx if idx < self.n_buckets else self.n_buckets

    def observe(self, value: float) -> None:
        v = float(value)
        if v < 0.0:
            v = 0.0
        idx = self._index(v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    def upper_bound(self, idx: int) -> float:
        """The `le` boundary of bucket `idx` (inf for the overflow slot)."""
        if idx >= self.n_buckets:
            return math.inf
        return self.base * (2.0 ** idx)

    def buckets(self) -> List[Tuple[float, int]]:
        """Cumulative (le, count) pairs, Prometheus histogram shape."""
        with self._lock:
            counts = list(self._counts)
        out: List[Tuple[float, int]] = []
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            out.append((self.upper_bound(i), cum))
        return out

    def _percentiles(self, counts: List[int], count: int,
                     mx: float, qs=(0.5, 0.9, 0.99)) -> List[float]:
        out = []
        for q in qs:
            if count == 0:
                out.append(0.0)
                continue
            target = q * count
            cum = 0
            val = mx
            for i, c in enumerate(counts):
                cum += c
                if cum >= target:
                    val = min(self.upper_bound(i), mx)
                    break
            out.append(val)
        return out

    def snapshot(self, reset: bool = False) -> dict:
        with self._lock:
            counts = list(self._counts)
            s, n, mx = self._sum, self._count, self._max
            if reset:
                self._counts = [0] * (self.n_buckets + 1)
                self._sum = 0.0
                self._count = 0
                self._max = 0.0
        p50, p90, p99 = self._percentiles(counts, n, mx)
        return {"count": n, "sum": s, "max": mx,
                "p50": p50, "p90": p90, "p99": p99}


class MetricsRecord:
    _ids = itertools.count()

    def __init__(self, category: str = "component",
                 labels: Optional[Dict[str, str]] = None):
        self.id = next(MetricsRecord._ids)
        self.category = category
        self.labels = labels or {}
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._reg_lock = threading.Lock()
        self._deleted = False
        WriteMetrics.instance().register(self)

    def _claim(self, name: str, kind: Dict) -> None:
        """Registration-time uniqueness (lock held): one name, one kind."""
        for d in (self._counters, self._gauges, self._histograms):
            if d is not kind and name in d:
                raise ValueError(
                    f"metric {name!r} already registered with a different "
                    "kind in this record")

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            _check_name(name)
            with self._reg_lock:
                c = self._counters.get(name)
                if c is None:
                    self._claim(name, self._counters)
                    c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            _check_name(name)
            with self._reg_lock:
                g = self._gauges.get(name)
                if g is None:
                    self._claim(name, self._gauges)
                    g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, base: float = HIST_BASE,
                  n_buckets: int = HIST_BUCKETS) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            _check_name(name)
            with self._reg_lock:
                h = self._histograms.get(name)
                if h is None:
                    self._claim(name, self._histograms)
                    h = self._histograms[name] = Histogram(
                        name, base, n_buckets)
        return h

    def histograms(self) -> List[Histogram]:
        with self._reg_lock:
            return list(self._histograms.values())

    def mark_deleted(self) -> None:
        self._deleted = True

    def snapshot(self, reset_counters: bool = False) -> dict:
        # copy the registration dicts under the lock so concurrent
        # first-touch registration can never mutate what we iterate
        with self._reg_lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._histograms.items())
        return {
            "category": self.category,
            "labels": dict(self.labels),
            "counters": {n: (c.collect() if reset_counters else c.value)
                         for n, c in counters},
            "gauges": {n: g.value for n, g in gauges},
            "histograms": {n: h.snapshot(reset=reset_counters)
                           for n, h in hists},
            "time": int(time.time()),
        }


class WriteMetrics:
    _instance: Optional["WriteMetrics"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._records: List[MetricsRecord] = []
        self._lock = threading.Lock()

    @classmethod
    def instance(cls) -> "WriteMetrics":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def register(self, record: MetricsRecord) -> None:
        with self._lock:
            self._records.append(record)

    def gc_deleted(self) -> None:
        with self._lock:
            self._records = [r for r in self._records if not r._deleted]

    def records(self) -> List[MetricsRecord]:
        with self._lock:
            return [r for r in self._records if not r._deleted]


class ReadMetrics:
    """Snapshot side (reference ReadMetrics::UpdateMetrics)."""

    @staticmethod
    def snapshot(reset_counters: bool = False) -> List[dict]:
        return [r.snapshot(reset_counters) for r in WriteMetrics.instance().records()]


# ---------------------------------------------------------------------------
# process-lifetime shared instruments

_shared_lock = threading.Lock()
_shared_hists: Dict[tuple, Histogram] = {}


def shared_histogram(name: str, category: str = "component",
                     labels: Optional[Dict[str, str]] = None) -> Histogram:
    """One process-lifetime histogram per (name, category, labels) — the
    lazy module-level instrument pattern (device round-trips, queue
    waits) without each site hand-rolling its own double-checked lock.
    The backing record is created on first use and never retired."""
    key = (name, category, tuple(sorted((labels or {}).items())))
    h = _shared_hists.get(key)
    if h is None:
        with _shared_lock:
            h = _shared_hists.get(key)
            if h is None:
                rec = MetricsRecord(category=category, labels=labels)
                h = _shared_hists[key] = rec.histogram(name)
    return h
