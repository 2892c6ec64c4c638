"""Agent self-metrics: the port's copy of the JAX package's
``monitor/metrics.py``, with one change of semantics: every instrument is
cumulative, as a Prometheus counter or histogram is, and no reader resets
it.  In the JAX package the self-monitor's snapshot reads and resets every
counter and histogram, so ``--stats`` totals, ``/metrics`` and the SLO
plane's budget breakdown (a difference of two readings) lose whatever a
send drained.  The port's self-monitor works out its deltas from the
values it last sent (``DeltaReader``), and ships the same documents.

Reference: core/monitor/MetricManager.h:33-94 — WriteMetrics holds a chain of
MetricsRecords (created by every queue/runner/plugin/pipeline); ReadMetrics
snapshots them for export.  Categories follow monitor/metric_constants/:
agent / runner / pipeline / component / plugin.

Concurrency contract: a record's registration dicts and every instrument's
updates are independently locked, so

  * a read never loses an increment: what lands after it is in the next
    read's delta;
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
                 "_max", "_window_max", "_lock")

    def __init__(self, name: str, base: float = HIST_BASE,
                 n_buckets: int = HIST_BUCKETS):
        self.name = name
        self.base = float(base)
        self.n_buckets = int(n_buckets)
        self._counts = [0] * (self.n_buckets + 1)   # [+Inf] is the last slot
        self._sum = 0.0
        self._count = 0
        self._max = 0.0
        # the largest observation since the self-monitor's last read: a
        # window's max is not a difference of two cumulative readings
        self._window_max = 0.0
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
            if v > self._window_max:
                self._window_max = v

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

    def state(self, take_window_max: bool = False
              ) -> Tuple[List[int], float, int, float]:
        """(bucket counts, sum, count, max) since the histogram was made,
        read atomically.  With ``take_window_max`` the max is the largest
        observation since the last such read, and the next window starts
        from nothing (the self-monitor's reader, the only one)."""
        with self._lock:
            if take_window_max:
                mx, self._window_max = self._window_max, 0.0
            else:
                mx = self._max
            return list(self._counts), self._sum, self._count, mx

    def document(self, counts: List[int], s: float, n: int, mx: float,
                 qs=(0.5, 0.9, 0.99)) -> dict:
        """The exported document of ``n`` observations in ``counts``:
        count, sum, max and bucket-upper-bound percentiles clipped at
        ``mx``."""
        out = []
        for q in qs:
            if n == 0:
                out.append(0.0)
                continue
            target = q * n
            cum = 0
            val = mx
            for i, c in enumerate(counts):
                cum += c
                if cum >= target:
                    val = min(self.upper_bound(i), mx)
                    break
            out.append(val)
        p50, p90, p99 = out
        return {"count": n, "sum": s, "max": mx,
                "p50": p50, "p90": p90, "p99": p99}

    def snapshot(self) -> dict:
        return self.document(*self.state())


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

    def instruments(self) -> Tuple[List[Tuple[str, Counter]],
                                   List[Tuple[str, Gauge]],
                                   List[Tuple[str, Histogram]]]:
        """(name, instrument) pairs of each kind, copied under the lock
        so concurrent first-touch registration never mutates what a
        reader iterates."""
        with self._reg_lock:
            return (list(self._counters.items()), list(self._gauges.items()),
                    list(self._histograms.items()))

    def mark_deleted(self) -> None:
        self._deleted = True

    def snapshot(self) -> dict:
        counters, gauges, hists = self.instruments()
        return {
            "category": self.category,
            "labels": dict(self.labels),
            "counters": {n: c.value for n, c in counters},
            "gauges": {n: g.value for n, g in gauges},
            "histograms": {n: h.snapshot() for n, h in hists},
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
    def snapshot() -> List[dict]:
        return [r.snapshot() for r in WriteMetrics.instance().records()]


class DeltaReader:
    """Each live record's snapshot as the change since this reader's last
    ``read()``: counters and histogram counts are differences of cumulative
    readings, a histogram's max and percentiles are those of the window's
    observations, gauges are as they stand.  The documents equal those of
    the JAX package's draining ``snapshot(reset_counters=True)`` over the
    same observations, and no instrument is reset.  A record's first read
    covers everything since it was made; retired records are forgotten."""

    def __init__(self) -> None:
        # (record id, metric name) -> the cumulative reading last returned
        self._last: Dict[Tuple[int, str], object] = {}

    def read(self) -> List[dict]:
        last: Dict[Tuple[int, str], object] = {}
        out = []
        for rec in WriteMetrics.instance().records():
            counters, gauges, hists = rec.instruments()
            cdoc = {}
            for n, c in counters:
                v = last[(rec.id, n)] = c.value
                cdoc[n] = v - self._last.get((rec.id, n), 0)
            hdoc = {}
            for n, h in hists:
                counts, s, cnt, mx = h.state(take_window_max=True)
                last[(rec.id, n)] = (counts, s, cnt)
                prev = self._last.get((rec.id, n))
                if prev is not None:
                    pc, ps, pn = prev
                    counts = [a - b for a, b in zip(counts, pc)]
                    s, cnt = s - ps, cnt - pn
                hdoc[n] = h.document(counts, s, cnt, mx)
            out.append({
                "category": rec.category,
                "labels": dict(rec.labels),
                "counters": cdoc,
                "gauges": {n: g.value for n, g in gauges},
                "histograms": hdoc,
                "time": int(time.time()),
            })
        self._last = last
        return out


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
