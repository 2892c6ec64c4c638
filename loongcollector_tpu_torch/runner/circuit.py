"""Per-sink three-state circuit breaker with spill-on-open degradation.

Unifies the scattered retry logic the reference spreads across
FlusherRunner backoff (FlusherRunner.cpp:133-141), AIMD sender-queue gates
and DiskBufferWriter spill into one explicit policy per sink:

  CLOSED     sends flow; consecutive failures and a sliding error-rate
             window are tracked.
  OPEN       tripped (streak >= failure_threshold, or error rate over
             `error_rate` with enough samples): callers stop burning the
             retry heap and route payloads to the disk buffer instead
             (spill-on-open).  An SINK_CIRCUIT_OPEN alarm fires on every
             open transition.
  HALF_OPEN  after `cooldown_s`, exactly one probe send is admitted.
             Success re-closes the breaker (and the owner replays spilled
             payloads); failure re-opens it and re-arms the cooldown.

State and transition counters export through monitor/metrics.py
(category "component", component "sink_circuit") so breaker behaviour is
visible in self-monitor output next to the chaos fault counters.

The port's copy of the JAX package's ``runner/circuit.py``: the same
states, thresholds, probe slot and probe timeout.  Trace events and
flight records are left out (the port has neither plane); the open alarm
is raised on the alarm plane (``SINK_CIRCUIT_OPEN``, level error, with the
breaker's pipeline) and every transition is kept in ``transitions``
(``--stats`` ``send.breakers``).
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Callable, List, Optional, Tuple

from ..monitor.alarms import AlarmLevel, AlarmManager, AlarmType
from ..monitor.metrics import MetricsRecord
from ..utils.logger import get_logger

log = get_logger("circuit")


class BreakerState(enum.IntEnum):
    CLOSED = 0
    OPEN = 1
    HALF_OPEN = 2


class SinkCircuitBreaker:
    """One breaker per sink (pipeline/flusher pair).

    Thread-safe; `allow_probe()` is consulted before a send, and exactly
    one of `on_success()` / `on_failure()` reports each send's outcome.
    `on_close` (if set) runs outside the lock whenever a half-open probe
    re-closes the breaker — owners hook disk-buffer replay there.

    ``transitions`` lists the states entered, in order (the first
    entry is the initial ``closed``), capped at ``MAX_TRANSITIONS``.
    """

    COMPONENT = "sink_circuit"
    ALARM_TYPE = AlarmType.SINK_CIRCUIT_OPEN
    KIND = "sink"
    DEGRADE_NOTE = "degrading to disk buffer"
    MAX_TRANSITIONS = 256

    def __init__(self, name: str,
                 failure_threshold: int = 5,
                 error_rate: float = 0.5,
                 window: int = 20,
                 min_samples: int = 8,
                 cooldown_s: float = 5.0,
                 on_close: Optional[Callable[[], None]] = None,
                 pipeline: str = ""):
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.error_rate = float(error_rate)
        self.window = max(1, int(window))
        self.min_samples = max(1, int(min_samples))
        self.cooldown_s = float(cooldown_s)
        self.on_close = on_close
        self.pipeline = pipeline
        self._state = BreakerState.CLOSED
        self._streak = 0
        self._results: List[bool] = []        # sliding outcome window
        self._opened_at = 0.0
        self._probe_in_flight = False
        self._probe_started = 0.0
        # backstop: a probe whose outcome never reports (callback lost,
        # payload dropped without breaker feedback) must not wedge the
        # slot forever — after this long the probe counts as failed
        self.probe_timeout_s = max(30.0, 2 * self.cooldown_s)
        self._lock = threading.Lock()
        # transitions decided under the lock are EMITTED (log line, alarm
        # count, on_close callback) outside it by _emit(): on_close starts
        # a replay and must never run under the held lock
        self._pending_emits: List[Tuple[str, str]] = []
        self.transitions: List[str] = ["closed"]
        self.metrics = MetricsRecord(
            category="component",
            labels={"component": self.COMPONENT, "sink": name})
        self._state_gauge = self.metrics.gauge("state")
        self._opened_total = self.metrics.counter("opened_total")
        self._reclosed_total = self.metrics.counter("reclosed_total")
        self._probes_total = self.metrics.counter("probes_total")
        self._spilled_total = self.metrics.counter("spilled_on_open_total")

    # -- queries -------------------------------------------------------------

    @property
    def state(self) -> BreakerState:
        with self._lock:
            return self._state

    def _expire_stuck_probe(self) -> None:
        """Lock held.  Release a probe slot whose outcome never arrived."""
        if self._probe_in_flight and \
                time.monotonic() - self._probe_started > self.probe_timeout_s:
            self._reopen("probe outcome never reported "
                         f"(> {self.probe_timeout_s:.0f}s)")

    def is_open(self) -> bool:
        """True while sends should degrade to the disk buffer: the breaker
        is OPEN, or HALF_OPEN with the single probe slot already taken."""
        with self._lock:
            if self._state is BreakerState.CLOSED:
                return False
            self._expire_stuck_probe()
            if self._state is BreakerState.HALF_OPEN:
                out = self._probe_in_flight
            else:
                out = time.monotonic() - self._opened_at < self.cooldown_s
        self._emit()
        return out

    def allow_probe(self) -> bool:
        """True when a send may proceed: always in CLOSED; in OPEN only
        once the cooldown elapsed (transitioning to HALF_OPEN and claiming
        the single probe slot); in HALF_OPEN only if the slot is free."""
        out = False
        with self._lock:
            if self._state is BreakerState.CLOSED:
                return True
            self._expire_stuck_probe()
            if self._state is BreakerState.OPEN:
                if time.monotonic() - self._opened_at >= self.cooldown_s:
                    self._state = BreakerState.HALF_OPEN
                    self._state_gauge.set(float(BreakerState.HALF_OPEN))
                    self._probe_in_flight = True
                    self._probe_started = time.monotonic()
                    self._probes_total.add(1)
                    self._pending_emits.append(("half_open", ""))
                    self._note_transition("half_open")
                    out = True
            elif not self._probe_in_flight:
                self._probe_in_flight = True
                self._probe_started = time.monotonic()
                self._probes_total.add(1)
                out = True
        self._emit()
        return out

    def note_spilled(self, n: int = 1) -> None:
        self._spilled_total.add(n)

    # -- outcomes ------------------------------------------------------------

    def on_success(self) -> None:
        with self._lock:
            self._record(True)
            self._streak = 0
            if self._state is not BreakerState.CLOSED:
                # an OPEN-state success can only be a probe (or a straggler
                # from before the trip) — both prove the sink works again
                self._state = BreakerState.CLOSED
                self._probe_in_flight = False
                self._results.clear()
                self._state_gauge.set(float(BreakerState.CLOSED))
                self._reclosed_total.add(1)
                self._pending_emits.append(("close", ""))
                self._note_transition("closed")
        self._emit()

    def on_inconclusive(self) -> None:
        """The send ended without a health signal (payload dropped as
        invalid, callback itself failed): record no sample, but release a
        held probe slot by re-arming the cooldown — a wedged slot would
        otherwise block every future probe."""
        with self._lock:
            if self._state is BreakerState.HALF_OPEN and \
                    self._probe_in_flight:
                self._reopen("probe outcome inconclusive")
            elif self._state is BreakerState.OPEN:
                self._probe_in_flight = False
        self._emit()

    def on_failure(self) -> None:
        with self._lock:
            self._record(False)
            self._streak += 1
            if self._state is BreakerState.HALF_OPEN:
                self._reopen("half-open probe failed")
            elif self._state is BreakerState.OPEN:
                self._probe_in_flight = False
            else:
                trip_streak = self._streak >= self.failure_threshold
                trip_rate = (len(self._results) >= self.min_samples
                             and (self._results.count(False)
                                  / len(self._results) > self.error_rate))
                if trip_streak or trip_rate:
                    self._reopen(
                        f"{self._streak} consecutive failures" if trip_streak
                        else f"error rate over {self.error_rate:.0%} "
                             f"in last {len(self._results)} sends")
        self._emit()

    # -- internals (call with lock held) -------------------------------------

    def _record(self, ok: bool) -> None:
        self._results.append(ok)
        if len(self._results) > self.window:
            del self._results[0]

    def _note_transition(self, state: str) -> None:
        if len(self.transitions) < self.MAX_TRANSITIONS:
            self.transitions.append(state)

    def mark_deleted(self) -> None:
        """Retire this breaker's metric record (owner stopped or its
        sink's queue was deleted) — the record must not outlive it in
        WriteMetrics."""
        self.metrics.mark_deleted()

    def _reopen(self, why: str) -> None:
        self._state = BreakerState.OPEN
        self._opened_at = time.monotonic()
        self._probe_in_flight = False
        self._streak = 0
        self._state_gauge.set(float(BreakerState.OPEN))
        self._opened_total.add(1)
        self._pending_emits.append(("open", why))
        self._note_transition("open")

    def _emit(self) -> None:
        """Deliver transition side effects (log line, alarm,
        on_close) decided under the lock — outside it."""
        # unlocked pre-check: transitions are rare, and every send pays
        # is_open()/allow_probe() — the common no-transition path must not
        # buy a second lock cycle.  Appends happen only under the lock and
        # each appender drains via its own _emit, so a stale-empty read
        # here just defers delivery to the thread that appended.
        if not self._pending_emits:
            return
        with self._lock:
            if not self._pending_emits:
                return
            emits, self._pending_emits = self._pending_emits, []
        for kind, why in emits:
            if kind == "open":
                log.warning("%s circuit %s opened: %s", self.KIND,
                            self.name, why)
                AlarmManager.instance().send_alarm(
                    self.ALARM_TYPE,
                    f"{self.KIND} {self.name} circuit opened: {why}; "
                    f"{self.DEGRADE_NOTE}",
                    AlarmLevel.ERROR, pipeline=self.pipeline)
            elif kind == "close":
                log.info("%s circuit %s re-closed", self.KIND, self.name)
                if self.on_close is not None:
                    self.on_close()
