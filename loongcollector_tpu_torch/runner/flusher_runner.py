"""FlusherRunner: drains sender queues into the HTTP sink.

Reference: core/runner/FlusherRunner.cpp — single thread (:168); pops
available items (rate + AIMD gates consulted inside the queues), dispatches
by sink type (:219), exponential backoff on failure (100 ms → 10 s,
:133-141), global send-byte rate limit (:202-204).

On top of the reference shape, each sink gets a three-state circuit
breaker (runner/circuit.py): a sink that fails persistently OPENs its
breaker, and instead of spinning payloads through the retry heap the
runner routes them straight to the DiskBufferWriter (spill-on-open
degradation).  When the half-open probe succeeds the breaker re-closes
and the runner replays the spilled payloads back through the live
flusher — one resilience policy for every sink.

The port's copy of the JAX package's ``runner/flusher_runner.py``: the
same dispatch, ``_on_done`` verdicts, retry heap, AIMD feedback, spill
after ``MAX_TRY_BEFORE_SPILL`` tries or on an open breaker, replay, and
exit spill under ``enable_full_drain_mode``.  It books ``send_ok``,
``send_fail``, ``spill`` and the tagged ``drop``s at delivery and acks
the source spans there (``ack_watermark``), observes the SLO plane's
terminals at the same sites (``spill``, ``drop``, ``send_ok``; JAX package
``:270``, ``:368``, ``:498-501``, ``:548-550``), raises the JAX package's
alarms (``SEND_QUOTA_EXCEED``, ``SEND_FAIL``, ``DISCARD_DATA``; ``:450-466``)
and observes each send's sink round trip (``sink_rtt_seconds``) and its
payload's sender-queue wait (``sender_queue_wait_seconds``) into the
runner's record (``:88-90``), the SLO budget breakdown's ``sink`` hop.  The
trace and profiler hooks are left out.  Two changes: the retry thread ends with the runner (``stop`` joins
it), and a send that fails after ``stop`` — a transfer the HTTP sink
finished while it drained — is spilled at once (or, when the buffer
refuses it, booked as a ``drop`` tagged ``exit_undelivered``) instead of
parking in a retry heap nothing runs any more.  ``send_stats()`` holds
the counts of ``--stats`` ``send``.
"""

from __future__ import annotations

import heapq
import statistics
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from ..monitor import ledger, slo
from ..monitor.alarms import AlarmLevel, AlarmManager, AlarmType
from ..monitor.metrics import MetricsRecord
from ..pipeline.queue.limiter import RateLimiter
from ..pipeline.queue.sender_queue import (SenderQueueItem,
                                           SenderQueueManager)
from ..utils import flags
from ..utils.logger import get_logger
from . import ack_watermark
from .circuit import BreakerState, SinkCircuitBreaker
from .http_sink import HttpSink

log = get_logger("flusher_runner")

RETRY_BASE_S = 0.1
RETRY_MAX_S = 10.0
MAX_TRY_BEFORE_SPILL = 20  # persistent failure → disk buffer (if configured)

# reference FlusherRunner.cpp:223-227 enable_full_drain_mode: spill what the
# exit drain budget could not flush instead of dropping it
flags.DEFINE_FLAG_BOOL("enable_full_drain_mode",
                       "spill undrained payloads to disk on exit", True)

# samples kept for the --stats medians (the newest ones)
STAT_SAMPLES = 65536

# observe-only handle of the live runner (the ledger's occupancy probe and
# lag watermarks, /debug/status's breakers): set by ``init``, cleared by
# ``stop``
_active_runner = None


class FlusherRunner:
    def __init__(self, sender_queue_manager: SenderQueueManager,
                 http_sink: Optional[HttpSink] = None,
                 max_bytes_per_sec: int = 0, disk_buffer=None,
                 breaker_failure_threshold: int = 5,
                 breaker_error_rate: float = 0.5,
                 breaker_cooldown_s: float = 5.0):
        self.sqm = sender_queue_manager
        self.http_sink = http_sink
        self.disk_buffer = disk_buffer
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self.rate_limiter = RateLimiter(max_bytes_per_sec)
        self._retry_heap = []
        self._retry_lock = threading.Lock()
        self._retry_thread: Optional[threading.Thread] = None
        self.breaker_failure_threshold = breaker_failure_threshold
        self.breaker_error_rate = breaker_error_rate
        self.breaker_cooldown_s = breaker_cooldown_s
        self._breakers: Dict[int, SinkCircuitBreaker] = {}
        self._breaker_lock = threading.Lock()
        # flushers seen at spill time, keyed by spill identity — the
        # resolver for breaker-close replay (the Application's periodic
        # replay handles flushers this runner never met)
        self._spilled_flushers: Dict[Tuple[str, str, str], object] = {}
        self._replay_pending = threading.Event()
        self.metrics = MetricsRecord(category="runner",
                                     labels={"runner": "flusher"})
        self.out_items = self.metrics.counter("out_items_total")
        self.spilled_items = self.metrics.counter("spilled_items_total")
        # dispatch → on_done latency per send attempt, and how long items
        # sat in their sender queue before this dispatch picked them up
        self.sink_rtt_hist = self.metrics.histogram("sink_rtt_seconds")
        self.sender_wait_hist = self.metrics.histogram(
            "sender_queue_wait_seconds")
        # the same two times, kept as samples for the --stats medians
        self._stats_lock = threading.Lock()
        self.requests = 0
        self.request_bytes = 0
        self.retries = 0
        self.status_counts: Dict[int, int] = {}
        self.dropped: Dict[str, int] = {}   # items dropped, by ledger tag
        self._rtt_samples: deque = deque(maxlen=STAT_SAMPLES)
        self._wait_samples: deque = deque(maxlen=STAT_SAMPLES)
        self._stopped = False

    def init(self) -> None:
        global _active_runner
        self._running = True
        self._stopped = False
        _active_runner = self
        self._thread = threading.Thread(target=self._run, name="flusher-runner",
                                        daemon=True)
        self._thread.start()

    # -- circuit breakers ----------------------------------------------------

    def breaker_for(self, item: SenderQueueItem) -> SinkCircuitBreaker:
        key = item.queue_key
        with self._breaker_lock:
            br = self._breakers.get(key)
            if br is None:
                flusher = item.flusher
                ident = (flusher.spill_identity() if flusher is not None
                         else {})
                name = (f"{ident.get('pipeline', '')}/"
                        f"{ident.get('flusher_type', 'unknown')}")
                br = SinkCircuitBreaker(
                    name,
                    failure_threshold=self.breaker_failure_threshold,
                    error_rate=self.breaker_error_rate,
                    cooldown_s=self.breaker_cooldown_s,
                    on_close=self._replay_pending.set,
                    pipeline=ident.get("pipeline", ""))
                self._breakers[key] = br
            return br

    def breakers(self) -> Dict[int, SinkCircuitBreaker]:
        with self._breaker_lock:
            return dict(self._breakers)

    def gc_breakers(self) -> int:
        """loongtenant: every hot reload retires the old generation's
        sender queues, but their breakers (and metric records) would
        accumulate in ``_breakers`` forever under config churn.  Drop and
        retire breakers whose queue no longer exists — queue keys are
        never reused, so a dropped key can't come back.  Runs on the
        runner loop's probe cadence."""
        with self._breaker_lock:
            keys = list(self._breakers)
        dead_keys = [k for k in keys if self.sqm.get_queue(k) is None]
        if not dead_keys:
            return 0
        dead = []
        with self._breaker_lock:
            for k in dead_keys:
                br = self._breakers.pop(k, None)
                if br is not None:
                    dead.append(br)
        for br in dead:
            br.mark_deleted()
        return len(dead)

    # -- lifecycle -----------------------------------------------------------

    def stop(self, drain: bool = True, timeout: float = 5.0) -> None:
        global _active_runner
        if _active_runner is self:
            _active_runner = None
        if drain:
            deadline = time.monotonic() + timeout
            while not self.sqm.all_empty() and time.monotonic() < deadline:
                time.sleep(0.05)
        self._running = False
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
        with self._retry_lock:
            self._stopped = True
            retry_thread = self._retry_thread
        if retry_thread is not None:
            retry_thread.join(timeout=5)
        try:
            self._exit_spill()
        finally:
            # retire this runner's metric records (and its breakers') AFTER
            # the exit spill — its spilled_items_total increments must land
            # on a record that is still exportable — so repeated
            # construct/stop cycles never accumulate live records
            self.metrics.mark_deleted()
            for br in self.breakers().values():
                br.mark_deleted()

    def _exit_spill(self) -> None:
        # exit spill: whatever could not drain in the budget persists to disk
        # (reference FlusherRunner.cpp:223-227 full-drain/spill on exit).
        # Items still in-flight in the HTTP sink are skipped — their pending
        # send may yet succeed, and spilling them would double-deliver.
        if self.disk_buffer is None \
                or not flags.get_flag("enable_full_drain_mode"):
            return
        # the retry heap first: its items are normally still queued (and get
        # spilled below), but items whose queue was deleted mid-backoff are
        # reachable ONLY from the heap — dropping the heap would drop them
        with self._retry_lock:
            heap_items = [entry[2] for entry in self._retry_heap]
            self._retry_heap.clear()
        for q in list(self.sqm._queues.values()):
            with q._lock:
                items = [i for i in q._items
                         if not getattr(i, "in_flight", False)]
            for item in items:
                self._spill_item(item)
        for item in heap_items:
            if getattr(item, "in_flight", False):
                continue
            if self.sqm.get_queue(item.queue_key) is not None:
                continue        # still queued: the loop above owned it
            self._spill_item(item)

    def _run(self) -> None:
        last_probe_replay = 0.0
        while self._running:
            if self._replay_pending.is_set():
                self._replay_pending.clear()
                self._replay_spilled()
            # a fully-spilled sink has no queued traffic left to drive the
            # half-open probe: when any breaker is off-CLOSED and a cooldown
            # has passed, pull spilled payloads back as probe traffic (a
            # failing probe just re-spills them)
            now = time.monotonic()
            if now - last_probe_replay >= self.breaker_cooldown_s:
                last_probe_replay = now
                # reload churn hygiene rides the same cadence: breakers
                # of deleted sender queues retire instead of accumulating
                self.gc_breakers()
                if (self.disk_buffer is not None
                        and any(br.state is not BreakerState.CLOSED
                                for br in self.breakers().values())):
                    self._replay_spilled()
            items = self.sqm.get_available_items()
            if not items:
                # backlog-aware hand-off (loongcolumn): a sender-queue push
                # wakes this loop immediately; the 20 ms timeout is only
                # the deadline fallback driving retry/replay cadences on
                # an idle agent
                self.sqm.wait_for_data(0.02)
                continue
            for item in items:
                if not self.rate_limiter.is_valid_to_pop():
                    self._requeue_later(item)
                    continue
                self.rate_limiter.post_pop(len(item.data))
                self._dispatch(item)

    def _release_limiters(self, item: SenderQueueItem) -> None:
        q = self.sqm.get_queue(item.queue_key)
        if q is not None:
            for cl in q.concurrency_limiters:
                cl.on_done()

    def _requeue_later(self, item: SenderQueueItem) -> None:
        self._release_limiters(item)
        q = self.sqm.get_queue(item.queue_key)
        if q is not None:
            q.reset_item_status(item)

    # -- spill / replay ------------------------------------------------------

    def _spill_item(self, item: SenderQueueItem, breaker=None) -> bool:
        """Route one undeliverable item to the disk buffer, freeing its
        queue slot.  False when spilling is impossible (no buffer, buffer
        full, exactly-once item) — the caller falls back to backoff."""
        flusher = item.flusher
        if (self.disk_buffer is None or flusher is None
                or "eo_cp" in item.tag):
            return False
        identity = flusher.spill_identity()
        if not self.disk_buffer.spill(item, identity):
            return False
        # durable on disk IS a terminal for the SOURCE span: the replay
        # path owns delivery from here, the checkpoint may advance
        ack_watermark.ack_spans(item.spans)
        if slo.is_on():
            slo.observe_stamps(self._ledger_pipeline(item), item.stamps,
                               slo.OUTCOME_SPILL)
        self.spilled_items.add(1)
        if breaker is not None:
            breaker.note_spilled()
        self._spilled_flushers[(identity.get("pipeline", ""),
                                identity.get("flusher_type", ""),
                                identity.get("plugin_id", ""))] = flusher
        self.sqm.remove_item(item)
        return True

    def _resolve_spilled(self, identity: dict):
        key = (identity.get("pipeline", ""),
               identity.get("flusher_type", ""),
               identity.get("plugin_id", ""))
        flusher = self._spilled_flushers.get(key)
        if flusher is None:
            return None
        # a pipeline swap deletes the sender queue: replaying into the
        # orphaned queue object would strand the payload AND delete its
        # file — drop the stale registry entry and keep the file for the
        # Application's resolver (which knows the live pipelines)
        q = self.sqm.get_queue(getattr(flusher, "queue_key", -1))
        if q is None or q is not getattr(flusher, "sender_queue", None):
            self._spilled_flushers.pop(key, None)
            return None
        return flusher

    def _replay_spilled(self) -> None:
        if self.disk_buffer is None:
            return
        try:
            self.disk_buffer.replay(self._resolve_spilled)
        except Exception:  # noqa: BLE001
            log.exception("breaker-close replay failed; files kept")

    # -- dispatch ------------------------------------------------------------

    def _ledger_pipeline(self, item: SenderQueueItem) -> str:
        q = self.sqm.get_queue(item.queue_key)
        if q is not None:
            return q.pipeline_name
        flusher = item.flusher
        if flusher is not None:
            return flusher.spill_identity().get("pipeline", "")
        return ""

    def _dispatch(self, item: SenderQueueItem) -> None:
        flusher = item.flusher
        if flusher is None or self.http_sink is None:
            # nowhere to send: the payload leaves the queue terminally
            self._note_drop("no_sink")
            if ledger.is_on():
                ledger.record(self._ledger_pipeline(item), ledger.B_DROP,
                              item.event_cnt, len(item.data), tag="no_sink")
            ack_watermark.ack_spans(item.spans)
            if slo.is_on():
                slo.observe_stamps(self._ledger_pipeline(item), item.stamps,
                                   slo.OUTCOME_DROP)
            self._release_limiters(item)
            self.sqm.remove_item(item)
            return
        breaker = self.breaker_for(item)
        if not breaker.allow_probe():
            # open circuit: degrade to disk instead of burning retries
            self._release_limiters(item)
            if not self._spill_item(item, breaker):
                self._backoff_retry(item)
            return
        try:
            request = flusher.build_request(item)
        except Exception:  # noqa: BLE001
            log.exception("build_request failed; backing off")
            self._release_limiters(item)
            breaker.on_failure()
            if breaker.is_open() and self._spill_item(item, breaker):
                return
            self._backoff_retry(item)
            return
        item.in_flight = True
        wait = max(0.0, time.monotonic() - item.enqueue_time)
        self.sender_wait_hist.observe(wait)
        with self._stats_lock:
            self.requests += 1
            self.request_bytes += len(request.body or b"")
            self._wait_samples.append(wait)
        # the send-attempt stopwatch rides the item's last_send_time slot
        # (its reference meaning); _on_done turns it into the sink RTT
        item.last_send_time = time.monotonic()
        self.http_sink.add_request(
            request, lambda status, body, it=item:
            self._on_done(it, status, body))

    def _on_done(self, item: SenderQueueItem, status: int,
                 body: bytes) -> None:
        item.in_flight = False
        rtt = None
        if item.last_send_time:
            rtt = max(0.0, time.monotonic() - item.last_send_time)
            self.sink_rtt_hist.observe(rtt)
        with self._stats_lock:
            self.status_counts[status] = self.status_counts.get(status,
                                                                0) + 1
            if rtt is not None:
                self._rtt_samples.append(rtt)
        flusher = item.flusher
        q = self.sqm.get_queue(item.queue_key)
        breaker = self.breaker_for(item)
        verdict = "drop"
        cb_failed = True
        try:
            verdict = flusher.on_send_done(item, status, body)
            cb_failed = False
        except Exception:  # noqa: BLE001
            log.exception("on_send_done failed")
        if q is not None:
            for cl in q.concurrency_limiters:
                cl.on_done()
                if verdict == "ok":
                    cl.on_success()
                elif verdict == "retry_slow":
                    # quota exceeded: collapse concurrency hard (AIMD slow
                    # path), regardless of raw status code
                    cl.on_fail(slow=True)
                elif verdict == "retry":
                    cl.on_fail(slow=(status == 429))
        if verdict == "ok":
            breaker.on_success()
        elif verdict in ("retry", "retry_slow"):
            breaker.on_failure()
        elif not cb_failed and status > 0:
            # permanent rejection with a real HTTP status: the payload is
            # dropped but the ENDPOINT answered — that is a healthy sink
            # (and a probe in flight must not wedge the slot)
            breaker.on_success()
        else:
            # callback blew up / status unknown: no health signal either
            # way — release a held probe slot without recording a sample
            breaker.on_inconclusive()
        if verdict == "retry_slow":
            AlarmManager.instance().send_alarm(
                AlarmType.SEND_QUOTA_EXCEED,
                f"quota exceeded (status {status})", AlarmLevel.WARNING)
        elif verdict == "retry":
            AlarmManager.instance().send_alarm(
                AlarmType.SEND_FAIL, f"send failed (status {status}); "
                "backing off", AlarmLevel.WARNING)
        elif verdict == "drop":
            # the exception fallback also lands here: the payload IS lost
            # either way, but operators must not read a local flusher bug
            # as a backend rejection
            AlarmManager.instance().send_alarm(
                AlarmType.DISCARD_DATA,
                ("payload dropped: flusher callback failed "
                 if cb_failed else
                 "payload dropped after permanent rejection ")
                + f"(status {status})", AlarmLevel.ERROR)
        if verdict in ("retry", "retry_slow"):
            # one failed attempt: the item stays inflight (retry heap or
            # spill), never double-counted — send_fail is informational.
            # is_on() guard: _ledger_pipeline takes the sqm lock, which a
            # disabled ledger must never pay for on the retry path
            if ledger.is_on():
                ledger.record(self._ledger_pipeline(item),
                              ledger.B_SEND_FAIL,
                              item.event_cnt, len(item.data))
            # spill-on-open: an open breaker (or plain try-count exhaustion)
            # moves the payload to disk and frees the queue slot
            # (reference DiskBufferWriter semantics)
            if (breaker.is_open()
                    or item.try_count >= MAX_TRY_BEFORE_SPILL
                    or not self._running):
                if self._spill_item(item, breaker):
                    return
            if not self._running:
                # the runner stopped while this transfer was in flight:
                # no retry will run — spilled above, or lost here
                self._drop_undelivered(item)
                return
            self._backoff_retry(item)
            return
        if verdict != "ok":
            self._note_drop("callback_failed" if cb_failed
                            else "permanent_reject")
        if ledger.is_on():
            if verdict == "ok":
                ledger.record(self._ledger_pipeline(item), ledger.B_SEND_OK,
                              item.event_cnt, len(item.data))
            else:
                # permanent rejection / callback failure: terminal discard
                ledger.record(self._ledger_pipeline(item), ledger.B_DROP,
                              item.event_cnt, len(item.data),
                              tag=("callback_failed" if cb_failed
                                   else "permanent_reject"))
        # sink accepted (or permanently rejected) the payload: terminal
        # for its SOURCE spans either way — the watermark moves
        ack_watermark.ack_spans(item.spans)
        if slo.is_on():
            slo.observe_stamps(self._ledger_pipeline(item), item.stamps,
                               slo.OUTCOME_SEND_OK if verdict == "ok"
                               else slo.OUTCOME_DROP)
        self.out_items.add(1)
        self.sqm.remove_item(item)

    def _backoff_retry(self, item: SenderQueueItem) -> None:
        """Exponential backoff (100 ms → 10 s, reference FlusherRunner.cpp
        :133-141) via a single shared timer heap — no thread per retry."""
        delay = min(RETRY_BASE_S * (2 ** min(item.try_count, 8)), RETRY_MAX_S)
        with self._stats_lock:
            self.retries += 1
        with self._retry_lock:
            heapq.heappush(self._retry_heap,
                           (time.monotonic() + delay, id(item), item))
            if self._stopped:
                return      # the exit spill owns the heap from here
            if self._retry_thread is None or not self._retry_thread.is_alive():
                self._retry_thread = threading.Thread(
                    target=self._retry_loop, name="flusher-retry", daemon=True)
                self._retry_thread.start()

    def _retry_loop(self) -> None:
        while True:
            with self._retry_lock:
                if not self._retry_heap or self._stopped:
                    return
                due, _, item = self._retry_heap[0]
                now = time.monotonic()
                if due <= now:
                    heapq.heappop(self._retry_heap)
                else:
                    item = None
                    wait = due - now
            if item is None:
                time.sleep(min(wait, 0.5))
                continue
            q = self.sqm.get_queue(item.queue_key)
            if q is not None:
                q.reset_item_status(item)
            elif not self._spill_item(item):
                # queue deleted while the item waited out its backoff
                # (pipeline swap) AND the spill refused (no buffer / full):
                # the payload is gone — ledger the loss, don't hide it
                self._note_drop("retry_orphaned")
                if ledger.is_on():
                    ledger.record(self._ledger_pipeline(item), ledger.B_DROP,
                                  item.event_cnt, len(item.data),
                                  tag="retry_orphaned")
                ack_watermark.ack_spans(item.spans)
                if slo.is_on():
                    slo.observe_stamps(self._ledger_pipeline(item),
                                       item.stamps, slo.OUTCOME_DROP)

    def _drop_undelivered(self, item: SenderQueueItem) -> None:
        """A payload that failed after ``stop`` and that the buffer
        refused: terminal, booked as a tagged drop."""
        log.error("payload of %d events undelivered at exit and not "
                  "spilled; dropped", item.event_cnt)
        AlarmManager.instance().send_alarm(
            AlarmType.DISCARD_DATA,
            "payload undelivered at exit and not spilled", AlarmLevel.ERROR)
        self._note_drop("exit_undelivered")
        if ledger.is_on():
            ledger.record(self._ledger_pipeline(item), ledger.B_DROP,
                          item.event_cnt, len(item.data),
                          tag="exit_undelivered")
        ack_watermark.ack_spans(item.spans)
        if slo.is_on():
            slo.observe_stamps(self._ledger_pipeline(item), item.stamps,
                               slo.OUTCOME_DROP)
        self.sqm.remove_item(item)

    # -- stats ---------------------------------------------------------------

    def _note_drop(self, tag: str) -> None:
        with self._stats_lock:
            self.dropped[tag] = self.dropped.get(tag, 0) + 1

    def send_stats(self) -> Dict[str, Any]:
        """The runner's counts for ``--stats`` ``send``: requests and
        their bytes, answers by status (0: the host could not be
        reached), backoff retries, items spilled, sent and dropped (by
        the drop's ledger tag), each breaker's
        transitions, and the median sender-queue wait and HTTP round trip
        (seconds, over the newest ``STAT_SAMPLES`` sends)."""
        with self._stats_lock:
            rtts = list(self._rtt_samples)
            waits = list(self._wait_samples)
            out = {"requests": self.requests,
                   "request_bytes": self.request_bytes,
                   "status_counts": {str(k): v for k, v in
                                     sorted(self.status_counts.items())},
                   "retries": self.retries,
                   "dropped_items": dict(self.dropped)}
        out.update({
            "spilled_items": self.spilled_items.value,
            "out_items": self.out_items.value,
            "breakers": {br.name: {"state": br.state.name.lower(),
                                   "transitions": list(br.transitions)}
                         for br in self.breakers().values()},
            "rtt_median_s": statistics.median(rtts) if rtts else None,
            "sender_queue_wait_median_s": (statistics.median(waits)
                                           if waits else None),
        })
        return out
