"""Sender queues: serialized payloads awaiting network dispatch.

Reference: core/collection_pipeline/queue/SenderQueue*.cpp and
SenderQueueItem.h — per-flusher bounded queues of compressed payloads with
retry state; GetAvailableItems consults per-destination rate and AIMD
concurrency limiters (SenderQueueManager.cpp:112-135); draining feeds back
to process queues.

The port's copy of the JAX package's ``pipeline/queue/sender_queue.py``,
with its retire semantics (``SenderQueue._retired``, the refused push).
``SenderQueueItem.stamps`` carries the SLO plane's ingest stamps of the
groups a payload serialized; a deleted queue's idle payloads are their
drop terminals (JAX package ``sender_queue.py:255-268``), and
``oldest_age`` is the ledger's ``sender_queue_lag_seconds`` watermark.
"""

from __future__ import annotations

import enum
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from .limiter import ConcurrencyLimiter, RateLimiter


class SendingStatus(enum.Enum):
    IDLE = 0
    SENDING = 1


class SenderQueueItem:
    __slots__ = ("data", "raw_size", "flusher", "queue_key", "status",
                 "enqueue_time", "try_count", "last_send_time", "tag",
                 "in_flight", "event_cnt", "spans", "stamps")

    def __init__(self, data: bytes, raw_size: int, flusher=None,
                 queue_key: int = 0, tag: Optional[dict] = None,
                 event_cnt: int = 0, spans: tuple = (),
                 stamps: tuple = ()):
        self.data = data
        self.raw_size = raw_size
        self.flusher = flusher
        self.queue_key = queue_key
        self.status = SendingStatus.IDLE
        self.enqueue_time = time.monotonic()
        self.try_count = 0
        self.last_send_time = 0.0
        self.tag = tag or {}
        self.in_flight = False
        # loongledger: how many events this payload carries — serialization
        # erases event identity, so the count rides the item to keep the
        # send_ok/spill boundaries in event units (0 = unknown provenance,
        # e.g. a pre-ledger disk-buffer file; ledgers as 0 on both sides)
        self.event_cnt = event_cnt
        # loongcrash: SOURCE (dev, inode, offset, length) spans this payload
        # carries — the terminal boundary (send_ok / durable spill / tagged
        # drop) acks them into the checkpoint watermark; () = no file
        # provenance (http input, replay) and nothing to ack
        self.spans = spans
        # loongslo: ingest stamps (monotonic ns) of the groups serialized
        # into this payload — the same terminal boundary observes their
        # ingest→terminal sojourn; () = stampless (plane off, replay)
        self.stamps = stamps


class SenderQueue:
    def __init__(self, key: int, capacity: int = 10, pipeline_name: str = ""):
        self.key = key
        self.pipeline_name = pipeline_name
        self._cap_high = max(capacity, 1)
        self._cap_low = max(int(capacity * 2 / 3), 1)
        self._items: Deque[SenderQueueItem] = deque()
        self._lock = threading.Lock()
        self._valid_to_push = True
        self._retired = False
        self._feedback = []
        # backlog-aware hand-off (loongcolumn): the manager installs its
        # data event here so a push wakes the FlusherRunner immediately
        # instead of waiting out its poll interval
        self._on_push = None
        self.rate_limiter: Optional[RateLimiter] = None
        self.concurrency_limiters: List[ConcurrencyLimiter] = []
        self.total_pushed = 0
        self.total_removed = 0

    def push(self, item: SenderQueueItem) -> bool:
        with self._lock:
            if self._retired:
                # deleted queue: a stale-reference push (e.g. a timeout
                # flush driving a removed pipeline's batcher mid-hot-
                # reload) would strand the payload in an orphaned queue
                # nothing dispatches, counts, or ledgers — refuse it,
                # matching BoundedProcessQueue.retire()'s push gate.
                # False means the CALLER still owns the payload (disk-
                # buffer replay keeps its file; flush paths record the
                # terminal drop) — recording here would double-terminate
                # a refused replay whose spill file survives.
                return False
            # Sender queues accept beyond the watermark (data already
            # left the process stage and must not be lost); validity
            # flag throttles the upstream instead (reference
            # BoundedSenderQueueInterface).
            self._items.append(item)
            self.total_pushed += 1
            if len(self._items) >= self._cap_high:
                self._valid_to_push = False
            notify = self._on_push
        if notify is not None:
            notify()        # outside the lock: wake the FlusherRunner
        return True

    def is_valid_to_push(self) -> bool:
        with self._lock:
            return self._valid_to_push

    def get_available_items(self, limit: int) -> List[SenderQueueItem]:
        out: List[SenderQueueItem] = []
        with self._lock:
            if self._retired:
                # deleted queue (loongledger): its remaining IDLE items
                # were already counted drop(queue_deleted) — dispatching
                # one now would give the same payload two terminals
                return out
            for item in self._items:
                if len(out) >= limit:
                    break
                if item.status is not SendingStatus.IDLE:
                    continue
                if self.rate_limiter and not self.rate_limiter.is_valid_to_pop():
                    break
                if any(not cl.is_valid_to_pop() for cl in self.concurrency_limiters):
                    break
                item.status = SendingStatus.SENDING
                item.try_count += 1
                item.last_send_time = time.monotonic()
                if self.rate_limiter:
                    self.rate_limiter.post_pop(len(item.data))
                for cl in self.concurrency_limiters:
                    cl.post_pop()
                out.append(item)
        return out

    def remove(self, item: SenderQueueItem) -> bool:
        feedbacks = []
        with self._lock:
            try:
                self._items.remove(item)
            except ValueError:
                return False
            self.total_removed += 1
            if not self._valid_to_push and len(self._items) <= self._cap_low:
                self._valid_to_push = True
                feedbacks = list(self._feedback)
        for fb in feedbacks:
            fb.feedback(self.key)
        return True

    def reset_item_status(self, item: SenderQueueItem) -> None:
        with self._lock:
            item.status = SendingStatus.IDLE

    def size(self) -> int:
        with self._lock:
            return len(self._items)

    def oldest_age(self) -> Optional[float]:
        """Seconds the oldest queued payload has waited (None when
        empty): the ``sender_queue_lag_seconds`` watermark."""
        with self._lock:
            if not self._items:
                return None
            return max(0.0, time.monotonic() - self._items[0].enqueue_time)

    def empty(self) -> bool:
        with self._lock:
            return not self._items

    def set_feedback(self, *feedbacks) -> None:
        with self._lock:
            self._feedback = list(feedbacks)


class SenderQueueManager:
    def __init__(self) -> None:
        self._queues: Dict[int, SenderQueue] = {}
        self._lock = threading.Lock()
        # backlog-aware hand-off: pushes set this event; the FlusherRunner
        # waits on it instead of sleeping out a fixed poll interval
        self._data_event = threading.Event()

    def wait_for_data(self, timeout: float) -> bool:
        """Block until a push signals new payloads (or timeout — the
        deadline fallback that keeps retry/replay cadences alive)."""
        if self._data_event.wait(timeout):
            self._data_event.clear()
            return True
        return False

    def create_or_reuse_queue(self, key: int, capacity: int = 10,
                              pipeline_name: str = "") -> SenderQueue:
        with self._lock:
            q = self._queues.get(key)
            if q is None:
                q = SenderQueue(key, capacity, pipeline_name)
                q._on_push = self._data_event.set
                self._queues[key] = q
            return q

    def get_queue(self, key: int) -> Optional[SenderQueue]:
        with self._lock:
            return self._queues.get(key)

    def delete_queue(self, key: int) -> None:
        with self._lock:
            q = self._queues.pop(key, None)
        if q is not None:
            from ...monitor import ledger, slo
            # serialized payloads still queued die with their queue
            # (direct delete, not the drain-then-GC path): terminal.
            # SENDING items are skipped — their delivery callback is
            # still coming and ledgers the terminal outcome (send_ok /
            # drop / retry_orphaned); counting them here too would
            # double-terminate the same events.  The retired flag is
            # raised under the SAME lock the dead snapshot is taken
            # under — and unconditionally, so a FlusherRunner iterating
            # a stale queue list cannot dispatch from a deleted queue
            # whether or not the ledger is counting
            led = ledger.is_on()
            slo_on = slo.is_on()
            with q._lock:
                q._retired = True
                dead = ([(i.event_cnt, len(i.data), i.stamps)
                         for i in q._items
                         if i.status is SendingStatus.IDLE]
                        if (led or slo_on) else [])
            for events, nbytes, stamps in dead:
                if led:
                    ledger.record(q.pipeline_name, ledger.B_DROP,
                                  events, nbytes, tag="queue_deleted")
                if slo_on:
                    slo.observe_stamps(q.pipeline_name, stamps,
                                       slo.OUTCOME_DROP)

    def get_available_items(self, limit_per_queue: int = 10
                            ) -> List[SenderQueueItem]:
        with self._lock:
            queues = list(self._queues.values())
        out: List[SenderQueueItem] = []
        for q in queues:
            out.extend(q.get_available_items(limit_per_queue))
        return out

    def remove_item(self, item: SenderQueueItem) -> bool:
        q = self.get_queue(item.queue_key)
        return q.remove(item) if q else False

    def all_empty(self) -> bool:
        with self._lock:
            queues = list(self._queues.values())
        return all(q.empty() for q in queues)
