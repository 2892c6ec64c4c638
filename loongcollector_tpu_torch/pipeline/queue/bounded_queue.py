"""Bounded process queues with high/low watermark back-pressure.

Reference: loongcollector_tpu/pipeline/queue/bounded_queue.py
(core/collection_pipeline/queue/BoundedProcessQueue.cpp:34,53,89-93 and
QueueParam.h:23-33: high watermark = capacity, low = capacity * 2/3).  A
push fails above the high watermark; a pop that brings the queue under
the low watermark fires the upstream ``FeedbackInterface`` so blocked
inputs resume.  The queue is bounded in bytes as well as groups.

Left out of the port: the ledger records, the chaos fault point, the
queue-wait histogram and the drop-oldest ``CircularProcessQueue`` (for
streaming inputs the port does not have yet).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, List, Optional

from ...models import PipelineEventGroup

DEFAULT_CAPACITY = 20
LOW_WATERMARK_RATIO = 2 / 3

# the byte bound keeps the standing backlog shallow when groups are large
# (512 KiB reader chunks); the count bound guards many tiny groups.
# 0 disables the byte bound.
DEFAULT_MAX_BYTES = 2 * 1024 * 1024


class FeedbackInterface:
    """Upstream wakeup hook (reference queue/FeedbackInterface.h)."""

    def feedback(self, key: int) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class BoundedProcessQueue:
    """Count- and byte-bounded MPSC queue with watermark feedback.

    Thread-safe; producers are input threads, consumers the processor
    runner.  ``set_pop_enabled(False)`` holds the queue for a drain."""

    def __init__(self, key: int, priority: int = 1,
                 capacity: int = DEFAULT_CAPACITY,
                 pipeline_name: str = "",
                 max_bytes: int = DEFAULT_MAX_BYTES):
        self.key = key
        self.priority = priority
        self.pipeline_name = pipeline_name
        self._cap_high = max(capacity, 1)
        self._cap_low = max(int(capacity * LOW_WATERMARK_RATIO), 1)
        self._bytes_high = max(int(max_bytes), 0)
        self._bytes_low = int(self._bytes_high * LOW_WATERMARK_RATIO)
        self._bytes = 0
        self._items: Deque[PipelineEventGroup] = deque()
        # enqueue timestamps and sizes ride parallel FIFOs
        self._enq_ts: Deque[float] = deque()
        self._sizes: Deque[int] = deque()
        self._lock = threading.Lock()
        self._valid_to_push = True
        self._pop_enabled = True
        self._retired = False
        self._feedback: List[FeedbackInterface] = []
        self.total_pushed = 0
        self.total_popped = 0
        self.total_rejected = 0

    # -- producer side ------------------------------------------------------

    def _over_high(self) -> bool:
        """High-watermark predicate (lock held): groups OR bytes."""
        if len(self._items) >= self._cap_high:
            return True
        return bool(self._bytes_high) and self._bytes >= self._bytes_high

    def _under_low(self) -> bool:
        """Low-watermark predicate (lock held): both bounds must clear."""
        if len(self._items) > self._cap_low:
            return False
        return not self._bytes_high or self._bytes <= self._bytes_low

    def push(self, group: PipelineEventGroup) -> bool:
        size = group.data_size() if self._bytes_high else 0
        with self._lock:
            if self._retired or not self._valid_to_push:
                self.total_rejected += 1
                return False
            self._items.append(group)
            self._enq_ts.append(time.perf_counter())
            self._sizes.append(size)
            self._bytes += size
            self.total_pushed += 1
            if self._over_high():
                self._valid_to_push = False
        return True

    def is_valid_to_push(self) -> bool:
        with self._lock:
            return self._valid_to_push

    # -- consumer side ------------------------------------------------------

    def _pop_locked(self) -> PipelineEventGroup:
        self._enq_ts.popleft()
        self._bytes -= self._sizes.popleft()
        self.total_popped += 1
        return self._items.popleft()

    def _feedbacks_locked(self) -> List[FeedbackInterface]:
        if not self._valid_to_push and self._under_low():
            self._valid_to_push = True
            return list(self._feedback)
        return []

    def pop(self) -> Optional[PipelineEventGroup]:
        with self._lock:
            if not self._pop_enabled or not self._items:
                return None
            item = self._pop_locked()
            feedbacks = self._feedbacks_locked()
        for fb in feedbacks:
            fb.feedback(self.key)
        return item

    def pop_run(self, max_groups: int, max_bytes: int
                ) -> List[PipelineEventGroup]:
        """Pop up to ``max_groups`` / ``max_bytes`` of queued groups in one
        lock acquisition: a trickle pops one group, a backlog a run."""
        out: List[PipelineEventGroup] = []
        nbytes = 0
        with self._lock:
            if not self._pop_enabled:
                return out
            while self._items and len(out) < max_groups:
                if out and nbytes + self._sizes[0] > max_bytes:
                    break
                nbytes += self._sizes[0]
                out.append(self._pop_locked())
            feedbacks = self._feedbacks_locked() if out else []
        for fb in feedbacks:
            fb.feedback(self.key)
        return out

    def set_pop_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._pop_enabled = enabled

    def retire(self) -> None:
        """Deleted queue: refuse new pushes and stop pops."""
        with self._lock:
            self._retired = True
            self._pop_enabled = False

    def empty(self) -> bool:
        with self._lock:
            return not self._items

    def size(self) -> int:
        with self._lock:
            return len(self._items)

    def bytes_queued(self) -> int:
        with self._lock:
            return self._bytes

    def set_feedback(self, *feedbacks: FeedbackInterface) -> None:
        with self._lock:
            self._feedback = list(feedbacks)
