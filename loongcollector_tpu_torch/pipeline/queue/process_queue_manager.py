"""Process-queue manager: per-pipeline queues, 3 priorities, round-robin pop.

Reference: loongcollector_tpu/pipeline/queue/process_queue_manager.py
(core/collection_pipeline/queue/ProcessQueueManager.{h,cpp}: PushQueue
:148, priorities and round-robin within a priority :45,91).  Consumers
block on one shared condition until any queue has data.  Left out of the
port: the ledger and SLO hooks and the circular queues.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ...models import PipelineEventGroup
from .bounded_queue import DEFAULT_MAX_BYTES, BoundedProcessQueue

PRIORITY_COUNT = 3  # 0 = highest

# default caps of one consumer run: a trickle pops single groups, a backlog
# hands the worker several groups per lock cycle
RUN_MAX_GROUPS = 8
RUN_MAX_BYTES = 4 * 1024 * 1024


class ProcessQueueManager:
    def __init__(self) -> None:
        self._queues: Dict[int, BoundedProcessQueue] = {}
        self._lock = threading.Lock()
        self._data_cv = threading.Condition(self._lock)
        self._rr_cursor: Dict[int, int] = {p: 0 for p in range(PRIORITY_COUNT)}
        # per-priority queue lists, rebuilt only when the topology changes
        self._version = 0
        self._snapshot_version = -1
        self._by_prio: Dict[int, list] = {}

    # -- lifecycle ----------------------------------------------------------

    def create_or_reuse_queue(self, key: int, priority: int = 1,
                              capacity: int = 20, pipeline_name: str = "",
                              max_bytes: int = DEFAULT_MAX_BYTES
                              ) -> BoundedProcessQueue:
        with self._lock:
            q = self._queues.get(key)
            if q is None:
                q = BoundedProcessQueue(key, priority, capacity,
                                        pipeline_name, max_bytes=max_bytes)
                self._queues[key] = q
                self._version += 1
            return q

    def delete_queue(self, key: int) -> None:
        """Remove the queue; an input still holding it has its pushes
        refused from now on."""
        with self._lock:
            q = self._queues.pop(key, None)
            if q is not None:
                self._version += 1
        if q is not None:
            q.retire()

    def get_queue(self, key: int) -> Optional[BoundedProcessQueue]:
        with self._lock:
            return self._queues.get(key)

    # -- producer -----------------------------------------------------------

    def push_queue(self, key: int, group: PipelineEventGroup) -> bool:
        with self._lock:
            q = self._queues.get(key)
        if q is None:
            return False
        pushed = q.push(group)
        if pushed:
            with self._data_cv:
                self._data_cv.notify()
        return pushed

    def is_valid_to_push(self, key: int) -> bool:
        q = self.get_queue(key)
        return q is not None and q.is_valid_to_push()

    # -- consumer -----------------------------------------------------------

    def pop_item(self, timeout: float = 0.2
                 ) -> Optional[Tuple[int, PipelineEventGroup]]:
        """Priority-ordered, round-robin within each priority level."""
        item = self._try_pop()
        if item is not None:
            return item
        with self._data_cv:
            self._data_cv.wait(timeout)
        return self._try_pop()

    def pop_run(self, timeout: float = 0.2,
                max_groups: int = RUN_MAX_GROUPS,
                max_bytes: int = RUN_MAX_BYTES
                ) -> Optional[Tuple[int, List[PipelineEventGroup]]]:
        """Like ``pop_item``, but drains a run of consecutive groups of the
        selected queue (one pipeline), sized by what is queued."""
        run = self._try_pop_run(max_groups, max_bytes)
        if run is not None:
            return run
        if timeout > 0:
            with self._data_cv:
                self._data_cv.wait(timeout)
        return self._try_pop_run(max_groups, max_bytes)

    def _prio_snapshot(self):
        with self._lock:
            if self._snapshot_version != self._version:
                self._by_prio = {p: [] for p in range(PRIORITY_COUNT)}
                for q in self._queues.values():
                    self._by_prio[q.priority].append(q)
                self._snapshot_version = self._version
            return self._by_prio, dict(self._rr_cursor)

    def _round_robin(self, take):
        """(key, what ``take(queue)`` gave) for the first queue, in priority
        and round-robin order, whose ``take`` gave something (not None)."""
        by_prio, cursors = self._prio_snapshot()
        for prio in range(PRIORITY_COUNT):
            level = by_prio.get(prio)
            if not level:
                continue
            start = cursors.get(prio, 0) % len(level)
            for i in range(len(level)):
                q = level[(start + i) % len(level)]
                got = take(q)
                if got is not None:
                    with self._lock:
                        self._rr_cursor[prio] = (start + i + 1) % len(level)
                    return q.key, got
        return None

    def _try_pop(self) -> Optional[Tuple[int, PipelineEventGroup]]:
        return self._round_robin(lambda q: q.pop())

    def _try_pop_run(self, max_groups: int, max_bytes: int
                     ) -> Optional[Tuple[int, List[PipelineEventGroup]]]:
        return self._round_robin(
            lambda q: q.pop_run(max_groups, max_bytes) or None)

    def all_empty(self) -> bool:
        with self._lock:
            queues = list(self._queues.values())
        return all(q.empty() for q in queues)

    def wake_up(self) -> None:
        with self._data_cv:
            self._data_cv.notify_all()
