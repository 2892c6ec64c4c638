"""Per-flusher event batching.

Reference: core/collection_pipeline/batch/Batcher.h:42-44 — a templated
two-stage (event batch → group batch) accumulator keyed by the group's
(source, topic, tags) so merged batches stay homogeneous; flush strategy from
FlushStrategy.h; timeout flushing driven centrally (TimeoutFlushManager,
pumped by processor thread 0 — runner/ProcessorRunner.cpp:109-112).

TPU-first note: batches keep groups whole (columnar groups are already
batched tensors); merging concatenates group lists, not per-event copies.

The port's copy of the JAX package's ``pipeline/batch/batcher.py``: the
HTTP-family flushers (``flusher/http_base.py``, ``flusher/http.py``)
batch through it; ``flusher_file`` and ``flusher_stdout`` still write
each group inline.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ...models import PipelineEventGroup
from .flush_strategy import FlushStrategy
from .timeout_flush_manager import TimeoutFlushManager


class _BatchState:
    __slots__ = ("groups", "event_cnt", "size_bytes", "create_time")

    def __init__(self) -> None:
        self.groups: List[PipelineEventGroup] = []
        self.event_cnt = 0
        self.size_bytes = 0
        self.create_time = time.monotonic()


def _group_key(group: PipelineEventGroup) -> Tuple:
    tags = tuple(sorted((k, v.to_bytes()) for k, v in group.tags.items()))
    return tags


class Batcher:
    """Accumulates groups per key; emits batches (lists of groups) to the
    flusher's SerializeAndPush callback."""

    def __init__(self, strategy: Optional[FlushStrategy] = None,
                 on_flush: Optional[Callable[[List[PipelineEventGroup]], None]] = None,
                 flusher_id: str = "", pipeline_name: str = ""):
        self.strategy = strategy or FlushStrategy()
        self.on_flush = on_flush
        self._batches: Dict[Tuple, _BatchState] = {}
        # events claimed out of _batches but still inside on_flush (the
        # write can block): occupancy for pending_events() — without it a
        # flush stalled mid-write leaves the events in no counter and the
        # conservation auditor could read a stable ledger + zero occupancy
        # as a quiesce with a nonzero residual (loongledger)
        self._emitting_events = 0
        self._lock = threading.Lock()
        self.flusher_id = flusher_id
        self.pipeline_name = pipeline_name
        TimeoutFlushManager.instance().register(self)

    def add(self, group: PipelineEventGroup) -> None:
        size = group.data_size()
        cnt = len(group)
        to_flush: List[Tuple[List[PipelineEventGroup], int]] = []
        with self._lock:
            key = _group_key(group)
            st = self._batches.get(key)
            if st is None:
                st = _BatchState()
                self._batches[key] = st
            if st.groups and self.strategy.size_would_exceed(st.size_bytes, size):
                to_flush.append((st.groups, st.event_cnt))
                self._emitting_events += st.event_cnt
                self._batches[key] = st = _BatchState()
            st.groups.append(group)
            st.event_cnt += cnt
            st.size_bytes += size
            if (self.strategy.need_flush_by_count(st.event_cnt)
                    or self.strategy.need_flush_by_size(st.size_bytes)
                    # backlog-aware hand-off (loongcolumn): while traffic
                    # flows, a batch past its timeout flushes on the very
                    # add that finds it due — the 1 s central pump is only
                    # the idle-pipeline deadline fallback, so batch latency
                    # tracks the configured timeout, not the pump cadence
                    or self.strategy.need_flush_by_time(st.create_time)):
                to_flush.append((st.groups, st.event_cnt))
                self._emitting_events += st.event_cnt
                del self._batches[key]
        self._emit_batches(to_flush)

    def pending_events(self) -> int:
        """Events currently held by open batches or mid-flush — the
        ledger's live-occupancy probe (loongledger): an event parked here
        is inflight, not lost."""
        with self._lock:
            return (sum(st.event_cnt for st in self._batches.values())
                    + self._emitting_events)

    def flush_timeout(self) -> None:
        to_flush = []
        with self._lock:
            for key in list(self._batches):
                st = self._batches[key]
                if st.groups and self.strategy.need_flush_by_time(st.create_time):
                    to_flush.append((st.groups, st.event_cnt))
                    self._emitting_events += st.event_cnt
                    del self._batches[key]
        self._emit_batches(to_flush)

    def flush_all(self) -> None:
        with self._lock:
            pending = [(st.groups, st.event_cnt)
                       for st in self._batches.values() if st.groups]
            self._emitting_events += sum(n for _, n in pending)
            self._batches.clear()
        self._emit_batches(pending)

    def _emit_batches(self,
                      batches: List[Tuple[List[PipelineEventGroup], int]]
                      ) -> None:
        for idx, (groups, n) in enumerate(batches):
            try:
                self._emit(groups, n)
            except BaseException:
                # the unemitted tail is genuinely lost with this raise —
                # release its occupancy claim so the system can still
                # quiesce; the loss then surfaces as a ledger residual
                # (the auditor firing on it is by design)
                with self._lock:
                    self._emitting_events -= sum(
                        m for _, m in batches[idx + 1:])
                raise

    def _emit(self, groups: List[PipelineEventGroup], n_events: int) -> None:
        try:
            if self.on_flush is not None and groups:
                self.on_flush(groups)
        finally:
            with self._lock:
                self._emitting_events -= n_events

    def close(self) -> None:
        TimeoutFlushManager.instance().unregister(self)
