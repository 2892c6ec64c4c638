"""Centralised batch timeout flushing.

Reference: core/collection_pipeline/batch/TimeoutFlushManager.h:45-56 —
FlushTimeoutBatch is driven periodically by processor thread 0
(runner/ProcessorRunner.cpp:109-112) rather than per-batcher timers.

The port's copy of the JAX package's module.  A pipeline with an
aggregator registers its timeout hook here, and so does, in tail mode,
each processor that holds records across groups (split_multiline's
carried open records: ``CollectionPipeline``'s drain hooks); the processor
runner pumps the hooks once a second (``ProcessorRunner._pump_timeout_flush``).
A ``--once`` run also force-closes what is still open at its stop-time
drain.
"""

from __future__ import annotations

import threading
from typing import Optional, Set


class TimeoutFlushManager:
    _instance: Optional["TimeoutFlushManager"] = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._batchers: Set = set()
        self._reg_lock = threading.Lock()

    @classmethod
    def instance(cls) -> "TimeoutFlushManager":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def register(self, batcher) -> None:
        with self._reg_lock:
            self._batchers.add(batcher)

    def unregister(self, batcher) -> None:
        with self._reg_lock:
            self._batchers.discard(batcher)

    def flush_timeout_batches(self) -> None:
        with self._reg_lock:
            batchers = list(self._batchers)
        for b in batchers:
            b.flush_timeout()
