"""Batch flush strategies.

Reference: core/collection_pipeline/batch/FlushStrategy.h — MinCnt /
MinSizeBytes / MaxSizeBytes / TimeoutSecs.  A batch flushes when it reaches
the min count/size, must flush before exceeding the max size, and is flushed
by timer after the timeout.

The port's copy of the JAX package's ``pipeline/batch/flush_strategy.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass
class FlushStrategy:
    min_cnt: int = 4096
    min_size_bytes: int = 512 * 1024
    max_size_bytes: int = 5 * 1024 * 1024
    timeout_secs: float = 1.0

    def need_flush_by_count(self, cnt: int) -> bool:
        return self.min_cnt > 0 and cnt >= self.min_cnt

    def need_flush_by_size(self, size: int) -> bool:
        return self.min_size_bytes > 0 and size >= self.min_size_bytes

    def size_would_exceed(self, size: int, add: int) -> bool:
        return self.max_size_bytes > 0 and size + add > self.max_size_bytes

    def need_flush_by_time(self, create_time: float) -> bool:
        return self.timeout_secs > 0 and (time.monotonic() - create_time) >= self.timeout_secs
