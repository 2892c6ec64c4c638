"""Send-path limiters.

Reference: core/collection_pipeline/limiter/ — RateLimiter::FlowControl
(token-style byte budget per second) and ConcurrencyLimiter
(ConcurrencyLimiter.h:37,59-67,115-116): AIMD per-destination concurrency
with fast/slow fallback ratios.  Host-side logic, unchanged by the TPU
redesign (network egress is not device work — SURVEY.md §2.7).

The port's copy of the JAX package's ``pipeline/queue/limiter.py``.
"""

from __future__ import annotations

import threading
import time


class RateLimiter:
    """Byte-budget token bucket: at most `max_bytes_per_sec` over 1s windows."""

    def __init__(self, max_bytes_per_sec: int):
        self.max_bytes_per_sec = max_bytes_per_sec
        self._window_start = 0.0
        self._window_bytes = 0
        self._lock = threading.Lock()

    def is_valid_to_pop(self) -> bool:
        if self.max_bytes_per_sec <= 0:
            return True
        with self._lock:
            now = time.monotonic()
            if now - self._window_start >= 1.0:
                return True
            return self._window_bytes < self.max_bytes_per_sec

    def post_pop(self, size: int) -> None:
        if self.max_bytes_per_sec <= 0:
            return
        with self._lock:
            now = time.monotonic()
            if now - self._window_start >= 1.0:
                self._window_start = now
                self._window_bytes = 0
            self._window_bytes += size


class ConcurrencyLimiter:
    """AIMD in-flight budget per destination (region/host/logstore).

    OnSuccess: +1 up to the cap after `INCREASE_AFTER` consecutive successes.
    OnFail: multiplicative decrease — fast (×0.5) for hard errors, slow
    (×0.8) for soft throttling, mirroring the reference's fast/slow fallback
    ratios (ConcurrencyLimiter.h:115-116).
    """

    FAST_FALL_BACK_RATIO = 0.5
    SLOW_FALL_BACK_RATIO = 0.8
    INCREASE_AFTER = 1

    def __init__(self, name: str, max_concurrency: int = 80,
                 min_concurrency: int = 1):
        self.name = name
        self.max_concurrency = max_concurrency
        self.min_concurrency = min_concurrency
        self._limit = max_concurrency
        self._in_flight = 0
        self._success_streak = 0
        self._lock = threading.Lock()

    def is_valid_to_pop(self) -> bool:
        with self._lock:
            return self._in_flight < self._limit

    def post_pop(self) -> None:
        with self._lock:
            self._in_flight += 1

    def on_done(self) -> None:
        with self._lock:
            self._in_flight = max(0, self._in_flight - 1)

    def on_success(self) -> None:
        with self._lock:
            self._success_streak += 1
            if self._success_streak >= self.INCREASE_AFTER and self._limit < self.max_concurrency:
                self._limit += 1
                self._success_streak = 0

    def on_fail(self, slow: bool = False) -> None:
        ratio = self.SLOW_FALL_BACK_RATIO if slow else self.FAST_FALL_BACK_RATIO
        with self._lock:
            self._success_streak = 0
            self._limit = max(self.min_concurrency, int(self._limit * ratio))

    @property
    def current_limit(self) -> int:
        with self._lock:
            return self._limit

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight
