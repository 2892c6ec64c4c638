"""SLS client management: region endpoint pools + response classification.

Reference: core/plugin/flusher/sls/SLSClientManager.cpp (~500 LoC) keeps an
ordered endpoint list per region, moves off a failing endpoint after a
burst of errors, and periodically probes back toward the primary;
FlusherSLS.cpp (1419 LoC) maps server response codes — quota exceed,
unauthorized, server busy — onto retry/backoff/drop decisions that drive
the AIMD concurrency limiter.

Both concerns are host-side control-plane logic, independent of the
device data plane.

The port's copy of the JAX package's ``flusher/sls_client.py``: the same
pool and the same verdicts.
"""

from __future__ import annotations

import json
import threading
import time
from typing import List, Optional

FAIL_THRESHOLD = 3          # consecutive failures before rotating away
PRIMARY_RETRY_SECS = 60.0   # probe back to the primary after this long


class EndpointPool:
    """Ordered endpoint list with failure rotation and primary probe-back.

    current() returns the active endpoint; on_fail(ep)/on_success(ep) feed
    back transfer outcomes.  After FAIL_THRESHOLD consecutive failures the
    pool rotates to the next endpoint; once off-primary, every
    PRIMARY_RETRY_SECS one request is steered back to the primary as a
    probe (remember-last-good semantics, SLSClientManager.cpp)."""

    def __init__(self, endpoints: List[str]):
        if not endpoints:
            raise ValueError("EndpointPool needs >= 1 endpoint")
        self.endpoints = list(endpoints)
        self._idx = 0
        self._fails = 0
        self._lock = threading.Lock()
        self._primary_probe_at = 0.0
        self._probing = False

    def current(self) -> str:
        with self._lock:
            if (self._idx != 0 and not self._probing
                    and time.monotonic() >= self._primary_probe_at):
                # steer ONE request at the primary as a health probe
                self._probing = True
                return self.endpoints[0]
            return self.endpoints[self._idx]

    def on_success(self, endpoint: str) -> None:
        with self._lock:
            if endpoint == self.endpoints[0]:
                if self._idx != 0:
                    self._idx = 0        # primary recovered — move home
                # only the probe's own outcome clears the probe state;
                # concurrent fallback successes must not re-arm a probe at
                # a still-dead primary every request
                self._probing = False
            if endpoint == self.endpoints[self._idx]:
                self._fails = 0

    def on_fail(self, endpoint: str) -> None:
        with self._lock:
            if endpoint == self.endpoints[0] and self._probing:
                # failed probe: stay on the fallback, rearm the timer
                self._probing = False
                self._primary_probe_at = (time.monotonic()
                                          + PRIMARY_RETRY_SECS)
                return
            if endpoint != self.endpoints[self._idx]:
                return  # stale result for an endpoint we already left
            self._fails += 1
            if self._fails >= FAIL_THRESHOLD:
                self._idx = (self._idx + 1) % len(self.endpoints)
                self._fails = 0
                if self._idx != 0:
                    self._primary_probe_at = (time.monotonic()
                                              + PRIMARY_RETRY_SECS)


# SLS error codes signalling QUOTA exhaustion: the server is alive but this
# project/shard is over its write budget — collapse send concurrency
# (AIMD slow path) instead of hammering it (FlusherSLS.cpp semantics).
QUOTA_ERROR_CODES = {
    "WriteQuotaExceed",
    "ProjectQuotaExceed",
    "ShardWriteQuotaExceed",
    "ExceedQuota",
}


def parse_error_code(body: bytes) -> Optional[str]:
    """SLS error bodies are JSON {"errorCode": ..., "errorMessage": ...}."""
    try:
        doc = json.loads(body)
        code = doc.get("errorCode")
        return code if isinstance(code, str) else None
    except (ValueError, AttributeError):
        return None


def classify_response(status: int, body: bytes) -> str:
    """Map one SLS send response onto a sender-queue verdict:

    ok          2xx
    retry_slow  quota exceeded (429, or 403 with a quota errorCode) —
                retry later AND collapse concurrency
    retry       transient server/network trouble (5xx, timeouts, status 0)
    drop        permanent rejection (bad request, auth, not found)
    """
    if 200 <= status < 300:
        return "ok"
    if status == 429:
        return "retry_slow"
    if status == 403:
        code = parse_error_code(body)
        if code in QUOTA_ERROR_CODES:
            return "retry_slow"
        return "retry"  # auth trouble can be transient (clock, STS rotate)
    if status >= 500 or status <= 0:
        return "retry"
    return "drop"
