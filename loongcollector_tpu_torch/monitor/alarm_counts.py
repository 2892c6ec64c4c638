"""Alarm counts of the send path.

The port has no alarm plane yet (the JAX package's ``monitor/alarms.py``).
Where the JAX package's send path calls ``AlarmManager.send_alarm`` — the
flusher runner's ``SEND_FAIL``, ``SEND_QUOTA_EXCEED`` and
``DISCARD_DATA`` (``runner/flusher_runner.py:450-470``), the breaker's
``SINK_CIRCUIT_OPEN`` (``runner/circuit.py``) and the disk buffer's
``SECONDARY_READ_WRITE`` at a quarantine (``runner/disk_buffer.py``) —
the port counts the alarm by its ``AlarmType`` name and logs it once an
episode: the first alarm of a (type, key) pair logs, the later ones only
count, until ``end_episode(key)`` (the sink answered again).  ``--stats``
``send.alarms`` reads ``counts()``.
"""

from __future__ import annotations

import threading
from typing import Dict, Set, Tuple

from ..utils.logger import get_logger

log = get_logger("alarms")

SEND_FAIL = "SEND_FAIL"
SEND_QUOTA_EXCEED = "SEND_QUOTA_EXCEED"
DISCARD_DATA = "DISCARD_DATA"
SINK_CIRCUIT_OPEN = "SINK_CIRCUIT_OPEN"
SECONDARY_READ_WRITE = "SECONDARY_READ_WRITE"

_lock = threading.Lock()
_counts: Dict[str, int] = {}
_open: Set[Tuple[str, str]] = set()


def alarm(alarm_type: str, message: str, key: str = "") -> None:
    """Count one alarm; log it when it opens an episode of (type, key)."""
    with _lock:
        _counts[alarm_type] = _counts.get(alarm_type, 0) + 1
        first = (alarm_type, key) not in _open
        _open.add((alarm_type, key))
    if first:
        log.warning("alarm %s%s: %s", alarm_type,
                    f" [{key}]" if key else "", message)


def end_episode(key: str) -> None:
    """Close every open episode of ``key``: its next alarm logs again."""
    with _lock:
        for pair in [p for p in _open if p[1] == key]:
            _open.discard(pair)


def counts() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def reset() -> None:
    with _lock:
        _counts.clear()
        _open.clear()
