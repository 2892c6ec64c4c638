"""Fail-soft evidence paths: each swallowed exception is logged once and
counted.

The self-observability planes read other subsystems to report on them (the
exposition renderer's refreshes, the SLO budget breakdown's hop totals,
the runtime gauges, ``/debug/status``'s sections).  As in the JAX package,
such a read never takes the agent or the page down: it is skipped.  Unlike
the JAX package, the port does not skip it silently: ``note(where)``
counts the exception under its site's name and logs it (with its
traceback) the first time that site fails; ``/debug/status`` shows the
counts (``evidence_faults``).
"""

from __future__ import annotations

import threading
from typing import Dict

from ..utils.logger import get_logger

log = get_logger("fail_soft")

_lock = threading.Lock()
_counts: Dict[str, int] = {}


def note(where: str, exc: BaseException) -> None:
    """Count one swallowed exception of ``where``; log the first."""
    with _lock:
        n = _counts.get(where, 0) + 1
        _counts[where] = n
    if n == 1:
        log.warning("evidence path %s failed (logged once, counted)",
                    where, exc_info=exc)


def counts() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def reset() -> None:
    """Tests only."""
    with _lock:
        _counts.clear()
