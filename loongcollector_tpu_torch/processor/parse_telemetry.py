"""Parse-fallback accounting of the structural-index parsers.

The port's copy of the JAX package's ``processor/parse_telemetry.py``: rows
the structural index cannot prove well-formed fall back to per-row Python,
and every such row is counted per (processor, pipeline), beside the rows
parsed and the rows parsed with schema drift (extras columns), on a
per-processor ``MetricsRecord`` and in ``status()`` (the agent's
``--stats`` ``parse`` section).  Once the fallback rate is sustained, a
one-shot ``PARSE_FALLBACK_DEGRADED`` alarm is raised (and logged) per
(processor, pipeline), as the reference does.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

from ..utils.logger import get_logger

log = get_logger("processor")

#: warn once a processor/pipeline has seen this many rows...
MIN_ROWS = 1024
#: ...with at least this fraction falling back per row
RATE_THRESHOLD = 0.05

_lock = threading.Lock()
_rows: Dict[Tuple[str, str], int] = {}
_fallback: Dict[Tuple[str, str], int] = {}
_drift: Dict[Tuple[str, str], int] = {}
_degraded: set = set()
_records: Dict[str, object] = {}


def _metrics(processor: str):
    rec = _records.get(processor)
    if rec is None:
        from ..monitor.metrics import MetricsRecord
        with _lock:
            rec = _records.get(processor)
            if rec is None:
                rec = MetricsRecord(category="component",
                                    labels={"component": "loongstruct",
                                            "processor": processor})
                _records[processor] = rec
    return rec


def note_rows(processor: str, pipeline: str, total: int,
              fallback: int, drift: int = 0) -> None:
    """Account one group's parse outcome.  `fallback` = rows that left the
    structural plane for per-row Python; `drift` = rows parsed on-plane
    with schema drift (extras columns)."""
    if total <= 0:
        return
    rec = _metrics(processor)
    rec.counter("parse_rows_total").add(total)
    if fallback:
        rec.counter("parse_fallback_rows_total").add(fallback)
    if drift:
        rec.counter("parse_drift_rows_total").add(drift)
    key = (processor, pipeline)
    warn = False
    with _lock:
        _rows[key] = _rows.get(key, 0) + total
        _fallback[key] = _fallback.get(key, 0) + fallback
        if drift:
            _drift[key] = _drift.get(key, 0) + drift
        seen, fb = _rows[key], _fallback[key]
        if key not in _degraded and seen >= MIN_ROWS \
                and fb >= seen * RATE_THRESHOLD:
            _degraded.add(key)
            warn = True
    if warn:
        log.warning("sustained per-row parse fallback on %s (pipeline %s): "
                    "%d/%d rows off the structural plane", processor,
                    pipeline, fb, seen)
        # outside _lock: the alarm manager takes its own
        from ..monitor.alarms import AlarmLevel, AlarmManager, AlarmType
        AlarmManager.instance().send_alarm(
            AlarmType.PARSE_FALLBACK_DEGRADED,
            f"sustained per-row parse fallback on {processor}: "
            f"{fb}/{seen} rows off the structural plane",
            AlarmLevel.ERROR, pipeline=pipeline,
            details={"processor": processor,
                     "fallback_rows": str(fb), "rows": str(seen)})


def status() -> Dict[str, object]:
    """Per-(processor, pipeline) row / fallback / drift totals, and which
    pairs crossed the sustained-fallback threshold."""
    with _lock:
        rows = dict(_rows)
        fallback = dict(_fallback)
        drift = dict(_drift)
        degraded = set(_degraded)
    out = {}
    for key, seen in rows.items():
        label = "/".join(k for k in key if k) or key[0]
        out[label] = {
            "rows": seen,
            "fallback_rows": fallback.get(key, 0),
            "drift_rows": drift.get(key, 0),
            "degraded": key in degraded,
        }
    return out


def reset() -> None:
    """Clear the accumulated totals (the records persist: they are
    process-lifetime instruments)."""
    with _lock:
        _rows.clear()
        _fallback.clear()
        _drift.clear()
        _degraded.clear()
