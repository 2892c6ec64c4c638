"""Self-monitoring of the port: the metrics records (``metrics.py``), the
event-conservation ledger and its auditor (``ledger.py``), the freshness
SLO plane (``slo.py``), the alarm plane (``alarms.py``), the self-monitor
server behind the internal inputs (``self_monitor.py``), the runtime
gauges (``runtime_stats.py``) and the ``/metrics`` and ``/debug``
endpoint (``exposition.py``)."""

from .metrics import (Counter, Gauge, Histogram, MetricsRecord,  # noqa: F401
                      ReadMetrics, WriteMetrics)
