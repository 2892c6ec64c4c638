"""Self-monitoring of the port: the metrics records
(``metrics.py``) and the event-conservation ledger (``ledger.py``)."""

from .metrics import (Counter, Gauge, Histogram, MetricsRecord,  # noqa: F401
                      ReadMetrics, WriteMetrics)
