"""Self-monitor server: agent metrics/alarms re-ingested as pipelines.

Reference: core/monitor/SelfMonitorServer.cpp:129,224,328 — a thread converts
metric records and alarms into event groups and pushes them into INTERNAL
collection pipelines consumed by input_internal_metrics /
input_internal_alarms (dogfooding: the agent observes itself through its own
data plane).

The port's copy of the JAX package's ``monitor/self_monitor.py``: the same
cadence (``interval_s``, 60 s unless ``input_internal_metrics`` sets
``IntervalSeconds``), the same reads only into a queue that can take the
group (the alarms flushed; the metrics as deltas since the last send,
which the server works out from the cumulative instruments with a
``DeltaReader`` where the JAX package resets them), and the same group
shapes: one multi-value metric event a record (named by its
category, labels as tags, each histogram flattened to ``_count`` /
``_p50`` / ``_p90`` / ``_p99`` / ``_max``) and one log event an aggregated
alarm, each group tagged ``__source__: self_monitor``.  The traces
pipeline is left out (the port has no ``trace/`` plane).  The server
counts the groups it pushed into each queue (``groups_pushed``), which the
internal inputs report, so a run knows when what they pushed has settled.
The runner registry stops it first (stop order 10).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..models import PipelineEventGroup
from ..utils.logger import get_logger
from .alarms import AlarmManager
from .metrics import DeltaReader

log = get_logger("self_monitor")

SEND_INTERVAL_S = 60.0


class SelfMonitorServer:
    _instance: Optional["SelfMonitorServer"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._lock = threading.Lock()
        # queue keys of the internal pipelines (set by the internal inputs)
        self._metrics_queue_key: Optional[int] = None
        self._alarms_queue_key: Optional[int] = None
        self.process_queue_manager = None
        self.interval_s = SEND_INTERVAL_S
        # queue key -> groups pushed there
        self._pushed: Dict[int, int] = {}
        self._deltas = DeltaReader()

    @classmethod
    def instance(cls) -> "SelfMonitorServer":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    # -- registration by internal input plugins -----------------------------

    def set_metrics_pipeline(self, queue_key: Optional[int]) -> None:
        with self._lock:
            self._metrics_queue_key = queue_key

    def set_alarms_pipeline(self, queue_key: Optional[int]) -> None:
        with self._lock:
            self._alarms_queue_key = queue_key

    def groups_pushed(self, queue_key: int) -> int:
        """Groups this server pushed into the queue ``queue_key``."""
        with self._lock:
            return self._pushed.get(queue_key, 0)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(target=self._run, name="self-monitor",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._lock:
            if not self._running:
                return
            self._running = False
        if self._thread:
            self._thread.join(timeout=2)
            self._thread = None

    def _run(self) -> None:
        last = time.monotonic()
        while self._running:
            time.sleep(0.5)
            if time.monotonic() - last < self.interval_s:
                continue
            last = time.monotonic()
            try:
                self.send_once()
            except Exception:  # noqa: BLE001
                log.exception("self monitor send failed")

    # -- conversion ----------------------------------------------------------

    def send_once(self) -> None:
        pqm = self.process_queue_manager
        if pqm is None:
            return
        from .runtime_stats import refresh
        refresh()   # pull device-plane / mesh / eBPF / xprof gauges
        with self._lock:
            mkey, akey = self._metrics_queue_key, self._alarms_queue_key
        # check queue validity BEFORE reading the deltas / flushing alarms:
        # a read moves the window on, and the window where the queue is
        # full is exactly the window whose telemetry must not be lost —
        # deltas keep accumulating until the queue reopens.
        if mkey is not None and pqm.is_valid_to_push(mkey):
            group = self._metrics_group()
            if group is not None and not group.empty():
                self._push(pqm, mkey, group)
        if akey is not None and pqm.is_valid_to_push(akey):
            group = self._alarms_group()
            if group is not None and not group.empty():
                self._push(pqm, akey, group)

    def _push(self, pqm, key: int, group: PipelineEventGroup) -> None:
        if pqm.push_queue(key, group):
            with self._lock:
                self._pushed[key] = self._pushed.get(key, 0) + 1

    def _metrics_group(self) -> Optional[PipelineEventGroup]:
        snaps = self._deltas.read()
        if not snaps:
            return None
        group = PipelineEventGroup()
        sb = group.source_buffer
        now = int(time.time())
        for snap in snaps:
            ev = group.add_metric_event(now)
            ev.set_name(sb.copy_string(snap["category"]))
            values = {}
            for k, v in snap["counters"].items():
                values[k] = float(v)
            for k, v in snap["gauges"].items():
                values[k] = float(v)
            for k, h in snap.get("histograms", {}).items():
                # flattened percentile trio + volume: the self-monitor
                # stream is multi-value metric events, not bucket vectors
                # (the exposition endpoint serves the full buckets)
                values[f"{k}_count"] = float(h["count"])
                values[f"{k}_p50"] = float(h["p50"])
                values[f"{k}_p90"] = float(h["p90"])
                values[f"{k}_p99"] = float(h["p99"])
                values[f"{k}_max"] = float(h["max"])
            if values:
                ev.set_multi_value(values)
            for k, v in snap["labels"].items():
                ev.set_tag(sb.copy_string(k), sb.copy_string(str(v)))
        group.set_tag(b"__source__", b"self_monitor")
        return group

    @staticmethod
    def _alarms_group() -> Optional[PipelineEventGroup]:
        alarms = AlarmManager.instance().flush()
        if not alarms:
            return None
        group = PipelineEventGroup()
        sb = group.source_buffer
        now = int(time.time())
        for alarm in alarms:
            ev = group.add_log_event(now)
            for k, v in alarm.items():
                ev.set_content(sb.copy_string(k), sb.copy_string(v))
        group.set_tag(b"__source__", b"self_monitor")
        return group
