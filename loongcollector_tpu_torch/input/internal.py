"""Internal self-monitor inputs.

Reference: core/plugin/input/InputInternalMetrics.cpp / InputInternalAlarms
.cpp — singleton inputs that bind the SelfMonitorServer's converted event
groups to a normal pipeline (SURVEY.md §2.6 self-monitor pipelines).

The port's copy of the JAX package's ``input/internal.py``:
``input_internal_metrics`` (``IntervalSeconds`` sets the server's cadence)
and ``input_internal_alarms``.  ``start`` binds the pipeline's process
queue to the server and starts it; ``stop`` unbinds.  Each input reports
the groups the server pushed into its queue (``groups_pushed``).
``input_internal_matched_container_info`` (JAX package ``:41-90``) claims
the ``ContainerManager``'s diff consumer: each discovery round that adds or
removes containers ships one group of ``action`` / ``container_id`` /
``container_name`` (and ``pod`` / ``namespace``) events, tagged
``__source__: matched_container_info``, into its pipeline's queue; a
refused push is re-emitted by the next round (the manager's baseline
advances only on delivery).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict

from ..container_manager import ContainerManager
from ..models import PipelineEventGroup
from ..monitor.self_monitor import SelfMonitorServer
from ..pipeline.plugin.interface import Input, PluginContext


class _InternalInput(Input):
    is_singleton = True
    read_seconds = 0.0

    @property
    def groups_pushed(self) -> int:
        """The groups the self-monitor server pushed into this input's
        process queue."""
        if self.context is None:
            return 0
        return SelfMonitorServer.instance().groups_pushed(
            self.context.process_queue_key)

    def _bind(self, server: SelfMonitorServer, key) -> None:
        raise NotImplementedError

    def start(self, should_abort=lambda: False) -> bool:
        server = SelfMonitorServer.instance()
        self._bind(server, self.context.process_queue_key)
        server.start()
        return True

    def stop(self, is_pipeline_removing: bool = False) -> bool:
        self._bind(SelfMonitorServer.instance(), None)
        return True


class InputInternalMetrics(_InternalInput):
    name = "input_internal_metrics"

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        interval = config.get("IntervalSeconds")
        if interval:
            SelfMonitorServer.instance().interval_s = float(interval)
        return True

    def _bind(self, server: SelfMonitorServer, key) -> None:
        server.set_metrics_pipeline(key)


class InputInternalAlarms(_InternalInput):
    name = "input_internal_alarms"

    def _bind(self, server: SelfMonitorServer, key) -> None:
        server.set_alarms_pipeline(key)


class InputInternalMatchedContainerInfo(Input):
    """Ships container discovery diffs as events (reference
    InputInternalMatchedContainerInfo + ContainerManager.cpp:325)."""

    name = "input_internal_matched_container_info"
    is_singleton = True
    read_seconds = 0.0

    def __init__(self) -> None:
        super().__init__()
        self._callback = None
        self._pushed = 0
        self._lock = threading.Lock()

    @property
    def groups_pushed(self) -> int:
        with self._lock:
            return self._pushed

    def start(self, should_abort=lambda: False) -> bool:
        mgr = ContainerManager.instance()
        queue_key = self.context.process_queue_key

        def on_diff(added, removed) -> bool:
            group = PipelineEventGroup()
            sb = group.source_buffer
            now = int(time.time())
            for info, action in ([(c, "added") for c in added]
                                 + [(c, "removed") for c in removed]):
                ev = group.add_log_event(now)
                ev.set_content(b"action", sb.copy_string(action))
                ev.set_content(b"container_id", sb.copy_string(info.id))
                ev.set_content(b"container_name", sb.copy_string(info.name))
                if info.k8s_pod:
                    ev.set_content(b"pod", sb.copy_string(info.k8s_pod))
                    ev.set_content(b"namespace",
                                   sb.copy_string(info.k8s_namespace))
            group.set_tag(b"__source__", b"matched_container_info")
            server = SelfMonitorServer.instance()
            if server.process_queue_manager is None or group.empty():
                return True
            # counted before the push: the drain rule never sees a settled
            # group its input has not counted
            with self._lock:
                self._pushed += 1
            if server.process_queue_manager.push_queue(queue_key, group):
                return True
            with self._lock:
                self._pushed -= 1
            return False

        self._callback = on_diff
        if not mgr.set_on_diff(on_diff):
            from ..utils.logger import get_logger
            get_logger("internal").error(
                "matched_container_info already bound to another pipeline")
            return False
        return True

    def stop(self, is_pipeline_removing: bool = False) -> bool:
        mgr = ContainerManager.instance()
        # only the owning pipeline clears the consumer slot
        if mgr.on_diff is self._callback:
            mgr.set_on_diff(None)
        return True
