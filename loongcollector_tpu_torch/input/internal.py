"""Internal self-monitor inputs.

Reference: core/plugin/input/InputInternalMetrics.cpp / InputInternalAlarms
.cpp — singleton inputs that bind the SelfMonitorServer's converted event
groups to a normal pipeline (SURVEY.md §2.6 self-monitor pipelines).

The port's copy of the JAX package's ``input/internal.py``:
``input_internal_metrics`` (``IntervalSeconds`` sets the server's cadence)
and ``input_internal_alarms``.  ``start`` binds the pipeline's process
queue to the server and starts it; ``stop`` unbinds.  Each input reports
the groups the server pushed into its queue (``groups_pushed``).
``input_internal_matched_container_info`` is left out: it needs the
container manager, which the port does not have.
"""

from __future__ import annotations

from typing import Any, Dict

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
