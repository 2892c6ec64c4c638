"""Singleton input-runner registry.

Reference: loongcollector_tpu/runner/input_registry.py, after
core/collection_pipeline/plugin/PluginRegistry.cpp:162-196 — the
registration matrix binding inputs to their singleton runners — and
InputFeedbackInterfaceRegistry (queue wakeup wiring).  A singleton input
runner declares itself here; the application hands every runner the
process-queue manager (``wire_all``) and stops them in order
(``stop_all``) before the processor runner drains.

Each entry: name, instance getter, stop method name, stop order (lower
stops first).  The port registers the runners it has, at the reference's
orders: the self-monitor server (10), the eBPF server (40) and the file
server (tail mode's file input, 60).  The reference's host monitor (20),
Prometheus (30) and gRPC forward (50) runners join with their modules.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List

from ..utils.logger import get_logger

log = get_logger("input_registry")


@dataclass
class _Entry:
    name: str
    instance: Callable[[], Any]
    stop_method: str = "stop"
    stop_order: int = 100


class InputRunnerRegistry:
    _entries: Dict[str, _Entry] = {}
    _lock = threading.Lock()

    @classmethod
    def register(cls, name: str, instance: Callable[[], Any],
                 stop_method: str = "stop", stop_order: int = 100) -> None:
        with cls._lock:
            cls._entries[name] = _Entry(name, instance, stop_method,
                                        stop_order)

    @classmethod
    def entries(cls) -> List[_Entry]:
        with cls._lock:
            return sorted(cls._entries.values(), key=lambda e: e.stop_order)

    @classmethod
    def wire_all(cls, process_queue_manager) -> None:
        """Hand every runner the process-queue manager (the watermark
        feedback boundary every input pushes through)."""
        for e in cls.entries():
            try:
                runner = e.instance()
            except Exception:  # noqa: BLE001
                # a runner that failed to instantiate never read an event
                log.exception("input runner %s instantiation failed", e.name)
                continue
            if hasattr(runner, "process_queue_manager"):
                runner.process_queue_manager = process_queue_manager

    @classmethod
    def stop_all(cls) -> None:
        for e in cls.entries():
            try:
                runner = e.instance()
                getattr(runner, e.stop_method)()
            except Exception:  # noqa: BLE001
                log.exception("input runner %s stop failed", e.name)


def register_builtin_runners() -> None:
    """Declarative matrix of the port's singleton runners (idempotent)."""
    from ..input.ebpf.server import EBPFServer
    from ..input.file.file_server import FileServer
    from ..monitor.self_monitor import SelfMonitorServer

    InputRunnerRegistry.register("self_monitor", SelfMonitorServer.instance,
                                 stop_order=10)
    InputRunnerRegistry.register("ebpf", EBPFServer.instance, stop_order=40)
    InputRunnerRegistry.register("file_server", FileServer.instance,
                                 stop_order=60)
