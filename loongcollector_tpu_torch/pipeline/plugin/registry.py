"""Static plugin registry.

Reference: core/collection_pipeline/plugin/PluginRegistry.cpp —
LoadStaticPlugins (:162-231) registers creators; CreateInput/Processor/
Flusher (:112-133); the aggregators and extensions as the JAX package's
registry (``create_aggregator``, ``create_extension``).  The port registers the plugins of its slice under the
reference's type names, ``_tpu`` and ``_native`` aliases included, so the
same pipeline YAML drives either package.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from .interface import Flusher, Input, Plugin, Processor


class PluginRegistry:
    _instance: Optional["PluginRegistry"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._inputs: Dict[str, Callable[[], Input]] = {}
        self._processors: Dict[str, Callable[[], Processor]] = {}
        self._flushers: Dict[str, Callable[[], Flusher]] = {}
        self._aggregators: Dict[str, Callable[[], Plugin]] = {}
        self._extensions: Dict[str, Callable[[], Plugin]] = {}
        self._loaded = False

    @classmethod
    def instance(cls) -> "PluginRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def register_input(self, name: str, creator: Callable[[], Input]) -> None:
        self._inputs[name] = creator

    def register_processor(self, name: str,
                           creator: Callable[[], Processor]) -> None:
        self._processors[name] = creator

    def register_flusher(self, name: str,
                         creator: Callable[[], Flusher]) -> None:
        self._flushers[name] = creator

    def register_aggregator(self, name: str,
                            creator: Callable[[], Plugin]) -> None:
        self._aggregators[name] = creator

    def register_extension(self, name: str,
                           creator: Callable[[], Plugin]) -> None:
        self._extensions[name] = creator

    def load_static_plugins(self) -> None:
        """Registers all built-in plugins (idempotent)."""
        if self._loaded:
            return
        self._loaded = True
        from ... import aggregator as _aggregator_pkg
        from ... import flusher as _flusher_pkg
        from ... import input as _input_pkg
        from ... import processor as _processor_pkg
        _processor_pkg.register_all(self)
        _flusher_pkg.register_all(self)
        _input_pkg.register_all(self)
        _aggregator_pkg.register_all(self)
        from . import extension as _extension_pkg
        _extension_pkg.register_all(self)

    def create_input(self, name: str) -> Optional[Input]:
        c = self._inputs.get(name)
        return c() if c else None

    def create_processor(self, name: str) -> Optional[Processor]:
        c = self._processors.get(name)
        return c() if c else None

    def create_flusher(self, name: str) -> Optional[Flusher]:
        c = self._flushers.get(name)
        return c() if c else None

    def create_aggregator(self, name: str) -> Optional[Plugin]:
        c = self._aggregators.get(name)
        return c() if c else None

    def create_extension(self, name: str) -> Optional[Plugin]:
        c = self._extensions.get(name)
        return c() if c else None
