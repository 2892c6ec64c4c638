"""CollectionPipeline: config → plugin chain, run synchronously.

Reference: core/collection_pipeline/CollectionPipeline.cpp — Init (:77)
builds inputs/processors/flushers from the registry (:109-204) and wires the
inner processors inputs supply (:236-256); Process (:419) runs inner then
user processors; Send hands the group to the flushers.  The port's slice
runs input → inner processors → processors → flushers on one thread, the
reference's default ``process_thread_count = 1``; queues, routers and
runner threads come with a later slice.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

from ..models import PipelineEventGroup
from ..utils.logger import get_logger
from .plugin.interface import Flusher, Input, PluginContext, Processor
from .plugin.registry import PluginRegistry

log = get_logger("pipeline")


class PipelineInitError(RuntimeError):
    """A plugin of the config is unknown or refused its config."""


class CollectionPipeline:
    def __init__(self, name: str, config: Dict[str, Any],
                 device: torch.device):
        self.name = name
        self.config = config
        self.context = PluginContext(pipeline_name=name, config=config,
                                     device=device)
        self.inputs: List[Input] = []
        self.inner_processors: List[Processor] = []
        self.processors: List[Processor] = []
        self.flushers: List[Flusher] = []
        self.stage_seconds: Dict[str, float] = {}
        registry = PluginRegistry.instance()
        registry.load_static_plugins()
        for icfg in config.get("inputs", []):
            inp = self._make(registry.create_input, icfg)
            self.inputs.append(inp)
            for pcfg in inp.inner_processor_configs():
                self.inner_processors.append(
                    self._make(registry.create_processor, pcfg))
        for pcfg in config.get("processors", []):
            self.processors.append(self._make(registry.create_processor, pcfg))
        for fcfg in config.get("flushers", []):
            self.flushers.append(self._make(registry.create_flusher, fcfg))

    def _make(self, create, cfg: Dict[str, Any]):
        typ = cfg.get("Type", "")
        plugin = create(typ)
        if plugin is None:
            raise PipelineInitError(f"pipeline {self.name}: unknown plugin "
                                    f"type {typ!r}")
        if not plugin.init(cfg, self.context):
            raise PipelineInitError(f"pipeline {self.name}: {typ} refused "
                                    f"its config")
        return plugin

    def _timed(self, name: str, fn, group) -> None:
        t0 = time.perf_counter()
        fn(group)
        self.stage_seconds[name] = (self.stage_seconds.get(name, 0.0)
                                    + time.perf_counter() - t0)

    def process(self, group: PipelineEventGroup) -> None:
        for p in self.inner_processors + self.processors:
            self._timed(p.name, p.process, group)

    def send(self, group: PipelineEventGroup) -> None:
        for f in self.flushers:
            self._timed(f.name, f.send, group)

    def run_once(self) -> int:
        """Read every input once, process and flush each group; returns the
        number of events sent.  Host seconds per stage accumulate in
        ``stage_seconds`` (``input`` is the file read)."""
        n_events = 0
        for inp in self.inputs:
            groups = inp.read_all()
            while True:
                t0 = time.perf_counter()
                group = next(groups, None)
                self.stage_seconds["input"] = (
                    self.stage_seconds.get("input", 0.0)
                    + time.perf_counter() - t0)
                if group is None:
                    break
                self.process(group)
                n_events += len(group)
                self.send(group)
        return n_events
