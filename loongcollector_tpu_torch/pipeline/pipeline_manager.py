"""CollectionPipelineManager, reduced: build, start and stop the pipelines.

Reference: loongcollector_tpu/pipeline/pipeline_manager.py.  The port
builds one pipeline per config of the config directory, gives each its
bounded process queue and its tenant share of the device plane's byte
budget, starts its inputs (a one-shot read into the queue, or a source
bound to a singleton runner such as the eBPF server), stops them before
the final drain, drains what its processors hold at stop, and stops the
pipelines.
Hot reload (generations, drain and hand-off), onetime configs and the
sender queues come with later slices.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..ops import device_plane
from .pipeline import CollectionPipeline
from .queue.process_queue_manager import ProcessQueueManager


class CollectionPipelineManager:
    def __init__(self, process_queue_manager: ProcessQueueManager,
                 device: torch.device):
        self.process_queue_manager = process_queue_manager
        self.device = device
        self._pipelines: Dict[str, CollectionPipeline] = {}
        self._by_key: Dict[int, CollectionPipeline] = {}
        self._lock = threading.Lock()

    def update_pipelines(self, configs: List[Tuple[str, Dict[str, Any]]]
                         ) -> None:
        """Build a pipeline for each (name, config) with its process queue
        and tenant share.  A config that fails to build raises."""
        for name, cfg in configs:
            p = CollectionPipeline(name, cfg, self.device,
                                   self.process_queue_manager)
            self.process_queue_manager.create_or_reuse_queue(
                p.process_queue_key, pipeline_name=name)
            with self._lock:
                self._pipelines[name] = p
                self._by_key[p.process_queue_key] = p
            device_plane.register_tenant(name)

    def start_inputs(self, should_abort: Callable[[], bool] = lambda: False
                     ) -> None:
        for p in self.pipelines():
            p.start_inputs(should_abort)

    def stop_inputs(self) -> None:
        """Stop every pipeline's inputs; the pipelines stay, so what the
        inputs flush at their stop is still processed."""
        for p in self.pipelines():
            p.stop_inputs()

    def drain_held(self) -> int:
        """Each pipeline's stop-time drain (``CollectionPipeline.drain_held``)
        on the calling thread; returns the groups sent."""
        return sum(p.drain_held() for p in self.pipelines())

    def find_pipeline(self, name: str) -> Optional[CollectionPipeline]:
        with self._lock:
            return self._pipelines.get(name)

    def find_pipeline_by_queue_key(self, key: int
                                   ) -> Optional[CollectionPipeline]:
        with self._lock:
            return self._by_key.get(key)

    def pipelines(self) -> List[CollectionPipeline]:
        with self._lock:
            return list(self._pipelines.values())

    def stop_all(self) -> None:
        """Stop the inputs, release each pipeline's registrations, delete
        the queues and release the tenant shares."""
        with self._lock:
            pipelines = list(self._pipelines.items())
            self._pipelines.clear()
            self._by_key.clear()
        for name, p in pipelines:
            p.stop_inputs()
            p.release()
            self.process_queue_manager.delete_queue(p.process_queue_key)
            device_plane.unregister_tenant(name)
