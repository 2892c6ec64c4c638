"""CollectionPipelineManager, reduced: build, start and stop the pipelines.

Reference: loongcollector_tpu/pipeline/pipeline_manager.py.  The port
builds one pipeline per config of the config directory, gives each its
bounded process queue and its tenant share of the device plane's byte
budget, starts its inputs (a one-shot read into the queue, or a source
bound to a singleton runner such as the eBPF server or, in tail mode
(``tail``), the file server), stops them before
the final drain, drains what its processors hold at stop, and stops the
pipelines.  Given a sender-queue manager, each flusher of a pipeline gets
its sender queue (``CollectionPipeline._wire_flusher``); ``stop_all``
stops the flushers (a batcher flushes into its queue), and
``delete_sender_queues`` retires the queues once the flusher runner has
drained them (``SenderQueueManager.delete_queue``: what is still queued
is booked as a ``queue_deleted`` drop).
Hot reload (generations, drain and hand-off) and onetime configs come
with later slices.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..ops import device_plane
from .pipeline import CollectionPipeline
from .queue.process_queue_manager import ProcessQueueManager


# observe-only handle of the most recently constructed manager (the
# ledger's occupancy probe, the lag watermarks, /debug/status); stop_all()
# clears it
_active_manager = None


class CollectionPipelineManager:
    def __init__(self, process_queue_manager: ProcessQueueManager,
                 device: torch.device, tail: bool = False,
                 sender_queue_manager=None):
        self.process_queue_manager = process_queue_manager
        self.sender_queue_manager = sender_queue_manager
        self._sender_queue_keys: List[int] = []
        self.device = device
        self.tail = tail
        self._pipelines: Dict[str, CollectionPipeline] = {}
        self._by_key: Dict[int, CollectionPipeline] = {}
        self._lock = threading.Lock()
        global _active_manager
        _active_manager = self

    def update_pipelines(self, configs: List[Tuple[str, Dict[str, Any]]]
                         ) -> None:
        """Build a pipeline for each (name, config) with its process queue
        and tenant share.  A config that fails to build raises."""
        for name, cfg in configs:
            p = CollectionPipeline(name, cfg, self.device,
                                   self.process_queue_manager,
                                   tail=self.tail,
                                   sender_queue_manager=(
                                       self.sender_queue_manager))
            self.process_queue_manager.create_or_reuse_queue(
                p.process_queue_key, pipeline_name=name)
            with self._lock:
                self._pipelines[name] = p
                self._by_key[p.process_queue_key] = p
                self._sender_queue_keys.extend(
                    f.queue_key for f in p.flushers
                    if f.sender_queue is not None)
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

    def resolve_buffered_flusher(self, identity: dict):
        """The live flusher a spilled payload's identity names
        (``plugin_id`` disambiguates same-type flushers of one pipeline),
        or None (JAX package ``application.py:462-476``)."""
        p = self.find_pipeline(identity.get("pipeline", ""))
        if p is None:
            return None
        want_id = identity.get("plugin_id", "")
        for f in p.flushers:
            if want_id and f.plugin_id == want_id:
                return f
        if not want_id:  # buffers written without plugin_id
            for f in p.flushers:
                if f.name == identity.get("flusher_type"):
                    return f
        return None

    def delete_sender_queues(self) -> None:
        """Retire every sender queue the pipelines had."""
        with self._lock:
            keys, self._sender_queue_keys = self._sender_queue_keys, []
        for key in keys:
            self.sender_queue_manager.delete_queue(key)

    def stop_all(self) -> None:
        """Stop the inputs, release each pipeline's registrations, delete
        the process queues, release the tenant shares and stop the
        flushers.  The sender queues stay for the flusher runner's drain
        (``delete_sender_queues``)."""
        global _active_manager
        if _active_manager is self:
            _active_manager = None
        with self._lock:
            pipelines = list(self._pipelines.items())
            self._pipelines.clear()
            self._by_key.clear()
        for name, p in pipelines:
            p.stop_inputs()
            p.release()
            self.process_queue_manager.delete_queue(p.process_queue_key)
            device_plane.unregister_tenant(name)
            p.stop_flushers()
