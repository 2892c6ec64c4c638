"""CollectionPipeline: config → plugin chain; process_begin → send.

Reference: core/collection_pipeline/CollectionPipeline.cpp — Init (:77)
builds inputs/processors/flushers from the registry (:109-204) and wires the
inner processors inputs supply (:236-256); Process (:419) runs inner then
user processors; Send hands the group to the flushers.  The processor
runner drives it (``runner/processor_runner.py``): ``process_begin`` walks
the chain up to the first processor that leaves device work in flight and
returns a continuation that finishes the chain (JAX package
``pipeline/pipeline.py:334-425``).  While a continuation is outstanding
the groups count as in process (``in_process_count``,
``wait_all_items_in_process_finished``).  There is no aggregator yet.
Host seconds per stage (``stage_seconds``) are summed across the runner's
workers.

Fused runs (resident stage fusion, ``pipeline/fused_chain.py``): at init
``plan_fusion`` turns every run of two or more consecutive stages that can
join one device program (a Tier-1 parse, a multi-pattern classify, a filter
on the source or on a field the run itself parsed) into a ``FusedRun``.
When fusion is on (``LOONG_FUSED``, by default exactly when the pipeline's
device is CUDA) the chain walk meets a run at its head and takes it as one
async stage: the run dispatches one K7 program a chunk for each group it
can take (``fused_dispatch``), and its continuation waits for the results
(``fused_result``), applies each member's epilogue (timed under the
member's name) and walks the rest of the chain inline; groups it cannot
take (a row over 4096 bytes, a row-path group) run the members per-stage
inline.  With fusion off the members run per-stage as before.
``drain_from`` always runs per-stage, as in the reference.

Processors that hold records across groups (split_multiline's carry)
release them at stop: ``drain_held`` runs every ``drain_groups()`` through
the processors after the holder and the send path (``drain_from``; JAX
package ``pipeline.py:294-330``).  The reference's timeout-flush
registration of the same hook waits for tail mode.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..models import PipelineEventGroup
from ..utils.logger import get_logger
from .plugin.interface import Flusher, Input, PluginContext, Processor
from .plugin.registry import PluginRegistry

log = get_logger("pipeline")

_queue_keys = itertools.count(1)


def next_queue_key() -> int:
    return next(_queue_keys)


class PipelineInitError(RuntimeError):
    """A plugin of the config is unknown or refused its config."""


class CollectionPipeline:
    def __init__(self, name: str, config: Dict[str, Any],
                 device: torch.device, process_queue_manager=None):
        self.name = name
        self.config = config
        self.process_queue_key = next_queue_key()
        self.context = PluginContext(
            pipeline_name=name, config=config, device=device,
            process_queue_manager=process_queue_manager,
            process_queue_key=self.process_queue_key)
        self.inputs: List[Input] = []
        self.inner_processors: List[Processor] = []
        self.processors: List[Processor] = []
        self.flushers: List[Flusher] = []
        self.stage_seconds: Dict[str, float] = {}
        self.events_sent = 0
        self._stats_lock = threading.Lock()
        self._in_process_cnt = 0
        self._in_process_zero = threading.Condition()
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
        # fused runs over the final chain: description only, the programs
        # are built at their first dispatch; LOONG_FUSED gates running them
        from .fused_chain import plan_fusion
        self.fused_runs = plan_fusion(self.inner_processors + self.processors,
                                      device)
        self._fused_by_head = {r.head: r for r in self.fused_runs}

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

    def add_stage_seconds(self, name: str, seconds: float) -> None:
        with self._stats_lock:
            self.stage_seconds[name] = (self.stage_seconds.get(name, 0.0)
                                        + seconds)

    def _timed(self, name: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.add_stage_seconds(name, time.perf_counter() - t0)

    # -- inputs ---------------------------------------------------------------

    def start_inputs(self, should_abort: Callable[[], bool] = lambda: False
                     ) -> None:
        """One-shot read of every input into this pipeline's process
        queue; the inputs' read seconds count as the ``input`` stage."""
        for inp in self.inputs:
            inp.start(should_abort)
            self.add_stage_seconds("input", inp.read_seconds)

    def stop_inputs(self) -> None:
        for inp in self.inputs:
            inp.stop()

    # -- processing -----------------------------------------------------------

    def process_begin(self, groups: List[PipelineEventGroup]
                      ) -> Optional[Callable[[], None]]:
        """Run the chain up to and including the first processor that
        leaves device work in flight.  Returns None when the chain ran to
        its end; else a continuation that consumes the device work and runs
        the remaining processors — call it exactly once."""
        with self._in_process_zero:
            self._in_process_cnt += 1
        try:
            cont = self._walk_chain(groups, 0, allow_async=True)
        except BaseException:
            self._exit_process()
            raise
        if cont is None:
            self._exit_process()
            return None

        def finish():
            try:
                cont()
            finally:
                self._exit_process()
        return finish

    def _walk_chain(self, groups: List[PipelineEventGroup], i: int,
                    allow_async: bool):
        """Walk the chain from ``i``.  With ``allow_async`` the first stage
        that leaves device work in flight returns a continuation, which
        finishes that stage and walks the rest of the chain inline."""
        chain = self.inner_processors + self.processors
        while i < len(chain):
            run = self._fused_by_head.get(i)
            if run is not None and run.enabled():
                tokens = run.dispatch(groups, self._timed)
                nxt = run.end
                if any(t is not None for t in tokens):
                    if allow_async:
                        def finish_run(run=run, tokens=tokens, nxt=nxt):
                            run.complete(groups, tokens, self._timed)
                            self._walk_chain(groups, nxt, allow_async=False)
                        return finish_run
                    run.complete(groups, tokens, self._timed)
                i = nxt
                continue
            p = chain[i]
            if not p.supports_async_dispatch:
                for g in groups:
                    self._timed(p.name, p.process, g)
                i += 1
                continue
            tokens = [self._timed(p.name, p.process_dispatch, g)
                      for g in groups]
            if allow_async and any(t is not None for t in tokens):
                rest = i + 1

                def finish(p=p, tokens=tokens, rest=rest):
                    self._complete(p, groups, tokens)
                    self._walk_chain(groups, rest, allow_async=False)
                return finish
            # nothing stayed in flight (or no overlap asked): finish inline
            self._complete(p, groups, tokens)
            i += 1
        return None

    def _complete(self, p: Processor, groups, tokens) -> None:
        for g, t in zip(groups, tokens):
            self._timed(p.name, p.process_complete, g, t)

    def _exit_process(self) -> None:
        with self._in_process_zero:
            self._in_process_cnt -= 1
            if self._in_process_cnt == 0:
                self._in_process_zero.notify_all()

    def in_process_count(self) -> int:
        with self._in_process_zero:
            return self._in_process_cnt

    def wait_all_items_in_process_finished(self, timeout: float = 10.0
                                           ) -> bool:
        with self._in_process_zero:
            return self._in_process_zero.wait_for(
                lambda: self._in_process_cnt == 0, timeout)

    def drain_from(self, chain_idx: int,
                   groups: List[PipelineEventGroup]) -> None:
        """Run released groups through the processors AFTER ``chain_idx``,
        then send them."""
        if not groups:
            return
        chain = self.inner_processors + self.processors
        for g in groups:
            for p in chain[chain_idx + 1:]:
                self._timed(p.name, p.process, g)
        self.send(groups)

    def drain_held(self) -> int:
        """Stop-time drain: every record a processor still holds ships
        through the rest of the chain.  Returns the groups sent."""
        n = 0
        chain = self.inner_processors + self.processors
        for idx, p in enumerate(chain):
            drain = getattr(p, "drain_groups", None)
            if drain is not None:
                groups = drain()
                self.drain_from(idx, groups)
                n += len(groups)
        return n

    def send(self, groups: List[PipelineEventGroup]) -> bool:
        for g in groups:
            for f in self.flushers:
                self._timed(f.name, f.send, g)
        with self._stats_lock:
            self.events_sent += sum(len(g) for g in groups)
        return True
