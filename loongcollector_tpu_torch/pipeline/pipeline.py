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
``wait_all_items_in_process_finished``).  Host seconds per stage
(``stage_seconds``) are summed across the runner's workers.

The aggregator stage (JAX package ``pipeline/pipeline.py:166-178``,
``:431-465``): at most one aggregator a pipeline (``aggregators`` in the
config), between the processors and the flushers.  ``send`` hands every
group to its ``add`` and sends what it returns (closed windows) in place
of the groups it took; its timeout hook is registered with the
``TimeoutFlushManager``, which the processor runner pumps once a second
(idle windows close), and the stop-time drain (``drain_held``) sends
what its ``flush`` force-closes.

The acked-offset hooks (``runner/ack_watermark.py``; JAX package
``pipeline/pipeline.py:436-450``, ``:505-515``): the groups the aggregator
absorbs and the groups filtered to nothing are terminal for their source
spans and are acked at once (forced); with more than one flusher a span
owes an ack from each (``note_fanout``, before the first send), and each
flusher acks what it delivered: ``flusher_file`` and ``flusher_stdout``
once written, the HTTP family once the sink took it or it was spilled
(the flusher runner).

The SLO plane's hooks (``monitor/slo.py``; JAX package
``pipeline/pipeline.py:443-516``, ``plugin/instance.py:218-227``) sit
beside them: the groups the aggregator absorbs and the groups filtered to
nothing retire their ingest stamps without a sojourn sample, a rollup
group gets its stamp at window close (``ensure_stamp`` in
``_send_direct``), more than one flusher raises the stamp's refcount
(``note_fanout``), and a ``ledger_terminal`` flusher's send observes its
send_ok (or, refused, drop) terminal.  Each plugin's host seconds are
also observed into its ``stage_seconds`` histogram (a record of category
``plugin`` a stage and pipeline; JAX package ``plugin/instance.py:41``),
the SLO budget breakdown's ``stage`` hop.

With the ledger on (``monitor/ledger.py``, ``LOONG_LEDGER=1``) the
pipeline books process_in at ``process_begin``, each stage's population
change (process_expand / process_drop, by plugin), process_out at
``send``, and send_ok for each flusher whose ``send`` is delivery
(``Flusher.ledger_terminal``: ``flusher_file``, ``flusher_stdout``); the
HTTP family (``flusher_http``, ``flusher_prometheus``) batches into its
sender queue, and the flusher runner books send_ok, send_fail, spill,
replay, quarantine and the tagged drops at delivery (JAX package
``runner/flusher_runner.py``).  Each flusher gets its ``plugin_id``
(``<type>/<index>``), a queue key and, given a sender-queue manager, its
sender queue before its init, as in the JAX package
(``pipeline.py:183-194``).  A self-accounting aggregator (the rollup)
books its own agg_in / agg_fold / agg_emit.

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
package ``pipeline.py:294-330``).  In tail mode each such processor's
``flush_timeout_groups`` also rides the ``TimeoutFlushManager`` (JAX
package ``pipeline.py:53-67``, ``:203-212``), so an idle source ships its
open record once the processor's timeout passed; a ``--once`` run drains
it at stop.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..models import PipelineEventGroup
from ..monitor import ledger, slo
from ..monitor.metrics import MetricsRecord
from ..runner import ack_watermark
from ..utils.logger import get_logger
from .plugin.interface import Flusher, Input, PluginContext, Processor
from .plugin.registry import PluginRegistry

log = get_logger("pipeline")

_queue_keys = itertools.count(1)


def next_queue_key() -> int:
    return next(_queue_keys)


class PipelineInitError(RuntimeError):
    """A plugin of the config is unknown or refused its config."""


class _AggTimeoutHook:
    """Adapter letting the aggregator ride TimeoutFlushManager's cadence
    (processor thread 0 drives it, ProcessorRunner.cpp:109-112)."""

    def __init__(self, pipeline: "CollectionPipeline"):
        self._pipeline = pipeline

    def flush_timeout(self) -> None:
        agg = self._pipeline.aggregator
        if agg is None:
            return
        hook = getattr(agg, "flush_timeout", None)
        if hook is not None:
            self._pipeline._send_direct(hook())


class _ProcDrainHook:
    """Timeout drain for a processor holding cross-group state
    (split_multiline's carried open records): what it releases runs
    through the rest of the chain and the send path."""

    def __init__(self, pipeline: "CollectionPipeline", chain_idx: int,
                 processor: Processor):
        self._pipeline = pipeline
        self._chain_idx = chain_idx
        self._processor = processor

    def flush_timeout(self) -> None:
        self._pipeline.drain_from(self._chain_idx,
                                  self._processor.flush_timeout_groups())


class CollectionPipeline:
    def __init__(self, name: str, config: Dict[str, Any],
                 device: torch.device, process_queue_manager=None,
                 tail: bool = False, sender_queue_manager=None):
        self.name = name
        self.config = config
        self.process_queue_key = next_queue_key()
        self.context = PluginContext(
            pipeline_name=name, config=config, device=device,
            process_queue_manager=process_queue_manager,
            process_queue_key=self.process_queue_key, tail=tail)
        self.inputs: List[Input] = []
        self.inner_processors: List[Processor] = []
        self.processors: List[Processor] = []
        self.flushers: List[Flusher] = []
        self.aggregator = None
        self._agg_timeout_hook = _AggTimeoutHook(self)
        self.stage_seconds: Dict[str, float] = {}
        # per-stage host-seconds histograms, one record a stage name
        self._stage_records: Dict[str, MetricsRecord] = {}
        self._stage_hists: Dict[str, Any] = {}
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
        # aggregator stage (reference pkg/pipeline/aggregator.go:24-51 —
        # at most one per pipeline, between processors and flushers)
        agg_cfgs = config.get("aggregators", [])
        if agg_cfgs:
            self.aggregator = self._make(registry.create_aggregator,
                                         agg_cfgs[0])
        for i, fcfg in enumerate(config.get("flushers", [])):
            self.flushers.append(self._make(
                registry.create_flusher, fcfg,
                lambda f, i=i, typ=fcfg.get("Type", ""): self._wire_flusher(
                    f, f"{typ}/{i}", sender_queue_manager)))
        # fused runs over the final chain: description only, the programs
        # are built at their first dispatch; LOONG_FUSED gates running them
        from .fused_chain import plan_fusion
        self.fused_runs = plan_fusion(self.inner_processors + self.processors,
                                      device)
        self._fused_by_head = {r.head: r for r in self.fused_runs}
        # last, once nothing can refuse its config: release() undoes them
        from .batch.timeout_flush_manager import TimeoutFlushManager
        if self.aggregator is not None:
            TimeoutFlushManager.instance().register(self._agg_timeout_hook)
        self._drain_hooks = [
            _ProcDrainHook(self, idx, p) for idx, p in
            enumerate(self.inner_processors + self.processors)
            if tail and hasattr(p, "flush_timeout_groups")]
        for hook in self._drain_hooks:
            TimeoutFlushManager.instance().register(hook)

    def _make(self, create, cfg: Dict[str, Any], before_init=None):
        typ = cfg.get("Type", "")
        plugin = create(typ)
        if plugin is None:
            raise PipelineInitError(f"pipeline {self.name}: unknown plugin "
                                    f"type {typ!r}")
        if before_init is not None:
            before_init(plugin)
        if not plugin.init(cfg, self.context):
            raise PipelineInitError(f"pipeline {self.name}: {typ} refused "
                                    f"its config")
        return plugin

    def _wire_flusher(self, flusher: Flusher, plugin_id: str,
                      sender_queue_manager) -> None:
        flusher.plugin_id = plugin_id
        flusher.queue_key = next_queue_key()
        if sender_queue_manager is not None:
            flusher.sender_queue = sender_queue_manager.create_or_reuse_queue(
                flusher.queue_key, pipeline_name=self.name)

    def stop_flushers(self) -> None:
        """Stop every flusher: a batching flusher flushes what its
        batcher holds into its sender queue."""
        for f in self.flushers:
            f.stop()

    def release(self) -> None:
        """Free the pipeline's global registrations (the aggregator's
        timeout hook and metrics record).  Called by the manager at stop."""
        from .batch.timeout_flush_manager import TimeoutFlushManager
        TimeoutFlushManager.instance().unregister(self._agg_timeout_hook)
        for hook in self._drain_hooks:
            TimeoutFlushManager.instance().unregister(hook)
        if self.aggregator is not None:
            self.aggregator.metrics.mark_deleted()
        with self._stats_lock:
            records = list(self._stage_records.values())
            self._stage_records.clear()
            self._stage_hists.clear()
        for rec in records:
            rec.mark_deleted()

    def add_stage_seconds(self, name: str, seconds: float) -> None:
        with self._stats_lock:
            self.stage_seconds[name] = (self.stage_seconds.get(name, 0.0)
                                        + seconds)

    def _stage_hist(self, name: str):
        """The ``stage_seconds`` histogram of stage ``name``."""
        h = self._stage_hists.get(name)
        if h is None:
            with self._stats_lock:
                h = self._stage_hists.get(name)
                if h is None:
                    rec = MetricsRecord(
                        category="plugin",
                        labels={"plugin_type": name, "pipeline": self.name})
                    self._stage_records[name] = rec
                    h = self._stage_hists[name] = rec.histogram(
                        "stage_seconds")
        return h

    def _timed(self, name: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            dt = time.perf_counter() - t0
            self.add_stage_seconds(name, dt)
            self._stage_hist(name).observe(dt)

    def _stage(self, p, fn, group: PipelineEventGroup, *args):
        """``fn(group, *args)`` timed under the plugin's name; with the
        ledger on, the group's population change is booked to it."""
        if not ledger.is_on():
            return self._timed(p.name, fn, group, *args)
        n_in = len(group)
        try:
            return self._timed(p.name, fn, group, *args)
        finally:
            ledger.record_delta(self.name, n_in, len(group), p.name)

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
        if ledger.is_on():
            ledger.record(self.name, ledger.B_PROCESS_IN,
                          sum(len(g) for g in groups),
                          sum(g.data_size() for g in groups))
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
                tokens = run.dispatch(groups, self._timed, self._stage)
                nxt = run.end
                if any(t is not None for t in tokens):
                    if allow_async:
                        def finish_run(run=run, tokens=tokens, nxt=nxt):
                            run.complete(groups, tokens, self._timed,
                                         self._stage)
                            self._walk_chain(groups, nxt, allow_async=False)
                        return finish_run
                    run.complete(groups, tokens, self._timed, self._stage)
                i = nxt
                continue
            p = chain[i]
            if not p.supports_async_dispatch:
                for g in groups:
                    self._stage(p, p.process, g)
                i += 1
                continue
            tokens = [self._stage(p, p.process_dispatch, g) for g in groups]
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
            self._stage(p, p.process_complete, g, t)

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
        if ledger.is_on():
            # held events re-enter the chain: the matching credit for the
            # process_drop their holding stage booked when it kept them
            ledger.record(self.name, ledger.B_PROCESS_EXPAND,
                          sum(len(g) for g in groups), tag="drain")
        chain = self.inner_processors + self.processors
        for g in groups:
            for p in chain[chain_idx + 1:]:
                self._stage(p, p.process, g)
        self.send(groups)

    def drain_held(self) -> int:
        """Stop-time drain: every record a processor still holds ships
        through the rest of the chain, then every window the aggregator
        holds is force-closed and sent (the reference's ``flush_batch``).
        Returns the groups sent."""
        n = 0
        chain = self.inner_processors + self.processors
        for idx, p in enumerate(chain):
            drain = getattr(p, "drain_groups", None)
            if drain is not None:
                groups = drain()
                self.drain_from(idx, groups)
                n += len(groups)
        if self.aggregator is not None:
            groups = self._timed(self.aggregator.name, self.aggregator.flush)
            n += self._send_direct(groups)
        return n

    def send(self, groups: List[PipelineEventGroup]) -> bool:
        """Processed groups to the aggregator, if any, and what leaves it
        to the flushers."""
        led = ledger.is_on()
        if led:
            ledger.record(self.name, ledger.B_PROCESS_OUT,
                          sum(len(g) for g in groups))
        if self.aggregator is not None:
            agg = self.aggregator
            n_in = sum(len(g) for g in groups)
            staged: List[PipelineEventGroup] = []
            for g in groups:
                staged.extend(self._timed(agg.name, agg.add, g))
            # groups the aggregator absorbed lose their span identity here:
            # acked (forced), so their source bytes never pin the watermark
            staged_ids = {id(g) for g in staged}
            consumed = [g for g in groups if id(g) not in staged_ids]
            ack_watermark.ack_groups(consumed, force=True)
            if consumed and slo.is_on():
                # absorbed into rollup state: the stamp retires without a
                # sojourn sample; the rollup minted at window close gets
                # its own stamp (_send_direct)
                slo.retire_groups(consumed)
            groups = staged
            if led and not getattr(agg, "ledger_self_accounting", False):
                # a stateful aggregator holds events (process_drop, repaid
                # at flush by _send_direct) or mints them (process_expand)
                ledger.record_delta(self.name, n_in,
                                    sum(len(g) for g in groups),
                                    "aggregator")
        self._flush_groups(groups)
        return True

    def _send_direct(self, groups: List[PipelineEventGroup]) -> int:
        """Groups the aggregator released outside ``send`` (timeout and
        drain flushes) to the flushers; returns the groups sent."""
        if ledger.is_on():
            n = sum(len(g) for g in groups)
            if not getattr(self.aggregator, "ledger_self_accounting", False):
                # the credit matching the "aggregator"-tagged process_drop
                # (a self-accounting aggregator booked agg_emit instead)
                ledger.record(self.name, ledger.B_PROCESS_EXPAND, n,
                              tag="aggregator_flush")
            ledger.record(self.name, ledger.B_PROCESS_OUT, n)
        empty = [g for g in groups if g.empty()]
        ack_watermark.ack_groups(empty, force=True)
        groups = [g for g in groups if not g.empty()]
        if slo.is_on():
            slo.retire_groups(empty)
            for g in groups:
                # rollups are minted stampless: window close IS their
                # ingest instant
                slo.ensure_stamp(self.name, g)
        self._flush_groups(groups)
        return len(groups)

    def _flush_groups(self, groups: List[PipelineEventGroup]) -> None:
        """Every group to every flusher (the port has no router), with
        the extra copies of more than one flusher booked as fanout.  A
        ``ledger_terminal`` flusher writes inline, so its send is terminal
        and booked send_ok here; the HTTP family's sends are booked by the
        flusher runner at delivery."""
        led = ledger.is_on()
        slo_on = slo.is_on()
        for g in groups:
            empty = g.empty()
            if empty:
                # filtered to nothing: terminal for its source span
                ack_watermark.ack_groups([g], force=True)
                if slo_on:
                    slo.retire_groups([g])
            elif len(self.flushers) > 1:
                # each flusher owes an ack: raised before any copy can ack
                ack_watermark.note_fanout(g, len(self.flushers))
                if slo_on:
                    # the stamp's refcount mirrors the fanout: each copy's
                    # terminal observes its own sojourn
                    slo.note_fanout(g, len(self.flushers))
            if led and len(self.flushers) > 1:
                ledger.record(self.name, ledger.B_FANOUT,
                              (len(self.flushers) - 1) * len(g))
            for f in self.flushers:
                ok = self._timed(f.name, f.send, g)
                if slo_on and f.ledger_terminal and not empty:
                    slo.observe_groups(self.name, [g],
                                       slo.OUTCOME_SEND_OK if ok
                                       else slo.OUTCOME_DROP)
                if led and f.ledger_terminal:
                    ledger.record(self.name, ledger.B_SEND_OK, len(g),
                                  g.data_size(), tag=f.name)
        with self._stats_lock:
            self.events_sent += sum(len(g) for g in groups)
