"""Agent entry point: ``python -m loongcollector_tpu_torch --config DIR``.

Reference: core/application/Application.cpp.  The port takes ``--config``,
``--data-dir``, ``--once`` and ``--cpu`` as the JAX CLI does: every pipeline
config in the directory (one pipeline per ``.yaml``/``.yml``/``.json``
file, named by its stem, read once at start) runs until SIGTERM or SIGINT
(tail mode), or once over the existing content of its inputs (``--once``).

Tail mode keeps its state in ``--data-dir`` (default
``~/.loongcollector_tpu_torch``, never the JAX package's directory): the
file checkpoints (``checkpoints.json``, the JAX package's format), the ack
journal and the crash marker.  It follows the JAX package's init and exit
orders (``application.py:125-220``, ``:355-410``): the recovery manager
begins (marker, journal window, torn-file sweep) before any reader opens;
the file server (``input/file/file_server.py``) follows the inputs' files
and pushes what it reads; at the signal the inputs stop (the file server
drains its readers to their last line and dumps), the processor runner
drains the queues and the held records ship, then the checkpoints are
dumped once more — after the drain, so they hold every ack it made — and
the marker is removed (``recovery.mark_clean_exit``).

The send path (JAX package ``application.py:63-86``, ``:305-306``,
``:327``, ``:366-371``): a sender-queue manager, the HTTP sink, a disk
buffer on ``<data dir>/buffer`` encrypted with ``<data dir>/spill_key``
(``utils/payload_crypto.py``) and the flusher runner are built before the
pipelines; the HTTP sink, then the flusher runner, then the processor
runner start.  Tail mode replays the disk buffer once a second.  At the
end of a run the processor runner drains, every flusher's batcher
flushes, and the send path drains within ``exit_flush_timeout`` seconds
(the JAX package's flag, 20 s, ``LOONG_EXIT_FLUSH_TIMEOUT``): a ``--once``
run replays the buffer once a second until the sender queues are empty
and no buffered payload of a live flusher is left; then the pipelines
stop, the flusher runner stops (``drain=True`` with what is left of the
budget; what it could not send it spills, ``enable_full_drain_mode``),
the HTTP sink stops and the sender queues are retired.  ``--once``
without ``--data-dir`` spills into a temporary data dir, removed at exit
when its buffer is empty; a payload dropped by the send path (a
permanent rejection, a spill the buffer refused) or left in such a
temporary buffer ends the run with exit code 1 (the buffer is kept).

``--once`` runs the streaming main path: the pipeline manager builds the
pipelines and their bounded process queues, the processor runner's workers
(``LOONG_PROCESS_THREADS``) pop them and dispatch through the device plane
(``LOONG_STREAM_DEPTH``, ``LOONG_DEVICE_INFLIGHT_BYTES``), and the inputs
push what they read, waiting at the queues' high watermark.  Once every
group the inputs pushed has settled, every process queue is empty and
every pipeline's in-process count is 0, the inputs stop before the final
drain, as in the reference's ``Application.exit``: the singleton input
runners first (``runner/input_registry.InputRunnerRegistry.stop_all``:
the eBPF server flushes the events it holds into the queues), then each
pipeline's inputs.  The runner processes what that pushed; then the
records the processors still hold (split_multiline's open record of each
file) ship through the rest of their chain on the calling thread
(``drain_held``), and the run ends once they are sent.  A processing
failure (a kernel failure included) ends the run with exit code 1.
``run_configs`` is the same run over (name, config) pairs, with an
optional ``feed`` called once the inputs have started (a library caller
driving an eBPF driver, say).

The pipelines run on the CUDA device unless ``--cpu`` is given; with no
CUDA device and no ``--cpu`` the CLI exits with an error.  ``--stats PATH``
writes the run's counts as JSON: events, kernel launches and their
geometry, device batches, rows routed to Python ``re``, the plane's
dispatches, peak in-flight bytes and budget waits, ring leases and
returns, the tuner's choices, threads and depth, the dispatch timeline's
legs and overlapped dispatches, and kernel seconds (the sum of the
timeline's exec legs on the card, every kernel's); and for the DFA
kernels, ``k2`` (the engines' ``match_batch`` on the DFA tier) and ``k4``
(the fused sets): launches, device batches, host-routed rows, launch
shapes, and the kernel's exec legs on the timeline (count, and on the
card their sum, median and largest); and ``fusion`` (resident stage
fusion): runs planned, groups fused and sent per-stage (``long_row_groups``:
a row over 4096 bytes), fused dispatches, K7 launches and launch shapes, K3
launches, the program rows, and K7's exec legs on the timeline (program
``fused``); ``aggregation`` (the metric rollup): folds by the substrate
that ran them and their host seconds, K6 launches and launch shapes, K6's
h2d, exec and d2h legs on the timeline (program ``segment_reduce``: count,
and on the card sum, median and largest), and the rollup's folded,
invalid, late, emitted and evicted rows; ``parse``: the structural-index
parsers' rows, fallback rows and drift rows; and ``ledger``: with
``LOONG_LEDGER=1``, each pipeline's event-conservation residual after the
run and the ledger's totals by boundary; and ``mesh`` (several devices,
the counterpart of the reference's ``/debug/status`` ``mesh``): each live
sharded kernel's status (chips and devices, dispatches, K8 launches, pad
fallbacks, the folded totals, per-chip row occupancy and padding share),
K8's launch shapes, the sharded dispatches' h2d legs per shard, and the
chip-lane router's status (lanes, each one's dispatches, rows and bytes in
flight); null when no sharded kernel was built and no lane is active.
``launch_shapes`` at the top holds K1's launches only.  ``engines``: each
cached regex engine's pattern, tier and counts (K1 launches and device
batches, K2 launches and batches, rows on ``re`` by route); ``classify``:
the rows ``processor_classify_url`` classified on ``re`` (object groups);
``ebpf``: each eBPF input's groups pushed and refused, and the driver's
delivered callbacks and callback errors; ``tail`` (tail mode, else null):
the data dir, the file server's readers, suppressed groups and alarm
counts, the groups its inputs pushed, their read seconds and rotations,
the recovery manager's status (unclean start, ``replay_duplicate_events``,
the watermark tracker) and the checkpoints as dumped at exit; ``send``:
the flusher runner's requests, request bytes, answers by status (0: the
host could not be reached), backoff retries, items sent, spilled and
dropped, each breaker's state and transitions, the median sender-queue
wait and HTTP round trip, the disk buffer's spilled, replayed and
quarantined items and the payloads left in it, whether the sender queues
were empty at exit, and the alarms the run raised, by type (the alarm
plane's totals); ``slo`` (with ``LOONG_SLO=1``, else null): the plane's
``/debug/slo`` document after the drain, each (pipeline, outcome)
``event_to_flush_ms`` histogram and the hop histograms' totals (seconds
and count), both over the whole run (the instruments are cumulative:
the self-monitor resets none of them); ``ledger`` also holds the auditor's
counts (``LOONG_LEDGER_AUDIT=1``).

The self-observability planes (JAX package ``application.py:106-127``,
``:372-377``): ``LOONG_LEDGER`` / ``LOONG_LEDGER_AUDIT`` turn on the
ledger and its auditor, ``LOONG_SLO`` the SLO plane and its evaluator, and
``LOONG_EXPO_PORT`` the ``/metrics`` and ``/debug`` endpoint
(``monitor/exposition.py``), all before the pipelines are built.  The
``input_internal_metrics`` / ``input_internal_alarms`` pipelines are fed
by the self-monitor server, a singleton runner stopped first.  At exit the
endpoint stops, then the SLO evaluator and the auditor (the planes stay
as they are, so a caller in the same process can still read them).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import statistics
import sys
import tempfile
import time
from dataclasses import asdict
from typing import Any, Callable, Dict, List, Optional, Tuple

from .utils import flags
from .utils.device import NoCudaDevice, resolve_device
from .utils.logger import get_logger

log = get_logger("application")

flags.DEFINE_FLAG_DOUBLE("exit_flush_timeout", "flush-out budget on exit (s)",
                         20.0)

DEFAULT_DATA_DIR = os.path.join(os.path.expanduser("~"),
                                ".loongcollector_tpu_torch")


def load_config_dir(config_dir: str) -> List[Tuple[str, Dict[str, Any]]]:
    """(name, config) of every pipeline file in the directory, by name."""
    out = []
    for fn in sorted(os.listdir(config_dir)):
        stem, ext = os.path.splitext(fn)
        path = os.path.join(config_dir, fn)
        if ext in (".yaml", ".yml"):
            import yaml
            with open(path) as f:
                cfg = yaml.safe_load(f)
        elif ext == ".json":
            with open(path) as f:
                cfg = json.load(f)
        else:
            continue
        out.append((stem, cfg))
    return out


class ProcessingFailed(RuntimeError):
    """A group failed in processing or send; the run exits non-zero."""


def _drained(pqm, manager, runner) -> bool:
    pushed = sum(inp.groups_pushed for p in manager.pipelines()
                 for inp in p.inputs)
    return (runner.groups_settled() == pushed and pqm.all_empty()
            and all(p.in_process_count() == 0 for p in manager.pipelines()))


def _wait_drained(pqm, manager, runner) -> None:
    while not runner.failed() and not _drained(pqm, manager, runner):
        time.sleep(0.002)


def _stop_inputs(manager) -> None:
    """Inputs stop before the final drain (reference ``Application.exit``):
    the singleton runners first, in their stop order, then each
    pipeline's inputs."""
    from .runner.input_registry import InputRunnerRegistry
    InputRunnerRegistry.stop_all()
    manager.stop_inputs()


class _SignalStop:
    """Tail mode's stop for the CLI: SIGTERM and SIGINT set a flag (the
    handler takes no lock); the run polls it."""

    def __init__(self) -> None:
        self.signum: Optional[int] = None

    def handle(self, signum, frame) -> None:  # noqa: ARG002
        self.signum = signum

    def is_set(self) -> bool:
        return self.signum is not None

    def wait(self, seconds: float) -> None:
        if self.signum is None:
            time.sleep(seconds)


def run_tail(config_dir: str, device, data_dir: str) -> Dict[str, Any]:
    """Tail mode: run every pipeline of the directory until SIGTERM or
    SIGINT; returns the run's counts."""
    configs = load_config_dir(config_dir)
    if not configs:
        raise FileNotFoundError(f"no pipeline config in {config_dir}")
    stop = _SignalStop()
    signal.signal(signal.SIGTERM, stop.handle)
    signal.signal(signal.SIGINT, stop.handle)
    stats = run_configs(configs, device, data_dir=data_dir, stop=stop)
    log.info("signal %s received; exit complete", stop.signum)
    return stats


def run_once(config_dir: str, device,
             data_dir: Optional[str] = None) -> Dict[str, Any]:
    """Run every pipeline of the directory once through the processor
    runner; returns the run's counts.  ``data_dir`` holds the send path's
    disk buffer (a temporary one when None)."""
    configs = load_config_dir(config_dir)
    if not configs:
        raise FileNotFoundError(f"no pipeline config in {config_dir}")
    return run_configs(configs, device, data_dir=data_dir)


class _SendPath:
    """The send path of one run: sender queues, HTTP sink, disk buffer
    and flusher runner (JAX package ``application.py:63-86``)."""

    def __init__(self, data_dir: str):
        from .pipeline.queue.sender_queue import SenderQueueManager
        from .runner.disk_buffer import DiskBufferWriter
        from .runner.flusher_runner import FlusherRunner
        from .runner.http_sink import HttpSink
        from .utils.payload_crypto import PayloadCipher
        self.sqm = SenderQueueManager()
        self.http_sink = HttpSink()
        self.disk_buffer = DiskBufferWriter(
            os.path.join(data_dir, "buffer"),
            cipher=PayloadCipher(os.path.join(data_dir, "spill_key")))
        self.runner = FlusherRunner(self.sqm, self.http_sink,
                                    disk_buffer=self.disk_buffer)
        self.queues_empty_at_exit: Optional[bool] = None
        self.queued_at_exit = 0

    def start(self) -> None:
        self.http_sink.init()
        self.runner.init()

    def replay(self, resolve) -> None:
        self.disk_buffer.replay(resolve)

    def drain(self, resolve, deadline: float) -> bool:
        """Replay the buffer once a second until the sender queues are
        empty and no buffered payload of a live flusher is left, or until
        ``deadline``; True when drained."""
        next_replay = 0.0
        while True:
            now = time.monotonic()
            if now >= next_replay:
                next_replay = now + 1.0
                self.replay(resolve)
            if self._settled(resolve):
                return True
            if now >= deadline:
                return False
            time.sleep(0.05)

    def _settled(self, resolve) -> bool:
        """No payload in a sender queue or the buffer.  A payload moves
        between the two while this looks (the runner spills and replays
        on its own thread), and each move counts a spill or a replay: the
        answer holds only when neither count moved meanwhile."""
        db = self.disk_buffer
        moves = (db.spilled, db.replayed)
        return (self.sqm.all_empty()
                and db.pending_for(resolve) == 0
                and self.sqm.all_empty()
                and (db.spilled, db.replayed) == moves)

    def stop(self, manager, deadline: float) -> None:
        """Stop the flusher runner (drain within what is left of the
        budget, then the exit spill), the HTTP sink, and retire the
        sender queues."""
        try:
            self.runner.stop(drain=True,
                             timeout=max(0.0, deadline - time.monotonic()))
        finally:
            self.http_sink.stop()
            self.queues_empty_at_exit = self.sqm.all_empty()
            self.queued_at_exit = sum(q.size() for q in
                                      list(self.sqm._queues.values()))
            manager.delete_sender_queues()

    def undelivered(self) -> int:
        """Payloads the send path dropped or left queued at exit."""
        return (sum(self.runner.dropped.values())
                + self.queued_at_exit)

    def stats(self) -> Dict[str, Any]:
        from .monitor.alarms import AlarmManager
        db = self.disk_buffer
        return dict(self.runner.send_stats(),
                    buffer_dir=db.directory,
                    spilled=db.spilled,
                    replayed=db.replayed,
                    quarantined=db.quarantined_files,
                    buffer_pending=len(db.pending()),
                    sender_queues_empty=self.queues_empty_at_exit,
                    queued_at_exit=self.queued_at_exit,
                    alarms=AlarmManager.instance().totals())


def run_configs(configs: List[Tuple[str, Dict[str, Any]]], device,
                feed: Optional[Callable[[], None]] = None,
                data_dir: Optional[str] = None,
                stop=None) -> Dict[str, Any]:
    """Run the (name, config) pipelines through the processor runner,
    calling ``feed()`` on this thread once their inputs have started;
    returns the run's counts.  Without ``stop`` the run is ``--once``:
    it ends once what the inputs read has drained.  With ``stop`` (an
    object with ``is_set()`` and ``wait(seconds)``, such as a
    ``threading.Event``) the run is tail mode, keeps its state in
    ``data_dir`` (required) and ends once ``stop`` is set."""
    from .ops import compile_watch, xprof
    from .ops import fused_pipeline
    from .ops.device_plane import DevicePlane, device_memory_status
    from .ops.device_stream import auto_tuner, batch_ring, stream_depth
    from .monitor import exposition, ledger, slo
    from .monitor.alarms import AlarmManager
    from .ops.kernels import dfa_scan_cuda, fused_program_cuda
    from .ops.kernels import field_extract_cuda as fxc
    from .ops.kernels import segment_reduce, segment_reduce_cuda
    from .ops.kernels import struct_index, struct_index_cuda
    from .processor import parse_telemetry
    from .processor.classify_url import ProcessorClassifyUrl
    from .ops.regex.engine import cached_engines
    from .ops.regex.fuse import live_sets
    from .pipeline.pipeline_manager import CollectionPipelineManager
    from .pipeline.queue.process_queue_manager import ProcessQueueManager
    from .runner.input_registry import (InputRunnerRegistry,
                                        register_builtin_runners)
    from .runner.processor_runner import ProcessorRunner
    from . import recovery
    from .input.file.checkpoint import CheckPointManager
    from .input.file.file_server import FileServer
    from .runner import ack_watermark
    from .pipeline.batch.timeout_flush_manager import TimeoutFlushManager
    tail = stop is not None
    fs = FileServer.instance()
    temp_data_dir = None
    if not data_dir:
        if tail:
            raise ValueError("tail mode needs a data dir")
        # the send path's buffer of a --once run without a data dir
        temp_data_dir = data_dir = tempfile.mkdtemp(prefix="lct-once-")
    os.makedirs(data_dir, exist_ok=True)
    # this run's alarms only (--stats send.alarms reads the totals)
    AlarmManager.instance().reset()
    send = _SendPath(data_dir)
    if tail:
        # this run's books only, and the journal window loaded before any
        # reader opens
        ack_watermark.tracker().reset()
        recovery.begin(data_dir, os.path.join(data_dir, "buffer"))
        fs.checkpoints = CheckPointManager(
            os.path.join(data_dir, "checkpoints.json"))
    if ledger.install_from_env():
        # this run's totals only: the residual is read after it drains
        ledger.reset()
        log.info("loongledger ACTIVE (audit=%s)",
                 ledger.auditor() is not None)
    if slo.install_from_env():
        # this run's stamps and episodes only
        slo.reset()
        log.info("loongslo ACTIVE (evaluator=%s)",
                 slo.evaluator() is not None)
    expo = exposition.start_from_env()
    pqm = ProcessQueueManager()
    manager = CollectionPipelineManager(pqm, device, tail=tail,
                                        sender_queue_manager=send.sqm)
    manager.update_pipelines(configs)
    resolve = manager.resolve_buffered_flusher
    register_builtin_runners()
    InputRunnerRegistry.wire_all(pqm)
    engines = cached_engines()
    sets = live_sets()
    fxc.reset_launch_shapes()
    dfa_scan_cuda.reset_launch_shapes()
    fused_program_cuda.reset_launch_shapes()
    segment_reduce_cuda.reset_launch_shapes()
    segment_reduce.device_kernel().reset_counts()
    struct_index_cuda.reset_launch_shapes()
    for kern in struct_index.device_kernels():
        kern.reset_counts()
    parse_telemetry.reset()
    runs = [r for p in manager.pipelines() for r in p.fused_runs]
    for counted in engines + sets + runs:
        counted.reset_counts()
    fused_pipeline.reset_counts()
    plane = DevicePlane.instance()
    plane.reset_counters()
    ring = batch_ring()
    ring_before = ring.totals()
    timeline = xprof.enable(device)
    runner = ProcessorRunner(pqm, manager, device=device)
    t0 = time.perf_counter()
    send.start()
    runner.init()
    drained_groups = 0
    drain_error: Optional[BaseException] = None
    inputs_stopped = False
    try:
        manager.start_inputs(should_abort=runner.failed)
        if feed is not None:
            feed()
        if tail:
            next_replay = time.monotonic() + 1.0
            while not stop.is_set() and not runner.failed():
                stop.wait(0.2)
                if time.monotonic() >= next_replay:
                    next_replay = time.monotonic() + 1.0
                    send.replay(resolve)
        else:
            _wait_drained(pqm, manager, runner)
        _stop_inputs(manager)
        inputs_stopped = True
        _wait_drained(pqm, manager, runner)
        if not runner.failed():
            try:
                drained_groups = manager.drain_held()
            except Exception as e:  # noqa: BLE001 — the run exits 1
                log.error("stop-time drain failed", exc_info=e)
                drain_error = e
    finally:
        if not inputs_stopped:
            _stop_inputs(manager)
        runner.stop()
        drained = _drained(pqm, manager, runner)
        manager_pipelines = manager.pipelines()
        # the send path's exit (JAX package application.py:366-371): the
        # batchers flush, the queues and the buffer drain within the
        # budget, the pipelines stop, the flusher runner stops
        exit_deadline = (time.monotonic()
                         + flags.get_flag("exit_flush_timeout"))
        try:
            for p in manager_pipelines:
                for f in p.flushers:
                    f.flush_all()
            if not tail and runner.error is None and drain_error is None:
                send.drain(resolve, exit_deadline)
        finally:
            # read while the pipelines' stage records are live
            slo_stats = _slo_stats()
            manager.stop_all()
            TimeoutFlushManager.instance().flush_timeout_batches()
            send.stop(manager, exit_deadline)
        seconds = time.perf_counter() - t0
        ledger_stats = _ledger_stats()
        # the JAX package's exit: the endpoint, then the SLO evaluator
        # (and, in the port, the auditor, so no plane thread outlives the
        # run)
        if expo is not None:
            expo.stop()
        slo.stop_evaluator()
        ledger.stop_auditor()
        xprof.disable()
        tail_stats = None
        if tail:
            tail_stats = _tail_stats(fs, manager_pipelines, data_dir)
    if runner.error is not None:
        raise ProcessingFailed(
            f"{runner.groups_failed} group(s) failed: {runner.error!r}"
        ) from runner.error
    if drain_error is not None:
        raise ProcessingFailed(f"stop-time drain failed: {drain_error!r}"
                               ) from drain_error
    if not drained or runner.alive_threads():
        raise ProcessingFailed("the processor runner did not drain")
    if send.undelivered():
        raise ProcessingFailed(
            f"{send.undelivered()} payload(s) undelivered: dropped "
            f"{send.runner.dropped}, {send.queued_at_exit} left queued")
    if temp_data_dir is not None:
        if send.disk_buffer.pending():
            raise ProcessingFailed(
                f"{len(send.disk_buffer.pending())} payload(s) spilled and "
                f"not delivered; kept in {temp_data_dir}")
        shutil.rmtree(temp_data_dir, ignore_errors=True)
    ring_after = ring.totals()
    on_card = device.type == "cuda"
    legs = timeline.leg_summary()
    kernel_s = timeline.leg_seconds("exec", xprof.DEVICE) if on_card \
        else None
    busy_s = timeline.exec_union_seconds(xprof.DEVICE) if on_card else None
    stages: Dict[str, float] = {}
    for p in manager_pipelines:
        for k, v in p.stage_seconds.items():
            stages[k] = stages.get(k, 0.0) + v
    return {
        "device": str(device),
        "events": sum(p.events_sent for p in manager_pipelines),
        "seconds": seconds,
        "stage_seconds": stages,
        "launches": sum(e.kernel.launches for e in engines
                        if e.kernel is not None),
        "launch_shapes": [dict(asdict(shape), launches=n)
                          for shape, n in fxc.launch_shapes.items()
                          if shape.entry_point in fxc.ENTRY_POINTS],
        "device_batches": sum(e.device_batches for e in engines),
        "re_oversize_rows": sum(e.re_oversize_rows for e in engines),
        "re_tier_rows": sum(e.re_tier_rows for e in engines),
        "kernel_seconds": kernel_s,
        # traced: the union of the exec legs over the pipeline's seconds
        "busy_share": busy_s / seconds if on_card else None,
        "threads": runner.thread_count,
        "depth": stream_depth(),
        "plane": plane.counters(),
        "ring": {"leases": ring_after["leases"] - ring_before["leases"],
                 "returns": ring_after["returns"] - ring_before["returns"],
                 "leased": ring_after["leased"],
                 "fenced": ring_after["fenced"],
                 "packs": ring_after["packs"] - ring_before["packs"]},
        "device_memory": device_memory_status(),
        "tuner": auto_tuner().chosen(),
        "timeline": {"legs": legs,
                     "overlapped_dispatches":
                         timeline.overlapped_dispatches(),
                     **timeline.stats()},
        "lane_overlap": runner.lane_overlap(),
        "compile": compile_watch.compile_status(),
        "drained_groups": drained_groups,
        "k2": _dfa_stats([e.dfa_kernel for e in engines
                          if e.dfa_kernel is not None],
                         sum(e.dfa_batches for e in engines),
                         sum(e.dfa_re_rows for e in engines), "match",
                         timeline, on_card),
        "k4": _dfa_stats([fs.kernel for fs in sets if fs.kernel is not None],
                         sum(fs.device_batches for fs in sets),
                         sum(fs.host_rows for fs in sets), "tags", timeline,
                         on_card),
        "fusion": _fusion_stats(runs, timeline, on_card),
        "aggregation": _aggregation_stats(
            [p.aggregator for p in manager_pipelines
             if p.aggregator is not None], timeline, on_card),
        "parse": parse_telemetry.status(),
        "k5": _k5_stats(timeline, on_card),
        "ledger": ledger_stats,
        "slo": slo_stats,
        "mesh": _mesh_stats(timeline),
        "engines": [_engine_stats(e) for e in engines],
        "classify": {"re_rows": sum(
            p.re_rows for pl in manager_pipelines for p in pl.processors
            if isinstance(p, ProcessorClassifyUrl))},
        "ebpf": _ebpf_stats(manager_pipelines),
        "tail": tail_stats,
        "send": send.stats(),
    }


def _tail_stats(fs, pipelines, data_dir: str) -> Dict[str, Any]:
    """Tail mode's exit: the checkpoints dumped once more after the drain
    (so they hold every ack it made), the marker removed; returns the file
    server's, the inputs' and the recovery manager's counts and the
    checkpoints as dumped."""
    from . import recovery
    fs.checkpoints.dump()
    status = recovery.status()
    recovery.mark_clean_exit()
    states = [inp._fs_state for p in pipelines for inp in p.inputs
              if getattr(inp, "_fs_state", None) is not None]
    with open(fs.checkpoints.path) as f:
        checkpoints = json.load(f)["check_point"]
    return {
        "data_dir": data_dir,
        "file_server": fs.status(),
        "groups_pushed": sum(st.groups_pushed for st in states),
        "read_seconds": sum(st.read_seconds for st in states),
        "rotations": sum(st.rotations for st in states),
        "recovery": status,
        "checkpoints": checkpoints,
    }


def _engine_stats(e) -> Dict[str, Any]:
    """One regex engine's counts for ``--stats``."""
    return {
        "pattern": e.pattern,
        "tier": e.tier.name,
        "launches": e.kernel.launches if e.kernel is not None else 0,
        "device_batches": e.device_batches,
        "dfa_launches": (e.dfa_kernel.launches
                         if e.dfa_kernel is not None else 0),
        "dfa_batches": e.dfa_batches,
        "re_tier_rows": e.re_tier_rows,
        "re_oversize_rows": e.re_oversize_rows,
        "dfa_re_rows": e.dfa_re_rows,
    }


def _ebpf_stats(pipelines) -> Optional[Dict[str, Any]]:
    """The eBPF inputs' groups pushed and refused, and the driver's
    delivered callbacks; None when no pipeline has an eBPF input."""
    from .input.ebpf.server import EBPFServer, _EBPFInputBase
    inputs = [inp for p in pipelines for inp in p.inputs
              if isinstance(inp, _EBPFInputBase)]
    if not inputs:
        return None
    adapter = EBPFServer.instance().adapter
    return {
        "inputs": {inp.name: {"groups_pushed": inp.groups_pushed,
                              "groups_dropped": inp.groups_dropped}
                   for inp in inputs},
        "adapter": type(adapter).__name__,
        "delivered": getattr(adapter, "delivered", None),
        "callback_errors": getattr(adapter, "callback_errors", None),
    }


def _mesh_stats(timeline: xprof.DeviceTimeline) -> Optional[Dict[str, Any]]:
    """The sharded plane's and the chip lanes' counts for ``--stats``, or
    None when no sharded kernel was built and no lane is active."""
    from .ops import chip_lanes
    from .ops.kernels import field_extract_cuda as fxc
    from .parallel.mesh import mesh_status
    mesh = mesh_status()
    router = chip_lanes.active_router()
    lanes = router.status() if router is not None and router.lane_count() \
        else None
    if mesh is None and lanes is None:
        return None
    kernels = mesh["kernels"] if mesh is not None else []
    return {
        "kernels": kernels,
        "k8_launches": sum(k["launches"] for k in kernels),
        "launch_shapes": [dict(asdict(shape), launches=n) for shape, n
                          in fxc.launch_shapes.items()
                          if shape.entry_point in fxc.STATS_ENTRY_POINTS],
        "shard_legs": timeline.shard_leg_summary(),
        "router": lanes,
    }


def _k5_stats(timeline: xprof.DeviceTimeline, on_card: bool
              ) -> Dict[str, Any]:
    """The structural index's counts for ``--stats``: K5's launches and
    dispatches, the groups it indexed in one dispatch and those it left to
    the numpy twin (by reason), the quote-mode delimiter's per-row FSM
    rows, K5's launch shapes and its dispatch legs on the timeline."""
    from .ops import xprof
    from .ops.kernels import struct_index, struct_index_cuda
    from .processor import parse_telemetry
    kernels = struct_index.device_kernels()
    host: Dict[str, int] = {}
    for k in kernels:
        for reason, n in k.host_groups.items():
            host[reason] = host.get(reason, 0) + n
    legs = {}
    clock = xprof.DEVICE if on_card else None
    for leg in ("h2d", "exec", "d2h"):
        durs = timeline.leg_durations(leg, clock,
                                      struct_index.StructIndexKernel.program)
        legs[leg] = {"count": len(durs),
                     "sum_s": sum(durs) if on_card else None,
                     "median_s": (statistics.median(durs)
                                  if durs and on_card else None),
                     "max_s": max(durs) if durs and on_card else None}
    return {
        "launches": sum(k.launches for k in kernels),
        "dispatches": sum(k.dispatch_count for k in kernels),
        "device_batches": sum(k.device_batches for k in kernels),
        "host_groups": host,
        "fallback_rows": sum(
            v["fallback_rows"] for name, v in parse_telemetry.status().items()
            if name.startswith("processor_parse_delimiter")),
        "launch_shapes": [dict(asdict(shape), launches=n) for shape, n
                          in struct_index_cuda.launch_shapes.items()],
        "legs": legs,
    }


def _aggregation_stats(aggs, timeline: xprof.DeviceTimeline,
                       on_card: bool) -> Dict[str, Any]:
    """The metric rollup's counts for ``--stats``: folds by substrate and
    their host seconds, K6's launches and shapes, its dispatch legs on the
    timeline, and the rollup's row counters."""
    from .ops import xprof
    from .ops.kernels import segment_reduce, segment_reduce_cuda
    folds: Dict[str, int] = {}
    for a in aggs:
        for sub, n in a.fold_counts.items():
            folds[sub] = folds.get(sub, 0) + n
    kernels = {id(k): k for k in [segment_reduce.device_kernel()] + [
        a._device_kern for a in aggs if a._device_kern is not None]}
    legs = {}
    clock = xprof.DEVICE if on_card else None
    for leg in ("h2d", "exec", "d2h"):
        durs = timeline.leg_durations(leg, clock,
                                      segment_reduce.SegmentReduceKernel.program)
        legs[leg] = {"count": len(durs),
                     "sum_s": sum(durs) if on_card else None,
                     "median_s": (statistics.median(durs)
                                  if durs and on_card else None),
                     "max_s": max(durs) if durs and on_card else None}
    counters: Dict[str, int] = {}
    for a in aggs:
        for name, v in a.metrics.snapshot()["counters"].items():
            counters[name] = counters.get(name, 0) + v
    return {
        "aggregators": len(aggs),
        "folds": folds,
        "fold_seconds": sum(a.fold_seconds for a in aggs),
        "k6_dispatches": sum(k.dispatch_count for k in kernels.values()),
        "k6_launches": sum(k.launches for k in kernels.values()),
        "launch_shapes": [dict(asdict(shape), launches=n) for shape, n
                          in segment_reduce_cuda.launch_shapes.items()],
        "legs": legs,
        "counters": counters,
    }


def _ledger_stats() -> Optional[Dict[str, Any]]:
    """With the ledger on: each pipeline's residual (read after the run
    drained, when nothing is in flight), the totals by boundary, and with
    the auditor on its counts."""
    from .monitor import ledger
    led = ledger.active_ledger()
    if led is None:
        return None
    snap = led.snapshot()
    out = {"residuals": ledger.residuals(snap), "snapshot": snap,
           "auditor": None}
    aud = ledger.auditor()
    if aud is not None:
        out["auditor"] = {
            "interval_s": aud.interval_s,
            "audits_total": aud.audits_total,
            "quiesced_audits_total": aud.quiesced_audits_total,
            "residual_alarms_total": aud.residual_alarms_total,
            "device_memory_alarms_total": aud.device_memory_alarms_total,
        }
    return out


def _slo_stats() -> Optional[Dict[str, Any]]:
    """With the SLO plane on: its ``/debug/slo`` document, each
    (pipeline, outcome) ``event_to_flush_ms`` histogram and the hop
    histograms' totals, read after the drain and before the pipelines
    stop (their stage records retire there)."""
    from .monitor import slo
    from .monitor.metrics import WriteMetrics
    if not slo.is_on():
        return None
    hists: Dict[str, Dict[str, Any]] = {}
    for rec in WriteMetrics.instance().records():
        if rec.category != "slo" or "outcome" not in rec.labels:
            continue
        for h in rec.histograms():
            hists.setdefault(rec.labels["pipeline"], {})[
                rec.labels["outcome"]] = h.snapshot()
    return {"debug": slo.debug_document(), "event_to_flush_ms": hists,
            "hop_totals": {name: {"sum_s": s, "count": n} for name, (s, n)
                           in slo._hop_totals().items()}}


def _fusion_stats(runs, timeline: xprof.DeviceTimeline,
                  on_card: bool) -> Dict[str, Any]:
    """Resident stage fusion's counts for ``--stats``: the runs planned,
    the groups they fused or sent per-stage, the fused dispatches and K7
    launches (with their shapes), K3 launches (its per-stage twin), and
    K7's exec legs on the timeline."""
    from .ops import fused_pipeline, xprof
    from .ops.kernels import fused_program_cuda
    programs = fused_pipeline.cached_programs()
    execs = timeline.leg_durations("exec", xprof.DEVICE if on_card else None,
                                   "fused")
    status = fused_pipeline.stage_fusion_status()
    return {
        "enabled": [r.enabled() for r in runs],
        "runs_planned": len(runs),
        "fused_groups": sum(r.fused_groups for r in runs),
        "long_row_groups": sum(r.long_row_groups for r in runs),
        "other_groups": sum(r.other_groups for r in runs),
        "fused_dispatches": status["fused_dispatch_total"],
        "program_dispatches": sum(p.dispatch_count for p in programs),
        "k7_launches": sum(p.launches for p in programs),
        "k3_launches": sum(p.span_launches() for p in programs),
        "programs": status["programs"],
        "kernel_seconds": sum(execs) if on_card else None,
        "exec_legs": len(execs),
        "exec_median_s": statistics.median(execs) if execs else None,
        "exec_max_s": max(execs, default=None),
        "launch_shapes": [dict(asdict(shape), launches=n) for shape, n
                          in fused_program_cuda.launch_shapes.items()],
    }


def _dfa_stats(kernels, device_batches: int, host_rows: int, mode: str,
               timeline: xprof.DeviceTimeline,
               on_card: bool) -> Dict[str, Any]:
    """One DFA kernel's counts for ``--stats``; its kernel seconds are the
    timeline's device exec legs of its program."""
    from .ops import xprof
    from .ops.kernels import dfa_scan, dfa_scan_cuda
    entry = dfa_scan_cuda.ENTRY_POINTS[mode]
    program = (dfa_scan.DFAMatchKernel if mode == "match"
               else dfa_scan.FusedScanKernel).program
    execs = timeline.leg_durations("exec", xprof.DEVICE if on_card else None,
                                   program)
    return {
        "launches": sum(k.launches for k in kernels),
        "device_batches": device_batches,
        "host_rows": host_rows,
        "kernel_seconds": sum(execs) if on_card else None,
        "exec_legs": len(execs),
        "exec_median_s": statistics.median(execs) if execs else None,
        "exec_max_s": max(execs, default=None),
        "launch_shapes": [dict(asdict(shape), launches=n) for shape, n
                          in dfa_scan_cuda.launch_shapes.items()
                          if shape.entry_point == entry],
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="loongcollector_tpu_torch")
    parser.add_argument("--config", required=True,
                        help="pipeline config directory")
    parser.add_argument("--data-dir", default=None,
                        help="checkpoint, recovery and send-buffer state "
                             f"directory (tail mode: default "
                             f"{DEFAULT_DATA_DIR}; --once: a temporary "
                             f"one)")
    parser.add_argument("--once", action="store_true",
                        help="process available data then exit")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--stats", default="",
                        help="write the run's counts as JSON to this path")
    args = parser.parse_args(argv)
    try:
        device = resolve_device("cpu" if args.cpu else None)
    except NoCudaDevice as e:
        print(f"loongcollector_tpu_torch: {e}", file=sys.stderr)
        return 2
    try:
        if args.once:
            stats = run_once(args.config, device, args.data_dir)
        else:
            stats = run_tail(args.config, device,
                             args.data_dir or DEFAULT_DATA_DIR)
    except ProcessingFailed as e:
        print(f"loongcollector_tpu_torch: {e}", file=sys.stderr)
        return 1
    log.info("run complete: %s", json.dumps(stats))
    if args.stats:
        with open(args.stats, "w") as f:
            json.dump(stats, f)
    return 0
