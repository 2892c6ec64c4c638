"""Agent entry point: ``python -m loongcollector_tpu_torch --config DIR``.

Reference: core/application/Application.cpp.  The port's slice takes
``--config``, ``--once`` and ``--cpu`` as the JAX CLI does: every pipeline
config in the directory (one pipeline per ``.yaml``/``.yml``/``.json``
file, named by its stem) runs once over the existing content of its inputs
and the process exits.  Tail mode comes with the file-server slice.

``--once`` runs the streaming main path: the pipeline manager builds the
pipelines and their bounded process queues, the processor runner's workers
(``LOONG_PROCESS_THREADS``) pop them and dispatch through the device plane
(``LOONG_STREAM_DEPTH``, ``LOONG_DEVICE_INFLIGHT_BYTES``), and the inputs
push what they read, waiting at the queues' high watermark.  The run ends
once every group the inputs pushed has settled, every process queue is
empty and every pipeline's in-process count is 0; then the records the
processors still hold (split_multiline's open record of each file) ship
through the rest of their chain on the calling thread (``drain_held``),
and the run ends once they are sent.  A processing failure (a kernel
failure included) ends the run with exit code 1.

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
``launch_shapes`` at the top holds K1's launches only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from dataclasses import asdict
from typing import Any, Dict, List, Optional, Tuple

from .utils.device import NoCudaDevice, resolve_device
from .utils.logger import get_logger

log = get_logger("application")


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


def run_once(config_dir: str, device) -> Dict[str, Any]:
    """Run every pipeline of the directory once through the processor
    runner; returns the run's counts."""
    from .ops import compile_watch, xprof
    from .ops import fused_pipeline
    from .ops.device_plane import DevicePlane, device_memory_status
    from .ops.device_stream import auto_tuner, batch_ring, stream_depth
    from .monitor import ledger
    from .ops.kernels import dfa_scan_cuda, fused_program_cuda
    from .ops.kernels import field_extract_cuda as fxc
    from .ops.kernels import segment_reduce, segment_reduce_cuda
    from .ops.kernels import struct_index, struct_index_cuda
    from .processor import parse_telemetry
    from .ops.regex.engine import cached_engines
    from .ops.regex.fuse import live_sets
    from .pipeline.pipeline_manager import CollectionPipelineManager
    from .pipeline.queue.process_queue_manager import ProcessQueueManager
    from .runner.processor_runner import ProcessorRunner
    configs = load_config_dir(config_dir)
    if not configs:
        raise FileNotFoundError(f"no pipeline config in {config_dir}")
    if ledger.install_from_env():
        # this run's totals only: the residual is read after it drains
        ledger.active_ledger().reset()
    pqm = ProcessQueueManager()
    manager = CollectionPipelineManager(pqm, device)
    manager.update_pipelines(configs)
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
    runner.init()
    drained_groups = 0
    drain_error: Optional[BaseException] = None
    try:
        manager.start_inputs(should_abort=runner.failed)
        while not runner.failed() and not _drained(pqm, manager, runner):
            time.sleep(0.002)
        if not runner.failed():
            try:
                drained_groups = manager.drain_held()
            except Exception as e:  # noqa: BLE001 — the run exits 1
                log.error("stop-time drain failed", exc_info=e)
                drain_error = e
    finally:
        runner.stop()
        seconds = time.perf_counter() - t0
        drained = _drained(pqm, manager, runner)
        manager_pipelines = manager.pipelines()
        manager.stop_all()
        xprof.disable()
    if runner.error is not None:
        raise ProcessingFailed(
            f"{runner.groups_failed} group(s) failed: {runner.error!r}"
        ) from runner.error
    if drain_error is not None:
        raise ProcessingFailed(f"stop-time drain failed: {drain_error!r}"
                               ) from drain_error
    if not drained or runner.alive_threads():
        raise ProcessingFailed("the processor runner did not drain")
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
        "ledger": _ledger_stats(),
        "mesh": _mesh_stats(timeline),
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
    drained, when nothing is in flight) and the totals by boundary."""
    from .monitor import ledger
    led = ledger.active_ledger()
    if led is None:
        return None
    snap = led.snapshot()
    return {"residuals": ledger.residuals(snap), "snapshot": snap}


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
    parser.add_argument("--once", action="store_true",
                        help="process available data then exit")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--stats", default="",
                        help="write the run's counts as JSON to this path")
    args = parser.parse_args(argv)
    if not args.once:
        print("loongcollector_tpu_torch: only --once is supported; tail mode "
              "comes with the file-server slice", file=sys.stderr)
        return 2
    try:
        device = resolve_device("cpu" if args.cpu else None)
    except NoCudaDevice as e:
        print(f"loongcollector_tpu_torch: {e}", file=sys.stderr)
        return 2
    try:
        stats = run_once(args.config, device)
    except ProcessingFailed as e:
        print(f"loongcollector_tpu_torch: {e}", file=sys.stderr)
        return 1
    log.info("run complete: %s", json.dumps(stats))
    if args.stats:
        with open(args.stats, "w") as f:
            json.dump(stats, f)
    return 0
