"""Runtime telemetry gauges for the self-monitor pipelines.

Reference analogue: core/monitor/metric_models + the per-runner metric
records the reference refreshes before each self-monitor send.  These
gauges surface the device plane's in-flight budget and utilization, the
batch ring and width tuner, the sharded mesh and chip lanes, the eBPF
connection table, and the device timeline's memory, compile and dispatch
accounting, so operators see device back-pressure and shedding in the same
internal metrics stream as everything else.

The port's copy of the JAX package's ``monitor/runtime_stats.py``, with
the records of the planes the port has (``device_plane``,
``mesh_parse``, ``ebpf_connections``, ``device_xprof``) and the ledger's
and SLO plane's export refreshes.  The Prometheus runner's, the processor
shards' and the profiler's records wait for their modules.  Every section
is fail-soft as in the JAX package, but a failure is logged once and
counted (``monitor/fail_soft.py``) instead of passing silently.
"""

from __future__ import annotations

import sys

from . import fail_soft
from .metrics import MetricsRecord

_PKG = __name__.split(".")[0]

_plane_rec = MetricsRecord(category="device_plane",
                           labels={"component": "device_plane"})
_ebpf_rec = MetricsRecord(category="ebpf_connections",
                          labels={"component": "ebpf"})
_mesh_rec = MetricsRecord(category="mesh_parse",
                          labels={"component": "sharded_plane"})
_xprof_rec = MetricsRecord(category="device_xprof",
                           labels={"component": "loongxprof"})


def _module(name: str):
    """An already-imported module of the port, or None: observe-only, a
    gauge refresh never imports (and so never constructs) a plane."""
    return sys.modules.get(f"{_PKG}.{name}")


def refresh() -> None:
    """Pull current values into the gauge records (called by the
    self-monitor right before it snapshots).  Every section is fail-soft:
    telemetry must never take down the monitor thread."""
    try:
        _dp = _module("ops.device_plane")
        plane = _dp.DevicePlane._instance if _dp is not None else None
        if plane is not None:
            u = plane.utilization()
            _plane_rec.gauge("inflight_bytes").set(u["inflight_bytes"])
            _plane_rec.gauge("budget_bytes").set(u["budget_bytes"])
            _plane_rec.gauge("dispatched_total").set(u["dispatched_total"])
            _plane_rec.gauge("budget_held_fraction_now").set(
                u["held_fraction"])
            _plane_rec.gauge("budget_occupancy_avg").set(u["occupancy_avg"])
            _plane_rec.gauge("device_busy_fraction").set(u["busy_fraction"])
            # monotone integrals next to the lifetime averages: rate()
            # over a scrape pair recovers the RECENT fraction
            _plane_rec.gauge("budget_occupancy_integral_seconds").set(
                u["occupancy_integral_s"])
            _plane_rec.gauge("device_busy_seconds").set(u["busy_s"])
            _plane_rec.gauge("submit_queue_depth").set(
                u["submit_queue_depth"])
            _plane_rec.gauge("device_idle_while_backlogged_ms").set(
                u["idle_while_backlogged_ms"])
    except Exception as e:  # noqa: BLE001
        fail_soft.note("runtime_stats.device_plane", e)
    try:
        # batch-ring occupancy + padding waste + the auto-tuner's live
        # decisions, next to the plane budget they feed
        _ds = _module("ops.device_stream")
        if _ds is not None:
            ring = _ds._ring
            if ring is not None:
                totals = ring.totals()
                _plane_rec.gauge("ring_slots_leased").set(totals["leased"])
                _plane_rec.gauge("ring_slots_pooled").set(totals["pooled"])
                _plane_rec.gauge("batch_padding_fraction_lifetime").set(
                    totals["padding_fraction"])
                _plane_rec.gauge("stream_depth").set(_ds.stream_depth())
            tuner = _ds._tuner
            if tuner is not None:
                _plane_rec.gauge("stream_flush_deadline_ms").set(
                    tuner.flush_deadline_s() * 1000.0)
    except Exception as e:  # noqa: BLE001
        fail_soft.note("runtime_stats.device_stream", e)
    try:
        # the sharded plane's folded counts (the status read folds the
        # queued per-dispatch counts here, off the dispatch path)
        _mesh = _module("parallel.mesh")
        doc = _mesh.mesh_status() if _mesh is not None else None
        if doc is not None and doc["kernels"]:
            k = doc["kernels"][-1]
            _mesh_rec.gauge("devices").set(k["chips"])
            totals = k["totals"]
            _mesh_rec.gauge("last_matched").set(int(totals["matched"]))
            _mesh_rec.gauge("last_events").set(int(totals["events"]))
            _mesh_rec.gauge("last_bytes").set(int(totals["bytes"]))
    except Exception as e:  # noqa: BLE001
        fail_soft.note("runtime_stats.mesh", e)
    try:
        # chip lanes: how many (the per-lane counters export through each
        # lane's own record; the port has no lane breaker)
        _cl = _module("ops.chip_lanes")
        r = _cl.active_router() if _cl is not None else None
        if r is not None and r.lane_count():
            _mesh_rec.gauge("chip_lanes").set(r.lane_count())
    except Exception as e:  # noqa: BLE001
        fail_soft.note("runtime_stats.chip_lanes", e)
    try:
        # the ledger's boundary totals + residual + lag watermarks into
        # per-pipeline gauge records (no-op while the ledger is off)
        from . import ledger
        ledger.export_refresh()
    except Exception as e:  # noqa: BLE001
        fail_soft.note("runtime_stats.ledger", e)
    try:
        # freshness/burn-rate gauges on the same cadence (no-op while the
        # SLO plane is off)
        from . import slo
        slo.export_refresh()
    except Exception as e:  # noqa: BLE001
        fail_soft.note("runtime_stats.slo", e)
    try:
        # device-memory ledger + compile accounting + timeline occupancy:
        # the fleet-level "is anything storming / leaking" summary
        _dp = _module("ops.device_plane")
        if _dp is not None:
            mem = _dp.device_memory_status()
            _xprof_rec.gauge("device_mem_live_bytes_total").set(
                float(mem["total_live_bytes"]))
            for fam, row in mem["families"].items():
                _xprof_rec.gauge(f"device_mem_live_bytes_{fam}").set(
                    float(row["live_bytes"]))
                _xprof_rec.gauge(f"device_mem_peak_bytes_{fam}").set(
                    float(row["peak_bytes"]))
        _cw = _module("ops.compile_watch")
        if _cw is not None:
            cdoc = _cw.compile_status()
            _xprof_rec.gauge("jit_families").set(float(len(cdoc)))
            _xprof_rec.gauge("jit_storm_episodes_total").set(float(
                sum(row["storm_episodes"] for row in cdoc.values())))
        _xp = _module("ops.xprof")
        if _xp is not None:
            xdoc = _xp.status()
            _xprof_rec.gauge("xprof_active").set(
                1.0 if xdoc is not None else 0.0)
            if xdoc is not None:
                _xprof_rec.gauge("xprof_dispatches_recorded").set(
                    float(xdoc["dispatches"]))
                _xprof_rec.gauge("xprof_dispatches_closed").set(
                    float(xdoc["closed"]))
                _xprof_rec.gauge("xprof_dispatches_dropped").set(
                    float(xdoc["dropped"]))
    except Exception as e:  # noqa: BLE001
        fail_soft.note("runtime_stats.xprof", e)
    try:
        _srv = _module("input.ebpf.server")
        server = _srv.EBPFServer._instance if _srv is not None else None
        if server is not None:
            from ..input.ebpf.adapter import EventSource
            netobs = server._managers.get(EventSource.NETWORK_OBSERVE)
            if netobs is not None:
                cm = netobs.connections
                _ebpf_rec.gauge("connections").set(cm.connection_count())
                _ebpf_rec.gauge("dropped_connections").set(cm.dropped_conns)
                _ebpf_rec.gauge("unmatched_responses").set(
                    cm.unmatched_responses)
            _ebpf_rec.gauge("process_cache_size").set(
                server.proc_tree.size())
            _ebpf_rec.gauge("process_cache_misses").set(
                server.proc_tree.misses)
    except Exception as e:  # noqa: BLE001
        fail_soft.note("runtime_stats.ebpf", e)
