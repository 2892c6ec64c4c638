"""Prometheus-text self-telemetry endpoint and debug surface (off by default).

Reference analogue: the reference agent exposes its internal metrics for
scraping next to the self-monitor pipelines; here a stdlib
ThreadingHTTPServer serves ``GET /metrics`` rendering every live
MetricsRecord in text exposition format v0.0.4:

  * counters  → ``loong_<name>``, process-lifetime cumulatives (the port's
    self-monitor resets nothing; in the JAX package it drains counters on
    its cadence, so a scrape there reads deltas since its last send);
  * gauges    → ``loong_<name>``;
  * histograms→ full ``_bucket{le=...}`` / ``_sum`` / ``_count`` series
    plus pre-computed ``_p50/_p90/_p99`` gauges for humans;
  * record labels (pipeline, plugin_type, sink...) become metric labels,
    with ``category`` always present.

Rendering never resets anything — scraping is read-only and safe to run
concurrently with the self-monitor's reads.

The debug surface:

  * ``/healthz``         — liveness: 200 + uptime / worker-count JSON;
  * ``/debug/status``    — running status JSON (pipelines, queue depths,
    ledger residuals and lags, worker backlogs, breaker states, device
    utilization, streaming ring, mesh and lanes, fusion, parse, recovery,
    device memory, compile and timeline sections), assembled from
    observe-only module handles — the endpoint never constructs a
    subsystem to report on it;
  * ``/debug/ledger``    — the event-conservation ledger
    (``ledger.debug_document``);
  * ``/debug/slo``       — the freshness-SLO plane (``slo.debug_document``);
  * ``/debug/timeline``  — the dispatch timeline as Chrome-trace JSON;
  * ``/debug/pprof``     — the profiler's folded stacks: the port has no
    profiler, so it answers as the JAX package does with it off;
  * ``/``                — an index; anything else 404.

The port's copy of the JAX package's ``monitor/exposition.py``: ``render``
and the routes above answer as there.  Differences: ``/debug/status``
holds only the sections of the subsystems the port has (``STATUS_SECTIONS``;
no tenants, flight or profiler), each pipeline row also carries its
queue's popped-group count (``queue_popped``), and ``evidence_faults``
shows the fail-soft reads that failed; ``/debug/timeline`` holds the
device legs only (the port has no host span tracer); ``/debug/flight`` is
left out with the flight recorder (``prof/``).  The fail-soft refreshes
of ``render`` and the status sections are logged once and counted
(``monitor/fail_soft.py``) instead of passing silently.

Activation: ``LOONG_EXPO_PORT=<port>`` env (application start) or
programmatic ``ExpositionServer(port).start()``; binds 127.0.0.1 unless
``LOONG_EXPO_HOST`` widens it.
"""

from __future__ import annotations

import http.server
import json
import math
import os
import re
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils.logger import get_logger
from . import fail_soft
from .metrics import WriteMetrics

log = get_logger("exposition")

ENV_PORT = "LOONG_EXPO_PORT"
ENV_HOST = "LOONG_EXPO_HOST"

_PKG = __name__.split(".")[0]

_process_t0 = time.monotonic()

_PREFIX = "loong_"
_NAME_SAN = re.compile(r"[^a-zA-Z0-9_]")
_LABEL_SAN = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(raw: str) -> str:
    name = _NAME_SAN.sub("_", raw)
    if not name or name[0].isdigit():
        name = "_" + name
    return _PREFIX + name


def _label_str(labels: Dict[str, str], extra: str = "") -> str:
    parts = []
    for k in sorted(labels):
        key = _LABEL_SAN.sub("_", str(k))
        val = str(labels[k]).replace("\\", "\\\\").replace(
            '"', '\\"').replace("\n", "\\n")
        parts.append(f'{key}="{val}"')
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    if v != v:                      # NaN
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def render() -> str:
    """The whole live metric tree in text exposition format."""
    try:
        # the ledger gauges mirror on the self-monitor cadence; a scrape
        # refreshes them too (cheap, idempotent) so the conservation
        # series is live from the first scrape, not the first cadence
        from . import ledger as _ledger
        _ledger.export_refresh()
    except Exception as e:  # noqa: BLE001
        fail_soft.note("render.ledger", e)
    try:
        # the SLO freshness/burn gauges mirror the same way: a scrape is
        # never staler than one render
        from . import slo as _slo
        _slo.export_refresh()
    except Exception as e:  # noqa: BLE001
        fail_soft.note("render.slo", e)
    by_name: Dict[Tuple[str, str], List[str]] = {}

    def emit(name: str, typ: str, line: str) -> None:
        by_name.setdefault((name, typ), []).append(line)

    for rec in WriteMetrics.instance().records():
        labels = dict(rec.labels)
        labels["category"] = rec.category
        # one snapshot per record: it already carries the histogram
        # percentiles, so only the bucket vectors need a separate read
        snap = rec.snapshot()
        for raw, value in snap["counters"].items():
            name = _metric_name(raw)
            emit(name, "counter", f"{name}{_label_str(labels)} {_fmt(value)}")
        for raw, value in snap["gauges"].items():
            name = _metric_name(raw)
            emit(name, "gauge", f"{name}{_label_str(labels)} {_fmt(value)}")
        for hist in rec.histograms():
            name = _metric_name(hist.name)
            hsnap = snap["histograms"].get(hist.name)
            if hsnap is None:      # registered after the snapshot above
                continue
            for le, cum in hist.buckets():
                le_label = 'le="%s"' % _fmt(le)
                emit(name, "histogram",
                     f"{name}_bucket{_label_str(labels, le_label)} {cum}")
            emit(name, "histogram",
                 f"{name}_sum{_label_str(labels)} {_fmt(hsnap['sum'])}")
            emit(name, "histogram",
                 f"{name}_count{_label_str(labels)} {hsnap['count']}")
            for q in ("p50", "p90", "p99"):
                qname = f"{name}_{q}"
                emit(qname, "gauge",
                     f"{qname}{_label_str(labels)} {_fmt(hsnap[q])}")
    out: List[str] = []
    for (name, typ) in sorted(by_name):
        out.append(f"# TYPE {name} {typ}")
        # insertion order, not lexical: histogram buckets must stay in
        # ascending `le` order ("+Inf" sorts lexically first)
        out.extend(by_name[(name, typ)])
    return "\n".join(out) + "\n"


def _module(name: str):
    """An already-imported module of the port, or None (observe-only)."""
    return sys.modules.get(f"{_PKG}.{name}")


def process_workers() -> int:
    """Active processor worker count, 0 when no runner is live."""
    _pr = _module("runner.processor_runner")
    runner = _pr._active_runner if _pr is not None else None
    return runner.thread_count if runner is not None else 0


def collect_status() -> dict:
    """The /debug/status document: a one-page answer to "what is this
    agent doing right now", assembled from observe-only handles.  Every
    section is fail-soft — a half-constructed subsystem (agent starting
    up, test harness) yields an absent section, never a 500."""
    doc: dict = {"time": int(time.time()),
                 "uptime_s": round(time.monotonic() - _process_t0, 1),
                 "pid": os.getpid()}
    try:
        _pm = _module("pipeline.pipeline_manager")
        mgr = _pm._active_manager if _pm is not None else None
        if mgr is not None:
            pqm = mgr.process_queue_manager
            with mgr._lock:
                items = list(mgr._pipelines.items())
            pipelines = {}
            for name, p in items:
                entry: dict = {"queue_key": p.process_queue_key}
                if pqm is not None:
                    q = pqm.get_queue(p.process_queue_key)
                    if q is not None:
                        entry["queue_depth"] = q.size()
                        entry["queue_popped"] = q.total_popped
                pipelines[name] = entry
            doc["pipelines"] = pipelines
    except Exception as e:  # noqa: BLE001
        fail_soft.note("status.pipelines", e)
    try:
        # per-pipeline conservation residual + lag watermarks inline (the
        # full boundary matrix lives at /debug/ledger); absent while the
        # ledger is off
        from . import ledger as _ledger
        led = _ledger.active_ledger()
        if led is not None:
            snap = led.snapshot()
            lags = _ledger.lag_snapshot()
            rows = doc.get("pipelines", {})
            for pname, prow in snap.items():
                if pname in rows:
                    rows[pname]["conservation_residual"] = \
                        _ledger.residual_of(prow)
            for pname, ages in lags.items():
                if pname in rows:
                    rows[pname]["queue_lag_seconds"] = round(
                        max(ages.values(), default=0.0), 3)
            doc["ledger"] = {
                "inflight_live": _ledger.live_inflight(),
                "residuals": _ledger.residuals(snap),
            }
    except Exception as e:  # noqa: BLE001
        fail_soft.note("status.ledger", e)
    try:
        _pr = _module("runner.processor_runner")
        runner = _pr._active_runner if _pr is not None else None
        if runner is not None:
            doc["workers"] = {
                "count": runner.thread_count,
                "inbox_depths": runner.inbox_depths(),
                "lane_overlap": [round(x, 4)
                                 for x in runner.lane_overlap()],
            }
    except Exception as e:  # noqa: BLE001
        fail_soft.note("status.workers", e)
    try:
        _fr = _module("runner.flusher_runner")
        fr = _fr._active_runner if _fr is not None else None
        if fr is not None:
            doc["breakers"] = {br.name: br.state.name
                               for br in fr.breakers().values()}
    except Exception as e:  # noqa: BLE001
        fail_soft.note("status.breakers", e)
    try:
        _dp = _module("ops.device_plane")
        plane = _dp.DevicePlane._instance if _dp is not None else None
        if plane is not None:
            u = plane.utilization()
            doc["device"] = {k: (round(v, 6) if isinstance(v, float) else v)
                             for k, v in u.items()}
    except Exception as e:  # noqa: BLE001
        fail_soft.note("status.device", e)
    try:
        # ring occupancy, per-geometry padding waste, and the width
        # auto-tuner's chosen floors/deadline
        _ds = _module("ops.device_stream")
        ring = _ds._ring if _ds is not None else None
        if ring is not None:
            tuner = _ds._tuner
            doc["streaming"] = {
                "depth": _ds.stream_depth(),
                "ring": ring.totals(),
                "geometries": ring.stats(),
                "tuner": tuner.chosen() if tuner is not None else None,
            }
    except Exception as e:  # noqa: BLE001
        fail_soft.note("status.streaming", e)
    try:
        # chip lanes + every live sharded kernel's counts
        _cl = _module("ops.chip_lanes")
        _mesh = _module("parallel.mesh")
        mesh_doc: dict = {}
        if _cl is not None:
            r = _cl.active_router()
            if r is not None and r.lane_count():
                mesh_doc.update(r.status())
        if _mesh is not None:
            ks = _mesh.mesh_status()
            if ks is not None:
                mesh_doc.update(ks)
        _pr = _module("runner.processor_runner")
        runner = _pr._active_runner if _pr is not None else None
        if runner is not None and mesh_doc:
            mesh_doc["worker_chip_map"] = runner.chip_lane_map()
        if mesh_doc:
            doc["mesh"] = mesh_doc
    except Exception as e:  # noqa: BLE001
        fail_soft.note("status.mesh", e)
    try:
        # fused-DFA compile stats and demotions
        _fuse = _module("ops.regex.fuse")
        if _fuse is not None:
            doc["fusion"] = _fuse.fusion_status()
    except Exception as e:  # noqa: BLE001
        fail_soft.note("status.fusion", e)
    try:
        # per-program fused-dispatch rows
        _fp = _module("ops.fused_pipeline")
        if _fp is not None:
            doc["stage_fusion"] = _fp.stage_fusion_status()
    except Exception as e:  # noqa: BLE001
        fail_soft.note("status.stage_fusion", e)
    try:
        # per-processor structural-parse fallback accounting, absent until
        # a parse processor has processed rows
        _pt = _module("processor.parse_telemetry")
        if _pt is not None:
            parse_doc = _pt.status()
            if parse_doc:
                doc["parse"] = parse_doc
    except Exception as e:  # noqa: BLE001
        fail_soft.note("status.parse", e)
    try:
        _rc = _module("recovery")
        rdoc = _rc.status() if _rc is not None else None
        if rdoc is not None:
            doc["recovery"] = rdoc
    except Exception as e:  # noqa: BLE001
        fail_soft.note("status.recovery", e)
    try:
        # device-memory ledger: live/peak bytes per allocation family
        _dp = _module("ops.device_plane")
        if _dp is not None:
            doc["device_memory"] = _dp.device_memory_status()
    except Exception as e:  # noqa: BLE001
        fail_soft.note("status.device_memory", e)
    try:
        # per-family build and first-launch accounting, absent until the
        # first watched build or launch
        _cw = _module("ops.compile_watch")
        if _cw is not None:
            cdoc = _cw.compile_status()
            if cdoc:
                doc["compile"] = cdoc
    except Exception as e:  # noqa: BLE001
        fail_soft.note("status.compile", e)
    try:
        # dispatch timeline occupancy + per-(program, geometry) dispatch
        # decomposition; absent while no timeline records
        _xp = _module("ops.xprof")
        if _xp is not None:
            xdoc = _xp.status()
            if xdoc is not None:
                doc["xprof"] = xdoc
    except Exception as e:  # noqa: BLE001
        fail_soft.note("status.xprof", e)
    doc["evidence_faults"] = fail_soft.counts()
    return doc


#: every section collect_status() can emit
STATUS_SECTIONS = (
    "time", "uptime_s", "pid",
    "pipelines", "ledger", "workers", "breakers",
    "device", "streaming", "mesh", "fusion", "stage_fusion", "parse",
    "recovery", "device_memory", "compile", "xprof", "evidence_faults",
)

#: device leg -> thread row of the Chrome trace (the JAX package's rows)
_LEG_TIDS = {"pack": 1, "submit": 2, "h2d": 3, "exec": 4, "d2h": 5}
PID_DEVICE = 2


def chrome_trace(timeline=None) -> dict:
    """The dispatch timeline as a Chrome-trace JSON object (the
    ``traceEvents`` array format Perfetto loads directly): each leg of
    each recorded dispatch a complete ("ph":"X") event under pid
    ``PID_DEVICE``, one thread row a leg, with ``dispatch_id``, bytes,
    program and geometry in its args — the device half of the JAX
    package's ``trace/export.chrome_trace``.  Host legs are timed from the
    timeline's host epoch, device legs from its device epoch."""
    if timeline is None:
        _xp = _module("ops.xprof")
        timeline = _xp.active_timeline() if _xp is not None else None
    events: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": PID_DEVICE,
         "args": {"name": "device (dispatch legs)"}},
    ]
    for leg, tid in sorted(_LEG_TIDS.items(), key=lambda kv: kv[1]):
        events.append({"ph": "M", "name": "thread_name",
                       "pid": PID_DEVICE, "tid": tid,
                       "args": {"name": leg}})
    dispatches = timeline.dispatches() if timeline is not None else []
    for rec in dispatches:
        for leg, t0, dur, clock in list(rec.legs):
            events.append({
                "ph": "X",
                "name": leg,
                "cat": "device",
                "pid": PID_DEVICE,
                "tid": _LEG_TIDS.get(leg, 9),
                "ts": round(t0 * 1e6, 3),
                "dur": round(dur * 1e6, 3),
                "args": {"dispatch_id": rec.id, "nbytes": rec.nbytes,
                         "program": rec.program or "unattributed",
                         "geometry": rec.geometry or "-",
                         "clock": clock},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


_INDEX = (b"loongcollector_tpu_torch exposition endpoint\n"
          b"  /metrics       Prometheus text exposition\n"
          b"  /healthz       liveness (uptime + worker count)\n"
          b"  /debug/status  running-status JSON\n"
          b"  /debug/pprof   folded stacks (no profiler in this agent)\n"
          b"  /debug/ledger  event-conservation ledger JSON\n"
          b"  /debug/slo     freshness-SLO plane JSON\n"
          b"  /debug/timeline  dispatch-timeline Chrome-trace JSON\n")

_PROM_CT = "text/plain; version=0.0.4; charset=utf-8"
_JSON_CT = "application/json; charset=utf-8"
_TEXT_CT = "text/plain; charset=utf-8"


def _json_body(doc) -> bytes:
    return (json.dumps(doc, sort_keys=True, default=str) + "\n").encode()


class _Handler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                self._reply(200, _PROM_CT, render().encode("utf-8"))
            elif path == "/healthz":
                doc = {"status": "ok", "pid": os.getpid(),
                       "uptime_s": round(time.monotonic() - _process_t0, 1),
                       "process_workers": process_workers()}
                self._reply(200, _JSON_CT,
                            (json.dumps(doc, sort_keys=True) + "\n").encode())
            elif path == "/debug/status":
                self._reply(200, _JSON_CT, _json_body(collect_status()))
            elif path == "/debug/ledger":
                from . import ledger as _ledger
                self._reply(200, _JSON_CT,
                            _json_body(_ledger.debug_document()))
            elif path == "/debug/slo":
                from . import slo as _slo
                self._reply(200, _JSON_CT, _json_body(_slo.debug_document()))
            elif path == "/debug/timeline":
                self._reply(200, _JSON_CT, _json_body(chrome_trace()))
            elif path == "/debug/pprof":
                # the port has no profiler: the JAX package's answer with
                # its profiler off
                self._reply(200, _TEXT_CT,
                            b"# profiler inactive (set LOONG_PROF=1)\n")
            elif path == "/":
                # an index, NOT the metrics page: unknown or bare paths
                # must never masquerade as a scrape target
                self._reply(200, _TEXT_CT, _INDEX)
            else:
                self.send_response(404)
                self.end_headers()
        except Exception as e:  # noqa: BLE001 — a bad record must not 500-loop
            log.exception("exposition render failed")
            self.send_response(500)
            self.end_headers()
            self.wfile.write(repr(e).encode())

    def _reply(self, code: int, ctype: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # scrape traffic is not agent log news
        pass


class ExpositionServer:
    """Lifecycle wrapper; `port=0` binds an ephemeral port (tests)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self.host = host
        self.port = port
        self._server: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> bool:
        if self._server is not None:
            return True
        try:
            self._server = http.server.ThreadingHTTPServer(
                (self.host, self.port), _Handler)
        except OSError as e:
            log.error("exposition endpoint bind %s:%d failed: %s",
                      self.host, self.port, e)
            self._server = None
            return False
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="exposition", daemon=True)
        self._thread.start()
        log.info("exposition endpoint on http://%s:%d/metrics",
                 self.host, self.port)
        return True

    def stop(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


def start_from_env(env=os.environ) -> Optional[ExpositionServer]:
    """LOONG_EXPO_PORT activates the endpoint at application start."""
    raw = env.get(ENV_PORT)
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        log.error("bad %s=%r; exposition endpoint stays off", ENV_PORT, raw)
        return None
    server = ExpositionServer(port, env.get(ENV_HOST, "127.0.0.1"))
    return server if server.start() else None
