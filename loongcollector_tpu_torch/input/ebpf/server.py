"""EBPFServer + plugin managers.

Reference: loongcollector_tpu/input/ebpf/server.py, after
core/ebpf/EBPFServer.h:73-100 (singleton InputRunner; poll thread
over the adapter) and core/ebpf/plugin/*/ managers:
  NetworkObserverManager — L7 parse (protocol/), connection enrichment
  ProcessSecurityManager / FileSecurityManager / NetworkSecurityManager
  (FileSecurityManager.cpp:217 pushes groups into process queues)
plus ProcessCacheManager enriching events with the process tree.

Events are batched per (source, pipeline): the manager accumulates raw
events briefly and flushes one event group — the columnar-friendly unit.
The groups are object groups (``add_log_event``), as the reference's, so a
``processor_classify_url`` downstream classifies them on Python ``re``.

The port's managers also count the groups their flushes pushed
(``groups_pushed``) and those the process queue refused
(``groups_dropped``; the reference drops such a group without a count, and
so does the port, with a warning).  The input shims report their manager's
``groups_pushed``, so ``application``'s drain waits for every group an
eBPF source pushed, the stop-time flush's included.  The process-queue
manager reaches the singleton server through
``runner/input_registry.InputRunnerRegistry.wire_all``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ...models import PipelineEventGroup, SpanEvent
from ...pipeline.plugin.interface import Input
from ...utils.logger import get_logger
from .adapter import (EBPFAdapter, EventSource, RawKernelEvent, get_adapter)
from .connections import ConnectionManager, sniff_l7
from .proc_tree import ProcessTreeCache

log = get_logger("ebpf")

FLUSH_INTERVAL_S = 0.5
MAX_BATCH_EVENTS = 1024


class _SourceManager:
    """Per-source accumulation + flush (base of the reference's per-source
    plugin managers)."""

    def __init__(self, source: EventSource, server: "EBPFServer"):
        self.source = source
        self.server = server
        self.queue_key: Optional[int] = None
        self._pending: List[RawKernelEvent] = []
        self._lock = threading.Lock()
        self._last_flush = time.monotonic()
        self.groups_pushed = 0
        self.groups_dropped = 0

    def on_raw_event(self, ev: RawKernelEvent) -> None:
        with self._lock:
            self._pending.append(ev)
            should_flush = len(self._pending) >= MAX_BATCH_EVENTS
        if should_flush:
            self.flush()

    def maybe_flush(self) -> None:
        if time.monotonic() - self._last_flush >= FLUSH_INTERVAL_S:
            self.flush()

    # managers that accumulate state outside _pending (connection spans /
    # rollup cells) set this so their flush runs even with no raw events
    flush_when_empty = False

    def flush(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
            self._last_flush = time.monotonic()
        if (not pending and not self.flush_when_empty) \
                or self.queue_key is None:
            return
        group = self.build_group(pending)
        if group is not None and not group.empty():
            pqm = self.server.process_queue_manager
            if pqm is not None:
                pushed = pqm.push_queue(self.queue_key, group)
                with self._lock:
                    if pushed:
                        self.groups_pushed += 1
                    else:
                        self.groups_dropped += 1
                if not pushed:
                    log.warning("ebpf %s: the process queue refused a group "
                                "of %d events; dropped", self.source.value,
                                len(group))

    def build_group(self, events: List[RawKernelEvent]
                    ) -> Optional[PipelineEventGroup]:  # pragma: no cover
        raise NotImplementedError


class NetworkObserverManager(_SourceManager):
    """L7 observer (reference NetworkObserverManager + ConnectionManager):
    control/stats events maintain the connection table; payload events emit
    the per-event log stream AND feed request/response matching, so each
    flush carries logs, completed-exchange SPANs (with latency) and the
    rollup metric cells — the observer's three output streams."""

    def __init__(self, source, server):
        super().__init__(source, server)
        self.connections = ConnectionManager()

    def on_raw_event(self, ev: RawKernelEvent) -> None:
        if ev.call_name in ("conn_connect", "conn_accept", "conn_close"):
            self.connections.accept_ctrl(ev)
            return
        if ev.call_name == "conn_stats":
            self.connections.accept_stats(ev)
            return
        if ev.payload:
            # sniff exactly once per event; build_group reuses the result
            proto, rec = sniff_l7(ev.payload)
            ev.l7 = (proto, rec)
            self.connections.accept_data(ev, proto, rec)
        super().on_raw_event(ev)

    flush_when_empty = True    # spans/metrics accumulate between flushes

    def build_group(self, events):
        group = PipelineEventGroup()
        sb = group.source_buffer
        tree = self.server.proc_tree
        for raw in events:
            # on_raw_event stashes the sniff result; events arriving by
            # other paths (tests, replays) sniff here instead
            proto, rec = getattr(raw, "l7", None) or \
                (sniff_l7(raw.payload) if raw.payload else ("raw", None))
            ev = group.add_log_event(raw.timestamp_ns // 1_000_000_000
                                     or int(time.time()))
            ent = tree.lookup(raw.pid, raw.ktime)
            ev.set_content(b"pid", sb.copy_string(str(raw.pid)))
            if ent is not None and ent.comm:
                ev.set_content(b"comm", sb.copy_string(ent.comm))
            ev.set_content(b"local_addr", sb.copy_string(raw.local_addr))
            ev.set_content(b"remote_addr", sb.copy_string(raw.remote_addr))
            ev.set_content(b"direction", sb.copy_string(raw.direction))
            ev.set_content(b"protocol", sb.copy_string(proto.encode()))
            if rec is None:
                continue
            ev.set_content(b"kind", sb.copy_string(rec.kind.encode()))
            if proto == "http":
                if rec.kind == "request":
                    ev.set_content(b"method", sb.copy_string(rec.method))
                    ev.set_content(b"path", sb.copy_string(rec.path))
                    if rec.host:
                        ev.set_content(b"host", sb.copy_string(rec.host))
                else:
                    ev.set_content(b"status",
                                   sb.copy_string(str(rec.status)))
                if rec.version:
                    ev.set_content(b"http_version",
                                   sb.copy_string(rec.version))
            elif proto == "redis":
                if rec.command:
                    ev.set_content(b"command", sb.copy_string(rec.command))
                if rec.key:
                    ev.set_content(b"key", sb.copy_string(rec.key))
                if rec.error:
                    ev.set_content(b"error", sb.copy_string(rec.error))
                elif rec.kind == "response":
                    ev.set_content(b"ok", sb.copy_string(
                        b"1" if rec.ok else b"0"))
            elif proto == "mysql":
                if rec.command:
                    ev.set_content(b"command", sb.copy_string(rec.command))
                if rec.sql:
                    ev.set_content(b"sql", sb.copy_string(rec.sql))
                if rec.kind == "response":
                    if rec.error_code:
                        ev.set_content(b"error_code", sb.copy_string(
                            str(rec.error_code)))
                        ev.set_content(b"error", sb.copy_string(
                            rec.error_message))
                    elif rec.column_count >= 0:
                        ev.set_content(b"columns", sb.copy_string(
                            str(rec.column_count)))
                    else:
                        ev.set_content(b"ok", sb.copy_string(
                            b"1" if rec.ok else b"0"))
        now = int(time.time())
        for span in self.connections.take_spans():
            sp = group.add_span_event(now)
            sp.name = span.name.encode()
            sp.kind = SpanEvent.Kind.SERVER
            sp.start_time_ns = span.start_ns
            sp.end_time_ns = span.end_ns
            sp.status = (SpanEvent.Status.ERROR if span.status == "error"
                         else SpanEvent.Status.OK)
            sp.set_attribute(b"protocol", sb.copy_string(span.protocol))
            sp.set_attribute(b"pid", sb.copy_string(str(span.pid)))
            sp.set_attribute(b"local_addr", sb.copy_string(span.local_addr))
            sp.set_attribute(b"remote_addr",
                             sb.copy_string(span.remote_addr))
            if span.status_code:
                sp.set_attribute(b"status_code",
                                 sb.copy_string(span.status_code))
            for k, v in span.attributes.items():
                sp.set_attribute(k.encode(), sb.copy_string(v))
            ent = tree.lookup(span.pid, span.ktime)
            if ent is not None and ent.comm:
                sp.set_attribute(b"comm", sb.copy_string(ent.comm))
        for (proto, remote, status), cell in \
                self.connections.take_rollup().items():
            mv = group.add_metric_event(now)
            mv.set_name(b"ebpf_l7_requests")
            mv.set_multi_value({
                b"count": cell.count,
                b"errors": cell.errors,
                b"latency_sum_ns": cell.latency_sum_ns,
                b"latency_max_ns": cell.latency_max_ns,
                b"rx_bytes": cell.rx_bytes,
                b"tx_bytes": cell.tx_bytes,
            })
            mv.set_tag(b"protocol", sb.copy_string(proto))
            mv.set_tag(b"remote", sb.copy_string(remote))
            mv.set_tag(b"status", sb.copy_string(status))
        group.set_tag(b"__source__", b"ebpf_network_observer")
        return group


class SecurityManager(_SourceManager):
    """Process/file/network security events (reference
    {Process,File,Network}SecurityManager).

    PROCESS_SECURITY exec/clone/exit events also drive the process-tree
    cache (reference ProcessCacheManager consumes the same stream), so
    every security event is enriched with the process AND parent blocks
    (AttachProcessData, ProcessCacheManager.cpp:248-291).  Driver event
    conventions: execve events carry the binary in `path` and the argument
    string in `payload`; clone/exit carry only identities."""

    def on_raw_event(self, ev: RawKernelEvent) -> None:
        if self.source is EventSource.PROCESS_SECURITY:
            tree = self.server.proc_tree
            name = ev.call_name
            if name in ("sys_execve", "execve"):
                binary = ev.path
                comm = binary.rsplit("/", 1)[-1] if binary else ""
                tree.on_execve(
                    ev.pid, ev.ktime, ppid=ev.ppid, comm=comm,
                    binary=binary,
                    args=ev.payload.decode("utf-8", "replace"))
            elif name in ("sys_clone", "clone", "sys_fork"):
                tree.on_clone(ev.pid, ev.ktime, ev.ppid)
            elif name in ("sys_exit", "exit", "sched_process_exit"):
                tree.on_exit(ev.pid, ev.ktime)
        super().on_raw_event(ev)

    def build_group(self, events):
        group = PipelineEventGroup()
        sb = group.source_buffer
        tree = self.server.proc_tree
        for raw in events:
            ev = group.add_log_event(raw.timestamp_ns // 1_000_000_000
                                     or int(time.time()))
            ev.set_content(b"pid", sb.copy_string(str(raw.pid)))
            ev.set_content(b"call_name", sb.copy_string(raw.call_name))
            tree.attach_process_data(raw.pid, raw.ktime, ev, sb)
            if raw.path:
                ev.set_content(b"path", sb.copy_string(raw.path))
            if raw.remote_addr:
                ev.set_content(b"remote_addr", sb.copy_string(raw.remote_addr))
        group.set_tag(b"__source__", b"ebpf_" + self.source.value.encode())
        return group


class CpuProfilingManager(_SourceManager):
    """On-CPU stack samples → profile events (reference CpuProfiler +
    cpu_profiling plugin manager): one LogEvent per aggregated
    (pid, stack) with a sample count per flush window."""

    def build_group(self, events):
        group = PipelineEventGroup()
        sb = group.source_buffer
        tree = self.server.proc_tree
        agg: Dict[tuple, int] = {}
        for raw in events:
            key = (raw.pid, tuple(raw.stack))
            agg[key] = agg.get(key, 0) + 1
        now = int(time.time())
        for (pid, stack), count in agg.items():
            ev = group.add_log_event(now)
            ent = tree.lookup(pid)
            ev.set_content(b"pid", sb.copy_string(str(pid)))
            if ent is not None and ent.comm:
                ev.set_content(b"comm", sb.copy_string(ent.comm))
            ev.set_content(b"stack", sb.copy_string(";".join(stack)))
            ev.set_content(b"count", sb.copy_string(str(count)))
        group.set_tag(b"__source__", b"ebpf_cpu_profiling")
        return group


class EBPFServer:
    _instance: Optional["EBPFServer"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self.adapter: EBPFAdapter = get_adapter()
        self.process_queue_manager = None
        self.proc_tree = ProcessTreeCache()
        self._managers: Dict[EventSource, _SourceManager] = {}
        self._thread: Optional[threading.Thread] = None
        self._running = False

    @classmethod
    def instance(cls) -> "EBPFServer":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def enable_plugin(self, source: EventSource, queue_key: int) -> bool:
        """Singleton per source: a reloaded pipeline reuses its queue key; a
        second pipeline claiming an active source is a config error."""
        mgr = self._managers.get(source)
        if mgr is not None and mgr.queue_key not in (None, queue_key):
            log.error("ebpf source %s already bound to another pipeline",
                      source.value)
            return False
        if mgr is None:
            if source is EventSource.NETWORK_OBSERVE:
                cls = NetworkObserverManager
            elif source is EventSource.CPU_PROFILING:
                cls = CpuProfilingManager
            else:
                cls = SecurityManager
            mgr = cls(source, self)
            self._managers[source] = mgr
        mgr.queue_key = queue_key
        ok = self.adapter.start_plugin(source, mgr.on_raw_event)
        self._ensure_thread()
        return ok

    def disable_plugin(self, source: EventSource,
                       queue_key: Optional[int] = None) -> bool:
        mgr = self._managers.get(source)
        if mgr is None:
            return True
        if queue_key is not None and mgr.queue_key != queue_key:
            return True  # someone else owns the source now
        self._managers.pop(source, None)
        mgr.flush()
        return self.adapter.stop_plugin(source)

    def _ensure_thread(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._run, name="ebpf-server",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        # stop driver delivery FIRST so no events arrive after the flush
        for source in list(self._managers):
            self.adapter.stop_plugin(source)
        self._running = False
        if self._thread:
            self._thread.join(timeout=2)
            self._thread = None
        for mgr in self._managers.values():
            mgr.flush()

    def _run(self) -> None:
        last_gc = time.monotonic()
        while self._running:
            time.sleep(0.1)
            for mgr in list(self._managers.values()):
                try:
                    mgr.maybe_flush()
                except Exception:  # noqa: BLE001
                    log.exception("ebpf flush failed")
            now = time.monotonic()
            if now - last_gc >= 5.0:
                last_gc = now
                try:
                    self.proc_tree.clear_expired()
                    netobs = self._managers.get(EventSource.NETWORK_OBSERVE)
                    if netobs is not None:
                        netobs.connections.iterations()
                except Exception:  # noqa: BLE001
                    log.exception("ebpf gc failed")


# ---------------------------------------------------------------------------
# input plugin shims (reference plugin/input/Input{NetworkObserver,...}.cpp)
# ---------------------------------------------------------------------------


class _EBPFInputBase(Input):
    """Binds its source to the pipeline's process queue; the server's
    managers push the groups.  ``start`` returns at once: the driver
    delivers events until the input stops."""

    source: EventSource = EventSource.NETWORK_OBSERVE
    is_singleton = True
    read_seconds = 0.0

    def __init__(self) -> None:
        super().__init__()
        self._manager: Optional[_SourceManager] = None

    @property
    def groups_pushed(self) -> int:
        """The groups this input's source manager pushed, the flush at its
        stop included."""
        return self._manager.groups_pushed if self._manager else 0

    @property
    def groups_dropped(self) -> int:
        """The groups the process queue refused this input's manager."""
        return self._manager.groups_dropped if self._manager else 0

    def start(self, should_abort=lambda: False) -> bool:
        server = EBPFServer.instance()
        key = self.context.process_queue_key
        ok = server.enable_plugin(self.source, key)
        mgr = server._managers.get(self.source)
        if mgr is not None and mgr.queue_key == key:
            self._manager = mgr
        return ok

    def stop(self, is_pipeline_removing: bool = False) -> bool:
        return EBPFServer.instance().disable_plugin(
            self.source, self.context.process_queue_key)


class InputNetworkObserver(_EBPFInputBase):
    name = "input_network_observer"
    source = EventSource.NETWORK_OBSERVE


class InputProcessSecurity(_EBPFInputBase):
    name = "input_process_security"
    source = EventSource.PROCESS_SECURITY


class InputFileSecurity(_EBPFInputBase):
    name = "input_file_security"
    source = EventSource.FILE_SECURITY


class InputNetworkSecurity(_EBPFInputBase):
    name = "input_network_security"
    source = EventSource.NETWORK_SECURITY


class InputCpuProfiling(_EBPFInputBase):
    name = "input_cpu_profiling"
    source = EventSource.CPU_PROFILING
