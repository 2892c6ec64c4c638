"""input_host_monitor — host metrics collectors.

Reference: core/host_monitor/ (8.5k LoC) — timer-scheduled collectors
(CPU/Mem/Disk/Net/Process/System) reading /proc via LinuxSystemInterface,
assembling metric events pushed through HostMonitorInputRunner
(HostMonitorInputRunner.cpp:285-339).

One runner thread schedules registered collectors on their intervals and
pushes MetricEvent groups into the owning pipeline's process queue.

The port's copy of the JAX package's ``input/host_monitor.py``: the same
collectors (``cpu``, ``mem``, ``disk``, ``net``, ``system``, ``process``,
``gpu``), entity snapshots and runner, reading the same files.  The runner
counts the groups it pushed for each registration (counted before the
push), which each input reports as its ``groups_pushed``, and ``stop``
wakes and joins its thread.  ``InputHostMonitor`` reads its cadence from
``IntervalSeconds``, as the JAX package's does.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..models import PipelineEventGroup
from ..pipeline.plugin.interface import Input, PluginContext
from ..utils.logger import get_logger

log = get_logger("host_monitor")


# ---------------------------------------------------------------------------
# collectors: each returns {metric_name: (value, {tag: val})}
# ---------------------------------------------------------------------------


class CpuCollector:
    name = "cpu"

    def __init__(self) -> None:
        self._last: Optional[List[int]] = None

    def collect(self) -> List[Tuple[str, float, Dict[str, str]]]:
        with open("/proc/stat") as f:
            line = f.readline().split()
        vals = [int(x) for x in line[1:9]]
        out = []
        if self._last is not None:
            deltas = [a - b for a, b in zip(vals, self._last)]
            total = sum(deltas) or 1
            names = ["user", "nice", "system", "idle", "iowait", "irq",
                     "softirq", "steal"]
            for n, d in zip(names, deltas):
                out.append((f"cpu_{n}_percent", 100.0 * d / total, {}))
        self._last = vals
        return out


class MemCollector:
    name = "mem"

    def collect(self):
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, rest = line.partition(":")
                info[k] = int(rest.split()[0]) * 1024
        total = info.get("MemTotal", 0)
        avail = info.get("MemAvailable", 0)
        used = total - avail
        out = [("memory_total_bytes", float(total), {}),
               ("memory_used_bytes", float(used), {}),
               ("memory_available_bytes", float(avail), {})]
        if total:
            out.append(("memory_used_percent", 100.0 * used / total, {}))
        return out


class DiskCollector:
    name = "disk"

    def collect(self):
        out = []
        seen = set()
        with open("/proc/mounts") as f:
            for line in f:
                dev, mnt, fstype = line.split()[:3]
                if not dev.startswith("/dev/") or mnt in seen:
                    continue
                seen.add(mnt)
                self._emit(out, dev, mnt, fstype)
        if "/" not in seen:
            # containers/VMs often mount the root fs from a non-/dev/
            # source (overlayfs, 9p, virtiofs) — report the root volume
            # even when /dev/-backed data volumes exist, so root-disk
            # capacity alerting is never blind
            with open("/proc/mounts") as f:
                for line in f:
                    dev, mnt, fstype = line.split()[:3]
                    if mnt == "/":
                        self._emit(out, dev, mnt, fstype)
                        break
        return out

    @staticmethod
    def _emit(out, dev, mnt, fstype):
        try:
            st = os.statvfs(mnt)
        except OSError:
            return
        total = st.f_blocks * st.f_frsize
        free = st.f_bavail * st.f_frsize
        if total == 0:
            return
        tags = {"device": dev, "mount": mnt, "fstype": fstype}
        out.append(("disk_total_bytes", float(total), tags))
        out.append(("disk_free_bytes", float(free), tags))
        out.append(("disk_used_percent",
                    100.0 * (total - free) / total, tags))


class NetCollector:
    name = "net"

    def __init__(self) -> None:
        self._last: Dict[str, Tuple[int, int]] = {}
        self._last_t = 0.0

    def collect(self):
        out = []
        now = time.monotonic()
        dt = now - self._last_t if self._last_t else 0
        with open("/proc/net/dev") as f:
            lines = f.readlines()[2:]
        for line in lines:
            iface, _, rest = line.partition(":")
            iface = iface.strip()
            vals = rest.split()
            rx, tx = int(vals[0]), int(vals[8])
            if iface in self._last and dt > 0:
                lrx, ltx = self._last[iface]
                tags = {"interface": iface}
                out.append(("net_rx_bytes_per_sec", (rx - lrx) / dt, tags))
                out.append(("net_tx_bytes_per_sec", (tx - ltx) / dt, tags))
            self._last[iface] = (rx, tx)
        self._last_t = now
        return out


class SystemCollector:
    name = "system"

    def collect(self):
        la1, la5, la15 = os.getloadavg()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return [("system_load_1m", la1, {}),
                ("system_load_5m", la5, {}),
                ("system_load_15m", la15, {}),
                ("system_uptime_seconds", uptime, {})]


class ProcessCollector:
    """Top-N processes by CPU ticks (reference ProcessCollector)."""

    name = "process"

    def __init__(self, top_n: int = 10):
        self.top_n = top_n

    def collect(self):
        procs = []
        for pid in os.listdir("/proc"):
            if not pid.isdigit():
                continue
            try:
                with open(f"/proc/{pid}/stat") as f:
                    data = f.read()
                # comm may contain spaces/parens: field 2 ends at last ')'
                rp = data.rindex(")")
                comm = data[data.index("(") + 1 : rp]
                rest = data[rp + 2 :].split()
                ticks = int(rest[11]) + int(rest[12])   # utime+stime
                rss = int(rest[21]) * os.sysconf("SC_PAGE_SIZE")
                nthreads = int(rest[17])
                start_ticks = int(rest[19])
                procs.append((ticks, comm, pid, rss, nthreads, start_ticks))
            except (OSError, IndexError, ValueError):
                continue
        procs.sort(reverse=True)
        out = []
        for ticks, comm, pid, rss, nthreads, start_ticks in procs[:self.top_n]:
            tags = {"pid": pid, "comm": comm}
            # entity detail (reference ProcessEntityCollector): cmdline,
            # uid, open fds, thread count, start time
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmdline = f.read().replace(b"\0", b" ").strip().decode(
                        "utf-8", "replace")
                if cmdline:
                    tags["cmdline"] = cmdline[:256]
            except OSError:
                pass
            try:
                st = os.stat(f"/proc/{pid}")
                tags["uid"] = str(st.st_uid)
            except OSError:
                pass
            try:
                n_fds = len(os.listdir(f"/proc/{pid}/fd"))
                out.append(("process_open_fds", float(n_fds), tags))
            except OSError:
                pass
            out.append(("process_cpu_ticks", float(ticks), tags))
            out.append(("process_rss_bytes", float(rss), tags))
            out.append(("process_threads", float(nthreads), tags))
            out.append(("process_start_ticks", float(start_ticks), tags))
        return out


class ProcessEntityCollector:
    """Process ENTITY lifecycle events (reference
    host_monitor/collector/ProcessEntityCollector.cpp:65-130 + the field
    vocabulary in constants/EntityConstants.cpp): top-N processes by CPU
    usage between collections, each emitted as an entity event (domain,
    entity type, stable entity id = md5(host|pid|ktime), first/last
    observed, keep-alive) plus a process→host link event.  Goes past the
    reference's TODOs: user name, cwd, binary and arguments are filled
    from /proc where readable."""

    name = "process_entity"

    def __init__(self, top_n: int = 20, interval_s: float = 60.0):
        import socket
        self.top_n = top_n
        self.interval_s = interval_s
        self._prev_ticks: Dict[int, int] = {}
        self._hostname = socket.gethostname()
        self._host_entity_id = hashlib.md5(
            self._hostname.encode()).hexdigest()
        self._boot_time = 0
        try:
            with open("/proc/stat") as f:
                for line in f:
                    if line.startswith("btime "):
                        self._boot_time = int(line.split()[1])
                        break
        except OSError:
            pass
        self._clk = os.sysconf("SC_CLK_TCK")

    def _entity_id(self, pid: str, ktime: str) -> str:
        return hashlib.md5(
            f"{self._hostname}{pid}{ktime}".encode()).hexdigest()

    @staticmethod
    def _user_of(uid: int) -> str:
        try:
            import pwd
            return pwd.getpwuid(uid).pw_name
        except (KeyError, ImportError):
            return str(uid)

    def _scan(self):
        """[(cpu_delta, pid, comm, ppid, start_ticks)] sorted by usage."""
        rows = []
        new_ticks: Dict[int, int] = {}
        for pid_s in os.listdir("/proc"):
            if not pid_s.isdigit():
                continue
            pid = int(pid_s)
            try:
                with open(f"/proc/{pid}/stat") as f:
                    data = f.read()
                rp = data.rindex(")")
                comm = data[data.index("(") + 1 : rp]
                rest = data[rp + 2 :].split()
                ppid = int(rest[1])
                ticks = int(rest[11]) + int(rest[12])
                start_ticks = int(rest[19])
            except (OSError, IndexError, ValueError):
                continue
            new_ticks[pid] = ticks
            delta = ticks - self._prev_ticks.get(pid, 0)
            rows.append((delta, pid, comm, ppid, start_ticks))
        self._prev_ticks = new_ticks
        rows.sort(reverse=True)
        return rows[: self.top_n]

    def collect_group(self) -> "PipelineEventGroup":
        group = PipelineEventGroup()
        sb = group.source_buffer
        now = int(time.time())
        keep_alive = str(int(self.interval_s * 2))

        def put(ev, k: str, v: str) -> None:
            ev.set_content(sb.copy_string(k.encode()),
                           sb.copy_string(v.encode()[:512]))

        for _delta, pid, comm, ppid, start_ticks in self._scan():
            ktime = str(self._boot_time + start_ticks // self._clk)
            entity_id = self._entity_id(str(pid), ktime)
            ev = group.add_log_event(now)
            put(ev, "__domain__", "infra")
            put(ev, "__entity_type__", "infra.host.process")
            put(ev, "__entity_id__", entity_id)
            put(ev, "__first_observed_time__", ktime)
            put(ev, "__last_observed_time__", str(now))
            put(ev, "__keep_alive_seconds__", keep_alive)
            put(ev, "pid", str(pid))
            put(ev, "ppid", str(ppid))
            put(ev, "comm", comm)
            put(ev, "ktime", ktime)
            try:
                st = os.stat(f"/proc/{pid}")
                put(ev, "user", self._user_of(st.st_uid))
            except OSError:
                pass
            try:
                put(ev, "cwd", os.readlink(f"/proc/{pid}/cwd"))
            except OSError:
                pass
            try:
                put(ev, "binary", os.readlink(f"/proc/{pid}/exe"))
            except OSError:
                pass
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    args = f.read().replace(b"\0", b" ").strip()
                if args:
                    put(ev, "arguments",
                        args.decode("utf-8", "replace"))
            except OSError:
                pass
            # process → host relation (reference link event)
            link = group.add_log_event(now)
            put(link, "__src_domain__", "infra")
            put(link, "__src_entity_type__", "infra.host.process")
            put(link, "__src_entity_id__", entity_id)
            put(link, "__dest_domain__", "infra")
            put(link, "__dest_entity_type__", "acs.host.instance")
            put(link, "__dest_entity_id__", self._host_entity_id)
            put(link, "__relation_type__", "update")
            put(link, "__first_observed_time__", ktime)
            put(link, "__last_observed_time__", str(now))
            put(link, "__keep_alive_seconds__", keep_alive)
        group.set_tag(b"__source__", b"process_entity")
        return group


class _HostInput(Input):
    """The port's drain surface of an input the runner collects for: the
    groups pushed under its registration name."""

    is_singleton = True
    read_seconds = 0.0

    def _registration(self) -> str:
        raise NotImplementedError

    @property
    def groups_pushed(self) -> int:
        if self.context is None:
            return 0
        return HostMonitorInputRunner.instance().groups_pushed(
            self._registration())


class InputProcessEntity(_HostInput):
    """Periodic process-entity snapshots (reference wires process_entity
    through InputHostMonitor's collector matrix; standalone input here)."""

    name = "input_process_entity"

    def __init__(self) -> None:
        super().__init__()
        self.interval_s = 60.0
        self.top_n = 20
        self._collector: Optional[ProcessEntityCollector] = None

    def init(self, config, context) -> bool:
        super().init(config, context)
        self.interval_s = float(config.get("IntervalSeconds", 60))
        self.top_n = int(config.get("TopN", 20))
        self._collector = ProcessEntityCollector(self.top_n, self.interval_s)
        return True

    def _registration(self) -> str:
        return f"{self.context.pipeline_name}#process_entity"

    def start(self, should_abort=lambda: False) -> bool:
        runner = HostMonitorInputRunner.instance()
        runner.register_group_collector(
            self._registration(),
            self._collector.collect_group,
            self.interval_s, self.context.process_queue_key, immediate=True)
        runner.start()
        return True

    def stop(self, is_pipeline_removing: bool = False) -> bool:
        HostMonitorInputRunner.instance().unregister(self._registration())
        return True


class GPUCollector:
    """GPU utilisation/memory (reference host_monitor GPU collector via
    NVML), read from nvidia-smi when it is on the PATH: one sample of each
    metric a card, tagged with its index."""

    name = "gpu"

    def collect(self):
        out = []
        import shutil
        import subprocess
        smi = shutil.which("nvidia-smi")
        if smi:
            try:
                r = subprocess.run(
                    [smi, "--query-gpu=index,utilization.gpu,memory.used,"
                     "memory.total", "--format=csv,noheader,nounits"],
                    capture_output=True, timeout=5, text=True)
                for line in r.stdout.splitlines():
                    parts = [p.strip() for p in line.split(",")]
                    if len(parts) != 4:
                        continue
                    tags = {"gpu": parts[0]}
                    out.append(("gpu_utilization_percent",
                                float(parts[1]), tags))
                    out.append(("gpu_memory_used_mb", float(parts[2]), tags))
                    out.append(("gpu_memory_total_mb", float(parts[3]), tags))
            except (OSError, ValueError, subprocess.SubprocessError):
                pass
        return out


COLLECTORS: Dict[str, Callable] = {
    "cpu": CpuCollector,
    "mem": MemCollector,
    "disk": DiskCollector,
    "net": NetCollector,
    "system": SystemCollector,
    "process": ProcessCollector,
    "gpu": GPUCollector,
}


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


class HostMonitorInputRunner:
    _instance: Optional["HostMonitorInputRunner"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._registrations: Dict[str, tuple] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._wake = threading.Event()
        self._pushed: Dict[str, int] = {}
        self.process_queue_manager = None

    @classmethod
    def instance(cls) -> "HostMonitorInputRunner":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def register(self, name: str, collectors: List[str], interval_s: float,
                 queue_key: int) -> None:
        insts = [COLLECTORS[c]() for c in collectors if c in COLLECTORS]
        with self._lock:
            self._registrations[name] = (insts, interval_s, queue_key, [0.0])
            self._pushed[name] = 0

    def register_group_collector(self, name: str, fn, interval_s: float,
                                 queue_key: int,
                                 immediate: bool = False) -> None:
        """Schedule an arbitrary group-producing callable (entity snapshots
        etc.); fn() -> Optional[PipelineEventGroup]."""
        with self._lock:
            self._registrations[name] = (
                fn, interval_s, queue_key,
                [0.0 if immediate else time.monotonic()])
            self._pushed[name] = 0

    def unregister(self, name: str) -> None:
        with self._lock:
            self._registrations.pop(name, None)

    def groups_pushed(self, name: str) -> int:
        """Groups pushed for registration ``name`` since it registered
        (kept after it unregisters, for the drain)."""
        with self._lock:
            return self._pushed.get(name, 0)

    def push(self, name: str, queue_key: int, group) -> bool:
        """Push ``group`` for registration ``name``, counted before the
        push (a refused push is uncounted)."""
        pqm = self.process_queue_manager
        if pqm is None:
            return False
        with self._lock:
            self._pushed[name] = self._pushed.get(name, 0) + 1
        if pqm.push_queue(queue_key, group):
            return True
        with self._lock:
            self._pushed[name] -= 1
        return False

    def start(self) -> None:
        with self._lock:
            if self._running:
                return
            self._running = True
            self._wake.clear()
        self._thread = threading.Thread(target=self._run, name="host-monitor",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._lock:
            self._running = False
            thread, self._thread = self._thread, None
        self._wake.set()
        if thread is not None:
            thread.join(timeout=5)

    def _run(self) -> None:
        while self._running:
            self._wake.wait(0.2)
            if not self._running:
                return
            with self._lock:
                regs = dict(self._registrations)
            now = time.monotonic()
            for name, (insts, interval, queue_key, last) in regs.items():
                if now - last[0] < interval:
                    continue
                last[0] = now
                try:
                    if callable(insts):
                        group = insts()
                        if group is not None and not group.empty():
                            self.push(name, queue_key, group)
                    else:
                        self.collect_once(insts, queue_key, name)
                except Exception:  # noqa: BLE001
                    log.exception("host monitor collect failed: %s", name)

    def collect_once(self, insts, queue_key: int, name: str = "") -> None:
        group = PipelineEventGroup()
        sb = group.source_buffer
        ts = int(time.time())
        for coll in insts:
            for metric, value, tags in coll.collect():
                ev = group.add_metric_event(ts)
                ev.set_name(sb.copy_string(metric))
                ev.set_value(value)
                for k, v in tags.items():
                    ev.set_tag(sb.copy_string(k), sb.copy_string(v))
        if not group.empty():
            self.push(name, queue_key, group)


class HostMetaCollector:
    """Entity snapshots (reference InputHostMeta): one host entity plus one
    entity per running process, shaped as log events with entity fields."""

    name = "host_meta"

    def collect_entities(self):
        import socket
        entities = []
        host = {
            "__entity_type__": "host",
            "hostname": socket.gethostname(),
            "os": "linux",
        }
        try:
            with open("/proc/sys/kernel/osrelease") as f:
                host["kernel"] = f.read().strip()
        except OSError:
            pass
        entities.append(host)
        for pid in os.listdir("/proc"):
            if not pid.isdigit():
                continue
            try:
                with open(f"/proc/{pid}/comm") as f:
                    comm = f.read().strip()
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmdline = f.read().replace(b"\0", b" ").decode(
                        "utf-8", "replace").strip()
                st = os.stat(f"/proc/{pid}")
            except OSError:
                continue
            entities.append({
                "__entity_type__": "process",
                "pid": pid,
                "comm": comm,
                "cmdline": cmdline[:512],
                "uid": str(st.st_uid),
            })
        return entities


class InputHostMeta(_HostInput):
    """Periodic host/process entity snapshots, scheduled through the shared
    HostMonitorInputRunner (one timer thread for all host collectors)."""

    name = "input_host_meta"

    def __init__(self) -> None:
        super().__init__()
        self.interval_s = 300.0

    def init(self, config, context) -> bool:
        super().init(config, context)
        self.interval_s = float(config.get("IntervalSeconds", 300))
        return True

    def _build_group(self):
        group = PipelineEventGroup()
        sb = group.source_buffer
        ts = int(time.time())
        for entity in HostMetaCollector().collect_entities():
            ev = group.add_log_event(ts)
            for k, v in entity.items():
                ev.set_content(sb.copy_string(k), sb.copy_string(v))
        group.set_tag(b"__source__", b"host_meta")
        return group

    def collect_once(self) -> None:
        HostMonitorInputRunner.instance().push(
            self._registration(), self.context.process_queue_key,
            self._build_group())

    def _registration(self) -> str:
        return f"{self.context.pipeline_name}#hostmeta"

    def start(self, should_abort=lambda: False) -> bool:
        runner = HostMonitorInputRunner.instance()
        runner.register_group_collector(
            self._registration(), self._build_group,
            self.interval_s, self.context.process_queue_key, immediate=True)
        runner.start()
        return True

    def stop(self, is_pipeline_removing: bool = False) -> bool:
        HostMonitorInputRunner.instance().unregister(self._registration())
        return True


class InputHostMonitor(_HostInput):
    name = "input_host_monitor"

    def __init__(self) -> None:
        super().__init__()
        self.collectors: List[str] = []
        self.interval_s = 60.0

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.collectors = list(config.get(
            "Collectors", ["cpu", "mem", "disk", "net", "system"]))
        self.interval_s = float(config.get("IntervalSeconds", 60))
        return True

    def start(self, should_abort=lambda: False) -> bool:
        runner = HostMonitorInputRunner.instance()
        runner.register(self._registration(), self.collectors,
                        self.interval_s, self.context.process_queue_key)
        runner.start()
        return True

    def stop(self, is_pipeline_removing: bool = False) -> bool:
        HostMonitorInputRunner.instance().unregister(self._registration())
        return True

    def _registration(self) -> str:
        return self.context.pipeline_name
