"""The port's host monitor (``input/host_monitor.py``) against the JAX
package's, on the CPU: each collector is fed the same captured ``/proc``
text and the same ``nvidia-smi`` output, by patching ``open``, ``os``,
``time`` and ``socket`` in each package's module namespace (and
``shutil.which`` / ``subprocess.run``, which the GPU collector imports
where it runs); nothing of the JAX package changes.

* ``cpu`` (two reads: the first primes, the second gives the shares),
  ``mem``, ``disk`` (``/dev/`` mounts, and the root volume when it is not
  one), ``net`` (rates over one clock), ``system``, ``process`` (top-N,
  entity tags), ``gpu`` (``nvidia-smi`` present, absent, failing): the
  same samples;
* ``ProcessEntityCollector``'s entity and link events, ``input_host_meta``'s
  entities, and the runner's metric groups: the same groups;
* the port's runner counts the groups it pushed for each registration
  (what its inputs report as ``groups_pushed``), a refused push is
  uncounted, and ``stop`` joins its thread at once.
"""

import os
import subprocess
import time
import types

import pytest

from loongcollector_tpu.input import host_monitor as ref_hm
from loongcollector_tpu_torch.input import host_monitor as port_hm
from test_torch_alarms import alarms_left_empty  # noqa: F401
from test_torch_extensions import _dump

SIDES = {"reference": ref_hm, "port": port_hm}

PROC = {
    "/proc/stat": "cpu  1000 20 300 4000 50 0 10 0 0 0\n"
                  "cpu0 500 10 150 2000 25 0 5 0 0 0\nbtime 1700000000\n",
    "/proc/meminfo": "MemTotal:       16384000 kB\n"
                     "MemFree:         1000000 kB\n"
                     "MemAvailable:    8192000 kB\nBuffers: 1 kB\n",
    "/proc/mounts": "/dev/sda1 /boot ext4 rw 0 0\n"
                    "overlay / overlay rw 0 0\n"
                    "/dev/sdb1 /data xfs rw 0 0\n"
                    "/dev/sdb1 /data xfs rw 0 0\n"
                    "tmpfs /tmp tmpfs rw 0 0\n",
    "/proc/net/dev": "Inter-|   Receive\n face |bytes packets\n"
                     "    lo: 1000 10 0 0 0 0 0 0 1000 10 0 0 0 0 0 0\n"
                     "  eth0: 50000 70 0 0 0 0 0 0 9000 20 0 0 0 0 0 0\n",
    "/proc/uptime": "12345.67 99999.00\n",
    "/proc/sys/kernel/osrelease": "6.1.0-test\n",
}
PIDS = {
    "1": ("(init) S 0 1 1 0 -1 4194560 1 0 0 0 50 30 0 0 20 0 1 0 10 "
          "1000 200", b"/sbin/init\0", "init", 0, 4),
    "42": ("(my app) R 1 42 42 0 -1 4194560 1 0 0 0 900 100 0 0 20 0 8 0 "
           "5000 9000 3000", b"python3\0app.py\0--port\0808\0", "my app",
           1000, 12),
    "77": ("(w) S 42 77 42 0 -1 4194560 1 0 0 0 5 5 0 0 20 0 2 0 6000 "
           "100 50", b"", "w", 1000, 3),
    "99": ("(gone", b"", "gone", 0, 0),      # a torn stat line: skipped
}
for _pid, (_stat, _cmd, _comm, _uid, _nfd) in PIDS.items():
    PROC[f"/proc/{_pid}/stat"] = f"{_pid} {_stat}\n"
    PROC[f"/proc/{_pid}/cmdline"] = _cmd
    PROC[f"/proc/{_pid}/comm"] = _comm + "\n"

SMI = "0, 37, 1024, 81559\n1, 0, 0, 81559\nbad line\n"


class _FS:
    """The captured host: ``open`` and an ``os`` with the calls the
    collectors make, over ``PROC``."""

    def __init__(self, proc):
        self.proc = dict(proc)

    def open(self, path, mode="r", *args, **kwargs):
        import io
        data = self.proc.get(path)
        if data is None:
            raise FileNotFoundError(path)
        if "b" in mode:
            return io.BytesIO(data if isinstance(data, bytes)
                              else data.encode())
        return io.StringIO(data if isinstance(data, str) else data.decode())

    def os(self):
        fs = self

        def listdir(path):
            if path == "/proc":
                return sorted(PIDS) + ["self", "net", "sys"]
            if path.startswith("/proc/") and path.endswith("/fd"):
                pid = path.split("/")[2]
                if pid in PIDS:
                    return [str(i) for i in range(PIDS[pid][4])]
            raise FileNotFoundError(path)

        def stat(path):
            pid = path.rsplit("/", 1)[-1]
            if pid not in PIDS:
                raise FileNotFoundError(path)
            return types.SimpleNamespace(st_uid=PIDS[pid][3])

        def readlink(path):
            pid, what = path.split("/")[2:4]
            if pid == "77":
                raise PermissionError(path)
            return {"cwd": f"/srv/{pid}", "exe": f"/usr/bin/p{pid}"}[what]

        def statvfs(path):
            if path == "/boot":
                raise OSError(path)
            blocks = {"/": 1000, "/data": 5000}.get(path, 0)
            return types.SimpleNamespace(f_blocks=blocks, f_frsize=4096,
                                         f_bavail=blocks // 4)

        def sysconf(name):
            return {"SC_PAGE_SIZE": 4096, "SC_CLK_TCK": 100}[name]

        ns = types.SimpleNamespace(**{k: getattr(os, k) for k in dir(os)
                                      if not k.startswith("__")})
        ns.listdir, ns.stat, ns.readlink = listdir, stat, readlink
        ns.statvfs, ns.sysconf = statvfs, sysconf
        ns.getloadavg = lambda: (0.5, 0.25, 0.125)
        fs._os = ns
        return ns


class _Clock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t

    def time(self):
        return 1700000100.0

    def sleep(self, s):
        self.t += s


@pytest.fixture
def host(monkeypatch):
    """Both modules on one captured host and one clock; returns the
    filesystem (tests edit ``fs.proc``) and the clock."""
    fs, clock = _FS(PROC), _Clock()
    for mod in SIDES.values():
        monkeypatch.setattr(mod, "open", fs.open, raising=False)
        monkeypatch.setattr(mod, "os", fs.os())
        monkeypatch.setattr(mod, "time", clock)
    import socket
    monkeypatch.setattr(socket, "gethostname", lambda: "node-7")
    return fs, clock


def _both(fn):
    return {side: fn(mod) for side, mod in SIDES.items()}


@pytest.mark.parametrize("name", ["mem", "disk", "system", "process"])
def test_one_read_collectors_equal(host, name):
    got = _both(lambda m: m.COLLECTORS[name]().collect())
    assert got["port"] == got["reference"]
    assert got["port"]


def test_disk_reports_the_root_volume_and_each_dev_mount_once(host):
    got = port_hm.DiskCollector().collect()
    mounts = [t["mount"] for n, _, t in got if n == "disk_total_bytes"]
    assert mounts == ["/data", "/"]


def test_process_top_n_and_tags(host):
    got = _both(lambda m: m.ProcessCollector(top_n=2).collect())
    assert got["port"] == got["reference"]
    pids = [t["pid"] for n, _, t in got["port"] if n == "process_cpu_ticks"]
    assert pids == ["42", "1"]
    tags = next(t for _, _, t in got["port"] if t["pid"] == "42")
    assert tags["cmdline"] == "python3 app.py --port 808"
    assert tags["uid"] == "1000" and tags["comm"] == "my app"


def test_cpu_and_net_deltas_equal(host):
    fs, clock = host
    colls = _both(lambda m: (m.CpuCollector(), m.NetCollector()))
    first = {s: [c.collect() for c in cs] for s, cs in colls.items()}
    assert first["port"] == first["reference"] == [[], []]
    fs.proc["/proc/stat"] = ("cpu  1100 20 350 4200 50 0 30 0 0 0\n"
                             "btime 1700000000\n")
    fs.proc["/proc/net/dev"] = PROC["/proc/net/dev"].replace(
        "50000", "90000").replace("9000 20", "13000 20")
    clock.t += 2.0
    second = {s: [c.collect() for c in cs] for s, cs in colls.items()}
    assert second["port"] == second["reference"]
    cpu, net = second["port"]
    assert dict((n, v) for n, v, _ in cpu)["cpu_user_percent"] == 100 * 100 \
        / 370
    rates = {(n, t["interface"]): v for n, v, t in net}
    assert rates[("net_rx_bytes_per_sec", "eth0")] == 20000.0
    assert rates[("net_tx_bytes_per_sec", "eth0")] == 2000.0


@pytest.mark.parametrize("smi", ["present", "absent", "failing"])
def test_gpu_collector_reads_nvidia_smi(monkeypatch, smi):
    import shutil
    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        if smi == "failing":
            raise subprocess.TimeoutExpired(cmd, 5)
        return subprocess.CompletedProcess(cmd, 0, stdout=SMI, stderr="")
    monkeypatch.setattr(shutil, "which", lambda name: None if smi == "absent"
                        else f"/usr/bin/{name}")
    monkeypatch.setattr(subprocess, "run", run)
    got = _both(lambda m: m.GPUCollector().collect())
    assert got["port"] == got["reference"]
    if smi == "present":
        assert ("gpu_memory_total_mb", 81559.0, {"gpu": "0"}) in got["port"]
        assert len(got["port"]) == 6
        assert calls[0][1:] == ["--query-gpu=index,utilization.gpu,"
                                "memory.used,memory.total",
                                "--format=csv,noheader,nounits"]
    else:
        assert got["port"] == []


def test_process_entities_equal(host):
    fs, clock = host
    colls = _both(lambda m: m.ProcessEntityCollector(top_n=2, interval_s=5))
    first = {s: _dump([c.collect_group()]) for s, c in colls.items()}
    assert first["port"] == first["reference"]
    fs.proc["/proc/77/stat"] = "77 " + PIDS["77"][0].replace(
        " 5 5 0 0", " 905 5 0 0") + "\n"
    second = {s: _dump([c.collect_group()]) for s, c in colls.items()}
    assert second["port"] == second["reference"]
    (tags, events), = second["port"]
    assert (b"__source__", b"process_entity") in tags
    pids = [dict(c)[b"pid"] for _, _, c in events if (b"pid", b"77") in c
            or (b"pid", b"42") in c]
    # between the two reads pid 77 used the most CPU, then pid 42
    assert pids == [b"77", b"42"]
    assert len(events) == 4                 # an entity and a link each


def test_host_meta_entities_equal(host):
    got = _both(lambda m: m.HostMetaCollector().collect_entities())
    assert got["port"] == got["reference"]
    assert got["port"][0] == {"__entity_type__": "host",
                              "hostname": "node-7", "os": "linux",
                              "kernel": "6.1.0-test"}
    groups = {}
    for side, mod in SIDES.items():
        inp = mod.InputHostMeta()
        groups[side] = _dump([inp._build_group()])
    assert groups["port"] == groups["reference"]


class _PQM:
    def __init__(self, accept=True):
        self.groups = []
        self.accept = accept

    def push_queue(self, key, group):
        if not self.accept:
            return False
        self.groups.append((key, group))
        return True


def test_runner_metric_groups_equal(host):
    got = {}
    for side, mod in SIDES.items():
        runner = mod.HostMonitorInputRunner()
        runner.process_queue_manager = _PQM()
        insts = [mod.COLLECTORS[c]() for c in ("mem", "system", "disk")]
        if side == "port":
            runner.collect_once(insts, 3, "p")
            assert runner.groups_pushed("p") == 1
        else:
            runner.collect_once(insts, 3)
        got[side] = [(k, _dump([g])) for k, g in
                     runner.process_queue_manager.groups]
    assert got["port"] == got["reference"]
    assert got["port"][0][0] == 3


def test_port_runner_counts_pushes_and_stops_at_once():
    runner = port_hm.HostMonitorInputRunner()
    pqm = runner.process_queue_manager = _PQM()
    group = port_hm.PipelineEventGroup()
    group.add_log_event(1)
    runner.register_group_collector("p#e", lambda: group, 0.01, 5,
                                    immediate=True)
    runner.start()
    try:
        deadline = time.monotonic() + 10
        while runner.groups_pushed("p#e") < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        t0 = time.monotonic()
        runner.stop()
    assert time.monotonic() - t0 < 1.0
    assert runner._thread is None
    assert runner.groups_pushed("p#e") == len(pqm.groups)
    runner.unregister("p#e")
    assert runner.groups_pushed("p#e") == len(pqm.groups)
    pqm.accept = False
    assert not runner.push("p#e", 5, group)
    assert runner.groups_pushed("p#e") == len(pqm.groups)


def test_inputs_report_their_registration_pushes():
    from loongcollector_tpu_torch.pipeline.plugin.interface import \
        PluginContext
    ctx = PluginContext("pipe", process_queue_key=9)
    runner = port_hm.HostMonitorInputRunner.instance()
    for cls, cfg, reg in (
            (port_hm.InputHostMonitor, {"Collectors": ["mem"]}, "pipe"),
            (port_hm.InputProcessEntity, {"IntervalSeconds": 1},
             "pipe#process_entity"),
            (port_hm.InputHostMeta, {}, "pipe#hostmeta")):
        inp = cls()
        assert inp.init(cfg, ctx)
        assert inp.groups_pushed == 0
        with runner._lock:
            runner._pushed[reg] = 3
        assert inp.groups_pushed == 3
        with runner._lock:
            runner._pushed.pop(reg)
