"""The port's eBPF server, its inputs and the agent's shutdown order,
against the JAX package on the CPU.

* The same ``RawKernelEvent`` stream (a seeded ``testdata.ebpf_stream``,
  and the flows of the reference's own tests) through both packages'
  ``EBPFServer`` with a ``MockAdapter`` gives equal groups: log, span and
  metric events, field for field, with ``time.time`` pinned in both
  (spans and rollup cells are stamped with it) and the timed flush held
  off, so only the 1,024-event threshold and the stop cut groups.  The
  network groups then go through both packages' ``processor_classify_url``
  (object groups: Python ``re``).
* ``NetworkObserverManager.build_group`` of the protocol corpora, the
  security and the CPU-profiling managers equal the reference's.
* The port registers the eBPF inputs and the classify and field
  processors under the reference's names, and its input-runner registry
  stops in the reference's order.
* ``application.run_configs`` stops the inputs before the final drain:
  events fed through a ``MockAdapter`` and not yet flushed when the stop
  begins reach the sink; the eBPF phase of ``chip_smoke.py`` at a small
  size, through the simulation driver, equals the generator's records.
"""

import collections
import json
import os
import time
import types

import pytest
import torch

from loongcollector_tpu.input.ebpf import adapter as ref_adapter
from loongcollector_tpu.input.ebpf import server as ref_server
from loongcollector_tpu.pipeline.plugin.interface import \
    PluginContext as RefContext
from loongcollector_tpu.pipeline.queue.process_queue_manager import \
    ProcessQueueManager as RefPQM
from loongcollector_tpu.processor.classify_url import \
    ProcessorClassifyUrl as RefClassify
from loongcollector_tpu_torch import application
from loongcollector_tpu_torch.input.ebpf import adapter
from loongcollector_tpu_torch.input.ebpf import server
from loongcollector_tpu_torch.input.file.file_server import FileServer
from loongcollector_tpu_torch.input.host_monitor import HostMonitorInputRunner
from loongcollector_tpu_torch.monitor.self_monitor import SelfMonitorServer
from loongcollector_tpu_torch.pipeline.plugin.interface import PluginContext
from loongcollector_tpu_torch.pipeline.plugin.registry import PluginRegistry
from loongcollector_tpu_torch.pipeline.queue.process_queue_manager import \
    ProcessQueueManager
from loongcollector_tpu_torch.processor.classify_url import \
    ProcessorClassifyUrl
from loongcollector_tpu_torch.runner import input_registry
from loongcollector_tpu_torch.testdata import (URL_RULES, ebpf_mismatches,
                                               ebpf_stream)
from test_torch_alarms import alarms_left_empty  # noqa: F401

NOW = 1_700_000_123.0
RULES = [{"Name": n, "Regex": r} for n, r in URL_RULES]

PKGS = {
    "ref": types.SimpleNamespace(adapter=ref_adapter, server=ref_server,
                                 PQM=RefPQM, Classify=RefClassify,
                                 ctx=lambda: RefContext()),
    "port": types.SimpleNamespace(
        adapter=adapter, server=server, PQM=ProcessQueueManager,
        Classify=ProcessorClassifyUrl,
        ctx=lambda: PluginContext("p", device=torch.device("cpu"))),
}


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    """``time.time`` pinned, the timed flush held off, and the port's
    singleton server and default adapter back as they were after."""
    monkeypatch.setattr(time, "time", lambda: NOW)
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.server, "FLUSH_INTERVAL_S", 1e9)
    monkeypatch.setattr(server.EBPFServer, "_instance", None)
    monkeypatch.setattr(adapter, "_default_adapter", None)
    yield
    inst = server.EBPFServer._instance
    if inst is not None:
        inst.stop()


def _canon(group):
    """A group's tags and events, field for field, in order."""
    evs = []
    for ev in group.events:
        kind = type(ev).__name__
        if kind == "LogEvent":
            evs.append((kind, ev.timestamp, [(k.to_bytes(), v.to_bytes())
                                             for k, v in ev.contents]))
        elif kind == "SpanEvent":
            evs.append((kind, ev.timestamp, ev.name, int(ev.kind),
                        ev.start_time_ns, ev.end_time_ns, int(ev.status),
                        sorted((k, v.to_bytes())
                               for k, v in ev.attributes.items())))
        else:
            evs.append((kind, ev.timestamp, ev.name.to_bytes(),
                        sorted(ev.value.values.items()),
                        sorted((k, v.to_bytes())
                               for k, v in ev.tags.items())))
    tags = sorted((k, v.to_bytes()) for k, v in group.tags.items())
    return tags, evs


def _run_server(pkg, events):
    """The events through a fresh server of ``pkg`` (MockAdapter, process
    security on queue 1, the network observer on 2), stopped; the groups
    of each queue, the network ones classified."""
    ad = pkg.adapter
    mock = ad.MockAdapter()
    srv = pkg.server.EBPFServer()
    srv.adapter = mock
    pqm = pkg.PQM()
    for key in (1, 2, 3):
        pqm.create_or_reuse_queue(key, capacity=1000)
    srv.process_queue_manager = pqm
    srcs = {ad.EventSource.PROCESS_SECURITY: 1,
            ad.EventSource.NETWORK_OBSERVE: 2,
            ad.EventSource.CPU_PROFILING: 3}
    for source, key in srcs.items():
        assert srv.enable_plugin(source, key)
    try:
        for ev in events:
            assert mock.feed(ad.RawKernelEvent(**dict(
                ev, source=ad.EventSource(ev["source"]))))
    finally:
        srv.stop()
    proc = pkg.Classify()
    assert proc.init({"SourceKey": "path", "TargetKey": "category",
                      "Rules": RULES}, pkg.ctx())
    out = collections.defaultdict(list)
    while True:
        item = pqm.pop_item(timeout=0)
        if item is None:
            break
        key, group = item
        if key == 2:
            proc.process(group)
        out[key].append(_canon(group))
    return dict(out)


@pytest.mark.parametrize("seed", [5, 6])
def test_stream_groups_equal_reference(seed):
    events, _ = ebpf_stream(seed, 1500, n_procs=12, n_conns=40)
    got = _run_server(PKGS["port"], events)
    want = _run_server(PKGS["ref"], events)
    assert got == want
    assert len(got[2]) == 3            # 3000 payload events: 1024s + stop
    assert sum(len(evs) for _t, evs in got[1]) == 12


def _ref_flows():
    """The events of the reference's own server tests
    (``tests/test_ebpf_forward.py``, ``tests/test_ebpf_depth.py``)."""
    def net(call="", payload=b"", ts=0, direction="ingress"):
        return dict(source="network_observe", pid=100, fd=5,
                    call_name=call, payload=payload, timestamp_ns=ts,
                    direction=direction, ktime=111,
                    local_addr="10.0.0.1:80", remote_addr="10.9.9.9:555")
    return [
        dict(source="network_observe", pid=1, local_addr="10.0.0.1:80",
             remote_addr="10.9.9.9:5555", direction="ingress",
             payload=b"GET /checkout HTTP/1.1\r\nHost: shop\r\n\r\n"),
        dict(source="process_security", pid=4000, ppid=1, ktime=77,
             call_name="sys_execve", path="/usr/bin/nginx",
             payload=b"nginx -g daemon off;"),
        dict(source="process_security", pid=4000, ktime=77,
             call_name="security_capable"),
        dict(source="process_security", pid=4001, ppid=4000, ktime=78,
             call_name="sys_clone"),
        dict(source="process_security", pid=4001, ktime=78,
             call_name="sys_exit"),
        net(call="conn_accept"),
        net(payload=b"GET /api/users HTTP/1.1\r\nHost: shop\r\n\r\n",
            ts=10_000),
        net(payload=b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nhi",
            ts=90_000, direction="egress"),
        dict(source="cpu_profiling", pid=4000, stack=["main", "loop"]),
        dict(source="cpu_profiling", pid=4000, stack=["main", "loop"]),
        dict(source="cpu_profiling", pid=1, stack=["idle"]),
    ]


def test_reference_flows_equal_reference():
    got = _run_server(PKGS["port"], _ref_flows())
    want = _run_server(PKGS["ref"], _ref_flows())
    assert got == want
    (_tags, evs), = got[2]
    kinds = collections.Counter(e[0] for e in evs)
    assert kinds == {"LogEvent": 3, "SpanEvent": 1, "MetricEvent": 1}
    span = next(e for e in evs if e[0] == "SpanEvent")
    assert span[2] == b"GET /api/users" and span[5] - span[4] == 80_000
    (_t, prof), = got[3]
    assert sorted(dict(e[2])[b"count"] for e in prof) == [b"1", b"2"]


_SQL = b"select * from users limit 5"
CORPUS = [bytes([1 + len(_SQL), 0, 0, 0, 0x03]) + _SQL,
          b"*3\r\n$3\r\nSET\r\n$5\r\nmykey\r\n$5\r\nhello\r\n",
          b"GET /x HTTP/1.1\r\nHost: h\r\n\r\n",
          b"HTTP/1.1 404 Not Found\r\nContent-Length: 9\r\n\r\nnot found",
          bytes([0x17, 0, 0, 1, 0xFF, 0x28, 0x04]) + b"#42S02Table 'x'",
          bytes([0x01, 0, 0, 1, 0x03]), b"-ERR unknown command 'FOO'\r\n",
          b"+OK\r\n", b"some random log text"]


@pytest.mark.parametrize("who", ["network", "security", "cpu"])
def test_build_group_equals_reference(who):
    out = {}
    for name, pkg in PKGS.items():
        ad, S = pkg.adapter, pkg.adapter.EventSource
        srv = pkg.server.EBPFServer()
        srv.adapter = ad.MockAdapter()
        if who == "network":
            mgr = pkg.server.NetworkObserverManager(S.NETWORK_OBSERVE, srv)
            evs = [ad.RawKernelEvent(source=S.NETWORK_OBSERVE, pid=1,
                                     timestamp_ns=10**9, payload=p,
                                     local_addr="1.1.1.1:1",
                                     remote_addr="2.2.2.2:2",
                                     direction="egress") for p in CORPUS]
        elif who == "security":
            mgr = pkg.server.SecurityManager(S.FILE_SECURITY, srv)
            srv.proc_tree.on_execve(77, 5, ppid=1, comm="sh",
                                    binary="/bin/sh", args="sh -c x")
            evs = [ad.RawKernelEvent(source=S.FILE_SECURITY, pid=77,
                                     ktime=5, call_name="security_file_open",
                                     path=f"/etc/f{i}",
                                     remote_addr="9.9.9.9:1" if i else "")
                   for i in range(3)]
        else:
            mgr = pkg.server.CpuProfilingManager(S.CPU_PROFILING, srv)
            evs = [ad.RawKernelEvent(source=S.CPU_PROFILING, pid=1 + i % 2,
                                     stack=["a", "b"][: 1 + i % 3])
                   for i in range(7)]
        out[name] = _canon(mgr.build_group(evs))
    assert out["port"] == out["ref"]
    assert out["port"][1]


def test_plugin_names_registered():
    reg = PluginRegistry.instance()
    reg.load_static_plugins()
    for name in ("input_network_observer", "input_process_security",
                 "input_file_security", "input_network_security",
                 "input_cpu_profiling"):
        inp = reg.create_input(name)
        assert isinstance(inp, server._EBPFInputBase) and inp.name == name
    for name in ("processor_classify_url_tpu",
                 "processor_classify_url_native", "processor_add_fields",
                 "processor_rename", "processor_drop",
                 "processor_strreplace"):
        assert reg.create_processor(name) is not None, name


def test_input_registry_stops_in_order(monkeypatch):
    monkeypatch.setattr(input_registry.InputRunnerRegistry, "_entries", {})
    input_registry.register_builtin_runners()
    stopped = []

    class Runner:
        process_queue_manager = None

        def __init__(self, name):
            self.name = name

        def stop(self):
            stopped.append(self.name)

        def halt(self):
            stopped.append(self.name + ".halt")
    late, early = Runner("late"), Runner("early")
    reg = input_registry.InputRunnerRegistry
    reg.register("late", lambda: late, stop_method="halt", stop_order=60)
    reg.register("early", lambda: early, stop_order=10)
    # the self-monitor server stops at the reference's 10, the host
    # monitor at 20, the file server (tail mode's file input) at 60
    assert [e.name for e in reg.entries()] == [
        "self_monitor", "early", "host_monitor", "ebpf", "file_server",
        "late"]
    assert reg.entries()[0].instance == SelfMonitorServer.instance
    assert reg.entries()[2].instance == HostMonitorInputRunner.instance
    assert reg.entries()[3].instance == server.EBPFServer.instance
    assert reg.entries()[4].instance == FileServer.instance
    pqm = ProcessQueueManager()
    try:
        reg.wire_all(pqm)
        assert late.process_queue_manager is pqm
        assert server.EBPFServer.instance().process_queue_manager is pqm
        assert FileServer.instance().process_queue_manager is pqm
        assert SelfMonitorServer.instance().process_queue_manager is pqm
        assert HostMonitorInputRunner.instance().process_queue_manager \
            is pqm
        reg.stop_all()
        assert stopped == ["early", "late.halt"]
    finally:
        FileServer.reset_for_testing()
        SelfMonitorServer._instance = None
        HostMonitorInputRunner._instance = None


def _configs(tmp_path):
    return [
        ("sec", {"inputs": [{"Type": "input_process_security"}],
                 "flushers": [{"Type": "flusher_file",
                               "FilePath": str(tmp_path / "sec.ndjson")}]}),
        ("net", {"inputs": [{"Type": "input_network_observer"}],
                 "processors": [{"Type": "processor_classify_url_tpu",
                                 "SourceKey": "path",
                                 "TargetKey": "category",
                                 "DefaultCategory": "other",
                                 "Rules": RULES}],
                 "flushers": [{"Type": "flusher_file",
                               "FilePath": str(tmp_path / "net.ndjson")}]}),
    ]


def _records(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_stop_flushes_held_events_before_the_drain(tmp_path):
    """Fewer events than a flush takes, fed through a MockAdapter: no group
    has been pushed when the stop begins, and every event still reaches
    the sink, classified."""
    mock = adapter.MockAdapter()
    server.EBPFServer.instance().adapter = mock
    events, expected = ebpf_stream(11, 200, n_procs=4, n_conns=8)
    held = []

    def feed():
        for ev in events:
            assert mock.feed(adapter.RawKernelEvent(**dict(
                ev, source=adapter.EventSource(ev["source"]))))
        mgrs = server.EBPFServer.instance()._managers
        held.append(sum(m.groups_pushed for m in mgrs.values()))
        held.append(sum(len(m._pending) for m in mgrs.values()))

    st = application.run_configs(_configs(tmp_path), torch.device("cpu"),
                                 feed=feed,
                                 data_dir=str(tmp_path / "port_data"))
    # every event but the 8 connections' connect and close is held
    assert held == [0, len(events) - 16]
    assert st["ebpf"]["inputs"] == {
        "input_process_security": {"groups_pushed": 1, "groups_dropped": 0},
        "input_network_observer": {"groups_pushed": 1, "groups_dropped": 0}}
    assert st["classify"]["re_rows"] == sum(expected["http_paths"].values())
    bad = ebpf_mismatches(_records(tmp_path / "net.ndjson"),
                          _records(tmp_path / "sec.ndjson"), expected)
    assert bad == []
    assert server.EBPFServer.instance()._managers == {}


def test_driver_phase_small(tmp_path):
    """The eBPF phase of ``chip_smoke.py`` at a small size on the CPU: the
    simulation driver loaded explicitly, every injected event delivered,
    and the records those of the generator."""
    if not os.path.exists(adapter.default_driver_path()):
        pytest.skip("the simulation driver is not built")
    drv = adapter.SoAdapter(adapter.default_driver_path())
    server.EBPFServer.instance().adapter = drv
    events, expected = ebpf_stream(12, 3000, n_procs=16, n_conns=48)

    def feed():
        for i, ev in enumerate(events):
            assert drv.feed(adapter.RawKernelEvent(**dict(
                ev, source=adapter.EventSource(ev["source"]))))
        deadline = time.monotonic() + 60
        while drv.delivered + drv.callback_errors < len(events) \
                and time.monotonic() < deadline:
            time.sleep(0.002)

    st = application.run_configs(_configs(tmp_path), torch.device("cpu"),
                                 feed=feed,
                                 data_dir=str(tmp_path / "port_data"))
    assert (drv.delivered, drv.callback_errors) == (len(events), 0)
    assert st["ebpf"]["delivered"] == len(events)
    n_req = sum(expected["http_paths"].values())
    assert st["classify"]["re_rows"] == n_req
    assert all(v["groups_dropped"] == 0
               for v in st["ebpf"]["inputs"].values())
    bad = ebpf_mismatches(_records(tmp_path / "net.ndjson"),
                          _records(tmp_path / "sec.ndjson"), expected)
    assert bad == []
