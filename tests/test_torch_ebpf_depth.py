"""The port's process-tree cache and connection manager against the JAX
package's, on the CPU.

Each scenario of ``tests/test_ebpf_depth.py`` (``ProcessTreeCache``:
exec/clone/exit, ``(pid, ktime)`` identity, the exit grace, a parent ref
blocking expiry, ``attach_process_data``; ``ConnectionManager``: a span
with its latency, the error rollup, ``conn_close`` and ``conn_stats``,
the bounded pending queue and table) runs on both packages and returns
what it observed; the two must be equal, and the port's must hold what
the reference's test asserts.  A seeded ``testdata.ebpf_stream`` through
both connection managers gives equal spans and rollup cells, and those of
the generator.
"""

import time
import types

import pytest

from loongcollector_tpu import models as ref_models
from loongcollector_tpu.input.ebpf import adapter as ref_adapter
from loongcollector_tpu.input.ebpf import connections as ref_connections
from loongcollector_tpu.input.ebpf import proc_tree as ref_proc_tree
from loongcollector_tpu_torch import models
from loongcollector_tpu_torch.input.ebpf import adapter
from loongcollector_tpu_torch.input.ebpf import connections
from loongcollector_tpu_torch.input.ebpf import proc_tree
from loongcollector_tpu_torch.testdata import ebpf_stream
from test_torch_alarms import alarms_left_empty  # noqa: F401

PKGS = {
    "ref": types.SimpleNamespace(models=ref_models, adapter=ref_adapter,
                                 conn=ref_connections, tree=ref_proc_tree),
    "port": types.SimpleNamespace(models=models, adapter=adapter,
                                  conn=connections, tree=proc_tree),
}

REQ = b"GET /api/users HTTP/1.1\r\nHost: shop\r\n\r\n"
RESP_OK = b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nhi"
RESP_ERR = b"HTTP/1.1 500 Oops\r\nContent-Length: 0\r\n\r\n"


def _net(pkg, pid=100, fd=5, call="", payload=b"", ts=0,
         direction="ingress", ktime=111):
    ad = pkg.adapter
    return ad.RawKernelEvent(source=ad.EventSource.NETWORK_OBSERVE, pid=pid,
                             fd=fd, call_name=call, payload=payload,
                             timestamp_ns=ts, direction=direction,
                             ktime=ktime, local_addr="10.0.0.1:80",
                             remote_addr="10.9.9.9:555")


def _entry(ent):
    if ent is None:
        return None
    return (ent.pid, ent.ktime, ent.ppid, ent.comm, ent.binary, ent.args,
            ent.cwd, ent.container_id, ent.refcnt, bool(ent.exited_at),
            ent.exec_id, ent.parent.exec_id if ent.parent else None)


def _span(span):
    return (span.protocol, span.pid, span.ktime, span.local_addr,
            span.remote_addr, span.start_ns, span.end_ns, span.name,
            span.status, span.status_code, sorted(span.attributes.items()),
            span.latency_ns)


def _cells(roll):
    return {k: (c.count, c.errors, c.latency_sum_ns, c.latency_max_ns,
                c.rx_bytes, c.tx_bytes) for k, c in roll.items()}


# -- ProcessTreeCache ---------------------------------------------------------

def tree_exec_clone_exit(pkg, monkeypatch):
    t = pkg.tree.ProcessTreeCache()
    parent = t.on_execve(100, 10, ppid=1, comm="bash", binary="/bin/bash",
                         args="bash -l")
    child = t.on_clone(200, 20, ppid=100)
    out = [_entry(parent), _entry(child), child.parent is parent]
    execd = t.on_execve(200, 25, ppid=100, comm="curl",
                        binary="/usr/bin/curl", args="curl http://x")
    out += [_entry(execd), execd.parent is parent, _entry(t.lookup(200)),
            _entry(t.lookup(200, 20)), t.size()]
    assert child.comm == "bash" and parent.refcnt == 3
    assert t.lookup(200).comm == "curl" and t.lookup(200, 20).comm == "bash"
    return out


def tree_pid_ktime_identity(pkg, monkeypatch):
    t = pkg.tree.ProcessTreeCache()
    t.on_execve(300, 50, comm="old")
    t.on_execve(300, 90, comm="new")
    assert t.lookup(300, 50).comm == "old"
    assert t.lookup(300).comm == "new"
    return [_entry(t.lookup(300, 50)), _entry(t.lookup(300, 90)),
            _entry(t.lookup(300))]


def tree_exit_grace_and_expiry(pkg, monkeypatch):
    t = pkg.tree.ProcessTreeCache()
    t.on_execve(400, 1, comm="gone")
    t.on_exit(400, 1)
    inside = t.clear_expired()
    monkeypatch.setattr(pkg.tree, "EXIT_GRACE_S", 0.0)
    time.sleep(0.01)
    after = t.clear_expired()
    # a miss falls through to the /proc warm sync: pid 400 of no process
    # here, negative-cached
    monkeypatch.setattr(pkg.tree.ProcessTreeCache, "_proc_sync",
                        lambda self, pid: None)
    gone = t.lookup(400, 1)
    assert (inside, after, gone) == (0, 1, None)
    return [inside, after, gone, t.size(), t.misses]


def tree_parent_ref_blocks_expiry(pkg, monkeypatch):
    monkeypatch.setattr(pkg.tree, "EXIT_GRACE_S", 0.0)
    t = pkg.tree.ProcessTreeCache()
    t.on_execve(500, 1, comm="parent")
    t.on_clone(600, 2, ppid=500)
    t.on_exit(500, 1)
    time.sleep(0.01)
    kept = t.clear_expired()
    assert kept == 0 and t.lookup(500, 1).comm == "parent"
    return [kept, _entry(t.lookup(500, 1)), _entry(t.lookup(600, 2))]


def tree_attach_process_data(pkg, monkeypatch):
    t = pkg.tree.ProcessTreeCache()
    t.on_execve(700, 1, ppid=1, comm="bash", binary="/bin/bash",
                args="bash")
    t.on_execve(800, 2, ppid=700, comm="curl", binary="/usr/bin/curl",
                args="curl -s http://x", cwd="/home/u")
    sb = pkg.models.SourceBuffer()
    g = pkg.models.PipelineEventGroup(sb)
    ev = g.add_log_event(1)
    ok = t.attach_process_data(800, 2, ev, sb)
    contents = [(k.to_bytes(), v.to_bytes()) for k, v in ev.contents]
    assert ok and dict(contents)[b"exec_id"] == b"800:2"
    assert dict(contents)[b"parent_binary"] == b"/bin/bash"
    return [ok, contents]


def tree_shrink_and_reexec(pkg, monkeypatch):
    """Past ``max_entries`` the exited entries go first; re-inserting one
    ``(pid, ktime)`` releases the old entry's parent ref."""
    t = pkg.tree.ProcessTreeCache(max_entries=8)
    t.on_execve(1, 1, comm="init")
    for i in range(2, 12):
        t.on_execve(i, i, ppid=1, comm=f"p{i}")
        if i % 3 == 0:
            t.on_exit(i, i)
    t.on_execve(5, 5, ppid=1, comm="again")
    return [t.size(), sorted(k for k in t._by_id),
            _entry(t._latest.get(1)), _entry(t._latest.get(5))]


# -- ConnectionManager --------------------------------------------------------

def conn_span_with_latency(pkg, monkeypatch):
    cm = pkg.conn.ConnectionManager()
    cm.accept_ctrl(_net(pkg, call="conn_accept"))
    first = cm.accept_data(_net(pkg, payload=REQ, ts=1_000))
    span = cm.accept_data(_net(pkg, payload=RESP_OK, ts=6_000,
                               direction="egress"))
    assert first is None and span.latency_ns == 5_000
    assert span.name == "GET /api/users" and span.attributes["host"] == "shop"
    return [first, _span(span), [_span(s) for s in cm.take_spans()],
            _cells(cm.take_rollup())]


def conn_error_rollup(pkg, monkeypatch):
    cm = pkg.conn.ConnectionManager()
    cm.accept_ctrl(_net(pkg, call="conn_accept"))
    for i in range(3):
        cm.accept_data(_net(pkg, payload=REQ, ts=i * 100))
        cm.accept_data(_net(pkg, payload=RESP_ERR, ts=i * 100 + 40,
                            direction="egress"))
    roll = _cells(cm.take_rollup())
    assert roll == {("http", "10.9.9.9:555", "5xx"):
                    (3, 3, 120, 40, len(REQ) * 3, len(RESP_ERR) * 3)}
    return [roll, len(cm.take_spans())]


def conn_close_and_stats(pkg, monkeypatch):
    cm = pkg.conn.ConnectionManager()
    cm.accept_ctrl(_net(pkg, call="conn_connect"))
    ev = _net(pkg, call="conn_stats")
    ev.flags = (300 << 16) | 120
    cm.accept_stats(ev)
    conn = cm._conns[(100, 5)]
    out = [cm.connection_count(), conn.rx_bytes, conn.tx_bytes, conn.role]
    cm.accept_ctrl(_net(pkg, call="conn_close"))
    out.append(cm.connection_count())
    assert out == [1, 120, 300, "client", 0]
    return out


def conn_pending_bounded(pkg, monkeypatch):
    cm = pkg.conn.ConnectionManager()
    for i in range(pkg.conn.MAX_PENDING_REQS + 10):
        cm.accept_data(_net(pkg, payload=REQ, ts=i))
    conn = cm._conns[(100, 5)]
    span = cm.accept_data(_net(pkg, payload=RESP_OK, ts=10_000,
                               direction="egress"))
    assert len(conn.pending) == pkg.conn.MAX_PENDING_REQS - 1
    return [len(conn.pending), _span(span)]


def conn_table_bounded(pkg, monkeypatch):
    cm = pkg.conn.ConnectionManager(max_connections=4)
    for fd in range(8):
        cm.accept_ctrl(_net(pkg, fd=fd, call="conn_connect"))
    assert cm.connection_count() == 4 and cm.dropped_conns == 4
    return [cm.connection_count(), cm.dropped_conns, sorted(cm._conns)]


def conn_unmatched_and_sticky(pkg, monkeypatch):
    """A response with no request is an unmatched span; a payload of
    another protocol on an HTTP connection is ignored."""
    cm = pkg.conn.ConnectionManager()
    span = cm.accept_data(_net(pkg, payload=RESP_OK, ts=5))
    cm.accept_data(_net(pkg, payload=REQ, ts=6))
    other = cm.accept_data(_net(pkg, payload=b"+OK\r\n", ts=7))
    return [_span(span), other, cm.unmatched_responses,
            len(cm._conns[(100, 5)].pending)]


SCENARIOS = {f.__name__: f for f in (
    tree_exec_clone_exit, tree_pid_ktime_identity, tree_exit_grace_and_expiry,
    tree_parent_ref_blocks_expiry, tree_attach_process_data,
    tree_shrink_and_reexec, conn_span_with_latency, conn_error_rollup,
    conn_close_and_stats, conn_pending_bounded, conn_table_bounded,
    conn_unmatched_and_sticky)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_reference(name, monkeypatch):
    got = SCENARIOS[name](PKGS["port"], monkeypatch)
    want = SCENARIOS[name](PKGS["ref"], monkeypatch)
    assert got == want


@pytest.mark.parametrize("seed", [3, 4])
def test_stream_spans_and_cells(seed):
    """A seeded stream through both connection managers: equal spans and
    cells, and the generator's exchanges (name, status code, latency) and
    cells."""
    events, expected = ebpf_stream(seed, 900, n_procs=8, n_conns=24)
    out = {}
    for who, pkg in PKGS.items():
        ad = pkg.adapter
        cm = pkg.conn.ConnectionManager()
        for ev in events:
            if ev["source"] != "network_observe":
                continue
            raw = ad.RawKernelEvent(**dict(ev, source=ad.EventSource(
                ev["source"])))
            if raw.call_name:
                cm.accept_ctrl(raw)
            else:
                cm.accept_data(raw)
        out[who] = ([_span(s) for s in cm.take_spans()],
                    _cells(cm.take_rollup()), cm.connection_count())
    assert out["port"] == out["ref"]
    spans, cells, open_conns = out["port"]
    assert open_conns == 0
    assert sorted((s[7], s[9], s[11]) for s in spans) == expected["spans"]
    assert cells == {k: tuple(v.values())
                     for k, v in expected["cells"].items()}
