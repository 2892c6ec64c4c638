"""Connection tracking + L7 request/response aggregation.

Reference: loongcollector_tpu/input/ebpf/connections.py, after
core/ebpf/plugin/network_observer/ConnectionManager.cpp (conn table keyed
by the kernel's connection id, fed by ctrl/data/stats events, bounded
size, idle GC via Iterations()) and NetworkObserverManager.cpp (pairs
request/response records per connection, converts them to spans, logs and
APP-level rollup metrics).

Mapping onto the v2 driver ABI: NETWORK_OBSERVE events with call_name
`conn_connect` / `conn_accept` / `conn_close` are control events,
`conn_stats` carries byte counters in flags, and payload-bearing events
are data events.  The manager:

* tracks per-(pid, fd) connection state (tuple, role, byte counters);
* sniffs L7 protocol per connection (sticky once detected);
* matches each response to the oldest outstanding request (FIFO — HTTP/1.x
  and the RESP/MySQL protocols answer in order) → one SPAN-shaped record
  with latency;
* aggregates rollup metrics per (protocol, remote, status-class):
  request count, error count, latency sum/max, bytes in/out — the
  observer's metrics stream.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from .protocol_http import parse_http
from .protocol_mysql import parse_mysql
from .protocol_redis import parse_redis

MAX_CONNECTIONS = 5000           # reference ConnectionManager default
MAX_PENDING_REQS = 64            # per-connection outstanding requests
IDLE_CLOSE_S = 120.0


def sniff_l7(payload: bytes):
    """Protocol detection order mirrors the reference's protocol matrix
    (core/ebpf/protocol/): HTTP (self-describing first line), then RESP
    (typed first byte), then MySQL (length-framed packets)."""
    rec = parse_http(payload)
    if rec is not None:
        return "http", rec
    rec = parse_redis(payload)
    if rec is not None:
        return "redis", rec
    rec = parse_mysql(payload)
    if rec is not None:
        return "mysql", rec
    return "raw", None


@dataclass
class L7Span:
    """One matched request/response exchange."""

    protocol: str
    pid: int
    ktime: int
    local_addr: str
    remote_addr: str
    start_ns: int
    end_ns: int
    name: str = ""           # http: METHOD path; redis/mysql: command
    status: str = "ok"       # ok / error
    status_code: str = ""    # http status / mysql error code
    attributes: Dict[str, str] = field(default_factory=dict)

    @property
    def latency_ns(self) -> int:
        return max(0, self.end_ns - self.start_ns)


@dataclass
class _Conn:
    pid: int
    fd: int
    ktime: int = 0
    local_addr: str = ""
    remote_addr: str = ""
    role: str = ""                   # client (connect) / server (accept)
    protocol: str = ""               # sticky after first successful sniff
    rx_bytes: int = 0
    tx_bytes: int = 0
    reported_rx: int = 0      # bytes already credited to a rollup cell
    reported_tx: int = 0
    last_seen: float = 0.0
    pending: Deque[Tuple[int, object, str]] = field(default_factory=deque)
    # (start_ns, request record, name)


class ConnStats:
    """Rollup metric cell (reference app-level metrics)."""

    __slots__ = ("count", "errors", "latency_sum_ns", "latency_max_ns",
                 "rx_bytes", "tx_bytes")

    def __init__(self) -> None:
        self.count = 0
        self.errors = 0
        self.latency_sum_ns = 0
        self.latency_max_ns = 0
        self.rx_bytes = 0
        self.tx_bytes = 0


class ConnectionManager:
    def __init__(self, max_connections: int = MAX_CONNECTIONS):
        self.max_connections = max_connections
        self._conns: Dict[Tuple[int, int], _Conn] = {}
        self._lock = threading.Lock()
        self._spans: List[L7Span] = []
        self._rollup: Dict[Tuple[str, str, str], ConnStats] = {}
        self.dropped_conns = 0
        self.unmatched_responses = 0

    # -- event intake -------------------------------------------------------

    def accept_ctrl(self, raw) -> None:
        """conn_connect / conn_accept / conn_close control events."""
        key = (raw.pid, raw.fd)
        with self._lock:
            if raw.call_name == "conn_close":
                self._conns.pop(key, None)
                return
            conn = self._conns.get(key)
            if conn is None:
                conn = self._new_conn_locked(raw)
            conn.role = ("server" if raw.call_name == "conn_accept"
                         else "client")
            conn.local_addr = raw.local_addr or conn.local_addr
            conn.remote_addr = raw.remote_addr or conn.remote_addr
            conn.last_seen = time.monotonic()

    def accept_stats(self, raw) -> None:
        """conn_stats: flags carries rx bytes, fd-adjacent counter in
        payload_len-free events; tx in the high half when present."""
        key = (raw.pid, raw.fd)
        with self._lock:
            conn = self._conns.get(key)
            if conn is None:
                conn = self._new_conn_locked(raw)
            rx = raw.flags & 0xFFFF
            tx = (raw.flags >> 16) & 0xFFFF
            conn.rx_bytes += rx
            conn.tx_bytes += tx
            conn.last_seen = time.monotonic()

    def accept_data(self, raw, proto: str = "",
                    rec=None) -> Optional[L7Span]:
        """Payload-bearing data event: match request/response, emit a span
        when an exchange completes.  The caller may pass an already-sniffed
        (proto, rec) so the payload is parsed exactly once per event."""
        key = (raw.pid, raw.fd)
        with self._lock:
            conn = self._conns.get(key)
            if conn is None:
                conn = self._new_conn_locked(raw)
            conn.last_seen = time.monotonic()
            if raw.local_addr:
                conn.local_addr = raw.local_addr
            if raw.remote_addr:
                conn.remote_addr = raw.remote_addr
            if raw.direction == "ingress":
                conn.rx_bytes += len(raw.payload)
            else:
                conn.tx_bytes += len(raw.payload)

            if rec is None:
                proto, rec = sniff_l7(raw.payload)
            if rec is None:
                return None
            if not conn.protocol:
                conn.protocol = proto
            elif proto != conn.protocol:
                # mid-stream continuation bytes can sniff differently;
                # the connection's protocol is sticky
                return None

            if rec.kind == "request":
                if len(conn.pending) >= MAX_PENDING_REQS:
                    conn.pending.popleft()   # shed oldest: bounded state
                name = self._request_name(proto, rec)
                conn.pending.append((raw.timestamp_ns, rec, name))
                return None

            # response: match the oldest outstanding request (in-order
            # protocols), or record an unmatched response
            if conn.pending:
                start_ns, req, name = conn.pending.popleft()
            else:
                self.unmatched_responses += 1
                start_ns, req, name = raw.timestamp_ns, None, ""
            span = self._build_span(conn, proto, req, rec, name,
                                    start_ns, raw.timestamp_ns, raw.ktime)
            self._spans.append(span)
            self._record_rollup(conn, span)
            return span

    # -- drain --------------------------------------------------------------

    def take_spans(self) -> List[L7Span]:
        with self._lock:
            spans, self._spans = self._spans, []
        return spans

    def take_rollup(self) -> Dict[Tuple[str, str, str], ConnStats]:
        with self._lock:
            roll, self._rollup = self._rollup, {}
        return roll

    def iterations(self) -> None:
        """Periodic GC (reference ConnectionManager::Iterations): drop idle
        connections so a leaky driver can't grow the table unbounded."""
        now = time.monotonic()
        with self._lock:
            for key, conn in list(self._conns.items()):
                if now - conn.last_seen > IDLE_CLOSE_S:
                    del self._conns[key]

    def connection_count(self) -> int:
        with self._lock:
            return len(self._conns)

    # -- internals ----------------------------------------------------------

    def _new_conn_locked(self, raw) -> _Conn:
        if len(self._conns) >= self.max_connections:
            # drop the least-recently-seen connection (bounded table)
            victim = min(self._conns.items(),
                         key=lambda kv: kv[1].last_seen)[0]
            del self._conns[victim]
            # connection-table eviction, not an event discard: no events
            # ride the evicted _Conn
            self.dropped_conns += 1
        conn = _Conn(pid=raw.pid, fd=raw.fd, ktime=raw.ktime,
                     local_addr=raw.local_addr, remote_addr=raw.remote_addr,
                     last_seen=time.monotonic())
        self._conns[(raw.pid, raw.fd)] = conn
        return conn

    @staticmethod
    def _request_name(proto: str, rec) -> str:
        if proto == "http":
            return (rec.method.decode("utf-8", "replace") + " "
                    + rec.path.decode("utf-8", "replace"))
        cmd = getattr(rec, "command", b"") or b""
        if isinstance(cmd, bytes):
            cmd = cmd.decode("utf-8", "replace")
        return cmd

    def _build_span(self, conn: _Conn, proto: str, req, resp, name: str,
                    start_ns: int, end_ns: int, ktime: int) -> L7Span:
        status = "ok"
        code = ""
        attrs: Dict[str, str] = {}
        if proto == "http":
            code = str(resp.status)
            if resp.status >= 400:
                status = "error"
            if req is not None and req.host:
                attrs["host"] = req.host.decode("utf-8", "replace")
        elif proto == "redis":
            if getattr(resp, "error", b""):
                status = "error"
                attrs["error"] = resp.error.decode("utf-8", "replace")
        elif proto == "mysql":
            if getattr(resp, "error_code", 0):
                status = "error"
                code = str(resp.error_code)
                attrs["error"] = resp.error_message.decode(
                    "utf-8", "replace") if isinstance(
                        resp.error_message, bytes) else str(
                        resp.error_message)
            if req is not None and getattr(req, "sql", b""):
                sql = req.sql
                attrs["sql"] = (sql.decode("utf-8", "replace")
                                if isinstance(sql, bytes) else str(sql))
        return L7Span(protocol=proto, pid=conn.pid, ktime=ktime or conn.ktime,
                      local_addr=conn.local_addr,
                      remote_addr=conn.remote_addr, start_ns=start_ns,
                      end_ns=end_ns, name=name, status=status,
                      status_code=code, attributes=attrs)

    def _record_rollup(self, conn: _Conn, span: L7Span) -> None:
        key = (span.protocol, conn.remote_addr,
               span.status_code[:1] + "xx" if span.status_code else
               span.status)
        cell = self._rollup.get(key)
        if cell is None:
            cell = self._rollup[key] = ConnStats()
        cell.count += 1
        if span.status == "error":
            cell.errors += 1
        cell.latency_sum_ns += span.latency_ns
        cell.latency_max_ns = max(cell.latency_max_ns, span.latency_ns)
        # credit only the bytes since this connection last reported, so
        # concurrent connections accumulate instead of overwriting and a
        # long-lived connection is never double-counted across flushes
        cell.rx_bytes += conn.rx_bytes - conn.reported_rx
        cell.tx_bytes += conn.tx_bytes - conn.reported_tx
        conn.reported_rx = conn.rx_bytes
        conn.reported_tx = conn.tx_bytes
