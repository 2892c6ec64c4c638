"""The port's flusher runner, circuit breaker and disk buffer held against
the JAX package's, through a scripted server on 127.0.0.1 that fails its
first N requests and then answers 200:

* with retries alone (a breaker that cannot trip), both runners deliver
  the same bodies in the same order from each queue (one transfer in
  flight a queue, the retry backoff long beside a round trip);
* with a breaker that trips, both deliver every body once, and their
  breakers make the same transitions (closed → open → half_open →
  closed); the port books spill and replay in balance;
* a spill file either package writes (encrypted, ``event_cnt`` in its
  header) replays through the other's ``DiskBufferWriter``, and a
  corrupted file is quarantined to ``.lcb.bad`` on both sides;
* an exit spill (``stop`` with the sink unreachable) replays on a new
  runner and delivers.

No test waits out the real backoff or cooldown: the retry constants are
patched as ``tests/test_chaos_soak.py:60-63`` does and the breakers get
cooldowns of 0.15 s; every server and runner is stopped by its fixture.
"""

import http.server
import json
import os
import threading
import time

import pytest

from loongcollector_tpu.monitor import ledger as ref_ledger
from loongcollector_tpu.pipeline.queue import limiter as ref_limiter
from loongcollector_tpu.pipeline.queue import sender_queue as ref_sq
from loongcollector_tpu.runner import circuit as ref_circuit
from loongcollector_tpu.runner import disk_buffer as ref_db
from loongcollector_tpu.runner import flusher_runner as ref_fr
from loongcollector_tpu.runner import http_sink as ref_hs
from loongcollector_tpu.utils import payload_crypto as ref_crypto
from loongcollector_tpu_torch.flusher import http as port_http
from loongcollector_tpu_torch.monitor import alarm_counts
from loongcollector_tpu_torch.monitor import ledger as port_ledger
from loongcollector_tpu_torch.pipeline.queue import limiter as port_limiter
from loongcollector_tpu_torch.pipeline.queue import sender_queue as port_sq
from loongcollector_tpu_torch.runner import circuit as port_circuit
from loongcollector_tpu_torch.runner import disk_buffer as port_db
from loongcollector_tpu_torch.runner import flusher_runner as port_fr
from loongcollector_tpu_torch.runner import http_sink as port_hs
from loongcollector_tpu_torch.utils import payload_crypto as port_crypto

SIDES = {
    "reference": dict(sq=ref_sq, limiter=ref_limiter, fr=ref_fr, hs=ref_hs,
                      db=ref_db, crypto=ref_crypto, circuit=ref_circuit),
    "port": dict(sq=port_sq, limiter=port_limiter, fr=port_fr, hs=port_hs,
                 db=port_db, crypto=port_crypto, circuit=port_circuit),
}


@pytest.fixture(autouse=True)
def short_backoff(monkeypatch):
    for fr in (ref_fr, port_fr):
        monkeypatch.setattr(fr, "RETRY_BASE_S", 0.02)
        monkeypatch.setattr(fr, "RETRY_MAX_S", 0.25)
    alarm_counts.reset()
    yield
    alive = [t.name for t in threading.enumerate()
             if t.name in ("flusher-runner", "flusher-retry")
             or t.name.startswith("http-sink")]
    # the reference's retry thread ends once its heap is empty
    deadline = time.monotonic() + 5
    while alive and time.monotonic() < deadline:
        time.sleep(0.02)
        alive = [t.name for t in threading.enumerate()
                 if t.name in ("flusher-runner", "flusher-retry")
                 or t.name.startswith("http-sink")]
    assert alive == []


class _Server:
    """Answers 503 to its first ``fail`` POSTs to each path, 200 after;
    keeps the bodies it answered 200, by path."""

    def __init__(self, fail):
        self.fail = fail
        self.seen = {}
        self.accepted = {}
        self.lock = threading.Lock()
        srv = self

        class H(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                with srv.lock:
                    srv.seen[self.path] = srv.seen.get(self.path, 0) + 1
                    ok = srv.seen[self.path] > srv.fail
                    if ok:
                        srv.accepted.setdefault(self.path, []).append(body)
                self.send_response(200 if ok else 503)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def url(self, path):
        return f"http://127.0.0.1:{self.httpd.server_port}{path}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5)


@pytest.fixture
def server_factory():
    made = []

    def make(fail):
        s = _Server(fail)
        made.append(s)
        return s

    yield make
    for s in made:
        s.stop()


class _Flusher:
    """The flusher surface the runner calls."""

    name = "flusher_http"

    def __init__(self, url, queue, pipeline="p", plugin_id="flusher_http/0"):
        self.url = url
        self.sender_queue = queue
        self.queue_key = queue.key
        self.pipeline = pipeline
        self.plugin_id = plugin_id

    def spill_identity(self):
        return {"pipeline": self.pipeline, "flusher_type": self.name,
                "plugin_id": self.plugin_id}

    def build_request(self, item):
        return port_http.HttpRequest("POST", self.url, {}, item.data,
                                     timeout=5.0)

    def on_send_done(self, item, status, body):
        if 200 <= status < 300:
            return "ok"
        return "retry" if status in (429, 500, 502, 503, 504) or \
            status <= 0 else "drop"


def _run(side, server, tmp_path, n_queues, n_items, threshold, fail_paths):
    m = SIDES[side]
    sqm = m["sq"].SenderQueueManager()
    sink = m["hs"].HttpSink()
    cipher = m["crypto"].PayloadCipher(str(tmp_path / f"{side}_key"))
    buf = m["db"].DiskBufferWriter(str(tmp_path / f"{side}_buffer"),
                                   cipher=cipher)
    runner = m["fr"].FlusherRunner(sqm, sink, disk_buffer=buf,
                                   breaker_failure_threshold=threshold,
                                   breaker_cooldown_s=0.15)
    flushers = []
    for k in range(n_queues):
        q = sqm.create_or_reuse_queue(100 + k, capacity=64,
                                      pipeline_name="p")
        q.concurrency_limiters = [m["limiter"].ConcurrencyLimiter(
            f"q{k}", max_concurrency=1)]
        flushers.append(_Flusher(server.url(f"/q{k}"), q,
                                 plugin_id=f"flusher_http/{k}"))
    sink.init()
    runner.init()
    try:
        for i in range(n_items):
            for k, f in enumerate(flushers):
                f.sender_queue.push(m["sq"].SenderQueueItem(
                    b"q%d-item%d" % (k, i), 9, flusher=f,
                    queue_key=f.queue_key, event_cnt=i + 1))
        want = n_queues * n_items
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if sum(len(v) for v in server.accepted.values()) >= want \
                    and sqm.all_empty():
                break
            time.sleep(0.02)
        breakers = [runner.breakers()[f.queue_key] for f in flushers]
        counts = [{k: v for k, v in br.metrics.snapshot()["counters"]
                   .items()} for br in breakers]
        return dict(server.accepted), counts, breakers, buf
    finally:
        runner.stop(drain=False)
        sink.stop()


def test_retries_deliver_same_bodies_in_same_order(server_factory,
                                                   tmp_path, monkeypatch):
    # the backoff (>= 0.5 s) dwarfs a round trip, so the order is the
    # queue's with the failed items after the rest
    for fr in (ref_fr, port_fr):
        monkeypatch.setattr(fr, "RETRY_BASE_S", 0.25)
    got = {}
    for side in ("reference", "port"):
        srv = server_factory(fail=3)
        got[side], counts, _, _ = _run(side, srv, tmp_path, 2, 4, 100,
                                       None)
        assert all(c["opened_total"] == 0 for c in counts)
    assert got["port"] == got["reference"]
    assert sum(len(v) for v in got["port"].values()) == 8


def test_breaker_trips_spills_and_recovers(server_factory, tmp_path):
    port_ledger.enable().reset()
    try:
        res = {}
        for side in ("reference", "port"):
            srv = server_factory(fail=6)
            res[side] = _run(side, srv, tmp_path, 1, 6, 3, None)
        snap = port_ledger.active_ledger().snapshot()
    finally:
        port_ledger.disable()
    for side, (accepted, counts, breakers, buf) in res.items():
        bodies = sorted(accepted["/q0"])
        assert bodies == sorted(b"q0-item%d" % i for i in range(6)), side
        assert counts[0]["opened_total"] >= 1
        assert counts[0]["reclosed_total"] == 1
        assert buf.pending() == []
    port_br = res["port"][2][0]
    t = port_br.transitions
    assert t[0] == "closed" and t[-1] == "closed" and "open" in t \
        and "half_open" in t
    assert t.count("open") == res["port"][1][0]["opened_total"]
    assert t.count("half_open") == res["port"][1][0]["probes_total"] \
        or t.count("half_open") <= res["port"][1][0]["probes_total"]
    assert res["port"][3].spilled >= 1
    assert res["port"][3].replayed == res["port"][3].spilled
    row = snap["p"]
    assert row["spill"]["events"] == row["replay"]["events"] > 0
    assert alarm_counts.counts().get("SINK_CIRCUIT_OPEN", 0) >= 1
    assert alarm_counts.counts().get("SEND_FAIL", 0) >= 1


class _Target:
    """A replay target: the flusher surface ``DiskBufferWriter.replay``
    resolves to."""

    def __init__(self, sq):
        self.sender_queue = sq.SenderQueue(1)
        self.queue_key = 1


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_spill_files_replay_across_packages(tmp_path, writer):
    reader = "port" if writer == "reference" else "reference"
    w, r = SIDES[writer], SIDES[reader]
    key = str(tmp_path / "spill_key")
    wbuf = w["db"].DiskBufferWriter(str(tmp_path / "buffer"),
                                    cipher=w["crypto"].PayloadCipher(key))
    ident = {"pipeline": "rollup", "flusher_type": "flusher_prometheus",
             "plugin_id": "flusher_prometheus/0"}
    payloads = [(b"payload-%d" % i * (i + 1), 100 + i, 7 * i)
                for i in range(4)]
    for data, raw, cnt in payloads:
        assert wbuf.spill(w["sq"].SenderQueueItem(data, raw, event_cnt=cnt),
                          ident)
    files = wbuf.pending()
    assert len(files) == 4 and all("/rollup/" in f for f in files)
    with open(files[0], "rb") as f:
        header = json.loads(f.readline())
    assert header["enc"] == "hmac-ctr-v1" and header["event_cnt"] == 0
    # corrupt one file's header: quarantined, not replayed
    with open(files[1], "r+b") as f:
        f.write(b"\x00garbage")
    rbuf = r["db"].DiskBufferWriter(str(tmp_path / "buffer"),
                                    cipher=r["crypto"].PayloadCipher(key))
    target = _Target(r["sq"])
    seen = []

    def resolve(identity):
        seen.append(identity)
        return target

    assert rbuf.replay(resolve) == 3
    got = [(i.data, i.raw_size, i.event_cnt)
           for i in target.sender_queue._items]
    assert got == [payloads[0], payloads[2], payloads[3]]
    assert seen[0]["plugin_id"] == "flusher_prometheus/0"
    assert rbuf.pending() == []
    assert [os.path.basename(p) for p in rbuf.quarantined()] == \
        [os.path.basename(files[1]) + ".bad"]
    if reader == "port":
        assert rbuf.quarantined_files == 1 and rbuf.replayed == 3
        assert alarm_counts.counts()["SECONDARY_READ_WRITE"] == 1


def test_exit_spill_replays_on_a_new_runner(server_factory, tmp_path):
    srv = server_factory(fail=0)
    key = str(tmp_path / "spill_key")

    def parts():
        sqm = port_sq.SenderQueueManager()
        q = sqm.create_or_reuse_queue(5, pipeline_name="p")
        buf = port_db.DiskBufferWriter(str(tmp_path / "buffer"),
                                       cipher=port_crypto.PayloadCipher(key))
        return sqm, q, buf

    # a runner that never dispatched: stop(drain) within no budget spills
    sqm, q, buf = parts()
    f = _Flusher(srv.url("/x"), q)
    runner = port_fr.FlusherRunner(sqm, None, disk_buffer=buf)
    for i in range(3):
        q.push(port_sq.SenderQueueItem(b"exit-%d" % i, 6, flusher=f,
                                       queue_key=5, event_cnt=1))
    runner.stop(drain=True, timeout=0.0)
    assert q.empty() and len(buf.pending()) == 3 and buf.spilled == 3
    # a new runner replays them through its flusher and delivers
    sqm, q, buf = parts()
    f = _Flusher(srv.url("/x"), q)
    sink = port_hs.HttpSink()
    runner = port_fr.FlusherRunner(sqm, sink, disk_buffer=buf)
    sink.init()
    runner.init()
    try:
        assert buf.replay(lambda ident: f) == 3
        deadline = time.monotonic() + 10
        while len(srv.accepted.get("/x", [])) < 3 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        runner.stop(drain=True, timeout=5.0)
        sink.stop()
    assert sorted(srv.accepted["/x"]) == [b"exit-0", b"exit-1", b"exit-2"]
    assert buf.pending() == [] and runner.send_stats()["status_counts"] == \
        {"200": 3}


def test_failure_after_stop_is_spilled_not_parked(tmp_path):
    """A transfer that fails once the runner stopped (the HTTP sink
    finishing its drain) is spilled at once; with no buffer it is a
    tagged drop."""
    for with_buffer in (True, False):
        sqm = port_sq.SenderQueueManager()
        q = sqm.create_or_reuse_queue(3, pipeline_name="p")
        buf = (port_db.DiskBufferWriter(str(tmp_path / f"b{with_buffer}"))
               if with_buffer else None)
        runner = port_fr.FlusherRunner(sqm, None, disk_buffer=buf)
        f = _Flusher("http://127.0.0.1:9/", q)
        item = port_sq.SenderQueueItem(b"late", 4, flusher=f, queue_key=3,
                                       event_cnt=2)
        q.push(item)
        q.get_available_items(1)
        item.in_flight = True           # dispatched: the exit spill skips it
        runner.stop(drain=False)
        runner._on_done(item, 503, b"")
        assert q.empty()
        if with_buffer:
            assert buf.spilled == 1
        else:
            assert runner.dropped == {"exit_undelivered": 1}
        assert runner._retry_thread is None


def test_concurrent_replays_push_each_file_once(tmp_path):
    """The application's loop and the flusher runner replay at once: the
    port's replays are serialized, so each file is pushed once (the JAX
    package's replay can push a file twice here)."""
    buf = port_db.DiskBufferWriter(str(tmp_path / "buffer"))
    ident = {"pipeline": "p", "flusher_type": "flusher_http",
             "plugin_id": "flusher_http/0"}
    for i in range(40):
        assert buf.spill(port_sq.SenderQueueItem(b"x%d" % i, 2), ident)
    target = _Target(port_sq)
    go = threading.Event()

    def replay():
        go.wait()
        buf.replay(lambda identity: target, limit=1000)

    threads = [threading.Thread(target=replay) for _ in range(4)]
    for t in threads:
        t.start()
    go.set()
    for t in threads:
        t.join(timeout=10)
    got = sorted(i.data for i in target.sender_queue._items)
    assert got == sorted(b"x%d" % i for i in range(40))
    assert buf.replayed == 40 and buf.pending() == []
