"""The port's event-loop HttpSink (``runner/http_sink.py``) through the
seven cases of the JAX package's ``tests/test_http_sink_loop.py``: a
round trip, a stalled destination that does not starve a live one,
keep-alive reuse, a chunked body, a stale keep-alive connection
recovered, a truncated chunked body as an error, and status 0 on a
refused connection.  Every server binds 127.0.0.1:0 and is stopped by its
fixture; no thread of the sink or of a server outlives its test.
"""

import http.server
import socket
import threading
import time

import pytest

from loongcollector_tpu_torch.runner.http_sink import HttpSink


class _Req:
    def __init__(self, url, method="POST", headers=None, body=b"x",
                 timeout=10.0):
        self.url = url
        self.method = method
        self.headers = headers or {}
        self.body = body
        self.timeout = timeout


@pytest.fixture
def sink():
    s = HttpSink(workers=2)
    s.init()
    yield s
    s.stop()
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("http-sink")]
    assert alive == []


@pytest.fixture
def serve():
    """serve(handler_cls) -> server on 127.0.0.1:0; all stopped after."""
    started = []

    def start(handler):
        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
        srv.daemon_threads = True
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        started.append((srv, t))
        return srv

    yield start
    for srv, t in started:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=5)


@pytest.fixture
def raw_socket():
    socks = []

    def make():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        return s

    yield make
    for s in socks:
        s.close()


def _ok_handler():
    class H(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        connections = set()

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            self.rfile.read(n)
            H.connections.add(self.client_address)
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, *a):
            pass
    return H


def _wait(cond, seconds):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)


def test_basic_roundtrip(sink, serve):
    srv = serve(_ok_handler())
    done = []
    sink.add_request(_Req(f"http://127.0.0.1:{srv.server_port}/"),
                     lambda st, body: done.append((st, body)))
    _wait(lambda: done, 5)
    assert done == [(200, b"ok")]


def test_stalled_destination_does_not_starve_live_ones(sink, serve,
                                                       raw_socket):
    stall = raw_socket()
    stall.listen(16)
    stall_port = stall.getsockname()[1]
    srv = serve(_ok_handler())
    stalled_done, live_done = [], []
    for _ in range(4):
        sink.add_request(_Req(f"http://127.0.0.1:{stall_port}/", timeout=30),
                         lambda st, b: stalled_done.append(st))
    t0 = time.monotonic()
    for _ in range(20):
        sink.add_request(_Req(f"http://127.0.0.1:{srv.server_port}/"),
                         lambda st, b: live_done.append(st))
    _wait(lambda: len(live_done) >= 20, 5)
    elapsed = time.monotonic() - t0
    assert len(live_done) == 20, (live_done, stalled_done)
    assert all(st == 200 for st in live_done)
    assert elapsed < 5.0
    assert stalled_done == []
    stall.close()              # the stalled transfers end now, with status 0
    _wait(lambda: len(stalled_done) >= 4, 10)
    assert stalled_done == [0, 0, 0, 0]


def test_keepalive_reuse(sink, serve):
    H = _ok_handler()
    srv = serve(H)
    done = []
    for _ in range(3):
        want = len(done) + 1
        sink.add_request(_Req(f"http://127.0.0.1:{srv.server_port}/"),
                         lambda st, b: done.append(st))
        _wait(lambda: len(done) >= want, 5)
    assert done == [200, 200, 200]
    assert len(H.connections) == 1, H.connections


def test_chunked_response(sink, serve):
    class H(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(200)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for part in (b"hello ", b"chunked ", b"world"):
                self.wfile.write(b"%x\r\n%s\r\n" % (len(part), part))
            self.wfile.write(b"0\r\n\r\n")

        def log_message(self, *a):
            pass

    srv = serve(H)
    done = []
    sink.add_request(_Req(f"http://127.0.0.1:{srv.server_port}/"),
                     lambda st, b: done.append((st, b)))
    _wait(lambda: done, 5)
    assert done == [(200, b"hello chunked world")]


def test_stale_keepalive_recovery(sink, serve):
    class H(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, *a):
            pass

    srv = serve(H)
    done = []
    for _ in range(3):
        want = len(done) + 1
        sink.add_request(_Req(f"http://127.0.0.1:{srv.server_port}/"),
                         lambda st, b: done.append(st))
        _wait(lambda: len(done) >= want, 5)
    assert done == [200, 200, 200]


def test_truncated_chunked_body_is_an_error(sink, raw_socket):
    srv = raw_socket()
    srv.listen(4)
    port = srv.getsockname()[1]

    def run():
        conn, _ = srv.accept()
        conn.recv(65536)
        conn.sendall(b"HTTP/1.1 200 OK\r\n"
                     b"Transfer-Encoding: chunked\r\n\r\n"
                     b"5\r\nhello\r\n")
        conn.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    done = []
    sink.add_request(_Req(f"http://127.0.0.1:{port}/", timeout=5),
                     lambda st, b: done.append((st, b)))
    _wait(lambda: done, 8)
    t.join(timeout=5)
    assert done and done[0][0] == 0, done


def test_error_status_zero_on_refused(sink):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    done = []
    sink.add_request(_Req(f"http://127.0.0.1:{port}/", timeout=3),
                     lambda st, b: done.append((st, b)))
    _wait(lambda: done, 6)
    assert done and done[0][0] == 0
