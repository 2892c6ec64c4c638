"""HttpSink: the network dispatch thread — a curl_multi-class event loop.

Reference: core/runner/sink/http/HttpSink.cpp — ONE dedicated thread around
a curl_multi event loop (:91,124) drives every in-flight transfer for every
flusher concurrently; completed responses dispatch back to the flusher's
OnSendDone, decrement in-flight counts and feed queues.

This implementation is the same shape on stdlib asyncio: a single event-loop
thread multiplexes all connections (TLS included), with

  * per-destination persistent connection pools (keep-alive reuse),
  * per-destination in-flight caps — a stalled or slow destination queues
    only its OWN transfers and can never starve other sinks (the failure
    mode of the previous worker-pool design: N slow requests = dead sink),
  * stale keep-alive defense: idle pooled connections that received FIN/EOF
    while parked are discarded at acquire time (reader.at_eof()), and a
    write failure on a reused connection retries once on a fresh one —
    a completed send is NEVER retried here (duplication is the flusher's
    call, same contract as before),
  * method-preserving redirects (307/308) followed a few hops — Doris
    stream-load answers every FE request with a 307 to a BE,
  * completion callbacks run on a separate dispatcher thread so a slow
    OnSendDone cannot stall network progress.

Public contract unchanged: init()/stop()/add_request(request, on_done)/
pending(); on_done(status, body) with status 0 ⇒ network error.

The port's copy of the JAX package's ``runner/http_sink.py``, without its
chaos point.  ``stop()`` joins both of its threads.
"""

from __future__ import annotations

import asyncio
import queue as _queue
import ssl
import threading
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import urlparse

from ..utils.logger import get_logger

log = get_logger("http_sink")

_MAX_REDIRECTS = 3


class _Dest:
    """Per-destination state: connection pool + concurrency gate."""

    __slots__ = ("sem", "idle")

    def __init__(self, limit: int):
        self.sem = asyncio.Semaphore(limit)
        self.idle: List[Tuple[asyncio.StreamReader, asyncio.StreamWriter]] = []


class HttpSink:
    def __init__(self, workers: int = 4):
        # `workers` is kept from the pool-era API; it now bounds PER-DEST
        # concurrent transfers (the event loop itself has no thread limit)
        self.per_dest = max(1, workers)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._cb_queue: _queue.Queue = _queue.Queue()
        self._cb_thread: Optional[threading.Thread] = None
        self._running = False
        self._pending = 0
        self._pending_lock = threading.Lock()
        self._dests: Dict[Tuple[str, str, int], _Dest] = {}
        self._ssl_ctx = ssl.create_default_context()

    # ------------------------------------------------------------- lifecycle

    def init(self) -> None:
        self._running = True
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run_loop,
                                        name="http-sink", daemon=True)
        self._thread.start()
        self._cb_thread = threading.Thread(target=self._run_callbacks,
                                           name="http-sink-cb", daemon=True)
        self._cb_thread.start()

    def stop(self) -> None:
        self._running = False
        loop = self._loop
        if loop is not None:
            # drain first: in-flight transfers get a grace window to finish
            # (FlusherRunner's exit-spill skips in_flight items on the
            # expectation that their pending send may yet succeed) — only
            # stragglers are cancelled
            try:
                fut = asyncio.run_coroutine_threadsafe(
                    self._drain(5.0), loop)
                fut.result(timeout=8)
            except Exception as e:  # noqa: BLE001 — loop may already be closing
                log.warning("http sink drain interrupted at stop: %r", e)
            loop.call_soon_threadsafe(self._shutdown_loop)
            if self._thread is not None:
                self._thread.join(timeout=5)
        self._cb_queue.put(None)
        if self._cb_thread is not None:
            self._cb_thread.join(timeout=5)
        self._thread = None
        self._cb_thread = None
        self._loop = None

    def add_request(self, request,
                    on_done: Callable[[int, bytes], None]) -> None:
        """request: flusher.HttpRequest; on_done(status, body) runs on the
        callback-dispatch thread (status 0 ⇒ network error)."""
        loop = self._loop
        if loop is None or not self._running:
            self._cb_queue.put((on_done, 0, b"http sink not running"))
            return
        with self._pending_lock:
            self._pending += 1
        try:
            loop.call_soon_threadsafe(
                lambda: loop.create_task(self._transfer(request, on_done)))
        except RuntimeError:  # loop already closed (stop race)
            self._complete(on_done, 0, b"http sink stopped")

    def pending(self) -> int:
        return self._pending

    # ------------------------------------------------------------ loop guts

    def _run_loop(self) -> None:
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_forever()
        finally:
            try:
                self._loop.close()
            except Exception:  # noqa: BLE001
                pass

    async def _drain(self, timeout: float) -> None:
        tasks = [t for t in asyncio.all_tasks()
                 if t is not asyncio.current_task()]
        if tasks:
            await asyncio.wait(tasks, timeout=timeout)

    def _shutdown_loop(self) -> None:
        for task in asyncio.all_tasks(self._loop):
            task.cancel()
        for dest in self._dests.values():
            for _, writer in dest.idle:
                try:
                    writer.close()
                except Exception:  # noqa: BLE001
                    pass
            dest.idle.clear()
        self._loop.call_soon(self._loop.stop)

    def _run_callbacks(self) -> None:
        while True:
            item = self._cb_queue.get()
            if item is None:
                return
            on_done, status, body = item
            try:
                on_done(status, body)
            except Exception:  # noqa: BLE001
                log.exception("on_done callback failed")

    def _complete(self, on_done, status: int, body: bytes) -> None:
        with self._pending_lock:
            self._pending -= 1
        self._cb_queue.put((on_done, status, body))

    # -------------------------------------------------------- HTTP/1.1 client

    async def _transfer(self, request, on_done) -> None:
        status, body = 0, b""
        try:
            url = request.url
            for _ in range(_MAX_REDIRECTS):
                status, body, location = await self._execute_once(url, request)
                if status in (307, 308) and location:
                    url = location
                    continue
                break
        except asyncio.CancelledError:
            body = b"http sink stopped"
        except Exception as e:  # noqa: BLE001 — transfer must never escape
            status, body = 0, repr(e).encode()
        self._complete(on_done, status, body)

    def _dest(self, key: Tuple[str, str, int]) -> _Dest:
        dest = self._dests.get(key)
        if dest is None:
            dest = self._dests[key] = _Dest(self.per_dest)
        return dest

    async def _execute_once(self, url: str, request):
        try:
            u = urlparse(url)
            host = u.hostname or ""
            port = u.port or (443 if u.scheme == "https" else 80)
            path = u.path or "/"
            if u.query:
                path += "?" + u.query
        except ValueError as e:
            return 0, str(e).encode(), None
        key = (u.scheme, host, port)
        dest = self._dest(key)
        async with dest.sem:
            # one reconnect retry, ONLY when the SEND on a kept-alive
            # connection failed (server closed it — the keep-alive race;
            # nothing was processed).  A failure after the request went out
            # must NOT re-send: the server may have ingested the batch.
            for attempt in (0, 1):
                reused = True
                sent = False
                reader = writer = None
                try:
                    # the keep-alive retry (attempt 1) must use a FRESH
                    # connection — a second stale idle one would waste the
                    # one retry the no-resend-after-send rule allows
                    got = self._pop_idle(dest) if attempt == 0 else None
                    if got is None:
                        reused = False
                        reader, writer = await asyncio.wait_for(
                            asyncio.open_connection(
                                host, port,
                                ssl=self._ssl_ctx
                                if u.scheme == "https" else None),
                            timeout=request.timeout)
                    else:
                        reader, writer = got
                    head = self._request_head(u, host, port, path, request)
                    writer.write(head)
                    if request.body:
                        writer.write(request.body)
                    await asyncio.wait_for(writer.drain(),
                                           timeout=request.timeout)
                    sent = True
                    status, body, location, will_close = \
                        await asyncio.wait_for(
                            self._read_response(reader, request.method),
                            timeout=request.timeout)
                    if will_close:
                        writer.close()
                    else:
                        dest.idle.append((reader, writer))
                    return status, body, location
                except Exception as e:  # noqa: BLE001 transport = retryable
                    if writer is not None:
                        try:
                            writer.close()
                        except Exception:  # noqa: BLE001
                            pass
                    if not reused or sent or attempt == 1:
                        return 0, repr(e).encode(), None

    def _pop_idle(self, dest: _Dest):
        """Reuse a parked connection, discarding any that died while idle
        (EOF/FIN arrives asynchronously — at_eof() sees it without a read)."""
        while dest.idle:
            reader, writer = dest.idle.pop()
            if reader.at_eof() or writer.is_closing():
                try:
                    writer.close()
                except Exception:  # noqa: BLE001
                    pass
                continue
            return reader, writer
        return None

    @staticmethod
    def _request_head(u, host: str, port: int, path: str, request) -> bytes:
        default_port = 443 if u.scheme == "https" else 80
        host_hdr = host if port == default_port else f"{host}:{port}"
        lines = [f"{request.method} {path} HTTP/1.1",
                 f"Host: {host_hdr}"]
        hdrs = {k.lower(): (k, v) for k, v in (request.headers or {}).items()}
        if "host" in hdrs:
            lines[1] = f"Host: {hdrs.pop('host')[1]}"
        if "content-length" not in hdrs and request.method not in ("GET",
                                                                  "HEAD"):
            body_len = len(request.body) if request.body else 0
            lines.append(f"Content-Length: {body_len}")
        if "connection" not in hdrs:
            lines.append("Connection: keep-alive")
        for k, v in hdrs.values():
            lines.append(f"{k}: {v}")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    @staticmethod
    async def _read_response(reader: asyncio.StreamReader, method: str):
        # absorb interim 1xx responses (Early Hints, 100-continue echoes):
        # they are NOT the final response — returning one would desync the
        # kept-alive connection (http.client did this absorption too)
        for _ in range(8):
            status_line = await reader.readline()
            if not status_line:
                raise ConnectionResetError("EOF before status line")
            parts = status_line.split(None, 2)
            status = int(parts[1])
            headers: Dict[bytes, bytes] = {}
            while True:
                line = await reader.readline()
                if not line:
                    raise ConnectionResetError("EOF inside response headers")
                if line in (b"\r\n", b"\n"):
                    break
                k, _, v = line.partition(b":")
                headers[k.strip().lower()] = v.strip()
            if status >= 200 or status == 101:   # 101 upgrade = final here
                break
        te = headers.get(b"transfer-encoding", b"").lower()
        clen = headers.get(b"content-length")
        body = b""
        has_len = False
        if method == "HEAD" or status in (204, 304) or status < 200:
            has_len = True
        elif b"chunked" in te:
            has_len = True
            chunks = []
            while True:
                size_line = await reader.readline()
                if not size_line:
                    # EOF mid-stream is NOT the terminal chunk — a silently
                    # truncated body must never return as success
                    raise ConnectionResetError("EOF inside chunked body")
                size = int(size_line.split(b";")[0].strip() or b"0", 16)
                if size == 0:
                    while True:  # trailers
                        t = await reader.readline()
                        if not t:
                            raise ConnectionResetError(
                                "EOF inside chunked trailers")
                        if t in (b"\r\n", b"\n"):
                            break
                    break
                chunks.append(await reader.readexactly(size))
                await reader.readexactly(2)  # chunk CRLF
            body = b"".join(chunks)
        elif clen is not None:
            has_len = True
            body = await reader.readexactly(int(clen))
        else:
            body = await reader.read()  # until EOF (HTTP/1.0-style)
        conn_hdr = headers.get(b"connection", b"").lower()
        will_close = (conn_hdr == b"close"
                      or status_line.startswith(b"HTTP/1.0")
                      or not has_len)
        location_b = headers.get(b"location")
        location = location_b.decode("latin-1") if location_b else None
        return status, body, location, will_close
