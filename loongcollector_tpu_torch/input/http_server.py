"""input_http_server — generic HTTP ingestion endpoint (+ OTLP/HTTP logs).

Reference: plugins/input/httpserver/input_http_server.go (generic HTTP
ingest with per-format decoders) and plugins/input/opentelemetry (OTLP
receiver). One threaded HTTP server per input instance; bodies may be
gzip/deflate-encoded.

Formats:
  * raw    — each non-empty line becomes one event ("content")
  * json   — one JSON object, or an array of objects → one event each
  * ndjson — one JSON object per line
  * influx — Influx line protocol → multi-value MetricEvents (telegraf)
  * statsd — (dog)statsd lines → MetricEvents
  * otlp   — ExportLogsServiceRequest JSON (resourceLogs→scopeLogs→
             logRecords); InputOTLP presets this and the /v1/logs path

The port's copy of the JAX package's ``input/http_server.py``: the same
formats, encodings, ``Decoder`` extension, answers (200, 400 for a body
that does not decode, 429 when the process queue refuses) and
``__source__`` tag.  ``start`` takes the port's ``should_abort`` and
returns once the server listens; the input counts the groups it pushed
(``groups_pushed``, counted before each push so the drain never sees a
settled group its input has not counted).
"""

from __future__ import annotations

import gzip
import http.server
import json
import threading
import time
import zlib
from typing import Any, Dict, Optional

from ..models import PipelineEventGroup
from ..pipeline.plugin.interface import Input, PluginContext
from ..utils.logger import get_logger

log = get_logger("http_server")


def _decode_body(headers, body: bytes) -> bytes:
    enc = (headers.get("Content-Encoding") or "").lower()
    if enc == "gzip":
        return gzip.decompress(body)
    if enc == "deflate":
        try:
            return zlib.decompress(body)
        except zlib.error:
            return zlib.decompress(body, -zlib.MAX_WBITS)  # raw deflate
    return body


def _obj_event(group: PipelineEventGroup, obj: Dict[str, Any],
               ts: int) -> None:
    sb = group.source_buffer
    ev = group.add_log_event(int(obj.get("__time__", ts)))
    for k, v in obj.items():
        if k == "__time__":
            continue
        val = v if isinstance(v, str) else json.dumps(v, ensure_ascii=False)
        ev.set_content(sb.copy_string(str(k).encode()),
                       sb.copy_string(val.encode()))


def parse_body(fmt: str, body: bytes, group: PipelineEventGroup) -> int:
    """Decoded body → events in `group`; returns the event count."""
    now = int(time.time())
    sb = group.source_buffer
    n = 0
    if fmt == "raw":
        for line in body.splitlines():
            if line:
                ev = group.add_log_event(now)
                ev.set_content(b"content", sb.copy_string(line))
                n += 1
    elif fmt == "json":
        data = json.loads(body)
        for obj in (data if isinstance(data, list) else [data]):
            _obj_event(group, obj, now)
            n += 1
    elif fmt == "ndjson":
        for line in body.splitlines():
            if line.strip():
                _obj_event(group, json.loads(line), now)
                n += 1
    elif fmt == "otlp":
        data = json.loads(body)
        for rl in data.get("resourceLogs", []):
            rattrs = {a["key"]: _attr_val(a.get("value", {}))
                      for a in rl.get("resource", {}).get("attributes", [])}
            for sl in rl.get("scopeLogs", []):
                for rec in sl.get("logRecords", []):
                    ev = group.add_log_event(
                        int(int(rec.get("timeUnixNano", 0)) // 1_000_000_000)
                        or now)
                    body_v = rec.get("body", {})
                    ev.set_content(b"content", sb.copy_string(
                        str(_attr_val(body_v)).encode()))
                    sev = rec.get("severityText")
                    if sev:
                        ev.set_content(b"severity",
                                       sb.copy_string(sev.encode()))
                    for a in rec.get("attributes", []):
                        ev.set_content(
                            sb.copy_string(a["key"].encode()),
                            sb.copy_string(
                                str(_attr_val(a.get("value", {}))).encode()))
                    for k, v in rattrs.items():
                        ev.set_content(sb.copy_string(f"resource.{k}".encode()),
                                       sb.copy_string(str(v).encode()))
                    n += 1
    elif fmt in ("influx", "influxdb"):
        from .metric_protocols import parse_influx_lines
        n = parse_influx_lines(body, group)
    elif fmt == "statsd":
        from .metric_protocols import parse_statsd_packet
        n = parse_statsd_packet(body, group)
    else:
        raise ValueError(f"unknown format {fmt!r}")
    return n


def _attr_val(v: Dict[str, Any]):
    for key in ("stringValue", "intValue", "doubleValue", "boolValue"):
        if key in v:
            return v[key]
    return json.dumps(v, ensure_ascii=False) if v else ""


class InputHTTPServer(Input):
    name = "input_http_server"
    default_format = "json"
    default_address = "0.0.0.0:12345"

    read_seconds = 0.0

    def __init__(self) -> None:
        super().__init__()
        self._server: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._pushed = 0

    @property
    def groups_pushed(self) -> int:
        with self._lock:
            return self._pushed

    def _push(self, pqm, group: PipelineEventGroup) -> bool:
        with self._lock:
            self._pushed += 1
        if pqm.push_queue(self.context.process_queue_key, group):
            return True
        with self._lock:
            self._pushed -= 1
        return False

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.fmt = (config.get("Format") or self.default_format).lower()
        self.address = config.get("Address", self.default_address)
        # a decoder EXTENSION ref (reference ext_default_decoder) overrides
        # the built-in Format parsing
        dec_ref = config.get("Decoder")
        self._decoder_ext = (context.get_extension(str(dec_ref))
                             if dec_ref else None)
        if dec_ref and self._decoder_ext is None:
            return False
        host, sep, port = self.address.rpartition(":")
        if not sep or not port.isdigit():
            log.error("%s Address must be host:port, got %r",
                      self.name, self.address)
            return False
        self._host, self._port = host, int(port)
        return self.fmt in ("raw", "json", "ndjson", "otlp",
                            "influx", "influxdb", "statsd")

    def start(self, should_abort=lambda: False) -> bool:
        inp = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                try:
                    body = _decode_body(self.headers, body)
                    if inp._decoder_ext is not None:
                        groups = inp._decoder_ext.decode(body, self.headers)
                        count = sum(len(g) for g in groups)
                        group = groups[0] if groups else PipelineEventGroup()
                    else:
                        group = PipelineEventGroup()
                        count = parse_body(inp.fmt, body, group)
                        groups = [group]
                except Exception as e:  # noqa: BLE001 — corrupt gzip raises
                    # EOFError/zlib.error, bad JSON shapes AttributeError/
                    # KeyError: ALL malformed input is a client 400, never
                    # a handler crash
                    self.send_response(400)
                    self.end_headers()
                    self.wfile.write(str(e).encode()[:200])
                    return
                pqm = inp.context.process_queue_manager
                ok = True
                if count and pqm is not None:
                    for g in groups:
                        g.set_tag(b"__source__", self.client_address[0]
                                  .encode())
                        ok = inp._push(pqm, g) and ok
                self.send_response(200 if ok else 429)
                self.end_headers()
                self.wfile.write(b"{}" if ok else b"busy")

            def log_message(self, *a):
                pass

        try:
            self._server = http.server.ThreadingHTTPServer(
                (self._host, self._port), Handler)
        except OSError as e:
            log.error("%s bind %s failed: %s", self.name, self.address, e)
            return False
        self._port = self._server.server_port   # resolves port 0 for tests
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name=self.name, daemon=True)
        self._thread.start()
        return True

    @property
    def port(self) -> int:
        return self._port

    def stop(self, is_pipeline_removing: bool = False) -> bool:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        return True


class InputOTLP(InputHTTPServer):
    """OTLP/HTTP logs receiver (plugins/input/opentelemetry)."""

    name = "input_otlp"
    default_format = "otlp"
    default_address = "0.0.0.0:4318"
