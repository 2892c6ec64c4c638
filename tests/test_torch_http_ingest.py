"""The port's HTTP ingest (``input/http_server.py``: ``input_http_server``
and ``input_otlp``) and its wire decoders (``input/metric_protocols.py``)
against the JAX package's, on the CPU, with the cases of the JAX
package's ``tests/test_longtail_inputs.py`` and
``tests/test_telegraf_jmxfetch.py``:

* ``parse_influx_lines`` and ``parse_statsd_packet``: the same events
  (name, time, nanoseconds, values, tags) and counts, escapes, quotes,
  typed fields, precisions, sample rates and bad lines included;
* each package's server on 127.0.0.1:0 gets the same POSTs, per format
  (``raw``, ``json``, ``ndjson``, ``otlp``, ``influx``, ``statsd``) and
  per encoding (none, gzip, zlib and raw deflate): the same groups, the
  ``__source__`` tag, the same answers (400 for a body that does not
  decode, 429 when the queue refuses), and the ``Decoder`` extension's
  groups in place of ``Format``'s;
* the port counts the groups it pushed (``groups_pushed``), and a
  refused push stays uncounted.

Every server is stopped in a ``finally``.
"""

import gzip
import json
import time
import urllib.error
import urllib.request
import zlib

import pytest

from loongcollector_tpu.input import http_server as ref_http
from loongcollector_tpu.input import metric_protocols as ref_mp
from loongcollector_tpu.models import PipelineEventGroup as RefGroup
from loongcollector_tpu.pipeline.plugin import extension as ref_ext
from loongcollector_tpu.pipeline.plugin.interface import \
    PluginContext as RefContext
from loongcollector_tpu_torch.input import http_server as port_http
from loongcollector_tpu_torch.input import metric_protocols as port_mp
from loongcollector_tpu_torch.models import PipelineEventGroup
from loongcollector_tpu_torch.pipeline.plugin import extension as port_ext
from loongcollector_tpu_torch.pipeline.plugin.interface import PluginContext
from test_torch_alarms import alarms_left_empty  # noqa: F401
from test_torch_extensions import _dump

SIDES = {"reference": (ref_http, ref_mp, ref_ext, RefContext, RefGroup),
         "port": (port_http, port_mp, port_ext, PluginContext,
                  PipelineEventGroup)}

NOW = 1700000009.0

INFLUX_CASES = [
    (b"cpu,host=web01,region=us usage_idle=92.5,usage_user=3i "
     b"1700000000000000000\n", ""),
    (rb"disk\ io,path=/var/log,tag\,x=a\=b used=1u,ok=true,"
     rb'msg="hello, \"world\"" 1700000001000000000', ""),
    (b"# comment\nbroken line without fields\nm v=1 1700000000\n", "s"),
    (b"m v=1,w=F,x=-2.5e3 1700000000123\n", "ms"),
    (b"no_time v=1\nm2,a=1 s=\"str\"\n\n", ""),
    (b"m v=1 1700000000123456789\nm v=2 1700000000\n", "us"),
]

STATSD_CASES = [
    b"page.views:1|c|@0.1|#env:prod,dc\nlatency:320|ms\n",
    b"x:1:2:3|g\nnot-a-metric\n",
    b"users:42|s\nbad:abc|g\nrate:3|c|@0\nh:1.5|h|#a:b\n",
]


class _Clock:
    @staticmethod
    def time():
        return NOW

    @staticmethod
    def time_ns():
        return int(NOW * 1e9)


@pytest.mark.parametrize("case", range(len(INFLUX_CASES)))
def test_influx_parse_equal(monkeypatch, case):
    body, precision = INFLUX_CASES[case]
    got = {}
    for side, (_, mp, _, _, group) in SIDES.items():
        monkeypatch.setattr(mp, "time", _Clock)
        g = group()
        n = mp.parse_influx_lines(body, g, precision=precision)
        got[side] = (n, _dump([g]))
    assert got["port"] == got["reference"]
    assert got["port"][0] >= 1


@pytest.mark.parametrize("case", range(len(STATSD_CASES)))
def test_statsd_parse_equal(monkeypatch, case):
    got = {}
    for side, (_, mp, _, _, group) in SIDES.items():
        monkeypatch.setattr(mp, "time", _Clock)
        g = group()
        n = mp.parse_statsd_packet(STATSD_CASES[case], g)
        got[side] = (n, _dump([g]))
    assert got["port"] == got["reference"]
    assert got["port"][0] >= 1


class _PQM:
    """The process-queue surface the server pushes into; refuses every
    push while ``full``."""

    def __init__(self):
        self.groups = []
        self.full = False

    def push_queue(self, key, group):
        if self.full:
            return False
        self.groups.append(group)
        return True


def _server(side, config, extensions=None):
    http, _, ext, ctx_cls, _ = SIDES[side]
    ctx = ctx_cls("t")
    ctx.process_queue_key = 1
    ctx.process_queue_manager = _PQM()
    for key, (cls_name, cfg) in (extensions or {}).items():
        e = getattr(ext, cls_name)()
        assert e.init(cfg, ctx)
        ctx.extensions[key] = e
    cls = http.InputOTLP if config.pop("otlp", False) else \
        http.InputHTTPServer
    inp = cls()
    assert inp.init(dict(config, Address="127.0.0.1:0"), ctx), config
    assert inp.start()
    return inp, ctx.process_queue_manager


def _post(port, body, headers=None, path="/ingest"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, headers=headers or {},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _encode(body, enc):
    if enc == "gzip":
        return gzip.compress(body), {"Content-Encoding": "gzip"}
    if enc == "zlib":
        return zlib.compress(body), {"Content-Encoding": "deflate"}
    if enc == "raw-deflate":
        c = zlib.compressobj(wbits=-zlib.MAX_WBITS)
        return c.compress(body) + c.flush(), {"Content-Encoding": "deflate"}
    return body, {}


OTLP = json.dumps({"resourceLogs": [{
    "resource": {"attributes": [{"key": "service.name",
                                 "value": {"stringValue": "api"}}]},
    "scopeLogs": [{"logRecords": [
        {"timeUnixNano": "1700000001000000000", "severityText": "WARN",
         "body": {"stringValue": "hello"},
         "attributes": [{"key": "n", "value": {"intValue": 7}}]},
        {"body": {"kvlistValue": {}}}]}]}]}).encode()

FORMAT_CASES = {
    "raw": b"line one\nline two\n\nline three",
    "json": json.dumps([{"k": "1", "n": 2, "__time__": 1700000002},
                        {"k": "2", "o": {"x": [1]}}]).encode(),
    "ndjson": b'{"msg": "a"}\n\n{"msg": "b", "v": 1.5}\n',
    "otlp": OTLP,
    "influx": b"cpu,host=a v=1 1700000000000000000\nmem used=2i\n",
    "statsd": b"a:1|c\nb:2|g|#k:v\n",
}
ENCODINGS = ("identity", "gzip", "zlib", "raw-deflate")


@pytest.fixture(scope="module")
def format_servers():
    """One server a package and format for the module (a server's stop
    waits out its poll interval), stopped at its teardown."""
    servers = {}
    try:
        for side in SIDES:
            for fmt in FORMAT_CASES:
                cfg = {"otlp": True} if fmt == "otlp" else {"Format": fmt}
                servers[(side, fmt)] = _server(side, cfg)
        yield servers
    finally:
        _stop_all(inp for inp, _ in servers.values())


def _stop_all(inputs):
    import threading
    threads = [threading.Thread(target=inp.stop) for inp in inputs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)


@pytest.mark.parametrize("enc", ENCODINGS)
@pytest.mark.parametrize("fmt", sorted(FORMAT_CASES))
def test_server_groups_per_format_and_encoding(monkeypatch, format_servers,
                                               fmt, enc):
    got = {}
    for side in SIDES:
        http, mp = SIDES[side][0], SIDES[side][1]
        monkeypatch.setattr(http.time, "time", _Clock.time)
        monkeypatch.setattr(mp, "time", _Clock)
        inp, pqm = format_servers[(side, fmt)]
        pqm.groups.clear()
        pushed = inp.groups_pushed if side == "port" else 0
        body, headers = _encode(FORMAT_CASES[fmt], enc)
        status = _post(inp.port, body, headers)
        monkeypatch.undo()
        got[side] = (status, _dump(pqm.groups))
        if side == "port":
            assert inp.groups_pushed - pushed == len(pqm.groups) == 1
    assert got["port"] == got["reference"]
    assert got["port"][0] == 200
    assert dict(got["port"][1][0][0])[b"__source__"] == b"127.0.0.1"


@pytest.mark.parametrize("body,headers,fmt", [
    (b"not json", {}, "json"),
    (b'["a", "b"]', {}, "json"),
    (b"\x1f\x8b\x08" + b"\x00" * 10, {"Content-Encoding": "gzip"}, "json"),
    (b"{broken\n", {}, "ndjson"),
    (b"garbage", {"Content-Encoding": "deflate"}, "raw"),
], ids=["json", "scalars", "gzip", "ndjson", "deflate"])
def test_bad_bodies_answer_400(format_servers, body, headers, fmt):
    got = {}
    for side in SIDES:
        inp, pqm = format_servers[(side, fmt)]
        pqm.groups.clear()
        before = inp.groups_pushed if side == "port" else None
        got[side] = (_post(inp.port, body, headers), len(pqm.groups))
        if side == "port":
            assert inp.groups_pushed == before
    assert got["port"] == got["reference"] == (400, 0)


def test_refused_push_answers_429_and_is_not_counted():
    got, servers = {}, {side: _server(side, {"Format": "ndjson"})
                        for side in SIDES}
    try:
        for side, (inp, pqm) in servers.items():
            pqm.full = True
            first = _post(inp.port, b'{"a": "1"}\n')
            pqm.full = False
            second = _post(inp.port, b'{"a": "2"}\n')
            got[side] = (first, second, len(pqm.groups))
    finally:
        _stop_all(inp for inp, _ in servers.values())
    inp = servers["port"][0]
    assert inp.groups_pushed == 1
    assert got["port"] == got["reference"] == (429, 200, 1)


@pytest.mark.parametrize("fmt,body", [
    ("json", b'{"a": "1", "n": 5}\n{"b": "2"}\n'),
    ("statsd", b"x:1|c\n"),
    ("influx", b"m v=1 1700000000000000000\n"),
])
def test_decoder_extension_replaces_the_format(monkeypatch, fmt, body):
    got, servers = {}, {side: _server(
        side, {"Decoder": "ext_default_decoder"},
        {"ext_default_decoder": ("ExtDefaultDecoder", {"Format": fmt})})
        for side in SIDES}
    try:
        for side, (inp, pqm) in servers.items():
            ext = SIDES[side][2]
            monkeypatch.setattr(ext.time, "time", _Clock.time)
            monkeypatch.setattr(SIDES[side][1], "time", _Clock)
            status = _post(inp.port, body)
            monkeypatch.undo()
            got[side] = (status, _dump(pqm.groups))
    finally:
        _stop_all(inp for inp, _ in servers.values())
    assert got["port"] == got["reference"]
    assert got["port"][0] == 200 and got["port"][1]


def test_dangling_decoder_and_bad_address_are_refused():
    for side in SIDES:
        http, _, _, ctx_cls, _ = SIDES[side]
        for cfg in ({"Decoder": "ext_default_decoder"},
                    {"Address": "no-port"}, {"Format": "xml"}):
            inp = http.InputHTTPServer()
            assert not inp.init(dict({"Address": "127.0.0.1:0"}, **cfg),
                                ctx_cls("t")), (side, cfg)


def test_stop_joins_the_server_thread():
    inp, _ = _server("port", {"Format": "raw"})
    thread = inp._thread
    assert thread.is_alive()
    t0 = time.monotonic()
    inp.stop()
    assert not thread.is_alive() and time.monotonic() - t0 < 5
    inp.stop()                              # idempotent
