"""The port's extension plane (``pipeline/plugin/extension.py``, the
``extensions:`` section of ``pipeline/pipeline.py``, ``PluginContext.
get_extension`` and the send side's hooks in ``flusher/http_base.py`` and
``flusher/http.py``) against the JAX package's, on the CPU, with the cases
of the JAX package's ``tests/test_extensions_sinks2.py``:

* each extension's behaviour on the same inputs: ``ext_basicauth``'s
  header, ``ext_request_breaker``'s trip, cooldown and probe (driven by
  one patched clock in both modules, no sleep), ``ext_default_decoder``'s
  groups for every format, ``ext_default_encoder``'s bytes,
  ``ext_groupinfo_filter``'s choice;
* a pipeline builds its extensions first and a flusher resolves them by
  type or ``Alias``: the authenticator signs the request, an open breaker
  fails ``build_request`` fast (``BreakerOpen``), the interceptor drops
  what it filters out, an ``Encoder`` extension builds the payload; a
  duplicate key and a dangling reference refuse the config;
* every ``Type:`` of the six shipped configs this slice completes is
  created by the port's registry, and ``import`` of the new modules loads
  neither ``jax`` nor ``loongcollector_tpu``.
"""

import subprocess
import sys

import pytest
import yaml

from loongcollector_tpu.models import PipelineEventGroup as RefGroup
from loongcollector_tpu.pipeline.plugin import extension as ref_ext
from loongcollector_tpu.pipeline.plugin.interface import \
    PluginContext as RefContext
from loongcollector_tpu.pipeline.pipeline import \
    CollectionPipeline as RefPipeline
from loongcollector_tpu.pipeline.queue.sender_queue import \
    SenderQueueItem as RefItem
from loongcollector_tpu_torch.models import PipelineEventGroup
from loongcollector_tpu_torch.pipeline.pipeline import (CollectionPipeline,
                                                        PipelineInitError)
from loongcollector_tpu_torch.pipeline.plugin import extension as port_ext
from loongcollector_tpu_torch.pipeline.plugin.interface import PluginContext
from loongcollector_tpu_torch.pipeline.plugin.registry import PluginRegistry
from loongcollector_tpu_torch.pipeline.queue.sender_queue import \
    SenderQueueItem
from test_torch_alarms import alarms_left_empty  # noqa: F401

SIDES = {"reference": (ref_ext, RefContext, RefGroup),
         "port": (port_ext, PluginContext, PipelineEventGroup)}

SHIPPED = ("es_with_aggregation", "http_ingest_spl", "http_with_extensions",
           "influx_ingest", "metrics_remote_write", "process_entities")


def _group(cls, rows, tags=None):
    g = cls()
    sb = g.source_buffer
    for row in rows:
        ev = g.add_log_event(1700000000)
        for k, v in row.items():
            ev.set_content(sb.copy_string(k.encode()),
                           sb.copy_string(v.encode()))
    for k, v in (tags or {}).items():
        g.set_tag(k.encode(), v.encode())
    return g


def _b(x):
    return x if isinstance(x, bytes) else x.to_bytes()


def _dump(groups):
    """Groups as comparable data: tags, and each event's kind, time,
    contents or metric name, value and tags."""
    out = []
    for g in groups:
        evs = []
        for ev in g.events:
            if hasattr(ev, "contents"):
                evs.append(("log", ev.timestamp, sorted(
                    (_b(k), _b(v)) for k, v in ev.contents)))
            else:
                val = ev.value
                multi = getattr(val, "values", None)
                v = (sorted(multi.items()) if multi is not None
                     else val.value)
                evs.append(("metric", ev.timestamp, ev.timestamp_ns,
                            _b(ev.name), v, sorted(
                                (_b(k), _b(t)) for k, t in ev.tags.items())))
        out.append((sorted((_b(k), _b(v)) for k, v in g.tags.items()),
                    evs))
    return out


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return 1700000000.0


# -- each extension ------------------------------------------------------------

def test_basicauth_header_equal():
    got = {}
    for side, (ext, ctx, _) in SIDES.items():
        a = ext.ExtBasicAuth()
        assert a.init({"Username": "u", "Password": "p"}, ctx("t"))

        class Req:
            headers = {}
        r = Req()
        a.apply(r)
        got[side] = r.headers["Authorization"]
        assert not ext.ExtBasicAuth().init({"Password": "p"}, ctx("t"))
    assert got["port"] == got["reference"] == "Basic dTpw"


@pytest.mark.parametrize("ratio,results", [
    (0.5, [False] * 6),
    (0.2, [True, True, True, False]),
    (0.2, [True] * 8),
    (0.1, [True, False, True, True, True, False]),
])
def test_request_breaker_trips_cools_and_probes(monkeypatch, ratio,
                                                results):
    """The same outcomes and allow() calls under one clock: equal answers
    at every step, through a trip, the window and the probe after it."""
    got = {}
    for side, (ext, ctx, _) in SIDES.items():
        clock = _Clock()
        monkeypatch.setattr(ext, "time", clock)
        b = ext.ExtRequestBreaker()
        assert b.init({"FailureRatio": ratio, "WindowInSeconds": 3},
                      ctx("t"))
        trace = []
        for ok in results:
            b.on_result(ok)
            clock.t += 0.1
            trace.append(b.allow())
        clock.t += 3.1                  # past the window: the probe
        trace.append(b.allow())
        b.on_result(True)
        trace.append(b.allow())
        got[side] = trace
        if side == "port":
            tripped = trace.count(False) > 0
            assert b.stats()["opened"] == (1 if tripped else 0)
            assert b.stats()["closed"] == (1 if tripped else 0)
    assert got["port"] == got["reference"]


DECODER_CASES = [
    ("json", b'{"a": "1", "n": 5}\n{"b": "2"}\nnot json\n[1, 2]\n\n'),
    ("raw", b"one line\ntwo"),
    ("influx", b"cpu,host=a v=1,w=2i 1700000000000000000\nbroken\n"),
    ("influxdb", b"mem used=3 1700000001000000000\n"),
    ("statsd", b"page.views:1|c|@0.5|#env:prod\nlat:320|ms\n"),
]


@pytest.mark.parametrize("fmt,body", DECODER_CASES,
                         ids=[c[0] for c in DECODER_CASES])
def test_decoder_groups_equal(monkeypatch, fmt, body):
    got = {}
    for side, (ext, ctx, _) in SIDES.items():
        d = ext.ExtDefaultDecoder()
        assert d.init({"Format": fmt}, ctx("t"))
        # the log formats stamp events with time.time(): one clock
        monkeypatch.setattr(ext.time, "time", lambda: 1700000005.0)
        got[side] = _dump(d.decode(body))
        monkeypatch.undo()
    assert got["port"] == got["reference"]
    assert got["port"] and got["port"][0][1]


def test_decoder_sls_round_trip_and_bad_format():
    got = {}
    for side, (ext, ctx, cls) in SIDES.items():
        enc = ext.ExtDefaultEncoder()
        assert enc.init({"Format": "sls_pb"}, ctx("t"))
        data = enc.encode([_group(cls, [{"k": "v"}, {"x": "y"}],
                                  {"env": "prod"})])
        dec = ext.ExtDefaultDecoder()
        assert dec.init({"Format": "sls"}, ctx("t"))
        got[side] = (data, _dump(dec.decode(data)))
        assert not ext.ExtDefaultDecoder().init({"Format": "xml"}, ctx("t"))
        assert not ext.ExtDefaultEncoder().init({"Format": "raw"}, ctx("t"))
    assert got["port"] == got["reference"]


@pytest.mark.parametrize("fmt", ["json", "sls_pb"])
def test_encoder_bytes_equal(fmt):
    got = {}
    for side, (ext, ctx, cls) in SIDES.items():
        enc = ext.ExtDefaultEncoder()
        assert enc.init({"Format": fmt}, ctx("t"))
        got[side] = bytes(enc.encode([
            _group(cls, [{"a": "1", "msg": "hi"}, {"b": "2"}],
                   {"env": "prod"}),
            _group(cls, [{"c": "3"}])]))
    assert got["port"] == got["reference"]


@pytest.mark.parametrize("tags", [{"env": "prod"}, {},
                                  {"env": "prod", "dc": "a"}])
def test_groupinfo_filter_keeps_the_same_groups(tags):
    got = {}
    for side, (ext, ctx, cls) in SIDES.items():
        f = ext.ExtGroupInfoFilter()
        assert f.init({"Tags": tags}, ctx("t"))
        groups = [_group(cls, [{"a": str(i)}], t) for i, t in enumerate(
            [{"env": "prod"}, {"env": "dev"}, {"env": "prod", "dc": "a"},
             {}, {"dc": "a"}])]
        got[side] = [groups.index(g) for g in f.filter(groups)]
    assert got["port"] == got["reference"]


# -- the pipeline's extensions and the flusher's hooks ---------------------------

FLUSHER_CFG = {
    "extensions": [
        {"Type": "ext_basicauth", "Username": "u", "Password": "p"},
        {"Type": "ext_request_breaker", "Alias": "br1",
         "FailureRatio": 0.5},
        {"Type": "ext_groupinfo_filter", "Tags": {"env": "prod"}},
        {"Type": "ext_default_encoder", "Format": "sls_pb"},
    ],
    "flushers": [{"Type": "flusher_http", "RemoteURL": "http://127.0.0.1:9/x",
                  "Authenticator": "ext_basicauth",
                  "RequestBreaker": "ext_request_breaker/br1",
                  "FlushInterceptor": "ext_groupinfo_filter",
                  "Encoder": "ext_default_encoder", "MinCnt": 1}],
}


def _ref_pipeline(config):
    cfg = dict(config, inputs=[{"Type": "input_static_file_onetime",
                                "FilePaths": ["/nonexistent"]}])
    p = RefPipeline()
    ok = p.init("ext-pipe", cfg)
    return p if ok else None


def _port_pipeline(config):
    import torch
    try:
        return CollectionPipeline("ext-pipe", dict(config, inputs=[]),
                                  torch.device("cpu"))
    except PipelineInitError:
        return None


def test_flusher_resolves_and_applies_the_extensions():
    got = {}
    for side, make, item_cls, group_cls in (
            ("reference", _ref_pipeline, RefItem, RefGroup),
            ("port", _port_pipeline, SenderQueueItem, PipelineEventGroup)):
        p = make(FLUSHER_CFG)
        assert p is not None, side
        fl = p.flushers[0] if side == "port" else p.flushers[0].plugin
        assert set(p.context.extensions) == {
            "ext_basicauth", "ext_request_breaker/br1",
            "ext_groupinfo_filter", "ext_default_encoder"}
        assert fl.authenticator is p.context.get_extension("ext_basicauth")
        sent = []
        fl.batcher.add = sent.append
        keep = _group(group_cls, [{"a": "1"}], {"env": "prod"})
        drop = _group(group_cls, [{"a": "2"}], {"env": "dev"})
        assert fl.send(keep) and fl.send(drop)
        assert sent == [keep]
        req = fl.build_request(item_cls(b"x", 1))
        encoded = fl._encoder_ext.encode([keep])
        for _ in range(6):
            fl.on_send_done(item_cls(b"x", 1), 503, b"")
        with pytest.raises(Exception) as ei:
            fl.build_request(item_cls(b"x", 1))
        got[side] = (req.headers, req.url, bytes(encoded),
                     type(ei.value).__name__)
        if side == "port":
            assert isinstance(ei.value, port_ext.BreakerOpen)
            p.stop_flushers()
            p.release()
        else:
            p.stop(True)
    assert got["port"] == got["reference"]
    assert got["port"][0]["Authorization"] == "Basic dTpw"
    assert got["port"][0]["Content-Type"] == "application/x-protobuf"


@pytest.mark.parametrize("config", [
    # a duplicate key (no Alias)
    {"extensions": [
        {"Type": "ext_basicauth", "Username": "a", "Password": "x"},
        {"Type": "ext_basicauth", "Username": "b", "Password": "y"}],
     "flushers": [{"Type": "flusher_file", "FilePath": "/dev/null"}]},
    # a dangling reference, for each hook
    {"flushers": [{"Type": "flusher_http", "RemoteURL": "http://127.0.0.1:9",
                   "Authenticator": "ext_basicauth"}]},
    {"flushers": [{"Type": "flusher_http", "RemoteURL": "http://127.0.0.1:9",
                   "RequestBreaker": "ext_request_breaker/none"}]},
    {"flushers": [{"Type": "flusher_http", "RemoteURL": "http://127.0.0.1:9",
                   "FlushInterceptor": "ext_groupinfo_filter"}]},
    {"flushers": [{"Type": "flusher_http", "RemoteURL": "http://127.0.0.1:9",
                   "Encoder": "ext_default_encoder"}]},
    # an extension that refuses its config
    {"extensions": [{"Type": "ext_basicauth"}],
     "flushers": [{"Type": "flusher_file", "FilePath": "/dev/null"}]},
], ids=["duplicate", "authenticator", "breaker", "interceptor", "encoder",
        "refused"])
def test_bad_extension_configs_are_refused(config):
    assert _ref_pipeline(config) is None
    assert _port_pipeline(config) is None


def test_aliased_extensions_are_distinct():
    p = _port_pipeline({"extensions": [
        {"Type": "ext_basicauth", "Username": "a", "Password": "x"},
        {"Type": "ext_basicauth", "Alias": "b", "Username": "b",
         "Password": "y"}],
        "flushers": [{"Type": "flusher_http", "RemoteURL": "http://h:9",
                      "Authenticator": "ext_basicauth/b"}]})
    assert p is not None
    req = p.flushers[0].build_request(SenderQueueItem(b"x", 1))
    assert req.headers["Authorization"] == "Basic Yjp5"
    p.stop_flushers()
    p.release()


# -- the shipped configs and the import rule ------------------------------------

@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_config_types_are_registered(name):
    reg = PluginRegistry.instance()
    reg.load_static_plugins()
    with open(f"example_config/quick_start/{name}.yaml") as f:
        cfg = yaml.safe_load(f)
    create = {"inputs": reg.create_input, "processors": reg.create_processor,
              "aggregators": reg.create_aggregator,
              "flushers": reg.create_flusher,
              "extensions": reg.create_extension}
    types = [(sec, c["Type"]) for sec in create for c in cfg.get(sec) or []]
    assert types
    for sec, typ in types:
        assert create[sec](typ) is not None, (sec, typ)


def test_new_modules_import_no_jax():
    mods = ["loongcollector_tpu_torch.pipeline.plugin.extension",
            "loongcollector_tpu_torch.input.http_server",
            "loongcollector_tpu_torch.input.metric_protocols",
            "loongcollector_tpu_torch.input.host_monitor",
            "loongcollector_tpu_torch.flusher.elasticsearch",
            "loongcollector_tpu_torch.flusher.clickhouse",
            "loongcollector_tpu_torch.flusher.sls",
            "loongcollector_tpu_torch.flusher.sls_client"]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'loongcollector_tpu' or m.startswith("
            "'loongcollector_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
