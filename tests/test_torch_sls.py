"""The port's SLS sink (``flusher/sls.py``, ``flusher/sls_client.py``)
against the JAX package's, on the CPU, with the cases of the JAX
package's ``tests/test_sls_client.py``:

* ``EndpointPool``: rotation after ``FAIL_THRESHOLD`` failures, a success
  breaking the streak, the probe back to the primary and its recovery,
  stale results; one scripted sequence of outcomes under one clock gives
  the same endpoints in both packages;
* ``classify_response`` and ``parse_error_code`` on the same answers;
* ``flusher_sls``: the same request for the same payload (URL, every
  header, the ``LOG <AccessKeyId>:<signature>`` Authorization: with one
  clock the ``Date`` and the signature are equal too, and without it the
  request is equal apart from them), the same LZ4-compressed LogGroup
  bytes for the same groups, the same verdicts, and the endpoint falling
  back after failures and not after a quota answer; ``ExactlyOnce`` is
  refused by the port.
"""

import json

import numpy as np
import pytest

from loongcollector_tpu import models as ref_models
from loongcollector_tpu.flusher import sls as ref_sls
from loongcollector_tpu.flusher import sls_client as ref_client
from loongcollector_tpu.pipeline.plugin.interface import \
    PluginContext as RefContext
from loongcollector_tpu.pipeline.queue.sender_queue import \
    SenderQueueItem as RefItem
from loongcollector_tpu_torch import models as port_models
from loongcollector_tpu_torch.flusher import sls as port_sls
from loongcollector_tpu_torch.flusher import sls_client as port_client
from loongcollector_tpu_torch.pipeline.plugin.interface import PluginContext
from loongcollector_tpu_torch.pipeline.queue.sender_queue import \
    SenderQueueItem
from test_torch_alarms import alarms_left_empty  # noqa: F401
from test_torch_send_codecs import libs  # noqa: F401

SIDES = {"reference": (ref_client, ref_sls, RefContext, RefItem,
                       ref_models),
         "port": (port_client, port_sls, PluginContext, SenderQueueItem,
                  port_models)}


class _Clock:
    def __init__(self, t=5000.0):
        self.t = t

    def monotonic(self):
        return self.t


def _pool_trace(side, monkeypatch, script, retry_s):
    client = SIDES[side][0]
    clock = _Clock()
    monkeypatch.setattr(client, "time", clock)
    monkeypatch.setattr(client, "PRIMARY_RETRY_SECS", retry_s)
    pool = client.EndpointPool(["a", "b", "c"])
    trace = []
    for step in script:
        if step == "tick":
            clock.t += 1.0
            continue
        ep = pool.current()
        trace.append(ep)
        if step == "fail":
            pool.on_fail(ep)
        elif step == "ok":
            pool.on_success(ep)
        elif step == "stale":
            pool.on_fail("a")
    trace.append(pool.current())
    return trace


POOL_SCRIPTS = [
    ["fail"] * 3 + ["ok"],                                  # rotate
    ["fail", "fail", "ok", "fail", "ok"],                   # streak broken
    ["fail"] * 3 + ["tick", "fail", "tick", "ok", "ok"],    # probe, home
    ["fail"] * 3 + ["stale", "stale", "ok"],                # stale results
    ["fail"] * 9 + ["tick"] * 3 + ["fail", "ok"] * 3,       # wrap around
]


@pytest.mark.parametrize("retry_s", [0.0, 2.5, 60.0])
@pytest.mark.parametrize("case", range(len(POOL_SCRIPTS)))
def test_endpoint_pool_same_endpoints(monkeypatch, case, retry_s):
    got = {side: _pool_trace(side, monkeypatch, POOL_SCRIPTS[case], retry_s)
           for side in SIDES}
    assert got["port"] == got["reference"]


def test_endpoint_pool_needs_an_endpoint():
    for side in SIDES:
        with pytest.raises(ValueError):
            SIDES[side][0].EndpointPool([])


ANSWERS = [(200, b""), (204, b""), (429, b""),
           (403, json.dumps({"errorCode": "WriteQuotaExceed"}).encode()),
           (403, json.dumps({"errorCode": "ShardWriteQuotaExceed"}).encode()),
           (403, b'{"errorCode": "Unauthorized"}'), (403, b"not json"),
           (400, b""), (404, b""), (500, b""), (503, b""), (0, b""),
           (-1, b""), (302, b"")]


@pytest.mark.parametrize("status,body", ANSWERS)
def test_classify_response_equal(status, body):
    got = {side: (SIDES[side][0].classify_response(status, body),
                  SIDES[side][0].parse_error_code(body)) for side in SIDES}
    assert got["port"] == got["reference"]


CONFIG = {"Project": "my-project", "Logstore": "host-entities",
          "Endpoint": "ep1.example", "Endpoints": ["ep1.example",
                                                  "ep2.example"],
          "AccessKeyId": "LTAI-id", "AccessKeySecret": "secret",
          "Topic": "t"}


def _flusher(side, config=None):
    fl = SIDES[side][1].FlusherSLS()
    assert fl.init(dict(config or CONFIG), SIDES[side][2]("t"))
    return fl


def _groups(models):
    rng = np.random.default_rng(4)
    g = models.PipelineEventGroup()
    sb = g.source_buffer
    for i in range(30):
        ev = g.add_log_event(1700000000 + i)
        ev.set_content(b"pid", sb.copy_string(str(i).encode()))
        ev.set_content(b"comm", sb.copy_string(
            b"proc-" + bytes(rng.choice(list(b"abcdef"), 8))))
    g.set_tag(b"__source__", b"process_entity")
    return [g]


@pytest.mark.parametrize("clocked", [True, False])
def test_request_equal(libs, monkeypatch, clocked):  # noqa: F811
    got = {}
    for side in SIDES:
        if clocked:
            monkeypatch.setattr(SIDES[side][1].time, "gmtime",
                                lambda *a: __import__("time").struct_time(
                                    (2026, 10, 19, 1, 2, 3, 0, 292, 0)))
        fl = _flusher(side)
        data = bytes(fl.serializer.serialize_view(
            _groups(SIDES[side][4])))
        payload = bytes(fl.compressor.compress(data))
        req = fl.build_request(SIDES[side][3](payload, len(data)))
        headers = dict(req.headers)
        if not clocked:
            assert headers.pop("Date")
            assert headers.pop("Authorization").startswith("LOG LTAI-id:")
        got[side] = (data, payload, req.method, req.url, headers)
        monkeypatch.undo()
    assert got["port"] == got["reference"]
    headers = got["port"][4]
    assert got["port"][3] == ("http://my-project.ep1.example/logstores/"
                              "host-entities/shards/lb")
    assert headers["x-log-compresstype"] == "lz4"
    assert headers["x-log-bodyrawsize"] == str(len(got["port"][0]))
    if clocked:
        assert headers["Date"] == "Mon, 19 Oct 2026 01:02:03 GMT"


def test_endpoint_falls_back_and_quota_does_not_rotate(monkeypatch):
    got = {}
    for side in SIDES:
        monkeypatch.setattr(SIDES[side][0], "PRIMARY_RETRY_SECS", 3600.0)
        fl = _flusher(side)
        item_cls = SIDES[side][3]
        trace = []
        for status, body in [(0, b"")] * 3 + [(200, b"")] + [
                (403, b'{"errorCode": "WriteQuotaExceed"}')] * 4 + [
                (400, b""), (500, b"")]:
            item = item_cls(b"x", 1)
            url = fl.build_request(item).url
            trace.append((url, fl.on_send_done(item, status, body)))
        got[side] = trace
    assert got["port"] == got["reference"]
    assert "ep2.example" in got["port"][3][0]
    assert got["port"][4][1] == "retry_slow"


def test_config_checks():
    for side in SIDES:
        assert not SIDES[side][1].FlusherSLS().init(
            {"Project": "p"}, SIDES[side][2]("t"))
    assert not port_sls.FlusherSLS().init(
        dict(CONFIG, ExactlyOnce={"Concurrency": 2}), PluginContext("t"))
