"""The port's ``flusher_elasticsearch`` and ``flusher_clickhouse`` against
the JAX package's, on the CPU, with the cases of the JAX package's
``tests/test_sinks.py``: equal groups give byte-equal payloads and the
same URL and headers.

* Elasticsearch ``_bulk``: a static ``Index`` on columnar groups (the
  batched row writer, the action line as each row's head, ISO-8601
  ``@timestamp``), on row groups and on columnar groups it cannot take
  (non-ASCII spans, a field named like a tag, an existing ``@timestamp``)
  (the dict path); the dynamic ``Index`` (``logs-%{app}``, resolved per
  row, ``unknown`` for a missing field); a timestamp past year 9999 that
  the fast path's range guard sends to the dict path, which raises in
  both; ``Authentication``'s Basic header; address rotation.
* ClickHouse: the JSONEachRow body (``_timestamp``) of columnar and row
  groups, the ``INSERT INTO db.table FORMAT JSONEachRow`` query URL, the
  Basic header.
"""

import numpy as np
import pytest

from loongcollector_tpu import models as ref_models
from loongcollector_tpu.flusher import clickhouse as ref_ch
from loongcollector_tpu.flusher import elasticsearch as ref_es
from loongcollector_tpu.pipeline.queue.sender_queue import \
    SenderQueueItem as RefItem
from loongcollector_tpu_torch import models as port_models
from loongcollector_tpu_torch.flusher import clickhouse as port_ch
from loongcollector_tpu_torch.flusher import elasticsearch as port_es
from loongcollector_tpu_torch.pipeline.queue.sender_queue import \
    SenderQueueItem
from test_torch_alarms import alarms_left_empty  # noqa: F401
from test_torch_send_codecs import libs  # noqa: F401

SIDES = {"reference": (ref_models, ref_es, ref_ch, RefItem),
         "port": (port_models, port_es, port_ch, SenderQueueItem)}

APPS = ("web", "api", "db")


def _row_group(models, seed, tags=None):
    rng = np.random.default_rng(seed)
    g = models.PipelineEventGroup()
    sb = g.source_buffer
    for i in range(12):
        ev = g.add_log_event(1700000000 + i)
        row = {"app": APPS[int(rng.integers(3))], "msg": f"hi {i}",
               "latency_ms": str(int(rng.integers(0, 9999)))}
        if i % 5 == 0:
            del row["app"]
        for k, v in row.items():
            ev.set_content(sb.copy_string(k.encode()),
                           sb.copy_string(v.encode()))
    for k, v in (tags or {}).items():
        g.set_tag(k.encode(), v.encode())
    return g


def _columnar_group(models, seed, fields=("app", "action", "latency_ms"),
                    tags=None, ts=None, text=None):
    """A grok-like columnar group: content consumed, one span a field."""
    rng = np.random.default_rng(seed)
    g = models.PipelineEventGroup()
    sb = g.source_buffer
    n = 20
    cols = {f: ([], []) for f in fields}
    for i in range(n):
        vals = text(i) if text else [
            APPS[int(rng.integers(3))], "get", str(int(rng.integers(9999)))]
        for f, v in zip(fields, vals):
            view = sb.copy_string(v.encode())
            cols[f][0].append(view.offset)
            cols[f][1].append(view.length)
    stamps = np.asarray(ts if ts is not None else
                        1700000000 + np.arange(n), dtype=np.int64)
    c = models.ColumnarLogs(np.zeros(n, np.int32), np.zeros(n, np.int32),
                            stamps)
    for f, (o, ln) in cols.items():
        c.set_field(f, np.array(o, np.int32), np.array(ln, np.int32))
    c.content_consumed = True
    g.set_columns(c)
    for k, v in (tags or {}).items():
        g.set_tag(k.encode(), v.encode())
    return g


GROUPS = {
    "rows": lambda m: [_row_group(m, 1), _row_group(m, 2, {"env": "prod"})],
    "columnar": lambda m: [_columnar_group(m, 3),
                           _columnar_group(m, 4, tags={"env": "prod"})],
    "mixed": lambda m: [_columnar_group(m, 5), _row_group(m, 6)],
    "non_ascii": lambda m: [_columnar_group(
        m, 7, text=lambda i: ["wéb", "get", str(i)])],
    "field_is_tag": lambda m: [_columnar_group(m, 8, tags={"app": "x"})],
    "has_timestamp": lambda m: [_columnar_group(
        m, 9, fields=("app", "@timestamp", "_timestamp"),
        text=lambda i: ["web", "2023-01-01T00:00:00Z", str(i)])],
    "empty": lambda m: [m.PipelineEventGroup()],
}


def _es(side, config):
    fl = SIDES[side][1].FlusherElasticsearch()
    assert fl._init_sink(config)
    return fl


def _ch(side, config):
    fl = SIDES[side][2].FlusherClickHouse()
    assert fl._init_sink(config)
    return fl


@pytest.mark.parametrize("index", ["logs", "logs-%{app}",
                                   "%{app}-%{tag.env}"])
@pytest.mark.parametrize("case", sorted(GROUPS))
def test_es_bulk_bytes_equal(libs, case, index):  # noqa: F811
    got = {}
    for side in SIDES:
        fl = _es(side, {"Addresses": ["http://a:9200", "http://b:9200/"],
                        "Index": index,
                        "Authentication": {"PlainText": {
                            "Username": "elastic", "Password": "pw"}}})
        built = fl.build_payload(GROUPS[case](SIDES[side][0]))
        urls = [fl.endpoint_url(None) for _ in range(3)]
        got[side] = (None if built is None else (bytes(built[0]),
                                                 built[1]), urls)
    assert got["port"] == got["reference"]
    if case != "empty":
        body, headers = got["port"][0]
        assert headers == {"Authorization": "Basic ZWxhc3RpYzpwdw=="}
        assert body.endswith(b"\n") and b'"@timestamp"' in body
    assert got["port"][1] == ["http://a:9200/_bulk", "http://b:9200/_bulk",
                              "http://a:9200/_bulk"]


def test_es_fast_path_is_taken_and_matches_the_dict_path(libs):  # noqa: F811
    """A static index on an in-range columnar group takes the batched
    writer (no event dict is built); its bytes equal what the dict path
    makes of the same rows as a row group."""
    fl = _es("port", {"Addresses": ["http://a"], "Index": "logs"})
    g = _columnar_group(port_models, 11)
    assert fl._ts_in_range(g)
    from loongcollector_tpu_torch.pipeline.serializer import batch_json
    assert batch_json.native_group_rows(g, "@timestamp") is not None
    fast = fl.build_payload([g])[0]
    rows = port_models.PipelineEventGroup()
    sb = rows.source_buffer
    for ts, obj in port_es.iter_event_dicts(_columnar_group(port_models,
                                                            11)):
        ev = rows.add_log_event(ts)
        for k, v in obj.items():
            ev.set_content(sb.copy_string(k.encode()),
                           sb.copy_string(v.encode()))
    assert bytes(fast) == bytes(fl.build_payload([rows])[0])


@pytest.mark.parametrize("ts", [253402300800, -1])
def test_es_range_guard_sends_outliers_to_the_dict_path(libs, ts):  # noqa: F811
    got = {}
    for side in SIDES:
        fl = _es(side, {"Addresses": ["http://a"], "Index": "logs"})
        g = _columnar_group(SIDES[side][0], 12,
                            ts=[1700000000] * 19 + [ts])
        assert not fl._ts_in_range(g)
        try:
            got[side] = ("ok", bytes(fl.build_payload([g])[0]))
        except (ValueError, OverflowError, OSError) as e:
            got[side] = ("raised", type(e).__name__)
    assert got["port"] == got["reference"]
    if ts > 0:
        assert got["port"][0] == "raised"


@pytest.mark.parametrize("case", sorted(GROUPS))
def test_clickhouse_body_and_url_equal(libs, case):  # noqa: F811
    got = {}
    for side in SIDES:
        fl = _ch(side, {"Addresses": ["http://ch:8123"], "Database": "db",
                        "Table": "logs", "Username": "u", "Password": "p"})
        built = fl.build_payload(GROUPS[case](SIDES[side][0]))
        got[side] = (None if built is None else (bytes(built[0]),
                                                 built[1]),
                     fl.endpoint_url(None))
    assert got["port"] == got["reference"]
    assert got["port"][1] == ("http://ch:8123/?query=INSERT%20INTO%20db."
                              "logs%20FORMAT%20JSONEachRow")
    if case not in ("empty", "has_timestamp"):
        assert b'"_timestamp": 17000000' in got["port"][0][0]


@pytest.mark.parametrize("config", [
    {"Index": "logs"}, {"Addresses": ["http://a"]},
    {"Addresses": [], "Index": "logs"}])
def test_es_and_clickhouse_refuse_incomplete_configs(config):
    for side in SIDES:
        assert not SIDES[side][1].FlusherElasticsearch()._init_sink(config)
        assert not SIDES[side][2].FlusherClickHouse()._init_sink(
            {k: v for k, v in config.items() if k != "Index"})


def test_flusher_request_headers_equal(libs):  # noqa: F811
    """The whole request of one payload: the sink's content type, the
    Basic header, the URL."""
    from loongcollector_tpu.pipeline.plugin.interface import PluginContext \
        as RefContext
    from loongcollector_tpu_torch.pipeline.plugin.interface import \
        PluginContext
    got = {}
    for side, ctx in (("reference", RefContext), ("port", PluginContext)):
        for make, cfg in (
                (SIDES[side][1].FlusherElasticsearch,
                 {"Addresses": ["http://a:9200"], "Index": "i",
                  "Authentication": {"PlainText": {"Username": "u",
                                                   "Password": "p"}}}),
                (SIDES[side][2].FlusherClickHouse,
                 {"Addresses": ["http://c:8123"], "Table": "t"})):
            fl = make()
            assert fl.init(cfg, ctx("t"))
            groups = [_row_group(SIDES[side][0], 13)]
            body, headers = fl.build_payload(groups)
            item = SIDES[side][3](body, len(body), tag={"headers": headers})
            req = fl.build_request(item)
            got.setdefault(side, []).append((req.url, req.headers,
                                             bytes(req.body)))
            fl.stop()
    assert got["port"] == got["reference"]
