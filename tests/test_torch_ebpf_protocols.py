"""The port's L7 parsers against the JAX package's, on the CPU.

* The recorded wire bytes of ``tests/test_ebpf_protocols.py`` (MySQL,
  Redis, HTTP, and the text that must parse as none of them) through both
  packages' ``parse_http``, ``parse_redis``, ``parse_mysql`` and
  ``sniff_l7`` give equal records.
* Every payload of a seeded ``testdata.ebpf_stream`` sniffs the same in
  both packages, and as the protocol of its connection.
"""

import dataclasses

import pytest

from loongcollector_tpu.input.ebpf import connections as ref_conn
from loongcollector_tpu.input.ebpf import protocol_http as ref_http
from loongcollector_tpu.input.ebpf import protocol_mysql as ref_mysql
from loongcollector_tpu.input.ebpf import protocol_redis as ref_redis
from loongcollector_tpu_torch.input.ebpf import connections
from loongcollector_tpu_torch.input.ebpf import protocol_http
from loongcollector_tpu_torch.input.ebpf import protocol_mysql
from loongcollector_tpu_torch.input.ebpf import protocol_redis
from loongcollector_tpu_torch.testdata import ebpf_stream
from test_torch_alarms import alarms_left_empty  # noqa: F401

# the recorded byte streams of tests/test_ebpf_protocols.py
_SQL = b"select * from users limit 5"
CORPUS = {
    "mysql_query": bytes([1 + len(_SQL), 0, 0, 0, 0x03]) + _SQL,
    "mysql_ok": bytes([0x07, 0, 0, 1, 0x00, 0, 0, 2, 0, 0, 0]),
    "mysql_err": (bytes([0x17, 0, 0, 1, 0xFF, 0x28, 0x04]) + b"#42S02"
                  + b"Table 'x' doesn't"),
    "mysql_resultset": bytes([0x01, 0, 0, 1, 0x03]),
    "redis_set": b"*3\r\n$3\r\nSET\r\n$5\r\nmykey\r\n$5\r\nhello\r\n",
    "redis_ok": b"+OK\r\n",
    "redis_err": b"-ERR unknown command 'FOO'\r\n",
    "redis_bulk": b"$5\r\nhello\r\n",
    "redis_int": b":42\r\n",
    "redis_inline": b"PING\r\n",
    "http_req": b"GET /x HTTP/1.1\r\nHost: h\r\n\r\n",
    "http_req_ua": (b"GET /api/v1/users?id=3 HTTP/1.1\r\n"
                    b"Host: shop.example\r\nUser-Agent: curl/8\r\n\r\n"),
    "http_resp": (b"HTTP/1.1 404 Not Found\r\nContent-Length: 9\r\n\r\n"
                  b"not found"),
    "garbage": b"\x00\x01\x02 binary junk",
    "empty": b"",
    "log_text": b"hello world, just a log line",
    "hello": b"hello world",
    "random_log": b"some random log text",
    "fox": b"The quick brown fox jumps over the lazy dog. " * 5,
    "bare_lf_http": b"POST /a HTTP/1.0\nHost: z\nContent-Length: 12\n\n",
    "bad_status": b"HTTP/1.1 abc Nope\r\n\r\n",
    "redis_null_bulk": b"$-1\r\n",
    "redis_array_resp": b"*2\r\n:1\r\n:2\r\n",
    "mysql_truncated": bytes([0xFF, 0xFF, 0x00, 0x00, 0x03]) + b"x" * 1100,
}

PARSERS = [("http", ref_http.parse_http, protocol_http.parse_http),
           ("redis", ref_redis.parse_redis, protocol_redis.parse_redis),
           ("mysql", ref_mysql.parse_mysql, protocol_mysql.parse_mysql)]


def _rec(rec):
    return None if rec is None else dataclasses.asdict(rec)


@pytest.mark.parametrize("name", sorted(CORPUS))
@pytest.mark.parametrize("parser", [p[0] for p in PARSERS])
def test_parsers_equal_reference(parser, name):
    _, ref, port = next(p for p in PARSERS if p[0] == parser)
    payload = CORPUS[name]
    assert _rec(port(payload)) == _rec(ref(payload))


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_sniff_equals_reference(name):
    proto, rec = connections.sniff_l7(CORPUS[name])
    ref_proto, ref_rec = ref_conn.sniff_l7(CORPUS[name])
    assert (proto, _rec(rec)) == (ref_proto, _rec(ref_rec))


def test_corpus_protocols():
    """The corpus sniffs as ``tests/test_ebpf_protocols.py`` says."""
    want = {"http_req": "http", "redis_set": "redis",
            "mysql_query": "mysql", "random_log": "raw", "fox": "raw"}
    for name, proto in want.items():
        assert connections.sniff_l7(CORPUS[name])[0] == proto


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_payloads_sniff_as_their_connection(seed):
    events, _ = ebpf_stream(seed, 600, n_procs=8, n_conns=24)
    protos = {}
    n = 0
    for ev in events:
        payload = ev.get("payload")
        if not payload or ev["source"] != "network_observe":
            continue
        proto, rec = connections.sniff_l7(payload)
        ref_proto, ref_rec = ref_conn.sniff_l7(payload)
        assert (proto, _rec(rec)) == (ref_proto, _rec(ref_rec))
        assert protos.setdefault(ev["fd"], proto) == proto
        n += 1
    assert n == 1200
    assert set(protos.values()) == {"http", "redis", "mysql"}
