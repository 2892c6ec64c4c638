"""The Elasticsearch sink end to end: ``es_with_aggregation.yaml``
(``testdata.es_aggregation_config``) ``--once`` on 2,000 lines in both
agents, the JAX package's and the port's, each to its own ``_bulk``
receiver on 127.0.0.1: both send the same rows (the grok's fields) under
their own ``logs-<app>`` action lines, with the config's Basic header on
every request (the ``@timestamp`` each read gives aside).  Both agents
run together; both are stopped and both receivers closed in a
``finally``.
"""

import base64
import json

from loongcollector_tpu_torch import testdata as td
from test_torch_agents_ingest import (PACKAGES, chip_smoke, native_built,
                                      start_agent, stop_agents)
from test_torch_alarms import alarms_left_empty  # noqa: F401

assert native_built


def test_es_with_aggregation_agents_agree(tmp_path, native_built):  # noqa: F811
    lines = td.gen_app_lines(2000, seed=11)
    log = tmp_path / "app.log"
    log.write_bytes(b"\n".join(lines) + b"\n")
    basic = "Basic " + base64.b64encode(b"elastic:changeme").decode()
    runs, procs = {}, {}
    try:
        for who in PACKAGES:
            recv = chip_smoke.CaptureReceiver(
                check=lambda path, h, b: None if path == "/_bulk" and
                h.get("Authorization") == basic else f"{path}").start()
            runs[who] = recv
            procs[who] = start_agent(who, tmp_path, {
                "es_with_aggregation.yaml": td.es_aggregation_config(
                    str(log), recv.url)}, once=True)
        rcs = {who: p.wait(timeout=120) for who, p in procs.items()}
    finally:
        errors = stop_agents(procs, tmp_path)
        for recv in runs.values():
            recv.stop()
    assert errors == [] and rcs == {"ref": 0, "port": 0}
    rows = {}
    for who, recv in runs.items():
        assert recv.errors == [], who
        got = []
        for index, src in td.es_bulk_rows(recv.bodies()):
            assert index == f"logs-{src['app']}", (who, index, src)
            assert src.pop("@timestamp").endswith("Z")
            got.append(json.dumps(src, sort_keys=True))
        rows[who] = sorted(got)
    assert rows["port"] == rows["ref"]
    assert sorted(json.dumps(dict(zip(("app", "action", "latency_ms"),
                                      x.decode().split(" "))),
                             sort_keys=True) for x in lines) == rows["port"]
