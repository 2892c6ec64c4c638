"""The extension plane end to end: ``http_with_extensions.yaml``
(``testdata.http_extensions_config``, the request breaker's window cut to
4 s) in both agents, the JAX package's and the port's, each with its own
receiver on 127.0.0.1: 1,500 JSON records in 3 POSTs through
``ext_default_decoder``, grouped by ``env``, to a receiver that refuses a
request without ``ext_basicauth``'s header and answers 503 to its first
4 requests.  In both agents every ``env=prod`` record arrives once and no
other, and the port's ``--stats`` shows ``ext_request_breaker`` opened and
closed again.  The breaker trips at its fifth ``allow`` (four results in
its window, all 503s: the retries at 0, 0.2, 0.6 and 1.4 s of one
payload), so its window must hold 3 s of results.  The outage is counted
in requests, not seconds, so that a slow host still sends the four.

Both agents start together; both agents and receivers are stopped in a
``finally``.
"""

import base64
import itertools
import json

from conftest import wait_for
from loongcollector_tpu_torch import testdata as td
from test_torch_agents_ingest import (PACKAGES, chip_smoke, free_port,
                                      listening, native_built, port_stats,
                                      start_agent, stop_agents)
from test_torch_alarms import alarms_left_empty  # noqa: F401

assert native_built


def test_http_with_extensions_agents_agree(tmp_path, native_built):  # noqa: F811
    recs = td.gen_extension_records(1500, seed=9)
    want = sorted(json.loads(r)["id"] for r in recs
                  if json.loads(r)["env"] == "prod")
    basic = "Basic " + base64.b64encode(
        f"{td.EXT_USER}:{td.EXT_PASSWORD}".encode()).decode()
    runs, procs = {}, {}
    try:
        for who in PACKAGES:
            calls = itertools.count()
            recv = chip_smoke.CaptureReceiver(
                status=lambda t, calls=calls: 503 if next(calls) < 4
                else 200,
                check=lambda path, h, b: None if h.get("Authorization")
                == basic else "no Basic header").start()
            port = free_port()
            runs[who] = dict(recv=recv, port=port)
            procs[who] = start_agent(who, tmp_path, {
                "http_with_extensions.yaml": td.http_extensions_config(
                    port, recv.url + "/ingest", window_s=4)})
        for who, run in runs.items():
            assert wait_for(lambda: procs[who].poll() is not None
                            or listening(run["port"]), 120), who
        for who, run in runs.items():
            for i in range(0, len(recs), 500):
                chip_smoke.http_post(run["port"],
                                     b"\n".join(recs[i:i + 500]) + b"\n")

        def ids(run):
            return sorted(json.loads(x)["id"] for b in run["recv"].bodies()
                          for x in b.splitlines())
        for who, run in runs.items():
            assert wait_for(lambda: procs[who].poll() is not None
                            or len(ids(run)) >= len(want), 120), who
    finally:
        errors = stop_agents(procs, tmp_path)
        for run in runs.values():
            run["recv"].stop()
    assert errors == []
    for who, run in runs.items():
        assert run["recv"].errors == [], who
        assert run["recv"].answers.get(503, 0) == 4, (who,
                                                      run["recv"].answers)
        assert ids(run) == want, who
    br = port_stats(tmp_path)["extensions"][
        "http_with_extensions/ext_request_breaker"]
    assert br["opened"] >= 1 and br["closed"] >= 1, br
