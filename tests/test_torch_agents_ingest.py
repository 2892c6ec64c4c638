"""HTTP ingest end to end: ``http_ingest_spl.yaml`` and
``influx_ingest.yaml`` (``testdata.http_ingest_spl_config`` /
``influx_ingest_config``) run whole in both agents, the JAX package's and
the port's, one tail-mode agent a package with both pipelines, each on its
own ports and receivers on 127.0.0.1.

* ``http_ingest_spl``: 2,000 NDJSON requests in 4 POSTs, every other
  gzipped, through ``processor_spl``'s ``where`` / ``stats`` / ``sort``
  to a ClickHouse receiver: each agent's rows equal
  ``testdata.ingest_spl_rows`` (and so each other's), each POST's rows
  arrive whole and in the SPL's sort order (``ingest_spl_runs``), every
  request an
  ``INSERT INTO logs.route_stats FORMAT JSONEachRow``;
* ``influx_ingest``: 2,000 influx points in 2 POSTs to a ``flusher_file``
  sink: each agent writes each point once, with its tags, values and
  time, and the two files hold the same records.

Both agents start together; the waits go to each server's listening port
and to the receivers' counts; both agents are stopped (SIGTERM, exit 0)
and both receivers in a ``finally``.
"""

import json
import os
import signal
import socket
import subprocess
import sys
from collections import Counter
from urllib.parse import unquote

import pytest

import chip_smoke
from conftest import wait_for
from loongcollector_tpu_torch import native as port_native
from loongcollector_tpu_torch import testdata as td
from test_torch_alarms import alarms_left_empty  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"ref": "loongcollector_tpu", "port": "loongcollector_tpu_torch"}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def listening(port):
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=1):
            return True
    except OSError:
        return False


def start_agent(who, tmp, configs, env=None, once=False):
    """A tail-mode agent of package ``who`` (``--once`` with ``once``) on
    the CPU over ``configs`` ({file name: YAML}), one worker; the port's
    writes ``--stats`` to ``<tmp>/<who>/stats.json``."""
    run = tmp / who
    cfg = run / "config"
    cfg.mkdir(parents=True)
    for name, text in configs.items():
        (cfg / name).write_text(text)
    full_env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                    LOONG_PROCESS_THREADS="1", **(env or {}))
    for key in ("LOONG_SLO", "LOONG_LEDGER", "LOONG_LEDGER_AUDIT",
                "LOONG_EXPO_PORT"):
        full_env.pop(key, None)
    args = [sys.executable, "-m", PACKAGES[who], "--config", str(cfg),
            "--data-dir", str(run / "data"), "--cpu"]
    if once:
        args.append("--once")
    if who == "port":
        args += ["--stats", str(run / "stats.json")]
    return subprocess.Popen(args, cwd=str(tmp), env=full_env,
                            stdout=subprocess.DEVNULL,
                            stderr=open(run / "agent.err", "wb"))


def stop_agents(procs, tmp):
    """SIGTERM every agent still running; each must exit 0.  Kills what
    does not exit."""
    errors = []
    for who, p in procs.items():
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for who, p in procs.items():
        try:
            rc = p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = "killed"
        if rc != 0:
            errors.append((who, rc, (tmp / who / "agent.err").read_bytes()
                           [-3000:].decode(errors="replace")))
    return errors


def port_stats(tmp):
    with open(tmp / "port" / "stats.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def native_built():
    assert port_native.ensure_built()


@pytest.fixture(scope="module")
def ingest_runs(tmp_path_factory, native_built):
    """Both agents over both configs; what each receiver and sink got."""
    tmp = tmp_path_factory.mktemp("ingest")
    recs = td.gen_ingest_records(2000, seed=7)
    posts = [recs[i:i + 500] for i in range(0, len(recs), 500)]
    points = td.gen_influx_lines(2000, seed=7)
    query = "/?query=INSERT INTO logs.route_stats FORMAT JSONEachRow"
    runs, procs = {}, {}
    try:
        for who in PACKAGES:
            recv = chip_smoke.CaptureReceiver(
                check=lambda path, h, b: None if unquote(path) == query
                else f"path {path}").start()
            ports = (free_port(), free_port())
            out = tmp / f"influx_{who}.json"
            runs[who] = dict(recv=recv, ports=ports, out=out)
            procs[who] = start_agent(who, tmp, {
                "http_ingest_spl.yaml": td.http_ingest_spl_config(
                    ports[0], recv.url),
                "influx_ingest.yaml": td.influx_ingest_config(ports[1],
                                                              out)})
        for who, run in runs.items():
            assert wait_for(lambda: procs[who].poll() is not None or all(
                listening(p) for p in run["ports"]), 120), who
            assert procs[who].poll() is None, who
        for who, run in runs.items():
            for k, post in enumerate(posts):
                chip_smoke.http_post(run["ports"][0],
                                     b"\n".join(post) + b"\n",
                                     gzipped=k % 2 == 1)
            for i in range(0, len(points), 1000):
                chip_smoke.http_post(run["ports"][1],
                                     b"\n".join(points[i:i + 1000]) + b"\n",
                                     content_type="text/plain")
        runs_want = td.ingest_spl_runs(posts)
        want = td.ingest_spl_rows(posts)
        for who, run in runs.items():
            def done(run=run):
                out = run["out"]
                rows = sum(b.count(b"\n") for b in run["recv"].bodies())
                lines = out.read_bytes().count(b"\n") if out.exists() \
                    else 0
                return rows >= len(want) and lines >= len(points)
            assert wait_for(lambda: procs[who].poll() is not None
                            or done(), 120), who
    finally:
        errors = stop_agents(procs, tmp)
        for run in runs.values():
            run["recv"].stop()
    assert errors == []
    return dict(runs=runs, want=want, want_runs=runs_want, points=points,
                stats=port_stats(tmp))


def test_http_ingest_spl_agents_agree(ingest_runs):
    want = Counter(ingest_runs["want"])
    rows = {}
    for who, run in ingest_runs["runs"].items():
        assert run["recv"].errors == [], who
        got = Counter()
        for body in run["recv"].bodies():
            for line in body.splitlines():
                r = json.loads(line)
                got[(r["route"], r["count"], r["avg_latency_ms"])] += 1
        rows[who] = got
        # each POST's rows whole and in the SPL's sort order
        assert chip_smoke.spl_run_errors(
            run["recv"].bodies(), ingest_runs["want_runs"]) == [], who
    assert rows["port"] == rows["ref"] == want
    st = ingest_runs["stats"]
    assert st["send"]["status_counts"] == {
        "200": ingest_runs["runs"]["port"]["recv"].answers[200]}


def test_influx_ingest_agents_agree(ingest_runs):
    want = td.influx_samples(ingest_runs["points"])
    records = {}
    for who, run in ingest_runs["runs"].items():
        seen = {}
        recs = [json.loads(x) for x in run["out"].read_bytes().splitlines()]
        for r in recs:
            lab = r["__labels__"]
            key = (lab["host"], lab["region"], r["__time__"] * 10**9)
            assert r["__name__"] == "cpu" and key not in seen, (who, r)
            seen[key] = r["__values__"]
        assert seen == want, who
        records[who] = sorted(json.dumps(r, sort_keys=True) for r in recs)
    assert records["port"] == records["ref"]
