"""Host metrics end to end: ``metrics_remote_write.yaml`` and
``process_entities.yaml`` (``testdata.host_metrics_config`` /
``process_entities_config``, both at a 1 s interval) in both agents, the
JAX package's and the port's, one tail-mode agent a package with both
pipelines, each to its own receivers on 127.0.0.1, with an
``nvidia-smi`` stand-in first on the agents' ``PATH`` (it prints one
card):

* remote write: both agents send the same metric names (the ``cpu``,
  ``mem``, ``disk``, ``net`` and ``gpu`` collectors) with the same label
  names, and ``gpu_memory_total_mb{gpu="0"}`` is the stand-in's
  ``memory.total`` in every sample;
* SLS: every request is signed (``chip_smoke.sls_signature_error``
  checks it with the config's keys), the receiver decodes the LZ4 block
  and the ``LogGroup`` itself, each agent's own PID is among its process
  entities, and both agents' entities and links carry the same keys and
  the same group tags.

Both agents start together and are stopped (SIGTERM, exit 0), and the
receivers closed, in a ``finally``.
"""

import os

import pytest

from conftest import wait_for
from loongcollector_tpu_torch import testdata as td
from test_torch_agents_ingest import (PACKAGES, chip_smoke, native_built,
                                      start_agent, stop_agents)
from test_torch_alarms import alarms_left_empty  # noqa: F401

assert native_built

SMI = """#!/bin/sh
case "$*" in
  *utilization.gpu*) echo "0, 12, 2048, 81559" ;;
  *) echo "stand-in" ;;
esac
"""


def _entities(recv):
    out = []
    for _, h, b in list(recv.posts):
        raw = chip_smoke.lz4_block_decompress(b, int(h["x-log-bodyrawsize"]))
        out.append(chip_smoke.decode_sls_loggroup(raw))
    return out


def _pids(recv):
    return {int(c["pid"]) for lg in _entities(recv) for _, c in lg["logs"]
            if c.get("__entity_type__") == "infra.host.process"}


@pytest.fixture(scope="module")
def host_runs(tmp_path_factory, native_built):  # noqa: F811
    tmp = tmp_path_factory.mktemp("host")
    bin_dir = tmp / "bin"
    bin_dir.mkdir()
    (bin_dir / "nvidia-smi").write_text(SMI)
    (bin_dir / "nvidia-smi").chmod(0o755)
    env = {"PATH": f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}"}
    lg_path = f"/logstores/{td.SLS_LOGSTORE}/shards/lb"
    runs, procs = {}, {}
    try:
        for who in PACKAGES:
            rw = chip_smoke.RemoteWriteReceiver().start()
            sls = chip_smoke.CaptureReceiver(
                check=lambda path, h, b: chip_smoke.sls_signature_error(
                    path, h, b, td.SLS_AK_ID, td.SLS_AK_SECRET)
                if path == lg_path else f"path {path}").start()
            runs[who] = dict(rw=rw, sls=sls)
            procs[who] = start_agent(who, tmp, {
                "metrics_remote_write.yaml": td.host_metrics_config(
                    rw.url, 1),
                "process_entities.yaml": td.process_entities_config(
                    sls.port, 1)}, env=env)
        for who, run in runs.items():
            def done(run=run, who=who):
                stamps = {ts for _, _, ts in list(run["rw"].samples)}
                return len(stamps) >= 2 and procs[who].pid in _pids(
                    run["sls"])
            assert wait_for(lambda: procs[who].poll() is not None
                            or done(), 120), who
        pids = {who: p.pid for who, p in procs.items()}
    finally:
        errors = stop_agents(procs, tmp)
        for run in runs.values():
            run["rw"].stop()
            run["sls"].stop()
    assert errors == []
    return dict(runs=runs, pids=pids)


def test_metrics_remote_write_agents_agree(host_runs):
    names, labels = {}, {}
    for who, run in host_runs["runs"].items():
        samples = list(run["rw"].samples)
        assert run["rw"].errors == [], who
        names[who] = sorted({lab["__name__"] for lab, _, _ in samples})
        labels[who] = sorted({tuple(sorted(lab)) for lab, _, _ in samples})
        gpu = [v for lab, v, _ in samples
               if lab["__name__"] == "gpu_memory_total_mb"]
        assert gpu and set(gpu) == {81559.0}, who
        assert all(lab.get("gpu") == "0" for lab, _, _ in samples
                   if lab["__name__"].startswith("gpu_")), who
    assert names["port"] == names["ref"]
    assert labels["port"] == labels["ref"]
    assert {"cpu_user_percent", "memory_total_bytes",
            "gpu_utilization_percent"} <= set(names["port"])


def test_process_entities_agents_agree(host_runs):
    keys, tags = {}, {}
    for who, run in host_runs["runs"].items():
        assert run["sls"].errors == [], who
        assert host_runs["pids"][who] in _pids(run["sls"]), who
        lgs = _entities(run["sls"])
        kinds = {}
        for lg in lgs:
            for _, c in lg["logs"]:
                kind = c.get("__entity_type__") or \
                    c.get("__src_entity_type__")
                kinds.setdefault(kind, set()).update(
                    k for k in c if k not in ("cwd", "binary", "arguments",
                                              "user"))
        keys[who] = {k: sorted(v) for k, v in kinds.items()}
        tags[who] = sorted({tuple(sorted(lg["tags"].items()))
                            for lg in lgs})
        auth = [h["Authorization"] for _, h, _ in run["sls"].posts]
        assert auth and all(a.startswith(f"LOG {td.SLS_AK_ID}:")
                            for a in auth), who
    assert keys["port"] == keys["ref"]
    assert tags["port"] == tags["ref"] == [(("__source__",
                                             "process_entity"),)]
