"""The send path end to end on the CPU.

* The shipped rollup config through ``flusher_prometheus``
  (``testdata.metric_rollup_remote_write_config``): the port's agent
  (``--cpu --once``, ledger on) and the JAX agent, each with its own
  remote-write receiver on 127.0.0.1 (``chip_smoke.RemoteWriteReceiver``)
  and its own ``--data-dir``, on one corpus: the decoded sample sets
  agree (sums within rtol = atol = 1e-5, the rest exact), every sample
  arrives once, the port's ledger residual is 0 and its sender queues are
  empty at exit.
* A checkpoint waits for delivery: a tail-mode agent shipping a log
  through ``flusher_http`` to a receiver that answers 503 keeps the log's
  acked offset below the undelivered spans (its breaker held closed); it
  moves to the end once the receiver answers 200; and with the breaker
  free to trip, the spans spilled to the disk buffer are acked while the
  receiver still refuses.
* A ``--once`` run whose sink never answers and whose buffer is a
  temporary one fails (exit 1) and keeps the buffer.

The retry constants are cut as ``tests/test_chaos_soak.py:60-63`` cuts
them, the exit budget (``exit_flush_timeout``) to a second or two; each
receiver is stopped by its fixture and no thread outlives a test.
"""

import json
import os
import subprocess
import sys
import threading

import pytest
import torch

import chip_smoke
from conftest import wait_for
from loongcollector_tpu_torch import application
from loongcollector_tpu_torch import native as port_native
from loongcollector_tpu_torch import recovery as port_recovery
from loongcollector_tpu_torch import testdata as td
from loongcollector_tpu_torch.input.file.file_server import FileServer
from loongcollector_tpu_torch.runner import ack_watermark as port_ack
from loongcollector_tpu_torch.runner import circuit as port_circuit
from loongcollector_tpu_torch.runner import flusher_runner as port_fr
from loongcollector_tpu_torch.utils import flags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _send_state(monkeypatch):
    before = set(threading.enumerate())
    monkeypatch.setattr(port_fr, "RETRY_BASE_S", 0.02)
    monkeypatch.setattr(port_fr, "RETRY_MAX_S", 0.25)
    budget = flags.get_flag("exit_flush_timeout")
    port_ack.tracker().reset()
    port_recovery.reset()
    FileServer.reset_for_testing()
    yield
    flags.set_flag("exit_flush_timeout", budget)
    FileServer.reset_for_testing()
    port_ack.tracker().reset()
    port_recovery.reset()
    assert wait_for(lambda: set(threading.enumerate()) <= before, 10.0), \
        set(threading.enumerate()) - before


@pytest.fixture
def receiver():
    made = []

    def make(status=lambda t: 200):
        r = chip_smoke.RemoteWriteReceiver(status).start()
        made.append(r)
        return r

    yield make
    for r in made:
        r.stop()


def test_rollup_remote_write_agents_agree(tmp_path, receiver, monkeypatch):
    # a whole library in place (the port's locked build) before either
    # agent loads it: the JAX agent's flusher_prometheus needs its snappy
    assert port_native.ensure_built()
    lines = td.gen_metrics_jsonl(3200, seed=17)
    log = tmp_path / "metrics.jsonl"
    log.write_bytes(b"\n".join(lines) + b"\n")
    oracle, _ = td.metrics_oracle(lines)
    rows = {}
    for who in ("ref", "port"):
        recv = receiver()
        cfg_dir = tmp_path / f"cfg_{who}"
        cfg_dir.mkdir()
        (cfg_dir / "rollup.yaml").write_text(
            td.metric_rollup_remote_write_config(str(log), recv.url))
        if who == "ref":
            env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
            env.pop("LOONG_AGG_SUBSTRATE", None)
            subprocess.run([sys.executable, "-m", "loongcollector_tpu",
                            "--config", str(cfg_dir), "--once",
                            "--data-dir", str(tmp_path / "ref_data")],
                           cwd=str(tmp_path), env=env, check=True,
                           capture_output=True, timeout=300)
        else:
            monkeypatch.setenv("LOONG_LEDGER", "1")
            monkeypatch.delenv("LOONG_AGG_SUBSTRATE", raising=False)
            stats_path = tmp_path / "stats.json"
            assert application.main([
                "--config", str(cfg_dir), "--once", "--cpu",
                "--data-dir", str(tmp_path / "port_data"),
                "--stats", str(stats_path)]) == 0
            stats = json.loads(stats_path.read_text())
        assert recv.errors == []
        rows[who] = td.rollup_sample_rows(recv.samples)   # each once
    assert len(rows["port"]) == len(oracle) == 1600
    assert td.rollup_mismatches(rows["port"], rows["ref"]) == []
    assert td.rollup_mismatches(rows["port"], oracle, f32_want=True) == []
    assert stats["ledger"]["residuals"] == {"rollup": 0}
    snap = stats["ledger"]["snapshot"]["rollup"]
    assert snap["send_ok"]["events"] == len(rows["port"])
    send = stats["send"]
    assert send["sender_queues_empty"] and send["dropped_items"] == {}
    assert send["status_counts"] == {"200": send["requests"]}
    assert send["breakers"]["rollup/flusher_prometheus"]["transitions"] == \
        ["closed"]
    assert send["spilled"] == 0 and send["buffer_pending"] == 0


def _http_config(log_path, url):
    return {"inputs": [{"Type": "input_file", "FilePaths": [str(log_path)]}],
            "flushers": [{"Type": "flusher_http", "RemoteURL": url,
                          "TimeoutSecs": 0.2}]}


class _JsonReceiver:
    """Collects flusher_http's NDJSON bodies; answers ``status[0]``."""

    def __init__(self):
        import http.server
        self.status = [503]
        self.lines = []
        self.refused = 0
        recv = self

        class H(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                st = recv.status[0]
                if st == 200:
                    recv.lines.extend(json.loads(x)["content"]
                                      for x in body.splitlines() if x)
                else:
                    recv.refused += 1
                self.send_response(st)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_port}/ingest"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5)


def _tail(tmp_path, config, stop):
    result = {}

    def run():
        try:
            result["stats"] = application.run_configs(
                [("tail", config)], torch.device("cpu"),
                data_dir=str(tmp_path / "data"), stop=stop)
        except BaseException as e:  # noqa: BLE001 — asserted below
            result["error"] = e

    t = threading.Thread(target=run)
    t.start()
    return t, result


@pytest.mark.parametrize("breaker_trips", [False, True])
def test_checkpoint_waits_for_delivery(tmp_path, monkeypatch, breaker_trips):
    flags.set_flag("exit_flush_timeout", 1.0)
    if not breaker_trips:
        # the breaker held closed: the payloads stay in the retry path
        monkeypatch.setattr(
            port_fr, "SinkCircuitBreaker",
            lambda name, **kw: port_circuit.SinkCircuitBreaker(
                name, **dict(kw, failure_threshold=10**6, error_rate=1.0)))
    log = tmp_path / "app.log"
    lines = [b"line %04d " % i + b"x" * 40 for i in range(300)]
    log.write_bytes(b"\n".join(lines) + b"\n")
    size = log.stat().st_size
    st = log.stat()
    recv = _JsonReceiver()
    stop = threading.Event()
    t, result = _tail(tmp_path, _http_config(log, recv.url), stop)
    try:
        acked = lambda: port_ack.durable_offset(st.st_dev, st.st_ino, -1)
        if breaker_trips:
            # five failures open the breaker; the payloads spill and
            # their spans are acked while the receiver still refuses
            assert wait_for(lambda: acked() == size, 15.0), acked()
            assert recv.lines == [] and recv.refused >= 5
            assert os.listdir(tmp_path / "data" / "buffer" / "tail")
        else:
            assert wait_for(lambda: recv.refused >= 4, 15.0)
            assert acked() == 0 and recv.lines == []
            recv.status[0] = 200
            assert wait_for(lambda: acked() == size, 15.0), acked()
            assert recv.lines == [ln.decode() for ln in lines]
    finally:
        stop.set()
        t.join(60)
        recv.stop()
    assert not t.is_alive()
    assert "error" not in result, result.get("error")
    send = result["stats"]["send"]
    assert send["dropped_items"] == {}
    if breaker_trips:
        assert send["spilled"] >= 1 and send["buffer_pending"] >= 1
        assert "open" in send["breakers"]["tail/flusher_http"]["transitions"]
    else:
        assert send["spilled"] == 0 and send["retries"] >= 4
    cps = result["stats"]["tail"]["checkpoints"]
    assert [c["offset"] for c in cps.values()] == [size]


def test_once_with_an_unreachable_sink_fails(tmp_path, monkeypatch):
    """--once without --data-dir: a payload left in the temporary buffer
    is data missing, so the run exits 1 and the buffer is kept."""
    flags.set_flag("exit_flush_timeout", 1.5)
    tmpdir = tmp_path / "tmp"
    tmpdir.mkdir()
    monkeypatch.setenv("TMPDIR", str(tmpdir))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    log = tmp_path / "app.log"
    log.write_bytes(b"a\nb\n")
    recv = _JsonReceiver()
    cfg_dir = tmp_path / "cfg"
    cfg_dir.mkdir()
    (cfg_dir / "p.json").write_text(json.dumps(_http_config(log, recv.url)))
    try:
        rc = application.main(["--config", str(cfg_dir), "--once", "--cpu"])
    finally:
        recv.stop()
    assert rc == 1
    kept = [d for d in os.listdir(tmpdir) if d.startswith("lct-once-")]
    assert len(kept) == 1
    assert os.listdir(tmpdir / kept[0] / "buffer" / "p")
