"""Tail mode end to end: the port's ``FileServer`` against the JAX
package's, and the port's tail agent against the JAX package's.

* The two file servers side by side, each with its own package's process
  queues, on the same files, polling alone (``LOONG_DISABLE_INOTIFY=1``)
  and with inotify: the JAX package's ``tests/test_file_hardening.py``
  scenarios (a queue at its high watermark resumed by its feedback, five
  rotation generations, a rotation with an unread tail, a truncation
  below the offset, a config whose paths change) and discovery (a glob
  with excludes, files created later, ``TailExisted`` off): each server
  pushes every line, in order per file, and the two push the same lines.
* The reader ceiling (``max_file_reader_num``) and the read-delay alarm,
  raised on both packages' alarm planes alike.
* A multiline record held open in the file ships by the timeouts (the
  reader's hold, then split_multiline's carry on the pipeline's timeout
  tick) while the source stays idle.
* The port's tail agent (``python -m loongcollector_tpu_torch --config D
  --data-dir D2 --cpu``) and the JAX package's on the same appended and
  rotated Apache log, stopped by SIGTERM: the NDJSON bytes are equal (the
  read time aside) and equal the ``re`` oracle's records.
* The port's agent killed by SIGKILL mid-stream and restarted on its data
  dir while the log grows: no line is lost, and every duplicate is a line
  whose span was neither below the checkpoint nor in the ack journal when
  the agent died (the JAX package's duplicate bound); a clean restart
  after a SIGTERM reads on with no duplicate.

Every agent run has a data dir of its own under ``tmp_path``; every
subprocess is killed and waited for in a ``finally``; no thread outlives a
test.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading

import pytest
import torch

from conftest import wait_for
from loongcollector_tpu.input.file.file_server import \
    FileServer as RefFileServer
from loongcollector_tpu.input.file.polling import \
    FileDiscoveryConfig as RefDiscovery
from loongcollector_tpu.pipeline.queue.process_queue_manager import \
    ProcessQueueManager as RefPQM
from loongcollector_tpu.utils import flags as ref_flags
from loongcollector_tpu_torch import application, recovery
from loongcollector_tpu_torch import testdata as td
from loongcollector_tpu_torch.input.file import file_server as port_fs_mod
from loongcollector_tpu_torch.input.file.file_server import FileServer
from loongcollector_tpu_torch.input.file.polling import FileDiscoveryConfig
from loongcollector_tpu_torch.pipeline.queue.process_queue_manager import \
    ProcessQueueManager
from loongcollector_tpu_torch.processor import split_multiline
from loongcollector_tpu_torch.runner import ack_watermark
from loongcollector_tpu_torch.utils import flags as port_flags
from test_torch_alarms import alarms_left_empty  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TIME = re.compile(rb'"__time__": \d+')
# deadlines of the waits on spawned agents: a cold ``import torch`` and the
# agent's start took up to 9.2 s on an idle 8-core machine loaded with
# eight busy loops, so under a six-worker test run they pass 10 s; each
# wait ends as soon as its condition holds
AGENT_START_S = 120.0   # spawn to the agent's own readiness mark
AGENT_SINK_S = 60.0     # readiness to what the test waits for in the sink


@pytest.fixture(autouse=True)
def _port_tail_state():
    """The port's process-wide tail state, reset around every test as
    ``conftest.py`` resets the JAX package's; no thread outlives a test."""
    before = set(threading.enumerate())
    ack_watermark.tracker().reset()
    recovery.reset()
    FileServer.reset_for_testing()
    yield
    FileServer.reset_for_testing()
    ack_watermark.tracker().reset()
    recovery.reset()
    assert wait_for(lambda: set(threading.enumerate()) <= before, 10.0), \
        set(threading.enumerate()) - before


@pytest.fixture(params=["polling", "inotify"])
def mode(request, monkeypatch):
    if request.param == "polling":
        monkeypatch.setenv("LOONG_DISABLE_INOTIFY", "1")
    else:
        monkeypatch.delenv("LOONG_DISABLE_INOTIFY", raising=False)
    return request.param


# -- the two file servers side by side ----------------------------------------

def _lines_from(groups):
    out = []
    for g in groups:
        cols = g.columns
        raw = bytes(g.source_buffer.raw)
        for o, n in zip(cols.offsets, cols.lengths):
            out.append(raw[int(o):int(o) + int(n)])
    return out


class _Side:
    """One package's file server and process queues."""

    def __init__(self, fs, pqm, discovery_cls):
        self.fs, self.pqm, self.discovery_cls = fs, pqm, discovery_cls
        fs.process_queue_manager = pqm
        self.groups = []

    def drain(self, key):
        while True:
            item = self.pqm.pop_item(timeout=0)
            if item is None:
                return
            assert item[0] == key
            self.groups.append(item[1])

    def lines(self):
        return _lines_from(self.groups)


class _Servers:
    """The port's ``FileServer`` and the JAX package's, driven in step."""

    def __init__(self, tmp_path):
        self.port = _Side(FileServer(), ProcessQueueManager(),
                          FileDiscoveryConfig)
        self.ref = _Side(RefFileServer(), RefPQM(), RefDiscovery)
        self.sides = (self.port, self.ref)
        for i, side in enumerate(self.sides):
            side.fs.checkpoints.path = str(tmp_path / f"cp{i}.json")

    def queue(self, key, capacity=1000):
        for side in self.sides:
            side.pqm.create_or_reuse_queue(key, capacity=capacity)

    def add(self, name, paths, key, **kw):
        for side in self.sides:
            side.fs.add_config(name, side.discovery_cls(list(paths), **{
                k: v for k, v in kw.items() if k.startswith("exclude")}),
                key, **{k: v for k, v in kw.items()
                        if not k.startswith("exclude")})

    def start(self):
        for side in self.sides:
            side.fs.start()

    def wait_lines(self, key, n):
        def enough():
            for side in self.sides:
                side.drain(key)
            return all(len(side.lines()) >= n for side in self.sides)
        assert wait_for(enough, 10.0), [len(s.lines()) for s in self.sides]
        got, want = self.port.lines(), self.ref.lines()
        assert got == want
        return got

    def stop(self):
        for side in self.sides:
            side.fs.stop()


@pytest.fixture
def servers(tmp_path):
    srv = _Servers(tmp_path)
    try:
        yield srv
    finally:
        srv.stop()


def test_blocked_queue_resumes_on_feedback(servers, tmp_path, mode):
    log = tmp_path / "b.log"
    lines = [f"line-{i:05d}".encode() for i in range(400)]
    log.write_bytes(b"\n".join(lines) + b"\n")
    # a tiny queue and tiny chunks: the drain hits the high watermark
    servers.queue(7, capacity=2)
    servers.add("blk", [str(log)], 7, tail_existing=True, chunk_size=256)
    servers.start()
    assert wait_for(lambda: not servers.port.pqm.is_valid_to_push(7), 10.0)
    assert wait_for(lambda: 7 in servers.port.fs._feedback_keys, 10.0)
    assert servers.wait_lines(7, len(lines)) == lines


def test_rotation_generations_lose_nothing(servers, tmp_path, mode):
    log = tmp_path / "rot.log"
    servers.queue(8)
    servers.add("rot", [str(log)], 8, tail_existing=True)
    log.write_bytes(b"gen-0 a\ngen-0 b\n")
    servers.start()
    expect = [b"gen-0 a", b"gen-0 b"]
    for gen in range(1, 6):
        assert servers.wait_lines(8, len(expect)) == expect
        os.rename(log, tmp_path / f"rot.log.{gen}")
        new = [f"gen-{gen} a".encode(), f"gen-{gen} b".encode()]
        log.write_bytes(b"\n".join(new) + b"\n")
        expect.extend(new)
    assert servers.wait_lines(8, len(expect)) == expect


def test_rotation_with_unread_tail(servers, tmp_path, mode):
    log = tmp_path / "tail.log"
    servers.queue(9)
    servers.add("tail", [str(log)], 9, tail_existing=True)
    log.write_bytes(b"early\n")
    servers.start()
    servers.wait_lines(9, 1)
    with open(log, "ab") as f:
        f.write(b"late-but-owed\n")
    os.rename(log, tmp_path / "tail.log.1")
    log.write_bytes(b"fresh\n")

    def done():
        for side in servers.sides:
            side.drain(9)
        return all(len(s.lines()) >= 3 for s in servers.sides)
    assert wait_for(done, 10.0)
    for side in servers.sides:
        assert sorted(side.lines()) == [b"early", b"fresh", b"late-but-owed"]


def test_truncate_below_offset_restarts(servers, tmp_path, mode):
    log = tmp_path / "tr.log"
    servers.queue(10)
    servers.add("tr", [str(log)], 10, tail_existing=True)
    log.write_bytes(b"old-1\nold-2\nold-3\n")
    servers.start()
    servers.wait_lines(10, 3)
    with open(log, "wb") as f:
        f.write(b"new-1\nnew-2\n")
    assert servers.wait_lines(10, 5) == [b"old-1", b"old-2", b"old-3",
                                         b"new-1", b"new-2"]


def test_config_paths_switch_files(servers, tmp_path, mode):
    old, new = tmp_path / "c-old.log", tmp_path / "c-new.log"
    servers.queue(11)
    servers.add("churn", [str(old)], 11, tail_existing=True)
    old.write_bytes(b"from-old\n")
    servers.start()
    servers.wait_lines(11, 1)
    new.write_bytes(b"from-new\n")
    for side in servers.sides:
        side.fs.update_config_paths("churn", [str(new)])
    assert servers.wait_lines(11, 2) == [b"from-old", b"from-new"]
    assert wait_for(lambda: not servers.port.fs._configs["churn"].readers
                    .get(str(old)), 10.0)


def test_discovery_globs_excludes_and_tail_existing(servers, tmp_path, mode):
    d = tmp_path / "logs"
    d.mkdir()
    (d / "a.log").write_bytes(b"a-history\n")
    (d / "skip.log").write_bytes(b"excluded\n")
    servers.queue(12)
    servers.add("disc", [str(d / "*.log")], 12, tail_existing=False,
                exclude_files=["skip.*"])
    servers.start()
    # the history of a file seen at start is skipped; what follows ships
    assert wait_for(lambda: all(s.fs._configs["disc"].readers
                                for s in servers.sides), 10.0)
    with open(d / "a.log", "ab") as f:
        f.write(b"a-new\n")
    assert servers.wait_lines(12, 1) == [b"a-new"]
    # a file created later is read from its start
    (d / "b.log").write_bytes(b"b-1\nb-2\n")
    got = servers.wait_lines(12, 3)
    assert sorted(got) == [b"a-new", b"b-1", b"b-2"]
    for side in servers.sides:
        assert sorted(side.fs._configs["disc"].readers) == [
            str(d / "a.log"), str(d / "b.log")]


def test_server_uses_inotify_only_when_asked(tmp_path, mode):
    fs = FileServer.instance()
    fs.process_queue_manager = ProcessQueueManager()
    fs.add_config("x", FileDiscoveryConfig([str(tmp_path / "*.log")]), 1)
    fs.start()
    try:
        from loongcollector_tpu_torch.input.file.event_listener import \
            create_listener
        probe = create_listener()
        has_inotify = probe is not None
        if probe is not None:
            probe.close()
        assert fs.status()["inotify"] == (mode == "inotify" and has_inotify)
    finally:
        FileServer.reset_for_testing()
    assert not fs.running


def test_reader_ceiling_and_delay_alarms_are_counted(tmp_path, monkeypatch):
    for reg in (port_flags._registry, ref_flags._registry):
        monkeypatch.setattr(reg["max_file_reader_num"], "value", 2)
        monkeypatch.setattr(reg["read_delay_alarm_bytes"], "value", 64)
        monkeypatch.setattr(reg["read_delay_alarm_duration"], "value", 0)
    for i in range(4):
        (tmp_path / f"r{i}.log").write_bytes(b"x" * 200 + b"\n")
    from loongcollector_tpu.monitor.alarms import AlarmManager
    from loongcollector_tpu_torch.monitor.alarms import \
        AlarmManager as PortAlarms
    AlarmManager.instance().flush()
    PortAlarms.instance().reset()
    counts = []
    raised = []
    for fs_cls, pqm_cls, disc in ((FileServer, ProcessQueueManager,
                                   FileDiscoveryConfig),
                                  (RefFileServer, RefPQM, RefDiscovery)):
        fs = fs_cls()
        pqm = pqm_cls()
        q = pqm.create_or_reuse_queue(21, capacity=1)
        fs.process_queue_manager = pqm
        fs.add_config("lim", disc([str(tmp_path / "r*.log")]), 21,
                      tail_existing=True, chunk_size=64)
        # a queue that stays full: the readers keep their backlog
        while q.is_valid_to_push():
            q.push(_empty_group(pqm_cls))
        fs._round()
        counts.append(fs._reader_count())
        if fs_cls is FileServer:
            totals = PortAlarms.instance().totals()
            assert totals["FILE_READER_EXCEED"] >= 1
            assert totals["READ_LOG_DELAY"] == 2
            assert fs.status()["alarms"] == totals
        mgr = PortAlarms if fs_cls is FileServer else AlarmManager
        raised.append(sorted(
            (d["alarm_type"], d["alarm_level"], d["pipeline"],
             d["alarm_message"].replace(str(tmp_path), "<dir>"))
            for d in mgr.instance().flush()))
        fs.stop()
        for st in list(fs._configs):
            fs.remove_config(st)
    # the JAX package's alarms stay out of later tests in this worker
    AlarmManager.instance().flush()
    PortAlarms.instance().reset()
    assert counts == [2, 2]
    # both raise the same alarms, at the same levels, with one message
    assert raised[0] == raised[1]
    assert {r[0] for r in raised[0]} == {"FILE_READER_EXCEED_ALARM",
                                          "READ_LOG_DELAY_ALARM"}


def _empty_group(pqm_cls):
    if pqm_cls is RefPQM:
        from loongcollector_tpu.models import PipelineEventGroup
    else:
        from loongcollector_tpu_torch.models import PipelineEventGroup
    return PipelineEventGroup()


# -- the agents ----------------------------------------------------------------

def _java_config(log_path, out_path):
    return {"inputs": [{"Type": "input_file", "FilePaths": [str(log_path)],
                        "Multiline": {"StartPattern": td.JAVA_START}}],
            "processors": [{"Type": "processor_parse_regex_native",
                            "SourceKey": "content", "Regex": td.JAVA_PARSE,
                            "Keys": list(td.JAVA_KEYS)}],
            "flushers": [{"Type": "flusher_file",
                          "FilePath": str(out_path)}]}


def _records(path):
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        data = f.read()
    return [json.loads(x) for x in data.splitlines()]


def test_held_multiline_record_ships_by_timeout(tmp_path, monkeypatch):
    """An idle source's open record: the reader holds it for its flush
    timeout, ships it marked partial, and split_multiline's carry ships it
    on the pipeline's timeout tick (both timeouts cut to half a second)."""
    monkeypatch.setattr(port_fs_mod, "ML_FLUSH_TIMEOUT_S", 0.5)
    monkeypatch.setattr(split_multiline, "CARRY_FLUSH_S", 0.5)
    log, out = tmp_path / "app.log", tmp_path / "out.json"
    head = (b"2024-01-01 10:00:00 INFO first\n  at a\n"
            b"2024-01-01 10:00:01 ERROR second\n  at b\n  at c\n")
    log.write_bytes(head)
    stop = threading.Event()
    result = {}

    def run():
        result["stats"] = application.run_configs(
            [("java", _java_config(log, out))], torch.device("cpu"),
            data_dir=str(tmp_path / "data"), stop=stop)

    t = threading.Thread(target=run)
    t.start()
    try:
        # the open record ships while the source is idle, before the stop
        assert wait_for(lambda: len(_records(out)) >= 2, 10.0)
        recs = _records(out)
        assert [r["message"] for r in recs] == ["first\n  at a",
                                                "second\n  at b\n  at c"]
    finally:
        stop.set()
        t.join(30)
    assert not t.is_alive()
    st = result["stats"]["tail"]
    assert st["groups_pushed"] >= 2
    assert not os.path.exists(tmp_path / "data" / "unclean.marker")


def _write_configs(tmp_path, log_path):
    outs = {}
    for who in ("port", "ref"):
        cfg = tmp_path / f"cfg_{who}"
        cfg.mkdir()
        outs[who] = tmp_path / f"out_{who}.json"
        (cfg / "apache.yaml").write_text(td.apache_config(str(log_path),
                                                          str(outs[who])))
    return outs


def _spawn(who, tmp_path, data_dir, stats=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    pkg = "loongcollector_tpu_torch" if who == "port" else \
        "loongcollector_tpu"
    cmd = [sys.executable, "-m", pkg, "--config", str(tmp_path / f"cfg_{who}"),
           "--data-dir", str(data_dir), "--cpu"]
    if stats:
        cmd += ["--stats", str(stats)]
    return subprocess.Popen(cmd, cwd=str(tmp_path), env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)


def _terminate(proc):
    proc.send_signal(signal.SIGTERM)
    _out, err = proc.communicate(timeout=AGENT_SINK_S)
    assert proc.returncode == 0, err.decode(errors="replace")[-3000:]


def _kill_all(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
        if p.stderr is not None:
            p.stderr.close()


def _count_lines(path):
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as f:
        return f.read().count(b"\n")


def test_tail_agents_agree_across_appends_and_rotation(tmp_path):
    log = tmp_path / "access.log"
    lines = td.gen_lines(4000, seed=31)
    log.write_bytes(b"\n".join(lines[:2000]) + b"\n")
    outs = _write_configs(tmp_path, log)
    procs = []
    try:
        for who in ("port", "ref"):
            procs.append(_spawn(who, tmp_path, tmp_path / f"data_{who}"))
        assert wait_for(lambda: all(
            (tmp_path / f"data_{w}" / "unclean.marker").exists()
            for w in ("port", "ref")), AGENT_START_S)
        for n, step in ((2000, None), (3000, "append"), (4000, "rotate")):
            if step == "append":
                with open(log, "ab") as f:
                    f.write(b"\n".join(lines[2000:3000]) + b"\n")
            elif step == "rotate":
                os.rename(log, tmp_path / "access.log.1")
                log.write_bytes(b"\n".join(lines[3000:]) + b"\n")
            assert wait_for(lambda n=n: all(
                _count_lines(o) >= n for o in outs.values()),
                AGENT_SINK_S), \
                {w: _count_lines(o) for w, o in outs.items()}
        for p in procs:
            _terminate(p)
    finally:
        _kill_all(procs)
    got = _TIME.sub(b'"__time__": 0', outs["port"].read_bytes())
    want = _TIME.sub(b'"__time__": 0', outs["ref"].read_bytes())
    assert got == want
    recs = [json.loads(x) for x in got.splitlines()]
    oracle = td.apache_oracle(lines)
    assert [{k: r.get(k) for k in td.APACHE_KEYS} for r in recs] == oracle
    for who in ("port", "ref"):
        assert not (tmp_path / f"data_{who}" / "unclean.marker").exists()
        with open(tmp_path / f"data_{who}" / "checkpoints.json") as f:
            cps = json.load(f)["check_point"]
        # the live file's checkpoint stands at its end
        live = [c for c in cps.values() if c["path"] == str(log)]
        assert [c["offset"] for c in live] == [os.path.getsize(log)]


def _line_index(lines):
    """Record fields → the line indexes that give them."""
    index = {}
    for i, rec in enumerate(td.apache_oracle(lines)):
        index.setdefault(tuple(rec[k] for k in td.APACHE_KEYS), []).append(i)
    return index


def _covered(data_dir, log_path, offsets):
    """Line start offsets (by index) the checkpoint or the ack journal of
    ``data_dir`` covers: a restart does not deliver those again."""
    st = os.stat(log_path)
    ranges = []
    cp_file = os.path.join(data_dir, "checkpoints.json")
    if os.path.exists(cp_file):
        with open(cp_file) as f:
            for c in json.load(f)["check_point"].values():
                if (c["dev"], c["inode"]) == (st.st_dev, st.st_ino):
                    ranges.append((0, c["offset"]))
    journal = os.path.join(data_dir, "ack_journal.jsonl")
    if os.path.exists(journal):
        with open(journal) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue          # a torn last line
                if (rec["d"], rec["i"]) == (st.st_dev, st.st_ino):
                    ranges.append((rec["o"], rec["o"] + rec["l"]))
    return {i for i, off in enumerate(offsets)
            if any(a <= off < b for a, b in ranges)}


def test_sigkill_restart_loses_nothing(tmp_path):
    log = tmp_path / "access.log"
    # ~1 MB before the kill: two reader chunks, so the kill lands while
    # the second is in flight or just acked
    lines = td.gen_lines(15000, seed=37)
    offsets, pos = [], 0
    for ln in lines:
        offsets.append(pos)
        pos += len(ln) + 1
    log.write_bytes(b"\n".join(lines[:12000]) + b"\n")
    outs = _write_configs(tmp_path, log)
    out, data = outs["port"], tmp_path / "data_port"
    procs = []
    try:
        first = _spawn("port", tmp_path, data)
        procs.append(first)
        # the agent marks its start (its data dir's unclean marker) before
        # it reads: the cold start gets its own deadline
        assert wait_for(lambda: (data / "unclean.marker").exists(),
                        AGENT_START_S)
        assert wait_for(lambda: _count_lines(out) > 0, AGENT_SINK_S)
        first.send_signal(signal.SIGKILL)
        first.wait()
        # a write the kill cut short was never acked, so the restart writes
        # its group again: cut the torn line off the sink
        data_out = out.read_bytes()
        out.write_bytes(data_out[:data_out.rfind(b"\n") + 1])
        before = _records(out)
        covered = _covered(str(data), str(log), offsets)
        with open(log, "ab") as f:
            f.write(b"\n".join(lines[12000:]) + b"\n")
        stats = tmp_path / "stats.json"
        second = _spawn("port", tmp_path, data, stats)
        procs.append(second)
        # the restart counts the unclean shutdown as it begins
        assert wait_for(lambda: (data / "recovery_state.json").exists(),
                        AGENT_START_S)
        assert wait_for(lambda: _count_lines(out) >= len(lines),
                        AGENT_SINK_S)
        _terminate(second)
    finally:
        _kill_all(procs)
    index = _line_index(lines)
    seen = {}
    for rec in _records(out):
        key = tuple(rec[k] for k in td.APACHE_KEYS)
        seen[key] = seen.get(key, 0) + 1
    want = {}
    for key, idx in index.items():
        want[key] = len(idx)
    lost = [k for k, n in want.items() if seen.get(k, 0) < n]
    assert not lost, f"{len(lost)} lines lost"
    dup_lines = set()
    for key, n in seen.items():
        if n > want[key]:
            dup_lines.update(index[key])
    delivered_before = {i for rec in before for i in
                        index[tuple(rec[k] for k in td.APACHE_KEYS)]}
    # a duplicate is a line delivered before the kill whose span neither
    # the checkpoint nor the journal held
    assert dup_lines <= delivered_before - covered
    st = json.loads(stats.read_text())["tail"]
    assert st["recovery"]["unclean_shutdown"] is True
    assert st["recovery"]["replay_duplicate_events"] >= 0
    assert not (data / "unclean.marker").exists()
    assert len(before) > 0


def test_clean_restart_reads_on_without_duplicates(tmp_path):
    """Two in-process tail runs on one data dir, the log growing between
    them: the second resumes at the checkpoint the first dumped after its
    drain, and the sink holds every line once."""
    log, out = tmp_path / "access.log", tmp_path / "out.json"
    lines = td.gen_lines(3000, seed=41)
    cfg = [("apache", {"inputs": [{"Type": "input_file",
                                   "FilePaths": [str(log)]}],
                       "processors": [{"Type": "processor_parse_regex_native",
                                       "SourceKey": "content",
                                       "Regex": td.APACHE,
                                       "Keys": list(td.APACHE_KEYS)}],
                       "flushers": [{"Type": "flusher_file",
                                     "FilePath": str(out)}]})]
    stats = []
    for lo, hi in ((0, 1500), (1500, 3000)):
        with open(log, "ab") as f:
            f.write(b"\n".join(lines[lo:hi]) + b"\n")
        stop = threading.Event()
        result = {}

        def run(stop=stop, result=result):
            result["st"] = application.run_configs(
                cfg, torch.device("cpu"), data_dir=str(tmp_path / "data"),
                stop=stop)

        t = threading.Thread(target=run)
        t.start()
        try:
            assert wait_for(lambda hi=hi: _count_lines(out) >= hi, 10.0)
        finally:
            stop.set()
            t.join(30)
        assert not t.is_alive()
        stats.append(result["st"]["tail"])
        FileServer.reset_for_testing()
    recs = _records(out)
    assert [{k: r.get(k) for k in td.APACHE_KEYS} for r in recs] == \
        td.apache_oracle(lines)
    assert stats[1]["recovery"]["unclean_shutdown"] is False
    (cp,) = stats[1]["checkpoints"].values()
    assert cp["offset"] == cp["read_offset"] == os.path.getsize(log)
