"""The port's acked-offset watermarks, checkpoints and recovery against the
JAX package's.

* Seeded ack orders through both packages' ``AckWatermarkTracker``: the
  same reads (consecutive spans of several sources), fanouts, forced and
  plain acks, stale and duplicate acks, a truncation that restarts a
  source's books and an outstanding window past ``MAX_OUTSTANDING_SPANS``,
  in a shuffled order; after every step ``durable_offset`` (with and
  without a fallback) and ``fully_acked`` agree, and so do the journals
  the trackers write and compact.
* A checkpoint file dumped by either package's ``CheckPointManager`` loads
  in the other's to the same entries, and both dump the same JSON for the
  same state (the JAX package's format, version 3).
* The same simulated kill in both packages: a source read in chunks, some
  chunks acked before the last checkpoint dump and some after it (in the
  ack journal only), then the process state dropped without the clean
  exit.  At the restart each recovery manager finds the marker, loads the
  journal window, and the reader resumed from the checkpoint suppresses
  the re-read spans the journal holds: ``replay_duplicate_events`` and
  ``replay_duplicate_spans`` agree, and so do the chunks delivered.
"""

import json
import os
import random
import threading

import pytest

from conftest import wait_for
from loongcollector_tpu import recovery as ref_recovery
from loongcollector_tpu.input.file import checkpoint as ref_checkpoint
from loongcollector_tpu.input.file import reader as ref_reader
from loongcollector_tpu.runner import ack_watermark as ref_ack
from loongcollector_tpu_torch import recovery as port_recovery
from loongcollector_tpu_torch.input.file import checkpoint as port_checkpoint
from loongcollector_tpu_torch.input.file import reader as port_reader
from loongcollector_tpu_torch.input.file.file_server import FileServer
from loongcollector_tpu_torch.runner import ack_watermark as port_ack

PKGS = {
    "port": (port_ack, port_checkpoint, port_reader, port_recovery),
    "ref": (ref_ack, ref_checkpoint, ref_reader, ref_recovery),
}


@pytest.fixture(autouse=True)
def _port_tail_state():
    """The port's process-wide tail state, reset around every test as
    ``conftest.py`` resets the JAX package's; no thread outlives a test."""
    before = set(threading.enumerate())
    port_ack.tracker().reset()
    port_recovery.reset()
    FileServer.reset_for_testing()
    yield
    FileServer.reset_for_testing()
    port_ack.tracker().reset()
    port_recovery.reset()
    assert wait_for(lambda: set(threading.enumerate()) <= before, 10.0), \
        set(threading.enumerate()) - before


def _ops(seed: int):
    """A seeded script of tracker calls over three sources."""
    rng = random.Random(seed)
    ops = []
    spans = []
    for src in range(3):
        dev, ino = 64769, 1000 + src
        base = rng.choice([0, 4096])
        if src != 2:                     # source 2 stays unregistered
            ops.append(("register", dev, ino, base))
        off = base
        for _ in range(rng.randint(40, 80)):
            length = rng.randint(1, 900)
            crc = rng.getrandbits(32)
            ops.append(("read", dev, ino, off, length, crc))
            spans.append((dev, ino, off, length))
            off += length
    rng.shuffle(spans)
    for span in spans:
        r = rng.random()
        if r < 0.1:
            ops.append(("fanout", span, 2))
            ops.append(("ack", [span], False))
            ops.append(("ack", [span], False))
        elif r < 0.2:
            ops.append(("ack", [span], True))
        elif r < 0.25:
            ops.append(("ack", [span, span], False))    # a duplicate ack
        elif r < 0.3:
            ops.append(("ack", [(span[0], span[1], span[2] + 1, 5)], False))
        elif r < 0.9:
            ops.append(("ack", [span], False))
        # else: never acked
        if rng.random() < 0.02:
            ops.append(("read", span[0], span[1], 0, 10, 7))   # truncation
    return ops


class _Group:
    """A stand-in group carrying a span's metadata (``span_of`` reads
    it through ``get_metadata``)."""

    def __init__(self, span, meta_key):
        dev, ino, off, length = span
        self._meta = {meta_key.LOG_FILE_DEV: str(dev),
                      meta_key.LOG_FILE_INODE: str(ino),
                      meta_key.LOG_FILE_OFFSET: str(off),
                      meta_key.LOG_FILE_LENGTH: str(length)}

    def get_metadata(self, key):
        return self._meta.get(key)


def _run_ops(mod, ops, journal):
    tr = mod.AckWatermarkTracker()
    tr.attach_journal(journal)
    meta_key = mod.EventGroupMetaKey
    trace = []
    sources = sorted({(op[1], op[2]) for op in ops if op[0] == "read"})
    for op in ops:
        kind = op[0]
        if kind == "register":
            tr.register_source(*op[1:])
        elif kind == "read":
            tr.note_read(*op[1:])
        elif kind == "fanout":
            tr.note_fanout(_Group(op[1], meta_key), op[2])
        else:
            tr.ack_spans(op[1], force=op[2])
        trace.append(tuple(
            (tr.durable_offset(d, i, 10 ** 9), tr.durable_offset(d, i, -1),
             tr.fully_acked(d, i), tr.outstanding_count(d, i))
            for d, i in sources))
    status = tr.status()
    status.pop("journal")
    tr.compact_journal()
    with open(journal) as f:
        compacted = f.read()
    tr.reset()
    return trace, status, compacted


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_ack_orders_give_equal_watermarks(seed, tmp_path):
    ops = _ops(seed)
    got = _run_ops(port_ack, ops, str(tmp_path / "port.jsonl"))
    want = _run_ops(ref_ack, ops, str(tmp_path / "ref.jsonl"))
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2] and got[2]


def test_outstanding_window_overflow_expires_alike(tmp_path):
    ops = [("register", 1, 2, 0)]
    ops += [("read", 1, 2, i * 10, 10, i)
            for i in range(port_ack.MAX_OUTSTANDING_SPANS + 5)]
    ops += [("ack", [(1, 2, i * 10, 10)], False)
            for i in range(port_ack.MAX_OUTSTANDING_SPANS - 3,
                           port_ack.MAX_OUTSTANDING_SPANS + 5)]
    assert port_ack.MAX_OUTSTANDING_SPANS == ref_ack.MAX_OUTSTANDING_SPANS
    got = _run_ops(port_ack, ops, str(tmp_path / "port.jsonl"))
    want = _run_ops(ref_ack, ops, str(tmp_path / "ref.jsonl"))
    assert got == want
    assert got[1]["forced_expirations"] > 0


def _checkpoints(mod):
    cps = [mod.ReaderCheckpoint(path=f"/var/log/app{i}.log",
                                offset=1000 * i + 7, dev=64769,
                                inode=500 + i, signature=("ab" * (i + 1)),
                                signature_size=i + 1,
                                update_time=1700000000.5 + i)
           for i in range(4)]
    return cps


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_checkpoint_files_load_in_either_package(writer, tmp_path):
    _ack, cp_mod, rd_mod, _rec = PKGS[writer]
    path = str(tmp_path / writer / "checkpoints.json")
    mgr = cp_mod.CheckPointManager(path)
    for cp in _checkpoints(rd_mod):
        mgr.update(cp)
    mgr.dump()
    with open(path) as f:
        doc = json.load(f)
    assert doc["version"] == 3 and len(doc["check_point"]) == 4
    for name, (_a, c_mod, _r, _rc) in PKGS.items():
        loaded = c_mod.CheckPointManager(path)
        loaded.load()
        for want in _checkpoints(rd_mod):
            got = loaded.get(want.dev, want.inode)
            assert vars(got) == vars(want), name
        assert loaded.get_by_path("/var/log/app2.log").offset == 2007
        # and dumps it back the same
        again = str(tmp_path / f"{writer}_{name}.json")
        loaded.path = again
        loaded.dump()
        with open(again) as f:
            assert json.load(f) == doc


def test_corrupt_checkpoint_is_quarantined_alike(tmp_path):
    for name, (_a, c_mod, _r, _rc) in PKGS.items():
        path = tmp_path / f"{name}.json"
        path.write_text('{"version": 3, "check_point": {"1:2": ')
        mgr = c_mod.CheckPointManager(str(path))
        mgr.load()
        assert mgr.quarantined_loads == 1
        assert not path.exists() and (tmp_path / f"{name}.json.bad").exists()
        assert mgr.get(1, 2) is None


# the recovery status both packages keep (the JAX package's also counts
# the events waiting in spill files and names its flight dump)
STATUS_KEYS = ("unclean_shutdown", "unclean_shutdown_total",
               "replay_duplicate_events", "replay_duplicate_spans",
               "torn_spills_removed", "window_spans", "watermark")


def _kill_and_restart(name, log_path, data_dir, ack_before, ack_after):
    """Read ``log_path`` in chunks as a registered source, ack the chunks
    of ``ack_before`` and dump the checkpoint, ack those of ``ack_after``
    (journal only), then drop the process state without a clean exit;
    restart and re-read from the checkpoint through
    ``suppress_duplicate``."""
    ack, cp_mod, rd_mod, rec = PKGS[name]
    os.makedirs(data_dir, exist_ok=True)
    cp_path = os.path.join(data_dir, "checkpoints.json")
    first = rec.begin(data_dir)
    assert not first.unclean
    r = rd_mod.LogFileReader(log_path, chunk_size=4096)
    assert r.open()
    ack.register_source(r.dev_inode.dev, r.dev_inode.inode, 0)
    mgr = cp_mod.CheckPointManager(cp_path)
    groups = []
    while True:
        g = r.read()
        if g is None:
            break
        groups.append(g)
        mgr.update(r.checkpoint())
    ack.ack_groups([groups[i] for i in ack_before])
    mgr.dump()
    ack.ack_groups([groups[i] for i in ack_after])
    r.close()
    # SIGKILL: the marker stays, the journal holds every ack
    ack.tracker().reset()
    rec.reset()
    second = rec.begin(data_dir)
    mgr = cp_mod.CheckPointManager(cp_path)
    mgr.load()
    r = rd_mod.LogFileReader(log_path, chunk_size=4096)
    assert r.open()
    cp = mgr.get(r.dev_inode.dev, r.dev_inode.inode)
    r.restore(cp)
    ack.register_source(r.dev_inode.dev, r.dev_inode.inode, r.offset)
    delivered = []
    while True:
        g = r.read()
        if g is None:
            break
        if not rec.suppress_duplicate(g):
            delivered.append(g.events[0].content.to_bytes())
    r.close()
    status = {k: v for k, v in second.status().items() if k in STATUS_KEYS}
    status["watermark"].pop("journal")
    rec.mark_clean_exit()
    ack.tracker().reset()
    rec.reset()
    return cp.offset, status, delivered, len(groups)


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_kill_restart_suppresses_alike(seed, tmp_path):
    rng = random.Random(seed)
    log_path = str(tmp_path / "app.log")
    with open(log_path, "wb") as f:
        for i in range(3000):
            f.write(b"line %05d %s\n" % (i, b"x" * rng.randint(0, 40)))
    n = 0
    with open(log_path, "rb") as f:
        n = len(f.read()) // 4096 + 1
    # a contiguous prefix acked before the dump, then some of the rest
    k = rng.randint(2, n // 2)
    ack_before = list(range(k))
    ack_after = sorted(rng.sample(range(k, n), (n - k) // 2))
    results = {name: _kill_and_restart(name, log_path,
                                       str(tmp_path / name), ack_before,
                                       ack_after)
               for name in PKGS}
    got, want = results["port"], results["ref"]
    assert got == want
    offset, status, delivered, chunks = got
    assert status["unclean_shutdown"] and status["unclean_shutdown_total"] == 1
    assert status["replay_duplicate_spans"] == len(ack_after) > 0
    assert status["replay_duplicate_events"] == len(ack_after)
    assert len(delivered) == chunks - k - len(ack_after)
    with open(log_path, "rb") as f:
        body = f.read()
    assert offset > 0 and all(c in body[offset:] for c in delivered)


def test_torn_spill_files_are_swept_alike(tmp_path):
    for name, (_a, _c, _r, rec) in PKGS.items():
        data_dir = tmp_path / name
        (data_dir / "buffer" / "p").mkdir(parents=True)
        (data_dir / "buffer" / "p" / "a.tmp").write_bytes(b"x")
        (data_dir / "buffer" / "b.tmp").write_bytes(b"y")
        (data_dir / "buffer" / "keep.lcb").write_bytes(b"z")
        m = rec.begin(str(data_dir))
        assert m.torn_spills_removed == 2
        assert sorted(os.listdir(data_dir / "buffer")) == ["keep.lcb", "p"]
        assert (data_dir / "unclean.marker").exists()
        rec.mark_clean_exit()
        assert not (data_dir / "unclean.marker").exists()
        rec.reset()
