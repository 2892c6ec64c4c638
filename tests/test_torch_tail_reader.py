"""The port's tail-mode file reader against the JAX package's, on the same
files.

Each case is a script of file operations (write, append, rename and
recreate, truncate and rewrite) and reads; the port's ``LogFileReader``
and the JAX package's read the same file side by side, and after every
step they must agree on what they shipped (the chunk's bytes, its
provenance metadata: offset, source length, crc32, the multiline stitch
markers), on the offset they stand at, on ``has_more`` / ``backlog`` and on
their checkpoints (offset and signature).  The corpora are the JAX
package's own reader cases (``tests/test_file_input.py``: rollback to the
last line, force flush, truncation, GBK transcoding with a character cut
by the chunk, invalid bytes, source lengths; ``tests/test_file_hardening
.py``: truncation below the offset mid-read, rotation with an unread tail),
plus the signature extension of a file first seen short, the multiline
hold and its timeout, ``rollback_last`` after a refused push, and the file
server's presplit groups (a row a line).  A
checkpoint taken by one package's reader and dumped by its
``CheckPointManager`` restores the other package's reader to the same
place, and both read on from there alike.
"""

import os
import threading

import pytest

from conftest import wait_for
from loongcollector_tpu.input.file import checkpoint as ref_checkpoint
from loongcollector_tpu.input.file import reader as ref_reader
from loongcollector_tpu_torch import recovery
from loongcollector_tpu_torch.input.file import checkpoint as port_checkpoint
from loongcollector_tpu_torch.input.file import reader as port_reader
from loongcollector_tpu_torch.input.file.file_server import FileServer
from loongcollector_tpu_torch.runner import ack_watermark
from test_torch_alarms import alarms_left_empty  # noqa: F401

META = ("log.file.offset", "log.file.length", "log.file.crc32",
        "log.file.inode", "log.file.dev", "log.file.path",
        "log.file.ml_partial_tail", "log.file.ml_continue")


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


def _shipped(group):
    if group is None:
        return None
    meta = {}
    for key, value in group._metadata.items():
        name = getattr(key, "value", key)
        if name in META:
            meta[name] = str(value)
    cols = group.columns
    if cols is not None and not group._events:
        # a presplit group: its rows are the chunk's lines
        raw = bytes(group.source_buffer.raw)
        lines = [raw[int(o):int(o) + int(n)]
                 for o, n in zip(cols.offsets, cols.lengths)]
        meta["rows"] = str(len(group))
        return b"".join(x + b"\n" for x in lines), meta
    return group.events[0].content.to_bytes(), meta


def _state(r):
    cp = r.checkpoint()
    return (r.offset, r.has_more(), r.backlog(), cp.offset, cp.signature,
            cp.signature_size, cp.dev, cp.inode)


class _Pair:
    """The two packages' readers over one path, driven in step."""

    def __init__(self, path, **kw):
        self.path = str(path)
        self.port = port_reader.LogFileReader(self.path, **kw)
        self.ref = ref_reader.LogFileReader(self.path, **kw)

    def read(self, force_flush=False):
        got = _shipped(self.port.read(force_flush=force_flush))
        want = _shipped(self.ref.read(force_flush=force_flush))
        assert got == want
        assert _state(self.port) == _state(self.ref)
        return got

    def drain(self, force_flush=False):
        out = []
        while True:
            got = self.read(force_flush)
            if got is None:
                return out
            out.append(got[0])

    def rollback_last(self):
        self.port.rollback_last()
        self.ref.rollback_last()
        assert _state(self.port) == _state(self.ref)

    def close(self):
        self.port.close()
        self.ref.close()


def _write(path, data, mode="wb"):
    with open(path, mode) as f:
        f.write(data)


GBK_TEXT = "时间=2024 级别=错误 消息=磁盘已满\nsecond line ascii\n"
GBK_CUT = "前缀abc中文内容结尾\n"


def _case_rollback(p, tmp):
    _write(p, b"complete line\npartial")
    pair = _Pair(p)
    assert pair.read()[0] == b"complete line\n"
    assert pair.read() is None          # the partial tail waits
    _write(p, b" done\n", "ab")
    assert pair.read()[0] == b"partial done\n"
    return pair


def _case_force_flush(p, tmp):
    _write(p, b"no newline here")
    pair = _Pair(p)
    assert pair.read() is None
    assert pair.read(force_flush=True)[0] == b"no newline here"
    return pair


def _case_truncation(p, tmp):
    _write(p, b"aaaa\nbbbb\n")
    pair = _Pair(p)
    pair.read()
    _write(p, b"new\n")                 # truncate + rewrite
    assert pair.read()[0] == b"new\n"
    return pair


def _case_truncate_below_offset(p, tmp):
    _write(p, b"".join(b"line %04d\n" % i for i in range(300)))
    pair = _Pair(p, chunk_size=1024)
    pair.read()
    pair.read()
    _write(p, b"short\n")
    assert pair.drain() == [b"short\n"]
    return pair


def _case_signature_extends(p, tmp):
    _write(p, b"x\n")                  # first seen short
    pair = _Pair(p)
    pair.read()
    _write(p, b"y\n", "ab")            # grows: the signature extends
    pair.read()
    _write(p, b"x\nz\nw\n")            # same first line, rewritten after it
    assert pair.drain() == [b"x\nz\nw\n"]
    return pair


def _case_rotation(p, tmp):
    _write(p, b"old content\n")
    pair = _Pair(p)
    pair.read()
    os.rename(p, str(p) + ".1")
    _write(str(p) + ".1", b"late write to rotated\n", "ab")
    _write(p, b"fresh content\n")
    # the readers keep the old inode: the late write ships from it
    assert pair.drain() == [b"late write to rotated\n"]
    new = port_reader.get_dev_inode(str(p))
    assert vars(new) == vars(ref_reader.get_dev_inode(str(p)))
    assert new.valid() and new != pair.port.dev_inode
    fresh = _Pair(p)
    assert fresh.drain() == [b"fresh content\n"]
    fresh.close()
    return pair


def _case_unread_tail_rotation(p, tmp):
    lines = b"".join(b"r%05d\n" % i for i in range(2000))
    _write(p, lines)
    pair = _Pair(p, chunk_size=4096)
    pair.read()
    read = pair.port.offset
    os.rename(p, str(p) + ".1")
    _write(p, b"next generation\n")
    got = pair.drain(force_flush=True)
    assert 0 < read and b"".join(got) == lines[read:]
    return pair


def _case_gbk(p, tmp):
    _write(p, GBK_TEXT.encode("gbk"))
    pair = _Pair(p, encoding="gbk")
    assert pair.read()[0].decode("utf-8") == GBK_TEXT
    return pair


def _case_gbk_cut(p, tmp):
    raw = GBK_CUT.encode("gbk")
    cut = raw.index("中".encode("gbk")) + 1
    _write(p, raw[:cut])
    pair = _Pair(p, chunk_size=cut, encoding="gbk")
    first = pair.read()
    _write(p, raw)
    out = b"" if first is None else first[0]
    out += b"".join(pair.drain(force_flush=True))
    assert out.decode("utf-8") == GBK_CUT
    return pair


def _case_gbk_invalid(p, tmp):
    _write(p, b"ok \x81\x20 bad\n" + "好\n".encode("gbk") + b"\x81\n")
    pair = _Pair(p, encoding="gbk")
    out = b"".join(pair.drain())
    assert "ok " in out.decode("utf-8") and "好".encode() in out
    assert not pair.port.has_more()
    return pair


def _case_gbk_source_length(p, tmp):
    raw = "中文行\n".encode("gbk")
    _write(p, raw)
    pair = _Pair(p, encoding="gbk")
    _body, meta = pair.read()
    assert int(meta["log.file.length"]) == len(raw) == pair.port.offset
    return pair


def _case_multiline_hold(p, tmp):
    start = r"\d{4}-\d\d-\d\d .*"
    _write(p, b"2024-01-01 a\n  at x\n2024-01-02 b\n  at y\n")
    held = _Pair(p, multiline_start=start, ml_flush_timeout=3600.0)
    # the open record (2024-01-02 ...) stays in the file
    assert held.read()[0] == b"2024-01-01 a\n  at x\n"
    assert held.read() is None
    _write(p, b"2024-01-03 c\n", "ab")
    assert held.read()[0] == b"2024-01-02 b\n  at y\n"
    held.close()
    # with no timeout the open record ships at once, marked partial
    pair = _Pair(p, multiline_start=start, ml_flush_timeout=0.0)
    body, meta = pair.read()
    assert body.endswith(b"2024-01-03 c\n")
    assert meta["log.file.ml_partial_tail"] == "1"
    _write(p, b"  at z\n", "ab")
    _body, meta = pair.read()
    assert meta["log.file.ml_continue"] == "1"
    return pair


def _case_multiline_chunk_record(p, tmp):
    end = r".*;"
    _write(p, b"a\nb\nc;\n" + b"".join(b"x%04d\n" % i for i in range(400)))
    pair = _Pair(p, multiline_end=end, chunk_size=512)
    pair.drain()
    _write(p, b"end;\n", "ab")
    pair.drain()
    return pair


def _case_rollback_last(p, tmp):
    _write(p, "中文行\nascii\n".encode("gbk"))
    pair = _Pair(p, encoding="gbk", chunk_size=7)
    first = pair.read()
    pair.rollback_last()
    assert pair.read() == first
    pair.drain()
    return pair


def _case_presplit(p, tmp):
    _write(p, b"".join(b"row %04d\n" % i for i in range(500)) + b"tail")
    pair = _Pair(p, chunk_size=2048, presplit_lines=True)
    got = pair.drain()
    assert len(got) > 1
    _write(p, b" end\n", "ab")
    assert pair.read()[0] == b"tail end\n"
    return pair


CASES = {
    "rollback_to_last_line": _case_rollback,
    "force_flush": _case_force_flush,
    "truncation_restarts": _case_truncation,
    "truncate_below_offset": _case_truncate_below_offset,
    "signature_extends": _case_signature_extends,
    "rotation": _case_rotation,
    "rotation_unread_tail": _case_unread_tail_rotation,
    "gbk": _case_gbk,
    "gbk_cut_character": _case_gbk_cut,
    "gbk_invalid_bytes": _case_gbk_invalid,
    "gbk_source_length": _case_gbk_source_length,
    "multiline_hold": _case_multiline_hold,
    "multiline_record_over_chunk": _case_multiline_chunk_record,
    "rollback_last": _case_rollback_last,
    "presplit_lines": _case_presplit,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_matches_reference(case, tmp_path):
    pair = CASES[case](tmp_path / "a.log", tmp_path)
    pair.close()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_checkpoint_resume_matches_reference(writer, tmp_path):
    """A reader's checkpoint, dumped by one package's manager, restores
    either package's reader to the same place; both read on alike."""
    p = tmp_path / "r.log"
    body = b"".join(b"resume %05d\n" % i for i in range(3000))
    _write(p, body)
    pair = _Pair(p, chunk_size=8192)
    pair.read()
    pair.read()
    mods = {"port": (port_reader, port_checkpoint),
            "ref": (ref_reader, ref_checkpoint)}
    _rd_mod, cp_mod = mods[writer]
    src = pair.port if writer == "port" else pair.ref
    cp_path = str(tmp_path / "checkpoints.json")
    mgr = cp_mod.CheckPointManager(cp_path)
    mgr.update(src.checkpoint())
    mgr.dump()
    _write(p, b"appended after the dump\n", "ab")
    restored = {}
    for name, (r_mod, c_mod) in mods.items():
        loaded = c_mod.CheckPointManager(cp_path)
        loaded.load()
        cp = loaded.get(src.dev_inode.dev, src.dev_inode.inode)
        assert cp.offset == src.offset > 0
        assert loaded.get_by_path(str(p)).signature == src.signature.hex()
        r = r_mod.LogFileReader(str(p), chunk_size=8192)
        assert r.open()
        r.restore(cp)
        restored[name] = r
    resumed = _Pair(p)
    resumed.port, resumed.ref = restored["port"], restored["ref"]
    rest = resumed.drain()
    assert b"".join(rest) == (body[src.offset:]
                              + b"appended after the dump\n")
    resumed.close()
    pair.close()
