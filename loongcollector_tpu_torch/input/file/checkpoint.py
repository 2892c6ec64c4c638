"""File read checkpoints: a JSON dump of per-file offsets.

Reference: core/file_server/checkpoint/CheckPointManager.{h,cpp} (h:99-140);
the port's copy of the JAX package's ``input/file/checkpoint.py``, which
writes the same format: a file dumped by either package loads in the
other.  Entries are keyed by (dev, inode), not path, carrying path,
signature and offset; they are dumped periodically and restored at start.
Keying by (dev, inode) is what makes rename-and-recreate rotation safe:
the rotated reader and the new reader at the same path own distinct
entries.

``offset`` is the *durable* offset: the acked-bytes low-watermark from
``runner/ack_watermark.py`` for sources the file server registered, the
read offset for everything else; ``read_offset`` records where reading
actually stood.  Restoring seeks to ``offset``, so a crash re-reads exactly
the unacked window: at-least-once, never loss.  A dump is a ``mkstemp``
file, fsynced, then ``os.replace``d: a crash finds the old file or the new
one, never a torn one.  A load that cannot parse the file moves it aside
to ``.bad``, counts it (``quarantined_loads``) and raises the JAX
package's ``CHECKPOINT_FAIL`` alarm.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

from ...runner import ack_watermark
from ...utils.logger import get_logger
from .reader import ReaderCheckpoint

log = get_logger("checkpoint")


class CheckPointManager:
    def __init__(self, path: str = ""):
        self.path = path
        self._checkpoints: Dict[Tuple[int, int], ReaderCheckpoint] = {}
        self._lock = threading.Lock()
        self.last_dump = 0.0
        self.quarantined_loads = 0

    @staticmethod
    def _key(cp: ReaderCheckpoint) -> Tuple[int, int]:
        return (cp.dev, cp.inode)

    def update(self, cp: ReaderCheckpoint) -> None:
        with self._lock:
            self._checkpoints[self._key(cp)] = cp

    def get(self, dev: int, inode: int) -> Optional[ReaderCheckpoint]:
        with self._lock:
            return self._checkpoints.get((dev, inode))

    def get_by_path(self, path: str) -> Optional[ReaderCheckpoint]:
        """Path lookup for callers that only know the path (e.g. status
        introspection). Reads prefer dev/inode: with rotation several
        entries may share a path; returns the most recently updated."""
        with self._lock:
            best = None
            for cp in self._checkpoints.values():
                if cp.path == path and (
                        best is None or cp.update_time > best.update_time):
                    best = cp
            return best

    def remove(self, dev: int, inode: int) -> None:
        with self._lock:
            self._checkpoints.pop((dev, inode), None)

    def dump(self) -> None:
        if not self.path:
            return
        with self._lock:
            entries = {}
            for (dev, ino), cp in self._checkpoints.items():
                # the persisted offset is the acked-bytes low-watermark for
                # sources the file server registered; bare readers fall back
                # to the read offset (seed semantics) inside durable_offset
                durable = ack_watermark.durable_offset(dev, ino, cp.offset)
                entries[f"{dev}:{ino}"] = {
                    "path": cp.path, "offset": durable,
                    "read_offset": cp.offset,
                    "dev": cp.dev, "inode": cp.inode,
                    "sig": cp.signature, "sig_size": cp.signature_size,
                    "update_time": cp.update_time,
                }
            data = {"version": 3, "check_point": entries}
        dirname = os.path.dirname(self.path) or "."
        os.makedirs(dirname, exist_ok=True)
        # unique tmp per dumper (concurrent dumps can't truncate each
        # other's file mid-write) + fsync before the atomic swap: a crash
        # right after dump() must find either the old or the new file,
        # never a torn one — this file is what recovery resumes from
        fd, tmp = tempfile.mkstemp(prefix=".checkpoint-", suffix=".tmp",
                                   dir=dirname)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.last_dump = time.monotonic()

    def load(self) -> None:
        if not self.path or not os.path.exists(self.path):
            return
        try:
            with open(self.path) as f:
                data = json.load(f)
            if not isinstance(data, dict):
                raise ValueError("checkpoint root is not an object")
        except (OSError, ValueError) as e:
            self._quarantine(e)
            return
        version = data.get("version", 1)
        with self._lock:
            for key, d in data.get("check_point", {}).items():
                # v1 files keyed entries by path; the entry body always
                # carried dev/inode, so both versions key the same way here
                path = d.get("path", key if version == 1 else "")
                cp = ReaderCheckpoint(
                    path=path, offset=d.get("offset", 0), dev=d.get("dev", 0),
                    inode=d.get("inode", 0), signature=d.get("sig", ""),
                    signature_size=d.get("sig_size", 0),
                    update_time=d.get("update_time", 0.0))
                self._checkpoints[self._key(cp)] = cp

    def _quarantine(self, err: Exception) -> None:
        """Corrupt/torn checkpoint: preserve the evidence as `.bad` (the
        next dump recreates the real file), log and count — a silent
        restart-from-zero with no trace is how loss hides."""
        bad = self.path + ".bad"
        try:
            os.replace(self.path, bad)
        except OSError:
            bad = "<unlinkable>"
        self.quarantined_loads += 1
        log.error("corrupt checkpoint file quarantined to %s: %s", bad, err)
        from ...monitor.alarms import AlarmLevel, AlarmManager, AlarmType
        AlarmManager.instance().send_alarm(
            AlarmType.CHECKPOINT_FAIL,
            f"corrupt checkpoint file quarantined to {bad}: {err}",
            AlarmLevel.ERROR)

    def dump_periodically(self, interval: float = 5.0) -> None:
        if time.monotonic() - self.last_dump >= interval:
            self.dump()
