"""Recovery manager: detect an unclean shutdown, and suppress the
ack-to-crash duplicate window at the restart.

The port's copy of the JAX package's ``recovery.py``.  A marker is written
at startup and removed only by a clean exit: finding it at the NEXT start
proves the previous process died without its drain (SIGKILL, OOM, power).
At every start the manager

  1. loads the ack journal (``runner/ack_watermark.py``) into a per-source
     duplicate window: spans the previous run ACKED but whose checkpoint
     dump never caught up.  The file server consults ``suppress_duplicate``
     on every fresh read: a re-read of an already delivered span is
     counted (``replay_duplicate_events``) and dropped before ingest, so
     the at-least-once re-read window gives bounded duplicates at the sink.
     The port's file server also ends each re-read at the window's
     boundaries (``read_limit``), so a chunk longer than the one first
     read — a file that grew past the old end of file — does not straddle
     an acked span and ship it again; the JAX package reads whole chunks
     there (``ROADMAP.md`` Queue 3);
  2. sweeps torn ``*.tmp`` files a crash left under the buffer directory.

The JAX package's restart alarm (``AGENT_RESTART``) is counted
(``unclean_shutdown_total``) and logged, as the port has no alarm plane;
its counts are read through ``status()`` (``--stats`` ``tail``), not a
metrics record.  The previous run's flight dump and the count of events
waiting in spill files come with the port's ``prof/`` and disk buffer.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from .models import EventGroupMetaKey
from .runner import ack_watermark
from .utils.logger import get_logger

log = get_logger("recovery")

MARKER_NAME = "unclean.marker"
STATE_NAME = "recovery_state.json"
JOURNAL_NAME = "ack_journal.jsonl"

# duplicate-window bound: per-source acked spans kept for suppression; a
# window this size covers any realistic ack-to-dump gap (dump cadence is
# seconds) while bounding recovery memory on a huge stale journal
MAX_WINDOW_SPANS = 65536


class _Window:
    """Acked intervals of one (dev, inode) from the previous run's journal:
    merged [start, end) list for containment, plus exact-span crcs for the
    strong (byte-verified) match."""

    __slots__ = ("ivals", "crcs")

    def __init__(self) -> None:
        self.ivals: List[List[int]] = []
        self.crcs: Dict[Tuple[int, int], int] = {}

    def add(self, off: int, length: int, crc: int) -> None:
        if length <= 0:
            return
        self.crcs[(off, length)] = crc
        start, end = off, off + length
        iv = self.ivals
        lo = 0
        while lo < len(iv) and iv[lo][1] < start:
            lo += 1
        hi = lo
        while hi < len(iv) and iv[hi][0] <= end:
            start = min(start, iv[hi][0])
            end = max(end, iv[hi][1])
            hi += 1
        iv[lo:hi] = [[start, end]]

    def read_limit(self, off: int) -> Optional[int]:
        """Bytes a read at ``off`` may take so that it ends at the next
        window boundary: the end of the interval holding ``off``, or the
        start of the next one; None past the last interval."""
        for start, stop in self.ivals:
            if off < start:
                return start - off
            if off < stop:
                return stop - off
        return None

    def covers(self, off: int, length: int, crc: int) -> bool:
        exact = self.crcs.get((off, length))
        if exact is not None:
            # byte-verified when both sides carry a crc; a mismatch means
            # the file changed under the same offsets — deliver, don't drop
            return not (exact and crc and exact != crc)
        end = off + length
        for start, stop in self.ivals:
            if start <= off and end <= stop:
                return True
            if start > off:
                break
        return False


class RecoveryManager:
    def __init__(self, data_dir: str, buffer_dir: str = "") -> None:
        self.data_dir = data_dir
        self.buffer_dir = buffer_dir or os.path.join(data_dir, "buffer")
        self.marker_path = os.path.join(data_dir, MARKER_NAME)
        self.state_path = os.path.join(data_dir, STATE_NAME)
        self.journal_path = os.path.join(data_dir, JOURNAL_NAME)
        self.unclean = False
        self.unclean_shutdown_total = 0
        self.replay_duplicate_events = 0
        self.replay_duplicate_spans = 0
        self.torn_spills_removed = 0
        self.window_spans = 0
        self.recovery_wall_s = 0.0
        self._windows: Dict[Tuple[int, int], _Window] = {}
        self._lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------

    def begin(self) -> None:
        t0 = time.monotonic()
        self.unclean = os.path.exists(self.marker_path)
        self._load_state()
        if self.unclean:
            self.unclean_shutdown_total += 1
            self._save_state()
            log.warning("unclean shutdown detected (marker %s); total=%d: "
                        "recovering from acked-offset checkpoints",
                        self.marker_path, self.unclean_shutdown_total)
        self._load_window()
        self._sweep_torn_spills()
        # the tracker journals future acks into the SAME file the window
        # was loaded from: a second crash inside this run keeps both the
        # old window's tail and this run's acks
        ack_watermark.tracker().attach_journal(self.journal_path)
        self._write_marker()
        self.recovery_wall_s = time.monotonic() - t0

    def mark_clean_exit(self) -> None:
        """Clean drain finished: compact the journal down to the live
        window and drop the marker — the next start is a clean start."""
        ack_watermark.tracker().compact_journal()
        try:
            os.unlink(self.marker_path)
        except OSError:
            pass

    # -- duplicate suppression -----------------------------------------------

    def suppress_duplicate(self, group) -> bool:
        """True ⇒ this freshly read group's SOURCE span was fully acked by
        the previous run — count it and drop it before ingest.  Called by
        the file server on the read path; the empty-window fast path is one
        dict check."""
        if not self._windows:
            return False
        span = ack_watermark.span_of(group)
        if span is None:
            return False
        dev, ino, off, length = span
        win = self._windows.get((dev, ino))
        if win is None:
            return False
        crc = 0
        raw = group.get_metadata(EventGroupMetaKey.LOG_FILE_CRC32)
        if raw is not None:
            try:
                crc = int(str(raw))
            except ValueError:
                crc = 0
        if not win.covers(off, length, crc):
            return False
        with self._lock:
            self.replay_duplicate_events += len(group)
            self.replay_duplicate_spans += 1
        # the span is already delivered: fold it into the watermark so the
        # checkpoint advances past it (and the journal re-records it for a
        # second crash inside this run)
        ack_watermark.ack_spans([span], force=True)
        return True

    def read_limit(self, dev: int, ino: int, off: int) -> Optional[int]:
        """The most a read of (dev, ino) at ``off`` may take so that its
        span lines up with the duplicate window (None: no limit).  A
        re-read chunk that straddles a window boundary is not contained in
        the window and would ship again whole; ending reads at the
        boundaries keeps every duplicate inside a span whose ack the
        journal did not hold.  The window's boundaries are the previous
        run's chunk ends, so they fall at line (and record) ends."""
        if not self._windows:
            return None
        win = self._windows.get((dev, ino))
        return None if win is None else win.read_limit(off)

    # -- internals -----------------------------------------------------------

    def _write_marker(self) -> None:
        try:
            with open(self.marker_path, "w") as f:
                f.write(json.dumps({"pid": os.getpid(),
                                    "start_time": time.time()}))
                f.flush()
        except OSError:
            log.exception("cannot write crash marker %s", self.marker_path)

    def _load_state(self) -> None:
        try:
            with open(self.state_path) as f:
                st = json.load(f)
            self.unclean_shutdown_total = int(
                st.get("unclean_shutdown_total", 0))
        except (OSError, ValueError):
            self.unclean_shutdown_total = 0

    def _save_state(self) -> None:
        try:
            with open(self.state_path, "w") as f:
                json.dump({"unclean_shutdown_total":
                           self.unclean_shutdown_total}, f)
        except OSError:
            pass

    def _load_window(self) -> None:
        """Journal → per-source duplicate windows.  Loaded on every start
        (not only unclean ones): after a clean exit the compacted journal
        holds exactly the spans above the last checkpoint dump, and
        suppressing those re-reads keeps a clean restart duplicate-free."""
        try:
            with open(self.journal_path) as f:
                lines = f.readlines()
        except OSError:
            return
        n = 0
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                dev, ino = int(rec["d"]), int(rec["i"])
                off, length = int(rec["o"]), int(rec["l"])
                crc = int(rec.get("c", 0))
            except (ValueError, KeyError, TypeError):
                continue    # torn tail line (crash mid-append): ignore
            win = self._windows.get((dev, ino))
            if win is None:
                win = self._windows[(dev, ino)] = _Window()
            win.add(off, length, crc)
            n += 1
            if n >= MAX_WINDOW_SPANS:
                log.warning("ack journal window capped at %d spans", n)
                break
        self.window_spans = n
        if n:
            log.info("duplicate-suppression window: %d spans over %d "
                     "sources", n, len(self._windows))

    def _sweep_torn_spills(self) -> None:
        if not os.path.isdir(self.buffer_dir):
            return
        for root, _dirs, files in os.walk(self.buffer_dir):
            for name in files:
                if name.endswith(".tmp"):
                    try:
                        os.unlink(os.path.join(root, name))
                        self.torn_spills_removed += 1
                    except OSError:
                        pass
        if self.torn_spills_removed:
            log.warning("removed %d torn spill temp files",
                        self.torn_spills_removed)

    def status(self) -> dict:
        with self._lock:
            doc = {
                "unclean_shutdown": self.unclean,
                "unclean_shutdown_total": self.unclean_shutdown_total,
                "replay_duplicate_events": self.replay_duplicate_events,
                "replay_duplicate_spans": self.replay_duplicate_spans,
                "torn_spills_removed": self.torn_spills_removed,
                "window_spans": self.window_spans,
                "recovery_wall_s": round(self.recovery_wall_s, 4),
            }
        doc["watermark"] = ack_watermark.tracker().status()
        return doc


_manager: Optional[RecoveryManager] = None


def begin(data_dir: str, buffer_dir: str = "") -> RecoveryManager:
    """Install and run the recovery manager for this process (before any
    reader opens)."""
    global _manager
    _manager = RecoveryManager(data_dir, buffer_dir)
    _manager.begin()
    return _manager


def mark_clean_exit() -> None:
    if _manager is not None:
        _manager.mark_clean_exit()


def suppress_duplicate(group) -> bool:
    m = _manager
    if m is None:
        return False
    return m.suppress_duplicate(group)


def read_limit(dev: int, ino: int, off: int) -> Optional[int]:
    m = _manager
    return None if m is None else m.read_limit(dev, ino, off)


def status() -> Optional[dict]:
    m = _manager
    return m.status() if m is not None else None


def reset() -> None:
    """Drop the installed manager (the tracker resets separately)."""
    global _manager
    _manager = None
