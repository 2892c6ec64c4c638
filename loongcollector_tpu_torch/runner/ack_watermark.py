"""Acked-offset watermarks: the cross-restart durability spine.

The port's copy of the JAX package's ``runner/ack_watermark.py``, whole.
The reader advances its offset at read time, so a ``kill -9`` would lose
everything between the last read and the last sink ack.  This module
folds terminal delivery acknowledgements (a flusher's write, a reasoned
drop) back into per-(dev, inode) *contiguous* watermarks: the checkpoint
dump asks ``durable_offset()`` and persists the low-watermark of
acknowledged SOURCE bytes instead of the read offset.  After a crash the
reader resumes at the watermark and re-reads only the unacked window:
at-least-once, never loss.

One module-global tracker, plain dict/list state under one lock, no
threads of its own:

  note_read(dev, ino, off, len, crc)   reader: span entered the pipeline
  note_fanout(group, n)                pipeline: span needs n terminal acks
  ack_spans(spans) / ack_groups(...)   terminal boundaries: span delivered
  durable_offset(dev, ino, fallback)   checkpoint dump: acked frontier
  register_source(dev, ino, base)      file server: watermark authoritative

Sources the file server never registers (the ``--once`` reader, bare
readers in tests) keep read-offset semantics: ``durable_offset`` falls
back.  A pipeline that never acks a source's spans is force-expired once
the source's outstanding window overflows (``forced_expirations`` counts
each give-up), so the checkpoint degrades to the read offset instead of
pinning at the first unacked byte.

Acks are journaled (append + flush, no fsync: the page cache survives
SIGKILL, and the journal is a duplicate suppressor, not a source of truth)
so the recovery manager (``recovery.py``) can suppress re-reads of spans
that were acked in the ack-to-checkpoint-dump window.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from ..models import EventGroupMetaKey

# per-source outstanding-span cap: beyond it the oldest spans are force-
# expired (watermark advances as if acked) so a non-acking pipeline cannot
# pin the checkpoint at its first unacked byte forever
MAX_OUTSTANDING_SPANS = 8192

Span = Tuple[int, int, int, int]   # (dev, inode, offset, length)


class _SourceState:
    __slots__ = ("base", "outstanding", "acked", "authoritative", "dumped")

    def __init__(self, base: int = 0):
        self.base = base              # contiguous acked/durable frontier
        # offset -> [length, crc32, refs]; refs = terminal acks still owed
        # (fanout to n flushers raises it to n before any copy can ack)
        self.outstanding: Dict[int, List[int]] = {}
        self.acked: List[List[int]] = []   # merged [start, end) beyond base
        self.authoritative = False    # register_source() ran (file server)
        self.dumped = -1              # last offset handed to a checkpoint dump


class AckWatermarkTracker:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sources: Dict[Tuple[int, int], _SourceState] = {}
        self._journal = None
        self._journal_path = ""
        self.forced_expirations = 0
        self.acked_spans_total = 0
        self.acked_bytes_total = 0

    # -- journal -------------------------------------------------------------

    def attach_journal(self, path: str) -> None:
        """Append acks to `path` from now on (recovery loads it first)."""
        with self._lock:
            self._close_journal()
            self._journal_path = path
            try:
                self._journal = open(path, "a")
            except OSError:
                self._journal = None

    def _close_journal(self) -> None:
        if self._journal is not None:
            try:
                self._journal.close()
            except OSError:
                pass
            self._journal = None

    def _journal_write(self, dev: int, ino: int, off: int, length: int,
                       crc: int) -> None:
        if self._journal is None:
            return
        try:
            self._journal.write(json.dumps(
                {"d": dev, "i": ino, "o": off, "l": length, "c": crc},
                separators=(",", ":")) + "\n")
            self._journal.flush()
        except (OSError, ValueError):
            self._close_journal()

    def compact_journal(self) -> None:
        """Rewrite the journal keeping only spans a restart could re-read:
        everything at or above each source's last *dumped* watermark (the
        checkpoint file is what decides where re-reading starts).  Runs at
        checkpoint-dump cadence so the journal stays a bounded window."""
        with self._lock:
            if self._journal is None or not self._journal_path:
                return
            keep: List[str] = []
            for (dev, ino), st in self._sources.items():
                # never dumped ⇒ a restart re-reads from 0 (or the restore
                # offset): keep the whole acked history for this source
                floor = st.dumped if st.dumped >= 0 else 0
                for start, end in st.acked:
                    if end > floor:
                        keep.append(json.dumps(
                            {"d": dev, "i": ino, "o": start,
                             "l": end - start, "c": 0},
                            separators=(",", ":")))
                # base-merged spans at/above the dumped floor must survive
                # too: they were acked but the checkpoint on disk is older
                if st.base > floor:
                    keep.append(json.dumps(
                        {"d": dev, "i": ino, "o": floor,
                         "l": st.base - floor, "c": 0},
                        separators=(",", ":")))
            tmp = self._journal_path + ".compact"
            try:
                self._close_journal()
                with open(tmp, "w") as f:
                    for line in keep:
                        f.write(line + "\n")
                    f.flush()
                os.replace(tmp, self._journal_path)
                self._journal = open(self._journal_path, "a")
            except OSError:
                self._journal = None

    # -- read-side hooks -----------------------------------------------------

    def register_source(self, dev: int, ino: int, base: int) -> None:
        """FileServer opened/restored a reader at `base`: the watermark for
        this source is authoritative from its first read — checkpoint dumps
        use the acked frontier, not the read offset."""
        with self._lock:
            st = self._sources.get((dev, ino))
            if st is None:
                st = self._sources[(dev, ino)] = _SourceState(base)
            elif not st.outstanding and not st.acked:
                st.base = base
            st.authoritative = True

    def note_read(self, dev: int, ino: int, off: int, length: int,
                  crc: int) -> None:
        if length <= 0 or not ino:
            return
        with self._lock:
            st = self._sources.get((dev, ino))
            if st is None:
                st = self._sources[(dev, ino)] = _SourceState(off)
            if off < st.base:
                # truncation / in-place rewrite: the old content's acks no
                # longer describe this file — restart the source's books
                auth = st.authoritative
                st = self._sources[(dev, ino)] = _SourceState(off)
                st.authoritative = auth
            entry = st.outstanding.get(off)
            if entry is not None:       # rollback re-read: idempotent
                entry[0] = length
                entry[1] = crc
                return
            st.outstanding[off] = [length, crc, 1]
            if len(st.outstanding) > MAX_OUTSTANDING_SPANS:
                self._force_expire(st)

    def _force_expire(self, st: _SourceState) -> None:
        """Outstanding window overflow: treat the oldest spans as acked so
        the watermark keeps moving (degrades to read-offset semantics for
        pipelines that never ack — the documented give-up, counted)."""
        while len(st.outstanding) > MAX_OUTSTANDING_SPANS // 2:
            off = min(st.outstanding)
            length, _, _ = st.outstanding.pop(off)
            self._merge_acked(st, off, off + length)
            self.forced_expirations += 1

    def note_fanout(self, group, n: int) -> None:
        """Router matched `n` flushers: the span owes n terminal acks.
        Must run BEFORE any flusher's send so a fast first copy cannot
        advance the watermark while the second is still in flight."""
        if n <= 1:
            return
        span = span_of(group)
        if span is None:
            return
        dev, ino, off, _ = span
        with self._lock:
            st = self._sources.get((dev, ino))
            if st is None:
                return
            entry = st.outstanding.get(off)
            if entry is not None:
                entry[2] = max(entry[2], n)

    # -- ack-side hooks ------------------------------------------------------

    def ack_spans(self, spans, force: bool = False) -> None:
        """Terminal delivery of `spans` (sink ack / durable spill / tagged
        drop).  `force` clears the span regardless of its fanout refcount —
        for terminals that end EVERY copy (pre-route drops, filtered-empty
        groups)."""
        if not spans:
            return
        with self._lock:
            for dev, ino, off, length in spans:
                st = self._sources.get((dev, ino))
                if st is None:
                    continue
                entry = st.outstanding.get(off)
                if entry is None:
                    continue    # unknown/stale ack (post-truncation): drop
                if not force:
                    entry[2] -= 1
                    if entry[2] > 0:
                        continue
                del st.outstanding[off]
                end = off + entry[0]
                self._merge_acked(st, off, end)
                self.acked_spans_total += 1
                self.acked_bytes_total += entry[0]
                self._journal_write(dev, ino, off, entry[0], entry[1])

    def _merge_acked(self, st: _SourceState, start: int, end: int) -> None:
        iv = st.acked
        lo = 0
        while lo < len(iv) and iv[lo][1] < start:
            lo += 1
        hi = lo
        while hi < len(iv) and iv[hi][0] <= end:
            start = min(start, iv[hi][0])
            end = max(end, iv[hi][1])
            hi += 1
        iv[lo:hi] = [[start, end]]
        # advance the contiguous frontier through everything now adjacent
        while iv and iv[0][0] <= st.base:
            if iv[0][1] > st.base:
                st.base = iv[0][1]
            iv.pop(0)

    # -- query side ----------------------------------------------------------

    def durable_offset(self, dev: int, ino: int, fallback: int) -> int:
        """Offset a checkpoint dump may persist for (dev, ino): the acked
        frontier for file-server-registered sources, the caller's read
        offset for everything else (bare readers keep seed semantics)."""
        with self._lock:
            st = self._sources.get((dev, ino))
            if st is None or not st.authoritative:
                return fallback
            out = min(st.base, fallback) if fallback >= 0 else st.base
            st.dumped = out
            return out

    def fully_acked(self, dev: int, ino: int) -> bool:
        with self._lock:
            st = self._sources.get((dev, ino))
            return st is None or not st.outstanding

    def outstanding_count(self, dev: int, ino: int) -> int:
        with self._lock:
            st = self._sources.get((dev, ino))
            return 0 if st is None else len(st.outstanding)

    def forget(self, dev: int, ino: int) -> None:
        """Source is gone for good (rotated reader fully drained+acked)."""
        with self._lock:
            self._sources.pop((dev, ino), None)

    def status(self) -> dict:
        with self._lock:
            return {
                "sources": len(self._sources),
                "outstanding_spans": sum(len(s.outstanding)
                                         for s in self._sources.values()),
                "acked_spans_total": self.acked_spans_total,
                "acked_bytes_total": self.acked_bytes_total,
                "forced_expirations": self.forced_expirations,
                "journal": self._journal_path or None,
            }

    def reset(self) -> None:
        with self._lock:
            self._sources.clear()
            self._close_journal()
            self._journal_path = ""
            self.forced_expirations = 0
            self.acked_spans_total = 0
            self.acked_bytes_total = 0


_tracker = AckWatermarkTracker()


def tracker() -> AckWatermarkTracker:
    return _tracker


# -- group/span plumbing ------------------------------------------------------

def span_of(group) -> Optional[Span]:
    """The (dev, inode, offset, length) SOURCE span riding `group`'s
    metadata from the file reader, or None for groups without file
    provenance (eBPF events, aggregator rollups, carried multiline
    records)."""
    length = group.get_metadata(EventGroupMetaKey.LOG_FILE_LENGTH)
    if length is None:
        return None
    try:
        return (int(str(group.get_metadata(EventGroupMetaKey.LOG_FILE_DEV)
                        or 0)),
                int(str(group.get_metadata(EventGroupMetaKey.LOG_FILE_INODE)
                        or 0)),
                int(str(group.get_metadata(EventGroupMetaKey.LOG_FILE_OFFSET)
                        or 0)),
                int(str(length)))
    except (TypeError, ValueError):
        return None


def spans_of(groups) -> Tuple[Span, ...]:
    """Spans for a batch of groups, so an ack can fire after
    serialization has erased the groups themselves."""
    out = []
    for g in groups:
        span = span_of(g)
        if span is not None:
            out.append(span)
    return tuple(out)


# module-level conveniences (the call-site surface)

def note_read(dev: int, ino: int, off: int, length: int, crc: int) -> None:
    _tracker.note_read(dev, ino, off, length, crc)


def register_source(dev: int, ino: int, base: int) -> None:
    _tracker.register_source(dev, ino, base)


def note_fanout(group, n: int) -> None:
    _tracker.note_fanout(group, n)


def ack_spans(spans, force: bool = False) -> None:
    _tracker.ack_spans(spans, force=force)


def ack_groups(groups, force: bool = False) -> None:
    _tracker.ack_spans(spans_of(groups), force=force)


def durable_offset(dev: int, ino: int, fallback: int) -> int:
    return _tracker.durable_offset(dev, ino, fallback)


def fully_acked(dev: int, ino: int) -> bool:
    return _tracker.fully_acked(dev, ino)
