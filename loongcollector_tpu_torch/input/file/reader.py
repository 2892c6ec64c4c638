"""Log file reader: chunked reads, rollback to the last complete line (or
the last complete multiline record), rotation tracking by (dev, inode)
and signature, checkpoints and GBK transcoding.

Reference: core/file_server/reader/LogFileReader.cpp — ReadLog :964,
GetRawData :1518 (pread into an arena, align to the last complete line and
roll back the rest), multiline-aware rollback :2128-2180,
GenerateEventGroup :2726 (ONE zero-copy RawEvent per chunk), signature
rotation detection (CheckFileSignature), DevInode tracking; the port's
copy of the JAX package's ``input/file/reader.py`` (its chaos and trace
hooks left out, as the port has neither plane).

A read resumes at ``offset`` (a restored checkpoint's, or where the last
read stopped); a file truncated below it, or whose first bytes no longer
match the signature taken when it was first seen (rewritten in place),
is read again from 0.  Every chunk's SOURCE span is noted with the
acked-offset tracker (``runner/ack_watermark.note_read``) and rides the
group's metadata (path, dev, inode, offset, length, crc32), so the
checkpoint can advance only as far as the sinks have acknowledged.

Multiline-aware rollback: with a start or end pattern the trailing open
record stays in the file (the offset does not advance past it), so the
next read re-delivers it whole.  When it cannot be held — a record longer
than a chunk, or one held past ``ml_flush_timeout`` with no new bytes —
it ships broken, marked ``ML_PARTIAL_TAIL``, and the next chunk
``ML_CONTINUE``, for split_multiline's carry to stitch.  The one-shot
read of ``--once`` passes ``ml_flush_timeout=0``: its last chunk ships
the open tail record at once, and split_multiline holds it until the
stop-time drain.

With ``presplit_lines`` (the file server's readers) a group is columnar
from the read, its rows the chunk's lines, as the JAX package's file
server reads (its ``presplit_lines``); the inner line split then leaves it
as it is.

``encoding="gbk"`` transcodes each chunk to UTF-8 (reference ReadGBK,
LogFileReader.cpp:1807), holding a trailing partial multibyte character in
the file as the newline rollback does; the span's length stays in source
bytes.
"""

from __future__ import annotations

import os
import re
import time
import zlib
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from ...models import (ColumnarLogs, EventGroupMetaKey, PipelineEventGroup,
                       SourceBuffer, columnar_enabled)
from ...runner import ack_watermark

DEFAULT_CHUNK = 512 * 1024
SIGNATURE_SIZE = 1024
ML_FLUSH_TIMEOUT_S = 5.0


@dataclass
class DevInode:
    dev: int = 0
    inode: int = 0

    def valid(self) -> bool:
        return self.inode != 0

    def __hash__(self) -> int:
        return hash((self.dev, self.inode))


def get_dev_inode(path: str) -> DevInode:
    try:
        st = os.stat(path)
        return DevInode(st.st_dev, st.st_ino)
    except OSError:
        return DevInode()


@dataclass
class ReaderCheckpoint:
    path: str = ""
    offset: int = 0
    dev: int = 0
    inode: int = 0
    signature: str = ""
    signature_size: int = 0
    update_time: float = field(default_factory=time.time)


class LogFileReader:
    def __init__(self, path: str, chunk_size: int = DEFAULT_CHUNK,
                 multiline_start: Optional[str] = None,
                 multiline_end: Optional[str] = None,
                 ml_flush_timeout: float = ML_FLUSH_TIMEOUT_S,
                 encoding: str = "utf8", presplit_lines: bool = False):
        self.path = path
        # the file server's groups are columnar from the read: line spans
        # over the chunk's arena, by the same split_chunk_spans pass the
        # inner split processor runs (which then leaves them as they are);
        # a bare reader keeps one RawEvent per chunk
        self.presplit_lines = presplit_lines
        self.encoding = (encoding or "utf8").lower()
        self.chunk_size = chunk_size
        self.offset = 0
        self.dev_inode = DevInode()
        self.signature = b""
        self._fd: Optional[int] = None
        self.last_read_time = 0.0
        self._ml_start = (re.compile(multiline_start.encode("latin-1"))
                          if multiline_start else None)
        self._ml_end = (re.compile(multiline_end.encode("latin-1"))
                        if multiline_end else None)
        self._ml_flush_timeout = ml_flush_timeout
        self._ml_hold_since = 0.0   # first time the current tail was held
        self._ml_hold_size = -1     # file size at that moment
        self._prev_partial = False  # the last chunk broke mid-record
        self._last_consumed = 0     # rollback_last() state
        self._last_prev_partial = False

    # -- lifecycle ----------------------------------------------------------

    def open(self) -> bool:
        try:
            self._fd = os.open(self.path, os.O_RDONLY)
        except OSError:
            self._fd = None
            return False
        st = os.fstat(self._fd)
        self.dev_inode = DevInode(st.st_dev, st.st_ino)
        return True

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    @property
    def is_open(self) -> bool:
        return self._fd is not None

    # -- signature / rotation ----------------------------------------------

    def _read_signature(self) -> bytes:
        assert self._fd is not None
        return os.pread(self._fd, SIGNATURE_SIZE, 0)

    def check_signature(self) -> bool:
        """False ⇒ the file was truncated or rewritten in place: restart
        from 0."""
        if self._fd is None:
            return True
        if not self.signature:
            self.signature = self._read_signature()
            return True
        cur = os.pread(self._fd, len(self.signature), 0)
        if cur != self.signature:
            self.signature = self._read_signature()
            self.offset = 0
            # held multiline state belonged to the old content: the first
            # new chunk is not a continuation
            self._prev_partial = False
            self._ml_hold_size = -1
            return False
        if len(self.signature) < SIGNATURE_SIZE:
            # the prefix still matches but the file was first seen short:
            # extend the signature as the file grows, so a copytruncate of
            # files sharing a short common prefix is still detected
            self.signature = self._read_signature()
        return True

    def restore(self, cp: ReaderCheckpoint) -> None:
        self.offset = cp.offset
        self.signature = bytes.fromhex(cp.signature) if cp.signature else b""

    def checkpoint(self) -> ReaderCheckpoint:
        return ReaderCheckpoint(
            path=self.path, offset=self.offset,
            dev=self.dev_inode.dev, inode=self.dev_inode.inode,
            signature=self.signature.hex(),
            signature_size=len(self.signature))

    # -- reading ------------------------------------------------------------

    def backlog(self) -> int:
        """Unread bytes (size - offset); 0 when unreadable or truncated."""
        if self._fd is None:
            return 0
        try:
            size = os.fstat(self._fd).st_size
        except OSError:
            return 0
        return max(0, size - self.offset)

    def has_more(self) -> bool:
        if self._fd is None:
            return False
        try:
            size = os.fstat(self._fd).st_size
        except OSError:
            return False
        # size < offset is truncation, not emptiness: read() must run so
        # the offset resets and the rewritten content ships
        return size != self.offset

    def read(self, force_flush: bool = False,
             max_bytes: Optional[int] = None
             ) -> Optional[PipelineEventGroup]:
        """One chunked read → event group with ONE RawEvent (zero-copy).

        Rolls back to the last '\\n' so only complete lines ship; if the
        chunk has no newline it ships whole only when force_flush or the
        chunk filled (oversized single line).  ``max_bytes`` caps the read
        (the recovery window's boundaries).
        """
        if self._fd is None and not self.open():
            return None
        self.check_signature()    # rewritten in place: offset reset to 0
        fd = self._fd  # local copy: a concurrent close() → EBADF
        if fd is None:
            return None
        try:
            size = os.fstat(fd).st_size
        except OSError:
            return None
        if size < self.offset:       # truncated
            self.offset = 0
            self._prev_partial = False
            self._ml_hold_size = -1
        if (not force_flush and self._ml_hold_size == size
                and time.monotonic() - self._ml_hold_since
                < self._ml_flush_timeout):
            # still holding the same open record and nothing new arrived
            return None
        want = min(self.chunk_size, size - self.offset)
        if want <= 0:
            return None
        if max_bytes is not None and 0 < max_bytes < want:
            data = os.pread(fd, max_bytes, self.offset)
            if b"\n" not in data:
                # no line ends inside the cap (content not as the window
                # saw it): read the whole chunk rather than stall
                data = os.pread(fd, want, self.offset)
        else:
            data = os.pread(fd, want, self.offset)
        if not data:
            return None
        filled = len(data) == self.chunk_size
        nl = data.rfind(b"\n")
        if nl >= 0:
            aligned = data[: nl + 1]      # roll back the partial tail line
        elif filled or force_flush:
            aligned = data                # oversized single line / final flush
        else:
            return None                   # wait for the line to complete

        # multiline-aware rollback: hold the trailing incomplete record in
        # the file, so records do not split across chunks
        partial_tail = False
        if (self._ml_start or self._ml_end) and not force_flush:
            ship = self._ml_align(aligned)
            if ship == 0 and filled:
                # a record larger than a whole chunk: ship it broken
                partial_tail = True
            elif ship < len(aligned):
                if filled:
                    # backlog catch-up: more bytes follow at once; hold the
                    # open tail in the file, no clock
                    aligned = aligned[:ship]
                else:
                    now = time.monotonic()
                    if size != self._ml_hold_size:
                        # new bytes since the hold began: restart the clock
                        self._ml_hold_size = size
                        self._ml_hold_since = now
                    if now - self._ml_hold_since >= self._ml_flush_timeout:
                        partial_tail = True   # flush the open record anyway
                    else:
                        aligned = aligned[:ship]
                        if not aligned:
                            return None
            else:
                self._ml_hold_size = -1
                if self._prev_partial and self._ml_end is None:
                    # start mode, no start line in the chunk: it still
                    # continues the broken record
                    partial_tail = True
        if partial_tail or force_flush:
            self._ml_hold_size = -1
        read_offset = self.offset
        src = aligned    # the source bytes the crc covers
        if self.encoding == "gbk":
            aligned, consumed_src = self._transcode_gbk(aligned, force_flush)
            if not aligned:
                return None
        else:
            consumed_src = len(aligned)
        span_crc = zlib.crc32(src[:consumed_src])
        # for rollback_last(): a refused push restores the offset and the
        # multiline stitch state together
        self._last_consumed = consumed_src
        self._last_prev_partial = self._prev_partial
        self.offset += consumed_src
        self.last_read_time = time.monotonic()

        sb = SourceBuffer(capacity=len(aligned) + 256)
        view = sb.copy_string(aligned)
        group = PipelineEventGroup(sb)
        ts = int(time.time())
        if self.presplit_lines and columnar_enabled():
            from ...processor.split_log_string import split_chunk_spans
            offs, lens = split_chunk_spans(sb.as_array(), view.offset,
                                           view.length, ord("\n"))
            group.set_columns(ColumnarLogs(
                offsets=np.asarray(offs, dtype=np.int32), lengths=lens,
                timestamps=np.full(len(offs), ts, dtype=np.int64)))
        else:
            group.add_raw_event(ts).set_content(view)
        group.set_metadata(EventGroupMetaKey.LOG_FILE_PATH, self.path)
        group.set_metadata(EventGroupMetaKey.LOG_FILE_INODE,
                           str(self.dev_inode.inode))
        group.set_metadata(EventGroupMetaKey.LOG_FILE_DEV,
                           str(self.dev_inode.dev))
        group.set_metadata(EventGroupMetaKey.LOG_FILE_OFFSET, str(read_offset))
        group.set_metadata(EventGroupMetaKey.LOG_FILE_LENGTH,
                           str(consumed_src))
        group.set_metadata(EventGroupMetaKey.LOG_FILE_CRC32, str(span_crc))
        # the span is in flight: the watermark owes it a terminal ack
        # before the checkpoint may advance past it
        ack_watermark.note_read(self.dev_inode.dev, self.dev_inode.inode,
                                read_offset, consumed_src, span_crc)
        if partial_tail:
            group.set_metadata(EventGroupMetaKey.ML_PARTIAL_TAIL, "1")
        if self._prev_partial:
            group.set_metadata(EventGroupMetaKey.ML_CONTINUE, "1")
        self._prev_partial = partial_tail
        return group

    def rollback_last(self) -> None:
        """Undo the last read() (the queue refused the group): the offset
        and the multiline stitch chain return to their values before it."""
        self.offset -= self._last_consumed
        self._last_consumed = 0
        self._prev_partial = self._last_prev_partial
        self._ml_hold_size = -1

    @staticmethod
    def _transcode_gbk(data: bytes, force_flush: bool
                       ) -> Tuple[bytes, int]:
        """GBK bytes → (UTF-8 bytes, source bytes consumed).

        A partial multibyte character at the END stays in the file (the
        next read completes it) unless force_flush; invalid bytes
        mid-stream are replaced.  0x0A is never a GBK trail byte, so a
        chunk ending at a newline cannot end mid-character: only chunks
        cut elsewhere (filled mid-line) may hold bytes back.
        """
        can_hold = not force_flush and not data.endswith(b"\n")
        consumed = len(data)
        while True:
            try:
                text = data[:consumed].decode("gbk")
                break
            except UnicodeDecodeError as ue:
                if can_hold and ue.start >= consumed - 2 \
                        and ue.end >= consumed:
                    # dangling lead byte at the chunk end: hold it
                    consumed = ue.start
                    if consumed == 0:
                        return b"", 0
                    continue
                text = data[:consumed].decode("gbk", errors="replace")
                break
        return text.encode("utf-8"), consumed

    def _ml_align(self, data: bytes) -> int:
        """Bytes of ``data`` that form complete multiline records (the
        reference's ``_ml_align``).  End mode: through the last line that
        matches the end pattern (0 when none does).  Start mode: up to the
        last line that matches the start pattern, which opens the record
        still growing; ``len(data)`` when no line does."""
        e = len(data)                 # exclusive end of the current line
        if self._ml_end is not None:
            while e > 0:
                s = data.rfind(b"\n", 0, e - 1) + 1
                line = data[s:e - 1] if data[e - 1:e] == b"\n" else data[s:e]
                if self._ml_end.fullmatch(line):
                    return e
                e = s
            return 0
        while e > 0:
            s = data.rfind(b"\n", 0, e - 1) + 1
            line = data[s:e - 1] if data[e - 1:e] == b"\n" else data[s:e]
            if self._ml_start.fullmatch(line):
                return s
            e = s
        return len(data)
