"""Log file reader: chunked reads with rollback to the last complete line.

Reference: core/file_server/reader/LogFileReader.cpp — ReadLog :964,
GetRawData :1518 (pread into an arena, align to the last complete line and
roll back the rest), GenerateEventGroup :2726 (ONE zero-copy RawEvent per
chunk).  The port's slice reads the existing content of a file once, one
group per chunk, and ``input_file`` pushes each into the pipeline's
process queue as it is read: rotation tracking, GBK transcoding and
checkpoints come with the file-server slice.

Multiline-aware rollback (JAX package ``input/file/reader.py:247-290``):
with a start or end pattern, a chunk that filled its read holds its open
tail record in the file, so records do not split across chunks; a record
longer than a chunk ships broken, marked ``ML_PARTIAL_TAIL``, and the next
chunk ``ML_CONTINUE``, for split_multiline's carry to stitch.  The last
chunk of the one-shot read ships its open tail record at once, marked as
the reference marks it once its flush timeout has passed: the record is
stashed by split_multiline and ships at the pipeline's stop.
"""

from __future__ import annotations

import os
import re
import time
import zlib
from typing import Optional

from ...models import EventGroupMetaKey, PipelineEventGroup, SourceBuffer

DEFAULT_CHUNK = 512 * 1024


class LogFileReader:
    def __init__(self, path: str, chunk_size: int = DEFAULT_CHUNK,
                 multiline_start: Optional[str] = None,
                 multiline_end: Optional[str] = None):
        self.path = path
        self.chunk_size = chunk_size
        self.offset = 0
        self.dev = 0
        self.inode = 0
        self._fd: Optional[int] = None
        self._ml_start = (re.compile(multiline_start.encode("latin-1"))
                          if multiline_start else None)
        self._ml_end = (re.compile(multiline_end.encode("latin-1"))
                        if multiline_end else None)
        self._prev_partial = False  # the last chunk broke mid-record

    def open(self) -> bool:
        try:
            self._fd = os.open(self.path, os.O_RDONLY)
        except OSError:
            self._fd = None
            return False
        st = os.fstat(self._fd)
        self.dev, self.inode = st.st_dev, st.st_ino
        return True

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def read(self, force_flush: bool = False
             ) -> Optional[PipelineEventGroup]:
        """One chunked read → event group with ONE RawEvent (zero-copy).

        Rolls back to the last '\\n' so only complete lines ship; if the
        chunk has no newline it ships whole only when force_flush or the
        chunk filled (oversized single line).
        """
        if self._fd is None and not self.open():
            return None
        size = os.fstat(self._fd).st_size
        want = min(self.chunk_size, size - self.offset)
        if want <= 0:
            return None
        data = os.pread(self._fd, want, self.offset)
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
        partial_tail = False
        if (self._ml_start or self._ml_end) and not force_flush:
            ship = self._ml_align(aligned)
            if ship == 0 and filled:
                # a record larger than a whole chunk: ship it broken
                partial_tail = True
            elif ship < len(aligned):
                if filled:
                    aligned = aligned[:ship]   # hold the open tail record
                else:
                    partial_tail = True        # the one-shot read's end
            elif self._prev_partial and self._ml_end is None:
                # start mode, no start line in the chunk: it still
                # continues the broken record
                partial_tail = True
        read_offset = self.offset
        self.offset += len(aligned)

        sb = SourceBuffer(capacity=len(aligned) + 256)
        view = sb.copy_string(aligned)
        group = PipelineEventGroup(sb)
        group.add_raw_event(int(time.time())).set_content(view)
        group.set_metadata(EventGroupMetaKey.LOG_FILE_PATH, self.path)
        group.set_metadata(EventGroupMetaKey.LOG_FILE_INODE, str(self.inode))
        group.set_metadata(EventGroupMetaKey.LOG_FILE_DEV, str(self.dev))
        group.set_metadata(EventGroupMetaKey.LOG_FILE_OFFSET, str(read_offset))
        group.set_metadata(EventGroupMetaKey.LOG_FILE_LENGTH,
                           str(len(aligned)))
        group.set_metadata(EventGroupMetaKey.LOG_FILE_CRC32,
                           str(zlib.crc32(aligned)))
        if partial_tail:
            group.set_metadata(EventGroupMetaKey.ML_PARTIAL_TAIL, "1")
        if self._prev_partial:
            group.set_metadata(EventGroupMetaKey.ML_CONTINUE, "1")
        self._prev_partial = partial_tail
        return group

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
