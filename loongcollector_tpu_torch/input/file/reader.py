"""Log file reader: chunked reads with rollback to the last complete line.

Reference: core/file_server/reader/LogFileReader.cpp — ReadLog :964,
GetRawData :1518 (pread into an arena, align to the last complete line and
roll back the rest), GenerateEventGroup :2726 (ONE zero-copy RawEvent per
chunk).  The port's slice reads the existing content of a file once, one
group per chunk, and ``input_file`` pushes each into the pipeline's
process queue as it is read: rotation tracking, multiline-aware rollback,
GBK transcoding and checkpoints come with the file-server slice.
"""

from __future__ import annotations

import os
import time
import zlib
from typing import Optional

from ...models import EventGroupMetaKey, PipelineEventGroup, SourceBuffer

DEFAULT_CHUNK = 512 * 1024


class LogFileReader:
    def __init__(self, path: str, chunk_size: int = DEFAULT_CHUNK):
        self.path = path
        self.chunk_size = chunk_size
        self.offset = 0
        self.dev = 0
        self.inode = 0
        self._fd: Optional[int] = None

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
        nl = data.rfind(b"\n")
        if nl >= 0:
            aligned = data[: nl + 1]      # roll back the partial tail line
        elif len(data) == self.chunk_size or force_flush:
            aligned = data                # oversized single line / final flush
        else:
            return None                   # wait for the line to complete
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
        return group
