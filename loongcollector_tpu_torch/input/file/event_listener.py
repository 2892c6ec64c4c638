"""Linux inotify event listener for the file server.

Reference: core/file_server/event_listener/EventListener_Linux.h; the
port's copy of the JAX package's ``input/file/event_listener.py``.
inotify watches on the log directories merge with the polling discovery
into one event stream.  Polling stays the source of truth (discovery,
rotation, filesystems where inotify is silent); inotify's job is latency
and idle CPU: the file-server thread sleeps on the inotify fd instead of a
fixed interval, so an append wakes it at once.  ``create_listener``
returns None where there is no inotify (not Linux, or
``LOONG_DISABLE_INOTIFY`` set), and the file server then polls alone, as
the JAX package's does.

ctypes straight onto libc — no external modules.
"""

from __future__ import annotations

import ctypes
import os
import select
import struct
import sys
from typing import Dict, List, Optional, Set, Tuple

IN_MODIFY = 0x00000002
IN_CLOSE_WRITE = 0x00000008
IN_MOVED_FROM = 0x00000040
IN_MOVED_TO = 0x00000080
IN_CREATE = 0x00000100
IN_DELETE = 0x00000200

_CHANGE_MASK = (IN_MODIFY | IN_CLOSE_WRITE | IN_MOVED_FROM | IN_MOVED_TO
                | IN_CREATE | IN_DELETE)
_DISCOVERY_MASK = IN_MOVED_FROM | IN_MOVED_TO | IN_CREATE | IN_DELETE

IN_NONBLOCK = 0x800
IN_CLOEXEC = 0x80000

_EVENT_HDR = struct.Struct("iIII")  # wd, mask, cookie, len


class InotifyListener:
    """Watches directories; wait() doubles as the poll sleep."""

    def __init__(self) -> None:
        if sys.platform != "linux":
            raise OSError("inotify is Linux-only")
        self._libc = ctypes.CDLL(None, use_errno=True)
        fd = self._libc.inotify_init1(IN_NONBLOCK | IN_CLOEXEC)
        if fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        self._fd = fd
        self._wd_to_dir: Dict[int, str] = {}
        self._dir_to_wd: Dict[str, int] = {}

    # -- watch management ---------------------------------------------------

    def watch_dir(self, path: str) -> bool:
        if path in self._dir_to_wd:
            return True
        wd = self._libc.inotify_add_watch(
            self._fd, path.encode(), _CHANGE_MASK)
        if wd < 0:
            return False
        self._wd_to_dir[wd] = path
        self._dir_to_wd[path] = wd
        return True

    def unwatch_missing(self, live_dirs: Set[str]) -> None:
        for path in list(self._dir_to_wd):
            if path not in live_dirs:
                wd = self._dir_to_wd.pop(path)
                self._wd_to_dir.pop(wd, None)
                self._libc.inotify_rm_watch(self._fd, wd)

    # -- event wait ---------------------------------------------------------

    def wait(self, timeout: float) -> List[Tuple[str, bool]]:
        """Sleep up to `timeout` or until filesystem events arrive.

        Returns [(path, needs_discovery)] — needs_discovery marks
        create/delete/rename events (file set changed); plain modifies
        only need a reader drain.
        """
        try:
            ready, _, _ = select.select([self._fd], [], [], timeout)
        except OSError:
            return []
        if not ready:
            return []
        out: List[Tuple[str, bool]] = []
        # drain everything queued (bounded reads; fd is non-blocking)
        for _ in range(16):
            try:
                buf = os.read(self._fd, 65536)
            except BlockingIOError:
                break
            except OSError:
                break
            pos = 0
            while pos + _EVENT_HDR.size <= len(buf):
                wd, mask, _cookie, nlen = _EVENT_HDR.unpack_from(buf, pos)
                pos += _EVENT_HDR.size
                name = buf[pos:pos + nlen].split(b"\0", 1)[0].decode(
                    "utf-8", "replace")
                pos += nlen
                d = self._wd_to_dir.get(wd)
                if d is None:
                    continue
                out.append((os.path.join(d, name) if name else d,
                            bool(mask & _DISCOVERY_MASK)))
            if len(buf) < 65536:
                break
        return out

    def close(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass
        self._wd_to_dir.clear()
        self._dir_to_wd.clear()


def create_listener() -> Optional[InotifyListener]:
    if os.environ.get("LOONG_DISABLE_INOTIFY"):
        return None
    try:
        return InotifyListener()
    except OSError:
        return None
