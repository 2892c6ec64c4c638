"""Event-driven process-tree cache.

Reference: loongcollector_tpu/input/ebpf/proc_tree.py
(core/ebpf/plugin/ProcessCacheManager.cpp + ProcessCache.cpp) —
the kernel driver delivers execve/clone/exit events; the cache keys entries
by (pid, ktime) (`data_event_id`) so pid reuse cannot mis-attribute, links
each entry to its parent, refcounts entries so a parent outlives its
children's events, and enriches security/observer events with the process
and parent metadata (AttachProcessData, ProcessCacheManager.cpp:248-291).

This implementation keeps those semantics on the v2 driver ABI:

* `on_execve` — insert/replace the (pid, ktime) entry; parent resolved
  from (ppid, *latest*) and ref-held by the child.
* `on_clone` — child inherits the parent's image (comm/binary/args/cwd),
  parent ref-held.
* `on_exit` — entry enters a grace period (events already in flight still
  need enrichment — the reference keeps entries alive via refcounts and a
  cleanup queue), then releases its parent ref and expires.
* `/proc` warm-sync for processes that exec'd before the driver attached
  (ProcessSyncRetryableEvent analogue), performed lazily on miss.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

EXIT_GRACE_S = 10.0      # reference keeps exited entries until refs drain
MAX_ENTRIES = 16384


@dataclass
class ProcEntry:
    pid: int
    ktime: int
    ppid: int = -1
    comm: str = ""
    binary: str = ""
    args: str = ""
    cwd: str = ""
    user: str = ""
    container_id: str = ""
    parent: Optional["ProcEntry"] = None
    refcnt: int = 1
    exited_at: float = 0.0       # monotonic; 0 = alive
    exec_id: str = field(default="", compare=False)

    def __post_init__(self) -> None:
        if not self.exec_id:
            self.exec_id = f"{self.pid}:{self.ktime}"


class ProcessTreeCache:
    """(pid, ktime)-keyed process cache with parent linkage + refcounts."""

    NEG_TTL_S = 30.0   # cache failed /proc lookups (exited pids) this long

    def __init__(self, max_entries: int = MAX_ENTRIES):
        self._by_id: Dict[Tuple[int, int], ProcEntry] = {}
        self._latest: Dict[int, ProcEntry] = {}   # pid -> newest entry
        self._neg: Dict[int, float] = {}          # pid -> expiry (monotonic)
        self._lock = threading.Lock()
        self.max_entries = max_entries
        self.misses = 0
        self.hits = 0

    # -- driver-event ingestion --------------------------------------------

    def on_execve(self, pid: int, ktime: int, ppid: int = -1,
                  comm: str = "", binary: str = "", args: str = "",
                  cwd: str = "", container_id: str = "") -> ProcEntry:
        with self._lock:
            parent = self._latest.get(ppid) if ppid >= 0 else None
            ent = ProcEntry(pid=pid, ktime=ktime, ppid=ppid, comm=comm,
                            binary=binary or comm, args=args, cwd=cwd,
                            container_id=container_id, parent=parent)
            if parent is not None:
                parent.refcnt += 1
                if not ent.container_id:
                    ent.container_id = parent.container_id
            old = self._latest.get(pid)
            if old is not None and old.ktime != ktime:
                # same pid re-exec'd: the old image expires once its
                # in-flight events drain
                old.exited_at = old.exited_at or time.monotonic()
            replaced = self._by_id.get((pid, ktime))
            if replaced is not None and replaced.parent is not None:
                # same (pid, ktime) re-inserted (ktime is the process START
                # time, stable across execve): release the old entry's
                # parent ref or the parent can never be collected
                replaced.parent.refcnt -= 1
            self._by_id[(pid, ktime)] = ent
            self._latest[pid] = ent
            self._shrink_locked()
            return ent

    def on_clone(self, pid: int, ktime: int, ppid: int) -> ProcEntry:
        with self._lock:
            parent = self._latest.get(ppid)
            ent = ProcEntry(pid=pid, ktime=ktime, ppid=ppid, parent=parent)
            if parent is not None:
                parent.refcnt += 1
                # a cloned child runs the parent's image until it execs
                ent.comm = parent.comm
                ent.binary = parent.binary
                ent.args = parent.args
                ent.cwd = parent.cwd
                ent.user = parent.user
                ent.container_id = parent.container_id
            self._by_id[(pid, ktime)] = ent
            self._latest[pid] = ent
            self._shrink_locked()
            return ent

    def on_exit(self, pid: int, ktime: int = 0) -> None:
        with self._lock:
            ent = (self._by_id.get((pid, ktime)) if ktime
                   else self._latest.get(pid))
            if ent is not None and not ent.exited_at:
                ent.exited_at = time.monotonic()

    # -- lookup / enrichment -----------------------------------------------

    def lookup(self, pid: int, ktime: int = 0) -> Optional[ProcEntry]:
        with self._lock:
            ent = (self._by_id.get((pid, ktime)) if ktime
                   else self._latest.get(pid))
        if ent is not None:
            self.hits += 1
            return ent
        ent = self._proc_sync(pid)
        if ent is None:
            self.misses += 1
        return ent

    def attach_process_data(self, pid: int, ktime: int, ev, sb) -> bool:
        """Enrich a log event with process + parent metadata (reference
        AttachProcessData: exec_id, pid, binary, args, cwd, container,
        then the parent block).  Returns False on cache miss."""
        ent = self.lookup(pid, ktime)
        if ent is None:
            return False
        ev.set_content(b"exec_id", sb.copy_string(ent.exec_id))
        ev.set_content(b"process_pid", sb.copy_string(str(ent.pid)))
        if ent.comm:
            ev.set_content(b"comm", sb.copy_string(ent.comm))
        if ent.binary:
            ev.set_content(b"binary", sb.copy_string(ent.binary))
        if ent.args:
            ev.set_content(b"arguments", sb.copy_string(ent.args))
        if ent.cwd:
            ev.set_content(b"cwd", sb.copy_string(ent.cwd))
        if ent.user:
            ev.set_content(b"user", sb.copy_string(ent.user))
        if ent.container_id:
            ev.set_content(b"container_id",
                           sb.copy_string(ent.container_id))
        parent = ent.parent
        if parent is not None:
            ev.set_content(b"parent_exec_id", sb.copy_string(parent.exec_id))
            ev.set_content(b"parent_pid", sb.copy_string(str(parent.pid)))
            if parent.binary:
                ev.set_content(b"parent_binary",
                               sb.copy_string(parent.binary))
            if parent.args:
                ev.set_content(b"parent_arguments",
                               sb.copy_string(parent.args))
        return True

    # -- maintenance --------------------------------------------------------

    def clear_expired(self) -> int:
        """Drop exited entries past their grace period whose refs drained
        (reference ClearExpiredCache + the cleanup retryable event)."""
        now = time.monotonic()
        dropped = 0
        with self._lock:
            for key, ent in list(self._by_id.items()):
                if ent.exited_at and now - ent.exited_at > EXIT_GRACE_S \
                        and ent.refcnt <= 1:
                    del self._by_id[key]
                    if self._latest.get(ent.pid) is ent:
                        del self._latest[ent.pid]
                    if ent.parent is not None:
                        ent.parent.refcnt -= 1
                    # process-cache eviction, not an event discard
                    dropped += 1
        return dropped

    def size(self) -> int:
        with self._lock:
            return len(self._by_id)

    def _shrink_locked(self) -> None:
        if len(self._by_id) <= self.max_entries:
            return
        # ForceShrink analogue: exited-first, then oldest ktime
        victims = sorted(self._by_id.items(),
                         key=lambda kv: (not kv[1].exited_at, kv[1].ktime))
        for key, ent in victims[: len(self._by_id) // 4]:
            del self._by_id[key]
            if self._latest.get(ent.pid) is ent:
                del self._latest[ent.pid]
            if ent.parent is not None:
                ent.parent.refcnt -= 1

    def _proc_sync(self, pid: int) -> Optional[ProcEntry]:
        """Lazy /proc warm-start for pre-attach processes.  Failed lookups
        (exited/never-existed pids) are negative-cached so event floods for
        dead pids don't repeat open("/proc/N/...") per event."""
        now = time.monotonic()
        with self._lock:
            exp = self._neg.get(pid)
            if exp is not None:
                if exp > now:
                    return None
                del self._neg[pid]
        try:
            with open(f"/proc/{pid}/comm") as f:
                comm = f.read().strip()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                args = f.read().replace(b"\0", b" ").decode(
                    "utf-8", "replace").strip()
            ppid = -1
            try:
                with open(f"/proc/{pid}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                pass
            cwd = ""
            try:
                cwd = os.readlink(f"/proc/{pid}/cwd")
            except OSError:
                pass
        except OSError:
            with self._lock:
                if len(self._neg) > 4096:
                    self._neg = {k: v for k, v in self._neg.items()
                                 if v > now}
                self._neg[pid] = now + self.NEG_TTL_S
            return None
        with self._lock:
            ent = self._latest.get(pid)
            if ent is None:
                ent = ProcEntry(pid=pid, ktime=0, ppid=ppid, comm=comm,
                                binary=comm, args=args, cwd=cwd,
                                parent=self._latest.get(ppid))
                if ent.parent is not None:
                    ent.parent.refcnt += 1
                self._by_id[(pid, 0)] = ent
                self._latest[pid] = ent
            return ent
