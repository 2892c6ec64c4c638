"""FileServer: the file-input singleton of tail mode.

Reference: core/file_server/FileServer.cpp and
file_server/event_handler/LogInput.cpp:357 (ProcessLoop — one event thread
driving discovery, modify events and reader reads) with
BlockedEventManager (requeue on back-pressure); the port's copy of the JAX
package's ``input/file/file_server.py``.

One thread: each round it (1) runs discovery for every registered config
on its interval (and at once when inotify reports a created, moved or
deleted file), (2) drains the readers of changed files into the process
queues, honouring watermark back-pressure — a blocked read retries without
losing the reader's offset, and the queue's feedback wakes the thread when
it falls under its low watermark — and (3) drains rotated readers (a path
whose inode changed: the old inode is read to its end while a new reader
starts at 0 on the new file) until they are read and acked.  Between
rounds it sleeps ``IDLE_SLEEP_S`` when polling alone, or up to
``IDLE_SLEEP_INOTIFY_S`` on the inotify fd, which wakes it at an append.

Every fresh read passes ``recovery.suppress_duplicate`` before ingest: a
span the previous run already delivered is counted and dropped; reads end
at the duplicate window's boundaries (``recovery.read_limit``), so a
re-read chunk lines up with the acked spans.  Readers
opened by discovery restore their checkpoint (by (dev, inode)) and
register with the acked-offset tracker, so checkpoint dumps
(``checkpoint_dump_interval``) persist the acked frontier.  The reader
opened after a rotation registers too (the JAX package's does not, so its
dump for the new file is the read offset; ``ROADMAP.md`` Queue 3).  Past
``max_file_reader_num`` readers the oldest rotated reader is shed.

The JAX package's two alarms (``READ_LOG_DELAY`` past
``read_delay_alarm_bytes`` of backlog, ``FILE_READER_EXCEED`` at the reader
ceiling) are rate-limited per path as there, logged and raised on the
alarm plane with the JAX package's levels and messages (``status()``
``alarms`` reads the plane's totals of the two).  Its CPU-level flow control waits
for the port's watchdog.  A config may carry a
``tag_provider`` (JAX package ``file_server.py:75``, ``:486-488``): each
group drained from a path gets the tags it gives for that path (the
container stdout input's container and pod tags).  ``reset_for_testing``
stops and joins the thread and drops the singleton.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from ... import recovery
from ...monitor.alarms import AlarmLevel, AlarmManager, AlarmType
from ...runner import ack_watermark
from ...utils import flags
from ...utils.logger import get_logger
from .checkpoint import CheckPointManager
from .event_listener import create_listener
from .polling import FileDiscoveryConfig, PollingDirFile
from .reader import ML_FLUSH_TIMEOUT_S, LogFileReader, get_dev_inode

log = get_logger("file_server")

DISCOVERY_INTERVAL_S = 1.0

# reference parity knobs (reader/LogFileReader.cpp:70 read_delay_alarm_duration,
# FileReaderOptions ReadDelayAlertThresholdBytes, EventHandler.cpp:342
# FILE_READER_EXCEED_ALARM reader-count ceiling)
flags.DEFINE_FLAG_INT64("read_delay_alarm_bytes",
                        "backlog bytes before READ_LOG_DELAY_ALARM",
                        200 * 1024 * 1024)
flags.DEFINE_FLAG_INT32("read_delay_alarm_duration",
                        "seconds between repeated read-delay alarms", 60)
flags.DEFINE_FLAG_INT32("max_file_reader_num",
                        "max simultaneously open log readers", 512)
flags.DEFINE_FLAG_INT32("checkpoint_dump_interval",
                        "checkpoint dump seconds", 5)
IDLE_SLEEP_S = 0.05
# with inotify the thread sleeps ON the fd, so the poll interval can relax:
# events wake it at once and polling is only the discovery/rotation net
IDLE_SLEEP_INOTIFY_S = 0.25



class _ConfigState:
    def __init__(self, name: str, discovery: FileDiscoveryConfig,
                 queue_key: int, tail_existing: bool,
                 multiline_start: Optional[str] = None,
                 multiline_end: Optional[str] = None,
                 encoding: str = "utf8", chunk_size: Optional[int] = None):
        self.name = name
        self.poller = PollingDirFile(discovery)
        self.queue_key = queue_key
        self.readers: Dict[str, LogFileReader] = {}
        self.rotated: List[LogFileReader] = []  # old inodes still draining
        self.last_discovery = 0.0
        self.known: List[str] = []
        self.tail_existing = tail_existing
        self.first_round = True
        self.multiline_start = multiline_start
        self.multiline_end = multiline_end
        self.encoding = encoding
        self.chunk_size = chunk_size   # None = the reader's default
        self.pending: set = set()   # paths with bytes left after a drain
        # what this config's input reports (the run's drain rule counts
        # groups_pushed against the groups the runner settled)
        self.groups_pushed = 0
        self.read_seconds = 0.0
        self.rotations = 0
        # optional per-path group tags (container meta on stdio inputs):
        # callable(path) -> Dict[bytes, bytes] | None
        self.tag_provider = None

    def new_reader(self, path: str) -> LogFileReader:
        kwargs = {}
        if self.chunk_size:
            kwargs["chunk_size"] = self.chunk_size
        return LogFileReader(path, multiline_start=self.multiline_start,
                             multiline_end=self.multiline_end,
                             ml_flush_timeout=ML_FLUSH_TIMEOUT_S,
                             encoding=self.encoding, presplit_lines=True,
                             **kwargs)


class FileServer:
    _instance: Optional["FileServer"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._configs: Dict[str, _ConfigState] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self.process_queue_manager = None
        self.checkpoints = CheckPointManager()
        # inotify merged with polling (EventListener_Linux.h); None off
        # Linux or when LOONG_DISABLE_INOTIFY is set
        self._listener = None
        self._dirty_paths: set = set()
        # False when any watch failed (max_user_watches, permission): the
        # poll interval stays tight so unwatched paths aren't slow-tailed
        self._watch_complete = False
        # BlockedEventManager: a watermark-refused drain registers this
        # server as the queue's feedback, so the runner popping the queue
        # under its low watermark wakes the thread
        self._blocked_wake = threading.Event()
        self._feedback_keys: set = set()
        # path -> last alarm time (per-file alarm rate limiting)
        self._delay_alarms: Dict[str, float] = {}
        self._reader_limit_alarms: Dict[str, float] = {}
        self.suppressed_groups = 0
        self.inotify = False    # the last start found inotify

    @classmethod
    def instance(cls) -> "FileServer":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset_for_testing(cls) -> None:
        """Stop and join the event thread (its final drain and dump
        included) and drop the singleton."""
        with cls._instance_lock:
            fs, cls._instance = cls._instance, None
        if fs is not None:
            fs.stop()
            for name in list(fs._configs):
                fs.remove_config(name)

    # -- config registration (from InputFile plugins) -----------------------

    def add_config(self, name: str, discovery: FileDiscoveryConfig,
                   queue_key: int, tail_existing: bool = False,
                   multiline_start: Optional[str] = None,
                   multiline_end: Optional[str] = None,
                   tag_provider=None, encoding: str = "utf8",
                   chunk_size: Optional[int] = None) -> _ConfigState:
        """Register a config; returns its state, whose counts the input
        reports.  ``tag_provider(path)`` gives the tags every group read
        from ``path`` carries (or None)."""
        with self._lock:
            st = _ConfigState(
                name, discovery, queue_key, tail_existing,
                multiline_start=multiline_start, multiline_end=multiline_end,
                encoding=encoding, chunk_size=chunk_size)
            st.tag_provider = tag_provider
            self._configs[name] = st
        return st

    def update_config_paths(self, name: str, file_paths) -> None:
        """Replace a registered config's discovery globs; an empty list
        drains and prunes all current readers next round."""
        with self._lock:
            st = self._configs.get(name)
            if st is not None:
                st.poller.config.file_paths = list(file_paths)
                st.last_discovery = 0.0  # force rediscovery next round

    def remove_config(self, name: str) -> None:
        with self._lock:
            st = self._configs.pop(name, None)
        if st:
            for r in st.readers.values():
                if r.is_open:
                    self.checkpoints.update(r.checkpoint())
                r.close()
            for r in st.rotated:
                r.close()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._running:
                return
            self._running = True
        self.checkpoints.load()
        self._listener = create_listener()
        self.inotify = self._listener is not None
        self._thread = threading.Thread(target=self._run, name="file-server",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._lock:
            if not self._running:
                return
            self._running = False
        self._blocked_wake.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
        # final flush of partial lines + checkpoints
        with self._lock:
            states = list(self._configs.values())
        for st in states:
            for r in st.readers.values():
                self._drain_reader(st, r, force_flush=True)
                self.checkpoints.update(r.checkpoint())
                r.close()
        self.checkpoints.dump()

    @property
    def running(self) -> bool:
        return self._running

    def status(self) -> dict:
        """The file server's counts for ``--stats``."""
        with self._lock:
            states = list(self._configs.values())
        return {
            "configs": len(states),
            "readers": sum(len(s.readers) for s in states),
            "rotated_readers": sum(len(s.rotated) for s in states),
            "inotify": self.inotify,
            "watch_complete": self._watch_complete,
            "suppressed_groups": self.suppressed_groups,
            "alarms": {k: v for k, v in
                       AlarmManager.instance().totals().items()
                       if k in ("READ_LOG_DELAY", "FILE_READER_EXCEED")},
        }

    # -- main loop ----------------------------------------------------------

    def _run(self) -> None:
        while self._running:
            try:
                busy = self._round()
                self.checkpoints.dump_periodically(
                    float(flags.get_flag("checkpoint_dump_interval")))
            except Exception:  # noqa: BLE001 - never kill the event thread
                log.exception("file server round failed")
                busy = False
            sleep = (IDLE_SLEEP_INOTIFY_S
                     if self._listener is not None and self._watch_complete
                     else IDLE_SLEEP_S)
            if busy:
                continue
            if self._blocked_wake.is_set():
                # a queue we blocked on drained: resume at once
                self._blocked_wake.clear()
                continue
            with self._lock:
                any_pending = any(st.pending for st in
                                  self._configs.values())
            if any_pending:
                # back-pressured readers outstanding: the inotify wait
                # below cannot see the feedback event, so bound the sleep
                sleep = min(sleep, IDLE_SLEEP_S)
            if self._listener is not None:
                # sleep ON the inotify fd: an append wakes the thread now,
                # not at the next poll tick
                for path, needs_discovery in self._listener.wait(sleep):
                    self._dirty_paths.add(path)
                    if needs_discovery:
                        with self._lock:
                            for st in self._configs.values():
                                st.last_discovery = 0.0
            else:
                self._blocked_wake.wait(sleep)
        if self._listener is not None:
            self._listener.close()
            self._listener = None

    def _round(self) -> bool:
        with self._lock:
            states = list(self._configs.values())
        dirty = self._dirty_paths
        self._dirty_paths = set()
        busy = False
        now = time.monotonic()
        live_dirs: set = set()
        for st in states:
            ran_discovery = False
            if now - st.last_discovery >= DISCOVERY_INTERVAL_S or st.first_round:
                ran_discovery = True
                st.last_discovery = now
                st.known = st.poller.poll()
                for path in st.known:
                    if path not in st.readers:
                        self._open_reader(st, path)
                    else:
                        self._check_rotation(st, path)
                # prune readers whose file left the glob or was deleted:
                # open fds would pin deleted files' disk space forever
                known_set = set(st.known)
                for path in list(st.readers):
                    if path not in known_set:
                        r = st.readers.pop(path)
                        self._drain_reader(st, r, force_flush=True)
                        self.checkpoints.remove(r.dev_inode.dev,
                                                r.dev_inode.inode)
                        r.close()
                        self._delay_alarms.pop(path, None)
                        self._reader_limit_alarms.pop(path, None)
                st.first_round = False
            # drain readers with unread bytes.  With complete inotify
            # coverage, off-discovery rounds only stat files that fired an
            # event or still had bytes after the last burst; the periodic
            # discovery pass remains the net for inotify-silent filesystems
            if self._listener is not None and self._watch_complete \
                    and not ran_discovery:
                targets = [st.readers[p]
                           for p in (dirty | st.pending) if p in st.readers]
            else:
                targets = list(st.readers.values())
            for r in targets:
                if ran_discovery:
                    self._check_read_delay(st, r)
                if r.has_more():
                    moved = self._drain_reader(st, r)
                    busy |= moved
                    if r.has_more():
                        st.pending.add(r.path)   # burst cap / back-pressure
                    else:
                        st.pending.discard(r.path)
                else:
                    st.pending.discard(r.path)
            for r in list(st.rotated):
                busy |= self._drain_reader(st, r, force_flush=True)
                if not r.has_more() and ack_watermark.fully_acked(
                        r.dev_inode.dev, r.dev_inode.inode):
                    # fully read AND every span acked: only now may the
                    # inode's books close (this reader's own entry: the
                    # live reader at the same path owns another inode)
                    self.checkpoints.remove(r.dev_inode.dev,
                                            r.dev_inode.inode)
                    ack_watermark.tracker().forget(r.dev_inode.dev,
                                                   r.dev_inode.inode)
                    r.close()
                    st.rotated.remove(r)
            if self._listener is not None:
                for path in st.known:
                    live_dirs.add(os.path.dirname(path) or ".")
                for pattern in st.poller.config.file_paths:
                    # static prefix of each glob: catches files created later
                    d = os.path.dirname(pattern)
                    while any(c in d for c in "*?["):
                        d = os.path.dirname(d)
                    if d and os.path.isdir(d):
                        live_dirs.add(d)
        if self._listener is not None:
            complete = True
            for d in live_dirs:
                complete = self._listener.watch_dir(d) and complete
            self._listener.unwatch_missing(live_dirs)
            self._watch_complete = complete
        return busy


    def _check_read_delay(self, st: _ConfigState, reader) -> None:
        """READ_LOG_DELAY (reference LogFileReader.cpp:1540-1559): the
        writer outruns the reader by more than the threshold — at most once
        per duration per file."""
        backlog = reader.backlog()
        if backlog <= flags.get_flag("read_delay_alarm_bytes"):
            self._delay_alarms.pop(reader.path, None)
            return
        now = time.monotonic()
        last = self._delay_alarms.get(reader.path, 0.0)
        if now - last < flags.get_flag("read_delay_alarm_duration"):
            return
        self._delay_alarms[reader.path] = now
        log.warning("read log delay: %s falls behind %d bytes",
                    reader.path, backlog)
        AlarmManager.instance().send_alarm(
            AlarmType.READ_LOG_DELAY,
            f"fall behind {backlog} bytes, path: {reader.path}",
            AlarmLevel.ERROR, st.name)

    def _register_feedback(self, queue_key: int) -> None:
        # on EVERY refusal (set_feedback replaces the list, so this is
        # idempotent): a queue recreated under the same key is woken too
        getter = getattr(self.process_queue_manager, "get_queue", None)
        q = getter(queue_key) if getter is not None else None
        if q is not None:
            q.set_feedback(self)
            self._feedback_keys.add(queue_key)

    def feedback(self, key: int) -> None:
        """The queue fell under its low watermark: wake the event thread so
        blocked readers resume at once (FeedbackInterface)."""
        self._blocked_wake.set()

    def _check_rotation(self, st: _ConfigState, path: str) -> None:
        """Rename-and-recreate rotation: the path's inode changed — finish
        the old inode through the rotated list, and open a fresh reader at
        offset 0 (reference: rotation by DevInode tracking)."""
        r = st.readers.get(path)
        if r is None:
            return
        cur = get_dev_inode(path)
        if cur.valid() and cur.inode != r.dev_inode.inode:
            st.rotated.append(r)
            st.rotations += 1
            # rotation churn must not blow past the fd ceiling: shed old
            # rotated readers first (the LIVE path always reopens, or the
            # new file's data would be lost)
            self._shed_for_capacity(st, path)
            new = st.new_reader(path)
            if new.open():
                st.readers[path] = new
                ack_watermark.register_source(
                    new.dev_inode.dev, new.dev_inode.inode, new.offset)
            else:
                del st.readers[path]

    def _reader_count(self) -> int:
        with self._lock:
            return sum(len(c.readers) + len(c.rotated)
                       for c in self._configs.values())

    def _shed_for_capacity(self, st: _ConfigState, path: str) -> bool:
        """At the reader ceiling: shed the oldest ROTATED reader (the
        reference cleans the rotator queue, EventHandler.cpp:330-348).
        Returns True when a slot was freed.  The alarm rate-limits per
        path."""
        if self._reader_count() < flags.get_flag("max_file_reader_num"):
            return True
        freed = False
        with self._lock:
            configs = list(self._configs.values())
        for c in configs:
            if c.rotated:
                old = c.rotated.pop(0)
                self.checkpoints.update(old.checkpoint())
                old.close()
                freed = True
                break
        now = time.monotonic()
        last = self._reader_limit_alarms.get(path, 0.0)
        if now - last >= flags.get_flag("read_delay_alarm_duration"):
            self._reader_limit_alarms[path] = now
            msg = (f"log reader count at limit "
                   f"({flags.get_flag('max_file_reader_num')}); "
                   + ("dropped an old rotated reader" if freed
                      else f"skipping {path}"))
            log.warning("%s", msg)
            AlarmManager.instance().send_alarm(
                AlarmType.FILE_READER_EXCEED, msg,
                AlarmLevel.WARNING, st.name)
        return freed

    def _open_reader(self, st: _ConfigState, path: str) -> None:
        if not self._shed_for_capacity(st, path):
            return
        r = st.new_reader(path)
        if not r.open():
            return
        cp = self.checkpoints.get(r.dev_inode.dev, r.dev_inode.inode)
        if cp is not None:
            r.restore(cp)
        elif not st.tail_existing and st.first_round:
            # skip history on first sight (reference TailExisted=false)
            try:
                r.offset = os.fstat(r._fd).st_size
            except OSError:
                pass
        # from here this source's checkpoint dumps use the acked frontier,
        # not the read offset (the at-least-once contract)
        ack_watermark.register_source(r.dev_inode.dev, r.dev_inode.inode,
                                      r.offset)
        st.readers[path] = r

    def _drain_reader(self, st: _ConfigState, reader: LogFileReader,
                      force_flush: bool = False) -> bool:
        """Read until empty or back-pressure; True if data moved."""
        moved = False
        pqm = self.process_queue_manager
        for _ in range(64):  # bounded burst per round
            if pqm is not None and not pqm.is_valid_to_push(st.queue_key):
                # watermark high: requeue for the feedback wakeup
                self._register_feedback(st.queue_key)
                break
            t0 = time.perf_counter()
            limit = recovery.read_limit(reader.dev_inode.dev,
                                        reader.dev_inode.inode,
                                        reader.offset)
            try:
                group = reader.read(force_flush=force_flush,
                                    max_bytes=limit)
            except OSError:
                break  # reader closed concurrently (config removal)
            st.read_seconds += time.perf_counter() - t0
            if group is None or not reader.is_open:
                break
            if recovery.suppress_duplicate(group):
                # the previous run already delivered this exact span (acked
                # after its last checkpoint dump): counted, never ingested
                moved = True
                self.suppressed_groups += 1
                self.checkpoints.update(reader.checkpoint())
                continue
            if st.tag_provider is not None:
                try:
                    tags = st.tag_provider(reader.path)
                except Exception:  # noqa: BLE001
                    tags = None
                if tags:
                    for k, v in tags.items():
                        group.set_tag(k, v)
            if pqm is not None:
                if not pqm.push_queue(st.queue_key, group):
                    # refused after the read: restore the offset and the
                    # multiline stitch state together
                    reader.rollback_last()
                    self._register_feedback(st.queue_key)
                    break
            st.groups_pushed += 1
            moved = True
            self.checkpoints.update(reader.checkpoint())
        return moved
