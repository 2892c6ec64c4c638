"""Disk buffering of failed/exiting send payloads.

Reference: core/plugin/flusher/sls/DiskBufferWriter.h:56,92 — serialized
payloads that cannot be sent (endpoint down, agent exiting) spill to disk
and replay on recovery; FlusherRunner spills SLS items at exit
(FlusherRunner.cpp:223-227, enable_full_drain_mode).

Format: one file per payload under <dir>/<tenant>/buffer_<ts>_<seq>.lcb
with a JSON header line (flusher identity + raw size + metadata) followed
by the payload bytes — ENCRYPTED at rest when a PayloadCipher is attached
(reference DiskBufferWriter.h:56 treats buffer-file encryption as
production-critical; a host-level reader of the spill directory must not
recover log content).  Plaintext files from older runs still replay.
Replay re-enqueues through the live flusher of the same pipeline/plugin
identity when it exists.

loongtenant namespace isolation: spills land in a per-pipeline
subdirectory (``<dir>/<sanitized pipeline name>/``; legacy files in the
root keep replaying) with a per-tenant byte quota — ``max_bytes`` split
evenly over the namespaces present — so one tenant filling the buffer
can refuse only ITS OWN spills, and ``pending()`` interleaves
namespaces round-robin so one tenant's deep backlog cannot starve every
other tenant's replay behind the per-round ``limit``.

The port's copy of the JAX package's ``runner/disk_buffer.py``: the same
file format, header keys (``event_cnt`` included), namespaces, caps and
``.lcb.bad`` quarantine, so a buffer either agent spills replays in the
other.  The chaos points, trace events and flight records are left out
(the port has none of those planes); a quarantine raises the
``SECONDARY_READ_WRITE`` alarm.  One change: replays are serialized
(``_replay_lock``).  The JAX package's ``replay`` can run on the
application's loop and on the flusher runner's thread at once, and both
can read a file before either removes it, pushing its payload twice.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Callable, List, Optional

from ..monitor import ledger
from ..monitor.alarms import AlarmLevel, AlarmManager, AlarmType
from ..pipeline.queue.sender_queue import SenderQueueItem
from ..utils.logger import get_logger

log = get_logger("disk_buffer")

MAX_BUFFER_BYTES = 512 * 1024 * 1024

_NS_SAFE = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_."


def _namespace_of(pipeline: str) -> str:
    """Filesystem-safe per-tenant namespace ("" = legacy root for
    unattributed payloads).  Collisions after sanitisation merge two
    tenants' QUOTAS, never their bytes (each file's header still names
    its true pipeline)."""
    if not pipeline:
        return ""
    ns = "".join(c if c in _NS_SAFE else "_" for c in pipeline)[:120]
    # ".."/"." are path traversal, a ".bad"-style suffix is quarantine
    # vocabulary — none may become a directory name
    if ns in (".", "..") or ns.startswith("."):
        ns = "_" + ns.lstrip(".")
    return ns or "_"


class DiskBufferWriter:
    def __init__(self, directory: str,
                 max_bytes: int = MAX_BUFFER_BYTES,
                 cipher=None):
        self.directory = directory
        self.max_bytes = max_bytes
        self.cipher = cipher  # utils.payload_crypto.PayloadCipher or None
        self._seq = 0
        self._lock = threading.Lock()
        # one replay at a time: the application's loop and the flusher
        # runner (breaker close, probe cadence) both replay, and two
        # replays reading one file before either removed it would push
        # its payload twice
        self._replay_lock = threading.Lock()
        self._run_id = uuid.uuid4().hex[:8]  # filenames unique across restarts
        # lazily-initialized running byte totals, keyed per tenant
        # namespace ("" = legacy root files); None until first scanned
        self._totals = None  # type: Optional[dict]
        # loongledger sidecar: path -> (pipeline, event_cnt) for files THIS
        # process spilled (and thus ledgered as B_SPILL).  A quarantined
        # file whose header is unreadable still settles its ledger balance
        # through this map; files from earlier runs are not in it and were
        # never counted, so their quarantine records nothing
        self._spill_ledger: dict = {}
        # items this writer spilled, replayed and quarantined (--stats)
        self.spilled = 0
        self.replayed = 0
        self.quarantined_files = 0

    # -- namespace accounting ------------------------------------------------

    def _ns_of_path(self, path: str) -> str:
        parent = os.path.dirname(os.path.abspath(path))
        root = os.path.abspath(self.directory)
        return "" if parent == root else os.path.basename(parent)

    def _ensure_totals(self) -> dict:
        """Lock held.  Per-namespace byte totals of files at rest."""
        if self._totals is None:
            totals: dict = {}
            for ns, paths in self._pending_by_ns().items():
                for path in paths:
                    try:
                        totals[ns] = totals.get(ns, 0) \
                            + os.path.getsize(path)
                    except OSError:
                        pass
            self._totals = totals
        return self._totals

    def _tenant_cap(self, totals: dict, ns: str) -> int:
        """One namespace's byte quota: the global cap split evenly over
        the namespaces present (this one included).  A single tenant
        keeps the whole buffer — exactly the pre-tenant behaviour."""
        n = len(set(totals) | {ns})
        return self.max_bytes if n <= 1 else self.max_bytes // n

    # -- write --------------------------------------------------------------

    def spill(self, item: SenderQueueItem, identity: dict) -> bool:
        """Persist one sender item.  identity: whatever the flusher needs to
        reclaim the payload (pipeline name, flusher type, plugin id...)."""
        ns = _namespace_of(identity.get("pipeline", ""))
        ns_dir = (os.path.join(self.directory, ns) if ns
                  else self.directory)
        os.makedirs(ns_dir, exist_ok=True)
        with self._lock:
            totals = self._ensure_totals()
            used = totals.get(ns, 0)
            cap = self._tenant_cap(totals, ns)
            if sum(totals.values()) + len(item.data) > self.max_bytes:
                # the GLOBAL cap still binds: per-tenant quotas divide the
                # buffer, they never let the sum overshoot it (tenants
                # arriving one at a time would otherwise stack shrinking
                # caps up to max_bytes * H(n))
                log.warning("disk buffer full; dropping payload (%d bytes)",
                            len(item.data))
                return False
            if used + len(item.data) > cap:
                # per-tenant quota: only THIS tenant's spill refuses —
                # other namespaces keep their headroom untouched
                log.warning(
                    "disk buffer tenant quota exceeded for %r "
                    "(%d + %d > %d); dropping payload",
                    ns or "<root>", used, len(item.data), cap)
                return False
            totals[ns] = used + len(item.data)
            self._seq += 1
            name = (f"buffer_{int(time.time())}_{self._run_id}"
                    f"_{self._seq}.lcb")
        header = dict(identity)
        header["raw_size"] = item.raw_size
        header["enqueue_time"] = time.time()
        # event provenance rides the spill so replay restores event-unit
        # accounting (0 = unknown, e.g. a pre-ledger item)
        header["event_cnt"] = getattr(item, "event_cnt", 0)
        payload = item.data
        if self.cipher is not None:
            payload = self.cipher.encrypt(payload)
            header["enc"] = "hmac-ctr-v1"
        path = os.path.join(ns_dir, name)
        tmp = path + ".tmp"
        try:
            # crash-safe: temp file + fsync + atomic rename — a crash or
            # power cut mid-spill leaves either the complete old state or
            # a stray .tmp (ignored by pending()), never a torn .lcb
            with open(tmp, "wb") as f:
                f.write(json.dumps(header).encode() + b"\n")
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError as e:
            log.error("disk buffer write failed: %s", e)
            with self._lock:
                self._note_removed(path, len(item.data))
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False
        with self._lock:
            self.spilled += 1
        if ledger.is_on():
            # spill is a conservation SINK: the events are safely at rest;
            # a later replay credits them back as a source
            ledger.record(header.get("pipeline", ""), ledger.B_SPILL,
                          header["event_cnt"], len(item.data))
            with self._lock:
                self._spill_ledger[path] = (header.get("pipeline", ""),
                                            header["event_cnt"])
        return True

    # -- read / replay ------------------------------------------------------

    def _walk_files(self, suffix: str) -> dict:
        """{namespace: sorted matching paths} over the root (legacy ""
        files) and every tenant subdirectory — the one traversal both
        pending() and quarantined() ride."""
        out: dict = {}
        try:
            entries = sorted(os.listdir(self.directory))
        except OSError:
            return out
        for e in entries:
            full = os.path.join(self.directory, e)
            if e.endswith(suffix):
                out.setdefault("", []).append(full)
            elif os.path.isdir(full):
                try:
                    files = sorted(os.path.join(full, f)
                                   for f in os.listdir(full)
                                   if f.endswith(suffix))
                except OSError:
                    continue
                if files:
                    out[e] = files
        return out

    def _pending_by_ns(self) -> dict:
        return self._walk_files(".lcb")

    def pending(self) -> List[str]:
        """All buffered payload paths, interleaved ROUND-ROBIN across
        tenant namespaces (oldest-first within each): replay's per-round
        ``limit`` then advances every tenant's backlog instead of
        serving one deep tenant exclusively."""
        by_ns = self._pending_by_ns()
        lanes = [by_ns[ns] for ns in sorted(by_ns)]
        out: List[str] = []
        i = 0
        while lanes:
            lanes = [lane for lane in lanes if i < len(lane)]
            for lane in lanes:
                out.append(lane[i])
            i += 1
        return out

    def pending_for(self, resolve: Callable[[dict], Optional[object]]
                    ) -> int:
        """Buffered payloads whose identity ``resolve`` maps to a live
        flusher: what a replay could still deliver in this process (files
        of pipelines that no longer exist are kept, and not counted).
        Reads each file's header line only."""
        n = 0
        for path in self.pending():
            try:
                with open(path, "rb") as f:
                    header = json.loads(f.readline())
            except (OSError, ValueError):
                continue
            if isinstance(header, dict) and resolve(header) is not None:
                n += 1
        return n

    def _read_classified(self, path: str):
        """('ok', header, payload) | ('corrupt', None, None) — structurally
        broken, safe to delete | ('locked', None, None) — encrypted but not
        currently decryptable (missing/wrong key): KEEP the file, the key
        may come back."""
        try:
            with open(path, "rb") as f:
                header = json.loads(f.readline())
                payload = f.read()
        except (OSError, ValueError):
            return "corrupt", None, None
        if not isinstance(header, dict):
            return "corrupt", None, None
        if header.get("enc") == "hmac-ctr-v1":
            if self.cipher is None:
                log.error("encrypted buffer file but no cipher configured; "
                          "keeping for later: %s", path)
                return "locked", None, None
            payload = self.cipher.decrypt(payload)
            if payload is None:   # wrong key or tampered file
                log.error("buffer file failed authentication; keeping: %s",
                          path)
                return "locked", None, None
        return "ok", header, payload

    def replay(self, resolve: Callable[[dict], Optional[object]],
               limit: int = 100) -> int:
        """Re-enqueue up to `limit` buffered payloads.  `resolve(identity)`
        returns the live flusher (with .sender_queue and .queue_key) or None
        if the pipeline no longer exists (payload is kept for later)."""
        with self._replay_lock:
            return self._replay(resolve, limit)

    def _replay(self, resolve: Callable[[dict], Optional[object]],
                limit: int) -> int:
        count = 0
        # scan ALL pending files but count only replayed ones toward the
        # limit — otherwise >limit unresolvable old files would starve every
        # newer payload forever
        for path in self.pending():
            if count >= limit:
                break
            status, header, payload = self._read_classified(path)
            if status == "corrupt":
                # quarantine, don't delete: a malformed file is evidence
                # (torn write from a crash, bit rot, injected corruption)
                # and must neither abort the replay loop nor vanish
                self._quarantine(path)
                continue
            if status == "locked":   # undecryptable today ≠ deletable
                continue
            flusher = resolve(header)
            if flusher is None or flusher.sender_queue is None:
                continue
            item = SenderQueueItem(payload, header.get("raw_size", len(payload)),
                                   flusher=flusher,
                                   queue_key=flusher.queue_key,
                                   event_cnt=int(header.get("event_cnt", 0)))
            if flusher.sender_queue.push(item) is False:
                # target refused (replay adapter at capacity): the file is
                # the only copy — keep it for a later round
                continue
            if ledger.is_on():
                # replay is a conservation SOURCE: the events re-enter the
                # live send path and will terminate again (send_ok, a
                # re-spill, or a drop)
                ledger.record(header.get("pipeline", ""), ledger.B_REPLAY,
                              item.event_cnt, len(payload))
            with self._lock:
                self._spill_ledger.pop(path, None)
                # counted before the file goes: a reader that misses the
                # file sees the count move (application._SendPath)
                self.replayed += 1
            self._remove(path)
            count += 1
        if count:
            log.info("replayed %d buffered payloads", count)
        return count

    def _quarantine(self, path: str) -> None:
        """Rename a malformed buffer file to `.lcb.bad` (out of pending())
        and alarm — operators can inspect or purge, replay moves on."""
        try:
            size = os.path.getsize(path)
            os.replace(path, path + ".bad")
        except OSError as e:
            log.error("quarantine of %s failed: %s", path, e)
            return
        with self._lock:
            self._note_removed(path, size)
            spilled = self._spill_ledger.pop(path, None)
            self.quarantined_files += 1
        if spilled is not None and ledger.is_on():
            # the file was ledgered as B_SPILL when this process wrote it:
            # credit it back out of the buffer (replay, tag=quarantine) and
            # retire the events terminally at the quarantine boundary — the
            # residual stays zero while `quarantine` names the loss bucket
            pipeline, events = spilled
            ledger.record(pipeline, ledger.B_REPLAY, events, size,
                          tag="quarantine")
            ledger.record(pipeline, ledger.B_QUARANTINE, events, size)
        log.error("malformed buffer file quarantined: %s.bad", path)
        AlarmManager.instance().send_alarm(
            AlarmType.SECONDARY_READ_WRITE,
            f"malformed disk-buffer file quarantined ({size} bytes)",
            AlarmLevel.ERROR)

    def quarantined(self) -> List[str]:
        by_ns = self._walk_files(".lcb.bad")
        return [p for ns in sorted(by_ns) for p in by_ns[ns]]

    def _note_removed(self, path: str, size: int) -> None:
        """Lock held: a file left its namespace — release quota bytes.
        A namespace that drained to zero leaves the table entirely, so a
        long-gone tenant does not keep shrinking every LIVE tenant's
        quota share forever."""
        if self._totals is not None:
            ns = self._ns_of_path(path)
            left = max(0, self._totals.get(ns, 0) - size)
            if left:
                self._totals[ns] = left
            else:
                self._totals.pop(ns, None)

    def _remove(self, path: str) -> None:
        try:
            size = os.path.getsize(path)
            os.remove(path)
        except OSError:
            return
        with self._lock:
            self._note_removed(path, size)
