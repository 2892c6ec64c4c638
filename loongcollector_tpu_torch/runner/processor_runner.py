"""ProcessorRunner: the worker threads between the process queues and the
flushers.

Reference: loongcollector_tpu/runner/processor_runner.py
(core/runner/ProcessorRunner.cpp:90-189).  Workers pop runs of groups from
the process-queue manager, find the owning pipeline, process and send.

* ``thread_count == 1`` (``LOONG_PROCESS_THREADS``, default 1): one worker
  pops the queue manager directly.
* ``thread_count > 1``: a dispatch loop pops the queue manager and routes
  each group to a fixed worker by CRC32 affinity on (queue key, source),
  through small bounded inboxes.  All groups of one source land on one
  worker, which sends them in pop order, so per-source order holds while
  distinct sources process in parallel.

Each worker owns a ``WorkerLane``: a FIFO of up to ``LOONG_STREAM_DEPTH - 1``
groups whose device work is in flight.  The worker dispatches group N+1
(``Pipeline.process_begin``: host stages, ring-slot pack, async kernel
dispatch), then completes the oldest group of its lane (consume the device
work, the remaining processors, send).  While the device computes group N
the host packs group N+1 and sends group N-1.  When the device stalls, the
plane's byte budget fills, the worker blocks in ``submit``, stops popping,
the queues reach their high watermark and the inputs wait.  A worker
waiting for budget completes its own lane's oldest group first (the relief
hook bound to its lane), so the budget cannot deadlock and sends keep
their order.

On CUDA each worker binds its own pair of streams (``ThreadStreams``: H2D
copies, kernel and D2H) and runs under its compute stream, so workers do
not serialise behind one stream.

Chip lanes (reference ``processor_runner.py:617-669``): with several
workers, each one binds to its home lane (``ops/chip_lanes``: ``worker_id
% n_lanes``) for its whole loop, so every device dispatch it makes lands
on that lane's device, and its stream pair is bound there.  The lookup
raises rather than leave a worker unbound (the reference's is fail-soft).
A lane of another device kind than the runner's (CUDA lanes under a
``--cpu`` run) binds nothing.

A processing or send failure is logged, the group dropped, and the first
failure kept in ``error``: the agent's ``--once`` run then stops feeding
and exits non-zero.  Nothing re-runs a group another way.

With the ledger on, a group whose device work stays in flight is booked
device_submit when it enters its lane and device_materialize when it
completes, and a failed group is a reason-tagged drop.  Left out of the
port: the SLO, ack-watermark, tracer, profiler and flight-recorder hooks,
the lane breaker and the alarms.  Once a second a worker (the dispatch loop
when sharded) pumps the ``TimeoutFlushManager`` and the auto-tuner.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import zlib
from collections import deque
from typing import List, Optional, Tuple

import torch

from ..models import EventGroupMetaKey, PipelineEventGroup
from ..monitor import ledger
from ..ops import chip_lanes
from ..ops.device_plane import (bind_thread_streams, current_tenant,
                                note_host_backlog, set_budget_relief,
                                set_thread_tenant)
from ..ops.device_stream import auto_tuner, stream_depth
from ..pipeline.batch.timeout_flush_manager import TimeoutFlushManager
from ..pipeline.queue.process_queue_manager import (RUN_MAX_GROUPS,
                                                    ProcessQueueManager)
from ..utils.logger import get_logger

log = get_logger("processor_runner")

TUNER_ADJUST_INTERVAL_S = 1.0

# the reference's ``process_thread_count`` default
DEFAULT_PROCESS_THREADS = 1

ENV_THREADS = "LOONG_PROCESS_THREADS"

# per-worker inbox depth: small on purpose, the buffering lives in the
# bounded process queues
INBOX_CAPACITY = 4

_SOURCE_TAG = b"__source__"


def resolve_thread_count(env=os.environ) -> int:
    """Worker count: ``LOONG_PROCESS_THREADS`` when it is an integer >= 1,
    else ``DEFAULT_PROCESS_THREADS``."""
    raw = env.get(ENV_THREADS)
    if raw is not None:
        try:
            n = int(raw)
            if n >= 1:
                return n
            log.warning("%s=%r below 1; using %d", ENV_THREADS, raw,
                        DEFAULT_PROCESS_THREADS)
        except ValueError:
            log.warning("invalid %s=%r; using %d", ENV_THREADS, raw,
                        DEFAULT_PROCESS_THREADS)
    return DEFAULT_PROCESS_THREADS


def shard_of(queue_key: int, source: Optional[bytes], n: int) -> int:
    """Affinity shard: CRC32 over the source identity seeded with the
    queue key, the same in every process."""
    if n <= 1:
        return 0
    return zlib.crc32(source or b"", queue_key & 0xFFFFFFFF) % n


def group_source_id(group: PipelineEventGroup) -> Optional[bytes]:
    """A group's ordering identity: its ``__source__`` tag, else its file
    (path and inode), else None (one worker per pipeline)."""
    src = group.get_tag(_SOURCE_TAG)
    if src is not None:
        return src.to_bytes()
    path = group.get_metadata(EventGroupMetaKey.LOG_FILE_PATH)
    if path is not None:
        inode = group.get_metadata(EventGroupMetaKey.LOG_FILE_INODE)
        pid = path.to_bytes()
        return (pid + b":" + inode.to_bytes()) if inode is not None else pid
    return None


class WorkerLane:
    """One worker's ring of groups whose device work is in flight: up to
    ``depth - 1`` entries, strict FIFO.  ``take()`` removes the oldest
    atomically, so the worker loop and the budget-relief hook cannot both
    complete one entry, and completion order is dispatch order."""

    __slots__ = ("worker_id", "depth", "capacity", "_lock", "_pending",
                 "_t0", "_held_since", "_held_s")

    def __init__(self, worker_id: int, depth: Optional[int] = None):
        self.worker_id = worker_id
        self.depth = depth if depth is not None else stream_depth()
        self.capacity = max(1, self.depth - 1)
        self._lock = threading.Lock()
        self._pending: deque = deque()   # [(pending, enqueued_at)]
        self._t0 = time.perf_counter()
        self._held_since = 0.0
        self._held_s = 0.0

    def put(self, pending) -> None:
        if pending is None:
            return
        now = time.perf_counter()
        with self._lock:
            if len(self._pending) >= self.capacity:
                raise RuntimeError("worker lane full")
            if not self._pending:
                self._held_since = now
            self._pending.append((pending, now))

    def take(self):
        """Remove and return the oldest pending entry, or None."""
        with self._lock:
            if not self._pending:
                return None
            p, _t = self._pending.popleft()
            if not self._pending:
                self._held_s += time.perf_counter() - self._held_since
            return p

    def busy(self) -> bool:
        with self._lock:
            return bool(self._pending)

    def full(self) -> bool:
        with self._lock:
            return len(self._pending) >= self.capacity

    def oldest_age(self) -> Optional[float]:
        """Seconds the oldest entry has ridden the lane (None when empty),
        held against the tuner's flush deadline."""
        with self._lock:
            if not self._pending:
                return None
            return time.perf_counter() - self._pending[0][1]

    def overlap_ratio(self) -> float:
        """Share of the lane's lifetime with device work in flight."""
        now = time.perf_counter()
        with self._lock:
            held = self._held_s
            if self._pending:
                held += now - self._held_since
        return held / max(now - self._t0, 1e-9)


class _ShardInbox:
    """Bounded hand-off between the dispatch loop and one worker.  A full
    inbox blocks the dispatcher (back-pressure); ``close()`` wakes the
    worker for its final drain."""

    def __init__(self, capacity: int = INBOX_CAPACITY):
        self._items: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._capacity = capacity
        self._closed = False

    def put(self, item, timeout: float = 1.0) -> bool:
        """Blocks while full.  False when closed (the caller owns the item
        again) or when the wait timed out with no space."""
        deadline = time.monotonic() + timeout
        with self._not_full:
            while len(self._items) >= self._capacity and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._not_full.wait(remaining)
            if self._closed:
                return False
            self._items.append(item)
            self._not_empty.notify()
            return True

    def get_run(self, timeout: float = 0.2, max_groups: int = 8):
        """The head item plus the consecutive items of its queue key, as
        one (key, groups) run, in FIFO order."""
        with self._not_empty:
            if not self._items:
                if timeout > 0 and not self._closed:
                    self._not_empty.wait(timeout)
                if not self._items:
                    return None
            key, group = self._items.popleft()
            groups = [group]
            while self._items and len(groups) < max_groups \
                    and self._items[0][0] == key:
                groups.append(self._items.popleft()[1])
            self._not_full.notify_all()
            return key, groups

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def is_closed(self) -> bool:
        with self._lock:
            return self._closed

    def drained(self) -> bool:
        with self._lock:
            return self._closed and not self._items

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class ProcessorRunner:
    def __init__(self, process_queue_manager: ProcessQueueManager,
                 pipeline_manager, thread_count: Optional[int] = None,
                 run_max_groups: int = RUN_MAX_GROUPS,
                 device: Optional[torch.device] = None):
        self.pqm = process_queue_manager
        self.pipeline_manager = pipeline_manager
        if thread_count is None:
            thread_count = resolve_thread_count()
        self.thread_count = max(1, int(thread_count))
        self.run_max_groups = max(1, int(run_max_groups))
        # on CUDA each worker binds its own stream pair on this device
        self.device = device
        self._threads: List[threading.Thread] = []
        self._dispatch_thread: Optional[threading.Thread] = None
        self._lanes: List[WorkerLane] = []
        self._inboxes: List[_ShardInbox] = []
        self._running = False
        # groups sent, dropped or failed: a run is drained when this equals
        # the groups its inputs pushed
        self._settled = 0
        self._count_lock = threading.Lock()
        self._last_adjust = time.monotonic()
        self._adjust_claim = threading.Lock()
        self.error: Optional[BaseException] = None
        self.groups_failed = 0

    # -- producer API -------------------------------------------------------

    def push_queue(self, key: int, group: PipelineEventGroup,
                   retry_times: int = 10) -> bool:
        for _ in range(retry_times):
            if self.pqm.push_queue(key, group):
                return True
            time.sleep(0.01)
        log.warning("push rejected after %d retries (queue %d)",
                    retry_times, key)
        return False

    # -- lifecycle ----------------------------------------------------------

    def init(self) -> None:
        self._running = True
        self._lanes = [WorkerLane(i) for i in range(self.thread_count)]
        if self.thread_count == 1:
            t = threading.Thread(target=self._guarded,
                                 args=(self._run_single, 0),
                                 name="processor-0", daemon=True)
            t.start()
            self._threads.append(t)
            return
        self._inboxes = [_ShardInbox() for _ in range(self.thread_count)]
        for i in range(self.thread_count):
            t = threading.Thread(target=self._guarded,
                                 args=(self._run_worker, i),
                                 name=f"processor-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        self._dispatch_thread = threading.Thread(
            target=self._guarded, args=(self._run_dispatch,),
            name="processor-dispatch", daemon=True)
        self._dispatch_thread.start()

    def _guarded(self, loop, *args) -> None:
        """A runner thread that dies fails the run instead of leaving the
        groups it held unsettled."""
        try:
            loop(*args)
        except BaseException as e:
            log.error("%s died", threading.current_thread().name,
                      exc_info=e)
            with self._count_lock:
                if self.error is None:
                    self.error = e
            raise

    def stop(self) -> None:
        """Stop popping, drain what the queues, inboxes and lanes hold, and
        join the threads."""
        self._running = False
        self.pqm.wake_up()
        if self._dispatch_thread is not None:
            self._dispatch_thread.join(timeout=10)
            if self._dispatch_thread.is_alive():
                # a wedged dispatch must not wedge stop(): close the
                # inboxes so the workers can finish what they hold
                for ib in self._inboxes:
                    ib.close()
            self._dispatch_thread = None
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()

    def alive_threads(self) -> int:
        n = sum(t.is_alive() for t in self._threads)
        return n + (self._dispatch_thread is not None
                    and self._dispatch_thread.is_alive())

    def failed(self) -> bool:
        return self.error is not None

    def groups_settled(self) -> int:
        """Groups sent, dropped or failed since ``init``."""
        with self._count_lock:
            return self._settled

    def _note_settled(self, n: int) -> None:
        with self._count_lock:
            self._settled += n

    def lane_overlap(self) -> List[float]:
        return [lane.overlap_ratio() for lane in self._lanes]

    def _note_failure(self, what: str, pipeline, groups,
                      exc: BaseException) -> None:
        log.error("pipeline %s %s failed", pipeline.name, what,
                  exc_info=exc)
        if ledger.is_on():
            ledger.record(pipeline.name, ledger.B_DROP,
                          sum(len(g) for g in groups),
                          sum(g.data_size() for g in groups),
                          tag=f"{what}_error")
        with self._count_lock:
            self.groups_failed += len(groups)
            self._settled += len(groups)
            if self.error is None:
                self.error = exc

    # -- shard routing ------------------------------------------------------

    def _shard(self, key: int, group: PipelineEventGroup) -> int:
        return shard_of(key, group_source_id(group), self.thread_count)

    def _pump_timeout_flush(self) -> None:
        """Once a second (reference ``processor_runner.py:450-470``): the
        ``TimeoutFlushManager``'s hooks run (an aggregator closes what its
        watermark or idle timer allows), then the width auto-tuner re-reads
        the plane's utilisation and moves the lanes' flush deadline.  A
        hook's failure is the runner's, as any processing failure."""
        now = time.monotonic()
        with self._adjust_claim:
            claimed = now - self._last_adjust >= TUNER_ADJUST_INTERVAL_S
            if claimed:
                self._last_adjust = now
        if claimed:
            TimeoutFlushManager.instance().flush_timeout_batches()
            auto_tuner().maybe_adjust()

    def _run_dispatch(self) -> None:
        """Sharded mode: pop runs from the queue manager and route each
        group to its affinity shard; on stop, drain the queues into the
        inboxes and close them."""
        while self._running:
            self._pump_timeout_flush()
            run = self.pqm.pop_run(timeout=0.2,
                                   max_groups=self.run_max_groups)
            if run is not None:
                self._handle_routed_run(run)
        while True:
            run = self.pqm.pop_run(timeout=0,
                                   max_groups=self.run_max_groups)
            if run is None:
                break
            self._handle_routed_run(run)
        for ib in self._inboxes:
            ib.close()

    def _handle_routed_run(self,
                           run: Tuple[int, List[PipelineEventGroup]]) -> None:
        key, groups = run
        for group in groups:
            self._route((key, group))

    def _route(self, item: Tuple[int, PipelineEventGroup]) -> None:
        key, group = item
        inbox = self._inboxes[self._shard(key, group)]
        # a full inbox blocks here: the back-pressure hop
        while not inbox.put(item, timeout=1.0):
            if inbox.is_closed():
                # forced shutdown: process inline rather than drop
                self._process_one(key, group)
                return
            self._pump_timeout_flush()

    # -- workers ------------------------------------------------------------

    def _worker_context(self, lane: WorkerLane, device=None):
        """Bind this worker's relief hook and, on CUDA, its stream pair on
        ``device`` (default the runner's); the worker runs under its
        compute stream."""
        set_budget_relief(self._make_relief(lane))
        device = device if device is not None else self.device
        if device is None or device.type != "cuda":
            return contextlib.nullcontext()
        streams = bind_thread_streams(device)
        return torch.cuda.stream(streams.compute)

    def _chip_lane_for(self, worker_id: int):
        """This worker's home chip lane (source → worker by the affinity
        hash, worker → lane by ``worker_id % n_lanes``), or None when lane
        routing is inactive or the lanes' devices are not the runner's
        kind.  Raises when the router does."""
        lane = chip_lanes.router().lane_for_worker(worker_id)
        if lane is not None and self.device is not None \
                and lane.device.type != self.device.type:
            return None
        return lane

    def chip_lane_map(self) -> List[Optional[int]]:
        """Worker index -> bound lane index (None: unbound)."""
        out: List[Optional[int]] = []
        for i in range(self.thread_count if self.thread_count > 1 else 0):
            lane = self._chip_lane_for(i)
            out.append(lane.index if lane is not None else None)
        return out

    def _make_relief(self, lane: WorkerLane):
        """Budget-relief hook bound to one lane: complete the oldest group
        it holds so the bytes it owns are released."""
        def _relieve() -> bool:
            p = lane.take()
            if p is None:
                return False
            self._complete(p)
            return True
        return _relieve

    def _advance_ring(self, lane: WorkerLane) -> None:
        """Complete the oldest group when the lane is at capacity, or when
        it outlived the tuner's flush deadline."""
        while lane.full():
            self._complete_oldest(lane)
        age = lane.oldest_age()
        if age is not None and age > auto_tuner().flush_deadline_s():
            self._complete_oldest(lane)

    def _run_single(self, worker_id: int) -> None:
        """One worker popping the queue manager directly."""
        lane = self._lanes[worker_id]
        had_item = False
        try:
            with self._worker_context(lane):
                while self._running:
                    self._pump_timeout_flush()
                    # with device work in flight, poll: an empty queue
                    # closes the overlap window and the lane completes
                    run = self.pqm.pop_run(
                        timeout=0.0 if lane.busy() else 0.2,
                        max_groups=self.run_max_groups)
                    if run is None:
                        had_item = False
                        self._complete_oldest(lane)
                        continue
                    if had_item or len(run[1]) > 1:
                        note_host_backlog()
                    had_item = True
                    self._handle_run(run[0], run[1], lane)
                self._complete_lane(lane)
                while True:
                    run = self.pqm.pop_run(timeout=0,
                                           max_groups=self.run_max_groups)
                    if run is None:
                        break
                    self._handle_run(run[0], run[1], None)
        finally:
            set_budget_relief(None)

    def _run_worker(self, worker_id: int) -> None:
        """Sharded mode: consume this worker's inbox with the same lane
        discipline as the single-worker loop."""
        lane = self._lanes[worker_id]
        inbox = self._inboxes[worker_id]
        chip = self._chip_lane_for(worker_id)
        chip_lanes.set_thread_lane(chip)
        try:
            with self._worker_context(
                    lane, chip.device if chip is not None else None):
                while True:
                    run = inbox.get_run(
                        timeout=0.0 if lane.busy() else 0.2,
                        max_groups=self.run_max_groups)
                    if run is None:
                        self._complete_oldest(lane)
                        if inbox.drained():
                            break
                        continue
                    if len(inbox):
                        note_host_backlog()
                    self._handle_run(run[0], run[1], lane)
                self._complete_lane(lane)
        finally:
            chip_lanes.set_thread_lane(None)
            set_budget_relief(None)

    def _handle_run(self, key: int, groups: List[PipelineEventGroup],
                    lane: Optional[WorkerLane]) -> None:
        """One popped run, group by group: dispatch, advance the lane, put
        the new group in the lane.  Dispatch is per group so that a group's
        budget wait can always be relieved by its lane."""
        for group in groups:
            if lane is None:
                self._process_one(key, group)
                continue
            nxt = self._dispatch_one(key, group, lane=lane)
            # dispatch before advance is the overlap: the device holds
            # group N+1 while the oldest lane entry completes
            self._advance_ring(lane)
            lane.put(nxt)

    def _dispatch_one(self, key: int, group: PipelineEventGroup,
                      lane: Optional[WorkerLane] = None):
        """Host stages and device dispatch of one group.  Returns a pending
        entry when device work stays in flight, else None (the group was
        processed and sent, after the lane, so send order is pop order)."""
        pipeline = self.pipeline_manager.find_pipeline_by_queue_key(key)
        if pipeline is None:
            log.warning("no pipeline for queue key %d; dropping group", key)
            self._note_settled(1)
            return None
        groups = [group]
        prev_tenant = current_tenant()
        set_thread_tenant(pipeline.name or None)
        try:
            try:
                finish = pipeline.process_begin(groups)
            except Exception as e:  # noqa: BLE001 — recorded, run fails
                self._note_failure("processing", pipeline, groups, e)
                return None
            if finish is None:
                if lane is not None:
                    self._complete_lane(lane)
                self._send(pipeline, groups)
                return None
        finally:
            set_thread_tenant(prev_tenant)
        if ledger.is_on():
            ledger.record(pipeline.name, ledger.B_DEVICE_SUBMIT,
                          sum(len(g) for g in groups))
        return pipeline, groups, finish

    def _complete_oldest(self, lane: WorkerLane) -> None:
        p = lane.take()
        if p is not None:
            self._complete(p)

    def _complete_lane(self, lane: WorkerLane) -> None:
        """Drain the whole lane in FIFO order (before an inline send, and
        on worker exit)."""
        while True:
            p = lane.take()
            if p is None:
                return
            self._complete(p)

    def _complete(self, pending) -> None:
        pipeline, groups, finish = pending
        # completion may run from the relief hook inside another
        # pipeline's submit wait: restore the tenant rather than clear it
        prev_tenant = current_tenant()
        set_thread_tenant(pipeline.name or None)
        try:
            try:
                finish()
            except Exception as e:  # noqa: BLE001 — recorded, run fails
                self._note_failure("processing", pipeline, groups, e)
                return
            if ledger.is_on():
                ledger.record(pipeline.name, ledger.B_DEVICE_MATERIALIZE,
                              sum(len(g) for g in groups))
            self._send(pipeline, groups)
        finally:
            set_thread_tenant(prev_tenant)

    def _send(self, pipeline, groups) -> None:
        try:
            pipeline.send(groups)
        except Exception as e:  # noqa: BLE001 — recorded, run fails
            self._note_failure("send", pipeline, groups, e)
            return
        self._note_settled(len(groups))

    def _process_one(self, key: int, group: PipelineEventGroup) -> None:
        pending = self._dispatch_one(key, group)
        if pending is not None:
            self._complete(pending)
