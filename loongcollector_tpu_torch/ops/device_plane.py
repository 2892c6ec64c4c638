"""The async host↔device data plane: dispatch under an in-flight byte budget.

Reference: loongcollector_tpu/ops/device_plane.py.  A kernel dispatch
returns at once while the device works; the host packs and dispatches
chunk N+1 while the device executes chunk N, and waits only where it
consumes a result (``DeviceFuture.result()``).

Back-pressure: every dispatch acquires from a process-wide in-flight byte
budget (``LOONG_DEVICE_INFLIGHT_BYTES``, 64 MiB by default) and releases it
when its result is consumed.  When the device stalls the budget fills,
``submit`` blocks, the runner worker stops popping, the bounded process
queues reach their high watermark and the file inputs wait: the chain of
the reference's runners and queues, one hop further onto the device.

What a dispatch returns: a tuple of outputs, each a host array or tensor
that is ready, or a handle with ``block_until_ready()`` and ``__array__``
(``HostOutput`` for a CUDA dispatch, ``LatencyInjectedArray`` for the test
kernels).  A CUDA dispatch (``device_stream.StagedKernel``) copies its
outputs into pinned host memory on its own stream and records a CUDA event
after the copy; ``result()`` waits on that event and reads the pinned
buffers.  Nothing between submit and result synchronises with the device.

Per-thread state: the worker's budget-relief hook, its tenant (the
pipeline whose share a dispatch counts against) and its pair of CUDA
streams (``ThreadStreams``: one for H2D copies, one for the kernel and the
D2H of its outputs).  PyTorch's current stream is per thread, so workers
do not serialise behind one stream.

Left out of the port: the chaos fault point, the tracer span and the
metrics instruments of the reference's ``submit``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import xprof
from ..utils.logger import get_logger

log = get_logger("device_plane")

_DEFAULT_BUDGET = 64 * 1024 * 1024  # bytes of packed rows in flight

_tls = threading.local()

# ---------------------------------------------------------------------------
# per-tenant (per-pipeline) shares of the in-flight byte budget: with N
# registered tenants each gets budget/N, and a tenant dispatching past its
# share drains its own oldest in-flight chunk first (the caller's on_wait
# hook).  Other tenants only ever wait on the global budget.

_tenant_lock = threading.Lock()
_tenant_registered: set = set()            # tenant names holding a share
_tenant_inflight: Dict[str, int] = {}      # name -> dispatched bytes in flight


def set_thread_tenant(name: Optional[str]) -> None:
    """Bind this thread's dispatches to a tenant (None unbinds)."""
    _tls.tenant = name


def current_tenant() -> Optional[str]:
    return getattr(_tls, "tenant", None)


def register_tenant(name: str) -> None:
    """Grant ``name`` a share of the plane budget (pipeline manager)."""
    if not name:
        return
    with _tenant_lock:
        _tenant_registered.add(name)


def unregister_tenant(name: str) -> None:
    """Drop ``name``'s share; in-flight accounting of futures not yet
    settled survives until they settle."""
    with _tenant_lock:
        _tenant_registered.discard(name)
        if not _tenant_inflight.get(name):
            _tenant_inflight.pop(name, None)


def _tenant_note(name: str, delta: int) -> None:
    with _tenant_lock:
        cur = max(0, _tenant_inflight.get(name, 0) + delta)
        if cur == 0 and name not in _tenant_registered:
            _tenant_inflight.pop(name, None)
        else:
            _tenant_inflight[name] = cur


def tenant_share_bytes(budget_bytes: int) -> int:
    """One tenant's slice of the budget (0: fewer than two tenants, or an
    unbounded plane)."""
    with _tenant_lock:
        n = len(_tenant_registered)
    if n <= 1 or not budget_bytes:
        return 0
    return budget_bytes // n


def tenant_over_share(name: str, nbytes: int, budget_bytes: int) -> bool:
    """True when dispatching ``nbytes`` more would push ``name`` past its
    share.  Never true with fewer than two tenants."""
    share = tenant_share_bytes(budget_bytes)
    if not share:
        return False
    with _tenant_lock:
        held = _tenant_inflight.get(name, 0)
    return held > 0 and held + nbytes > share


def reset_tenants_for_testing() -> None:
    with _tenant_lock:
        _tenant_registered.clear()
        _tenant_inflight.clear()

# ---------------------------------------------------------------------------
# device-memory ledger: live/peak bytes per allocation family.  At quiesce
# ``ring_slots`` live bytes are 0 once every leased slot has returned.

_mem_lock = threading.Lock()
_mem: Dict[str, List[int]] = {}   # family -> [live, peak, allocs, frees]


def mem_note_alloc(family: str, nbytes: int) -> None:
    if nbytes <= 0:
        return
    with _mem_lock:
        row = _mem.setdefault(family, [0, 0, 0, 0])
        row[0] += nbytes
        row[1] = max(row[1], row[0])
        row[2] += 1


def mem_note_free(family: str, nbytes: int) -> None:
    """Live bytes clamp at zero: a double free is an accounting bug
    upstream, never a negative gauge."""
    if nbytes <= 0:
        return
    with _mem_lock:
        row = _mem.setdefault(family, [0, 0, 0, 0])
        row[0] = max(0, row[0] - nbytes)
        row[3] += 1


def mem_live_bytes(family: str) -> int:
    with _mem_lock:
        row = _mem.get(family)
        return row[0] if row is not None else 0


def device_memory_status() -> dict:
    with _mem_lock:
        fams = {f: {"live_bytes": row[0], "peak_bytes": row[1],
                    "allocs": row[2], "frees": row[3]}
                for f, row in sorted(_mem.items())}
        total_live = sum(row[0] for row in _mem.values())
    return {"families": fams, "total_live_bytes": total_live}


def note_host_backlog() -> None:
    """Runner loops call this when they popped work with more queued: a
    device-idle gap while the host has backlog is charged to
    ``idle_while_backlogged_ms``."""
    plane = DevicePlane._instance
    if plane is not None:
        plane.note_backlogged()


def set_budget_relief(fn: Optional[Callable[[], bool]]) -> None:
    """Register this thread's last-resort budget releaser.  While a thread
    waits for budget in ``submit``, the plane first lets the dispatching
    PendingParse drain its own chunks (``on_wait``); if that owns nothing,
    the relief hook runs (the ProcessorRunner's completes the oldest group
    of the worker's lane).  A thread waiting for budget never holds
    futures it cannot release itself, so the budget cannot deadlock."""
    _tls.relief = fn


# ---------------------------------------------------------------------------
# per-thread CUDA streams


class ThreadStreams:
    """One thread's pair of CUDA streams on one device: ``h2d`` for the
    copies of inputs to the device, ``compute`` for the kernel and the D2H
    copies of its outputs.  Chained by events, the H2D of chunk N+1 can run
    under chunk N's kernel."""

    __slots__ = ("device", "h2d", "compute")

    def __init__(self, device: torch.device):
        self.device = device
        self.h2d = torch.cuda.Stream(device)
        self.compute = torch.cuda.Stream(device)


def bind_thread_streams(device: torch.device) -> ThreadStreams:
    """Give this thread its own stream pair on ``device`` (the processor
    runner binds one per worker when it starts)."""
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    streams = ThreadStreams(device)
    pairs = getattr(_tls, "streams", None)
    if pairs is None:
        pairs = _tls.streams = {}
    pairs[device] = streams
    return streams


def thread_streams(device: torch.device) -> ThreadStreams:
    """This thread's stream pair on ``device``, bound at first use."""
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    streams = getattr(_tls, "streams", {}).get(device)
    return streams if streams is not None else bind_thread_streams(device)


def _budget_from_env() -> int:
    try:
        return int(os.environ.get("LOONG_DEVICE_INFLIGHT_BYTES",
                                  _DEFAULT_BUDGET))
    except ValueError:
        return _DEFAULT_BUDGET


def to_host_array(o) -> np.ndarray:
    """One dispatch output as a host numpy array.  A tensor must already
    lie in host memory: a device tensor here would be a hidden copy and
    synchronisation, so it raises."""
    if isinstance(o, torch.Tensor):
        if o.device.type != "cpu":
            raise ValueError(f"dispatch output on {o.device}: a dispatch "
                             f"returns host buffers or HostOutput handles")
        return o.numpy()
    return np.asarray(o)


class HostOutput:
    """One output of a CUDA dispatch: a pinned host tensor that the
    dispatch's D2H copy fills, ready once ``done`` (the CUDA event recorded
    after the copy) has completed.  The array it gives is a view of that
    buffer, valid until the ring slot that owns it is released."""

    __slots__ = ("tensor", "done")

    def __init__(self, tensor: torch.Tensor, done):
        self.tensor = tensor
        self.done = done

    def block_until_ready(self) -> "HostOutput":
        self.done.synchronize()
        return self

    def __array__(self, dtype=None, copy=None):
        self.block_until_ready()
        a = self.tensor.numpy()
        return a if dtype is None else a.astype(dtype)


# dispatch → resolve stopwatch sink: one shared histogram (lazy, so importing
# the plane never touches the metrics registry)
_rtt_hist = None


def roundtrip_histogram():
    """The device round-trip histogram (``device_roundtrip_seconds``,
    dispatch to materialise), observed by every DeviceFuture that
    resolves successfully — the SLO budget breakdown's ``device`` hop."""
    global _rtt_hist
    if _rtt_hist is None:
        from ..monitor.metrics import shared_histogram
        _rtt_hist = shared_histogram("device_roundtrip_seconds",
                                     labels={"component": "device_plane"})
    return _rtt_hist


class DeviceFuture:
    """A dispatched kernel call whose results are not yet consumed.

    ``result()`` waits for the dispatch (the final CUDA event of a CUDA
    dispatch), reads its host outputs as numpy, and releases the plane
    budget exactly once; a successful ``result()`` observes the round trip
    since the dispatch returned (``roundtrip_histogram``, JAX package
    ``device_plane.py:234-245``, ``:401``).  A kernel that raised at
    dispatch surfaces its error here: fail at consume."""

    __slots__ = ("_plane", "_nbytes", "_outputs", "_error", "_done",
                 "_materialised", "_tenant", "_xid", "_t0", "__weakref__")

    def __init__(self, plane: "DevicePlane", nbytes: int,
                 outputs: Optional[Sequence] = None,
                 error: Optional[BaseException] = None,
                 tenant: Optional[str] = None, xid: int = 0):
        self._plane = plane
        self._nbytes = nbytes
        self._outputs = outputs
        self._error = error
        self._done = False
        self._materialised: Optional[List[np.ndarray]] = None
        self._tenant = tenant
        self._xid = xid
        self._t0 = time.perf_counter()

    @property
    def dispatch_id(self) -> int:
        """The timeline's id of this dispatch (0 while it is off)."""
        return self._xid

    def _release_budget(self) -> None:
        self._plane._release(self._nbytes)
        if self._tenant is not None:
            _tenant_note(self._tenant, -self._nbytes)
            self._tenant = None
        # settle point: the dispatch's legs are read once, here
        xprof.close_dispatch(self._xid)

    def result(self) -> List[np.ndarray]:
        if self._done:
            if self._error is not None:
                raise self._error
            return self._materialised  # type: ignore[return-value]
        try:
            if self._error is not None:
                raise self._error
            outputs = self._outputs
            if outputs and hasattr(outputs[0], "block_until_ready"):
                outputs[0].block_until_ready()
            self._materialised = [to_host_array(o) for o in outputs]
            roundtrip_histogram().observe(time.perf_counter() - self._t0)
            return self._materialised
        except BaseException as e:  # noqa: BLE001 — record, release, re-raise
            self._error = e
            raise
        finally:
            self._done = True
            self._outputs = None
            self._release_budget()

    def release(self) -> None:
        """Force-release without consuming: error-path cleanup for a
        dispatch loop that cannot consume this future.  The budget returns
        at once; a later ``result()`` raises."""
        if self._done:
            return
        self._done = True
        self._outputs = None
        if self._error is None:
            self._error = RuntimeError(
                "DeviceFuture released without materialisation")
        self._release_budget()

    def __del__(self):
        # backstop: an abandoned in-flight future must never strand plane
        # budget.  Reaching this is a bug upstream — warn loudly.
        try:
            if not self._done:
                self._done = True
                self._outputs = None
                self._release_budget()
                log.warning(
                    "DeviceFuture dropped without result()/release(); "
                    "budget (%d bytes) reclaimed by finaliser — fix the "
                    "owning dispatch path", self._nbytes)
        except Exception:  # noqa: BLE001 — never raise from a finaliser
            pass


class DevicePlane:
    """Process-wide async dispatch gate with an in-flight byte budget."""

    _instance: Optional["DevicePlane"] = None
    _instance_lock = threading.Lock()

    def __init__(self, budget_bytes: Optional[int] = None):
        self.budget_bytes = budget_bytes or _budget_from_env()
        self._inflight = 0
        self._dispatched = 0
        self._peak_inflight = 0
        self._budget_waits = 0
        self._lock = threading.Lock()
        self._freed = threading.Condition(self._lock)
        # utilisation accounting (all under self._lock)
        now = time.perf_counter()
        self._util_t0 = now
        self._util_last = now
        self._occupancy_integral = 0.0
        self._busy_s = 0.0
        self._idle_since: Optional[float] = now
        self._idle_backlogged_ms = 0.0
        self._backlog_probe_at: Optional[float] = None
        self._waiters = 0

    @classmethod
    def instance(cls) -> "DevicePlane":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset_for_testing(cls, budget_bytes: Optional[int] = None
                          ) -> "DevicePlane":
        with cls._instance_lock:
            cls._instance = cls(budget_bytes)
            return cls._instance

    # -- budget -------------------------------------------------------------

    def inflight_bytes(self) -> int:
        with self._lock:
            return self._inflight

    def would_block(self, nbytes: int) -> bool:
        """True when ``submit(nbytes)`` would wait for budget.  A dispatch
        loop holding futures must drain its own oldest first."""
        with self._lock:
            return (self._inflight + nbytes > self.budget_bytes
                    and self._inflight > 0)

    def counters(self) -> dict:
        """Dispatches, peak in-flight bytes and budget waits since the
        plane was made or ``reset_counters()`` last ran."""
        with self._lock:
            return {"dispatches": self._dispatched,
                    "peak_inflight_bytes": self._peak_inflight,
                    "budget_waits": self._budget_waits,
                    "inflight_bytes": self._inflight,
                    "budget_bytes": self.budget_bytes}

    def reset_counters(self) -> None:
        with self._lock:
            self._dispatched = 0
            self._peak_inflight = self._inflight
            self._budget_waits = 0

    # -- utilisation accounting ---------------------------------------------

    def _util_tick(self, now: float) -> None:
        """Lock held: fold the elapsed interval into the occupancy
        integrals before an in-flight transition."""
        dt = now - self._util_last
        if dt > 0:
            self._occupancy_integral += (self._inflight / self.budget_bytes
                                         if self.budget_bytes else 0.0) * dt
            if self._inflight > 0:
                self._busy_s += dt
        self._util_last = now

    def note_backlogged(self) -> None:
        """The host has queued work now: charge the device-idle gap since
        the last backlogged probe (backlog must exist at both ends of a
        charged gap; a plane that never dispatched stays at zero)."""
        now = time.perf_counter()
        with self._lock:
            if self._dispatched == 0 or self._inflight > 0 \
                    or self._idle_since is None:
                self._backlog_probe_at = None
                return
            if self._backlog_probe_at is None:
                self._backlog_probe_at = now
                return
            start = max(self._idle_since, self._backlog_probe_at)
            if now > start:
                self._idle_backlogged_ms += (now - start) * 1000.0
            self._backlog_probe_at = now

    def utilization(self) -> dict:
        now = time.perf_counter()
        with self._lock:
            self._util_tick(now)
            elapsed = max(now - self._util_t0, 1e-9)
            return {
                "budget_bytes": self.budget_bytes,
                "inflight_bytes": self._inflight,
                "held_fraction": (self._inflight / self.budget_bytes
                                  if self.budget_bytes else 0.0),
                "occupancy_avg": self._occupancy_integral / elapsed,
                "busy_fraction": self._busy_s / elapsed,
                "occupancy_integral_s": self._occupancy_integral,
                "busy_s": self._busy_s,
                "idle_while_backlogged_ms": self._idle_backlogged_ms,
                "submit_queue_depth": self._waiters,
                "dispatched_total": self._dispatched,
                "elapsed_s": elapsed,
            }

    def _acquire(self, nbytes: int,
                 should_abort: Optional[Callable[[], bool]] = None,
                 on_wait: Optional[Callable[[], bool]] = None) -> int:
        """Block until ``nbytes`` fits the budget.  A dispatch larger than
        the whole budget is admitted when nothing is in flight.  ``on_wait``
        runs outside the lock on every wait round: a caller owning futures
        drains one there and returns True (False: owns nothing); then this
        thread's relief hook; then a short wait for a release."""
        waiting = False
        try:
            while True:
                with self._freed:
                    if self._inflight + nbytes <= self.budget_bytes or \
                            self._inflight == 0:
                        self._util_tick(time.perf_counter())
                        self._inflight += nbytes
                        self._dispatched += 1
                        self._peak_inflight = max(self._peak_inflight,
                                                  self._inflight)
                        self._idle_since = None
                        return self._inflight
                    if should_abort is not None and should_abort():
                        raise DispatchAborted()
                    if not waiting:
                        waiting = True
                        self._waiters += 1
                        self._budget_waits += 1
                progressed = on_wait() if on_wait is not None else False
                if not progressed:
                    relief = getattr(_tls, "relief", None)
                    progressed = bool(relief()) if relief is not None \
                        else False
                if not progressed:
                    with self._freed:
                        self._freed.wait(timeout=0.05)
        finally:
            if waiting:
                with self._lock:
                    self._waiters -= 1

    def _release(self, nbytes: int) -> None:
        with self._freed:
            self._util_tick(time.perf_counter())
            self._inflight = max(0, self._inflight - nbytes)
            if self._inflight == 0:
                self._idle_since = self._util_last
                self._backlog_probe_at = None
            self._freed.notify_all()

    # -- dispatch -----------------------------------------------------------

    def submit(self, kernel: Callable, args: Sequence, nbytes: int,
               should_abort: Optional[Callable[[], bool]] = None,
               on_wait: Optional[Callable[[], bool]] = None
               ) -> DeviceFuture:
        """Dispatch ``kernel(*args)`` under the byte budget and return its
        future at once.  A kernel that raises at dispatch gives an errored
        future: the error surfaces at the ordered consume point."""
        tenant = getattr(_tls, "tenant", None)
        if tenant is not None and on_wait is not None:
            # a tenant past budget/n_tenants drains its own oldest chunk
            while tenant_over_share(tenant, nbytes, self.budget_bytes):
                if not on_wait():
                    break
        self._acquire(nbytes, should_abort, on_wait)
        if tenant is not None:
            _tenant_note(tenant, nbytes)
        # the dispatch id is minted after admission: the submit leg times
        # the dispatch call, not the back-pressure wait
        xid = xprof.begin_dispatch(nbytes)
        try:
            if xid:
                xprof.set_current_dispatch(xid)
                t_submit = time.perf_counter()
            try:
                outputs = kernel(*args)
            finally:
                if xid:
                    xprof.leg(xid, "submit", t_submit,
                              time.perf_counter() - t_submit)
                    xprof.set_current_dispatch(0)
            if not isinstance(outputs, (tuple, list)):
                outputs = (outputs,)
            return DeviceFuture(self, nbytes, outputs=outputs,
                                tenant=tenant, xid=xid)
        except BaseException as e:  # noqa: BLE001 — delivered via result()
            return DeviceFuture(self, nbytes, error=e, tenant=tenant,
                                xid=xid)


class DispatchAborted(RuntimeError):
    """Raised by submit() when the caller's should_abort() fired while
    waiting for budget (pipeline stopping)."""


# ---------------------------------------------------------------------------
# latency-injection kernels: CPU-testable stand-ins for a slow or stalled
# device, and wrappers around a real CUDA dispatch


class LatencyInjectedArray:
    """An output handle that becomes ready at a deadline (and once the
    wrapped output is ready, when it is a handle itself)."""

    __slots__ = ("_value", "_deadline")

    def __init__(self, value, deadline: float):
        self._value = value
        self._deadline = deadline

    def block_until_ready(self) -> "LatencyInjectedArray":
        now = time.perf_counter()
        if now < self._deadline:
            time.sleep(self._deadline - now)
        if hasattr(self._value, "block_until_ready"):
            self._value.block_until_ready()
        return self

    def __array__(self, dtype=None, copy=None):
        self.block_until_ready()
        a = to_host_array(self._value)
        return a if dtype is None else a.astype(dtype)


class LatencyInjectedKernel:
    """Wraps a kernel so that dispatch returns at once and the results
    become ready ``rtt_s`` later.  ``serialize=True`` models a device that
    executes one dispatch at a time; ``wire_s`` adds one-way wire latency
    before execution and again before the results are visible."""

    def __init__(self, inner: Callable, rtt_s: float, serialize: bool = True,
                 wire_s: float = 0.0):
        self.inner = inner
        self.rtt_s = rtt_s
        self.serialize = serialize
        self.wire_s = wire_s
        self._stream_free_at = 0.0
        self._lock = threading.Lock()
        self.calls = 0

    def __call__(self, *args):
        outs = self.inner(*args)
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        now = time.perf_counter()
        with self._lock:
            self.calls += 1
            if self.serialize:
                start = max(now + self.wire_s, self._stream_free_at)
                exec_done = start + self.rtt_s
                self._stream_free_at = exec_done
            else:
                exec_done = now + self.wire_s + self.rtt_s
            deadline = exec_done + self.wire_s
        return tuple(LatencyInjectedArray(o, deadline) for o in outs)


class StallableKernel(LatencyInjectedKernel):
    """Latency kernel whose completions can be held indefinitely."""

    def __init__(self, inner: Callable, rtt_s: float = 0.0):
        super().__init__(inner, rtt_s)
        self._stalled = threading.Event()
        self._stalled.set()  # set = running

    def stall(self) -> None:
        self._stalled.clear()

    def unstall(self) -> None:
        self._stalled.set()

    def __call__(self, *args):
        outs = super().__call__(*args)
        ev = self._stalled

        class _Gate(LatencyInjectedArray):
            __slots__ = ()

            def block_until_ready(self):
                ev.wait()
                return super().block_until_ready()

        return tuple(_Gate(o._value, o._deadline) for o in outs)
