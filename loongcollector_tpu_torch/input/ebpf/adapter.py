"""eBPF driver adapter boundary.

Reference: loongcollector_tpu/input/ebpf/adapter.py, after
core/ebpf/EBPFAdapter.cpp:149-231 — the server dlopens the eBPF driver
library (BPF program loading, perf-buffer polling) and receives raw events
through registered callbacks; plugin managers consume them.

This framework keeps the same boundary: `EBPFAdapter` is the abstract driver
interface; `MockAdapter` replays synthetic/recorded raw events (the only
driver usable in unprivileged containers — kernel BPF needs CAP_BPF and a
compiled driver, loaded here the same way via `SoAdapter` when present).

The port loads the same driver library as the reference, through the same
ctypes mirrors of ``native/ebpf_driver_abi.h``.  Its ``SoAdapter`` also
counts the callbacks it delivered (``delivered``) and those whose handler
raised (``callback_errors``): the handler's exception still never unwinds
into the driver, as in the reference, but it no longer goes unseen.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ...utils.logger import get_logger

log = get_logger("ebpf")


class EventSource(enum.Enum):
    NETWORK_OBSERVE = "network_observe"
    PROCESS_SECURITY = "process_security"
    FILE_SECURITY = "file_security"
    NETWORK_SECURITY = "network_security"
    CPU_PROFILING = "cpu_profiling"


@dataclass
class RawKernelEvent:
    """A raw event from the driver (what the perf buffer would deliver)."""

    source: EventSource
    pid: int = 0
    timestamp_ns: int = 0
    ppid: int = -1             # parent pid (-1 unknown)
    ktime: int = 0             # process start ktime: (pid, ktime) is the
                               # stable process identity across pid reuse
    # network events
    fd: int = -1
    local_addr: str = ""
    remote_addr: str = ""
    direction: str = ""        # ingress / egress
    payload: bytes = b""       # captured L7 bytes
    # security events
    call_name: str = ""        # e.g. security_file_permission, sys_execve
    path: str = ""
    flags: int = 0
    # profiling
    stack: List[str] = field(default_factory=list)


Callback = Callable[[RawKernelEvent], None]


class EBPFAdapter:
    """Driver interface (reference EBPFAdapter): start/stop per source,
    callbacks deliver raw events on the poll thread."""

    def start_plugin(self, source: EventSource, callback: Callback) -> bool:
        raise NotImplementedError

    def stop_plugin(self, source: EventSource) -> bool:
        raise NotImplementedError

    def suspend_plugin(self, source: EventSource) -> bool:
        return True

    def resume_plugin(self, source: EventSource) -> bool:
        return True


class MockAdapter(EBPFAdapter):
    """Replay adapter: feed() injects events; optionally a generator thread
    produces a synthetic stream (used by tests and the bench harness)."""

    def __init__(self) -> None:
        self._callbacks: Dict[EventSource, Callback] = {}
        self._lock = threading.Lock()

    def start_plugin(self, source: EventSource, callback: Callback) -> bool:
        with self._lock:
            self._callbacks[source] = callback
        return True

    def stop_plugin(self, source: EventSource) -> bool:
        with self._lock:
            self._callbacks.pop(source, None)
        return True

    def feed(self, event: RawKernelEvent) -> bool:
        with self._lock:
            cb = self._callbacks.get(event.source)
        if cb is None:
            return False
        cb(event)
        return True


# --------------------------------------------------------------------------
# dlopen'd driver ABI (native/ebpf_driver_abi.h)
#
# Reference: core/ebpf/EBPFAdapter.cpp:149-231 — the agent dlopens the
# driver library and talks through a versioned vtable.  SoAdapter is that
# boundary: ctypes mirrors of the C structs (layout pinned against the
# header by tests/test_torch_ebpf_abi.py), version/size handshake at load,
# callbacks
# delivered from the driver's poll thread.  The in-tree simulation driver
# (native/libloong_ebpf_sim.so) implements the same table a real kernel
# driver would.

import ctypes
import os

ABI_VERSION = 2
CALLNAME_MAX = 32
PATH_MAX = 128
ADDR_MAX = 64
PAYLOAD_MAX = 4096
STACK_DEPTH = 32
FRAME_MAX = 96

_SOURCE_TO_U32 = {
    EventSource.NETWORK_OBSERVE: 0,
    EventSource.PROCESS_SECURITY: 1,
    EventSource.FILE_SECURITY: 2,
    EventSource.NETWORK_SECURITY: 3,
    EventSource.CPU_PROFILING: 4,
}
_U32_TO_SOURCE = {v: k for k, v in _SOURCE_TO_U32.items()}
_DIRECTION = {0: "", 1: "ingress", 2: "egress"}
_DIRECTION_TO_U16 = {"": 0, "ingress": 1, "egress": 2}


class CEvent(ctypes.Structure):
    _fields_ = [
        ("timestamp_ns", ctypes.c_uint64),
        ("source", ctypes.c_uint32),
        ("pid", ctypes.c_int32),
        ("fd", ctypes.c_int32),
        ("flags", ctypes.c_uint32),
        ("direction", ctypes.c_uint16),
        ("stack_depth", ctypes.c_uint16),
        ("payload_len", ctypes.c_uint32),
        ("ppid", ctypes.c_int32),
        ("reserved0", ctypes.c_uint32),
        ("ktime", ctypes.c_uint64),
        ("call_name", ctypes.c_char * CALLNAME_MAX),
        ("path", ctypes.c_char * PATH_MAX),
        ("local_addr", ctypes.c_char * ADDR_MAX),
        ("remote_addr", ctypes.c_char * ADDR_MAX),
        ("payload", ctypes.c_uint8 * PAYLOAD_MAX),
        ("stack", (ctypes.c_char * FRAME_MAX) * STACK_DEPTH),
    ]


_CB = ctypes.CFUNCTYPE(None, ctypes.POINTER(CEvent), ctypes.c_void_p)


class CDriver(ctypes.Structure):
    _fields_ = [
        ("abi_version", ctypes.c_uint32),
        ("event_size", ctypes.c_uint32),
        ("start", ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_uint32, _CB,
                                   ctypes.c_void_p)),
        ("stop", ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_uint32)),
        ("suspend", ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_uint32)),
        ("resume", ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_uint32)),
        ("inject", ctypes.CFUNCTYPE(ctypes.c_int,
                                    ctypes.POINTER(CEvent))),
    ]


def default_driver_path() -> str:
    env = os.environ.get("LOONG_EBPF_DRIVER")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))), "native",
        "libloong_ebpf_sim.so")


def _event_to_c(ev: RawKernelEvent) -> CEvent:
    c = CEvent()
    c.timestamp_ns = ev.timestamp_ns
    c.source = _SOURCE_TO_U32[ev.source]
    c.pid = ev.pid
    c.fd = ev.fd
    c.flags = ev.flags
    c.ppid = ev.ppid
    c.ktime = ev.ktime
    c.direction = _DIRECTION_TO_U16.get(ev.direction, 0)
    c.call_name = ev.call_name.encode()[:CALLNAME_MAX - 1]
    c.path = ev.path.encode()[:PATH_MAX - 1]
    c.local_addr = ev.local_addr.encode()[:ADDR_MAX - 1]
    c.remote_addr = ev.remote_addr.encode()[:ADDR_MAX - 1]
    payload = ev.payload[:PAYLOAD_MAX]
    c.payload_len = len(payload)
    ctypes.memmove(c.payload, payload, len(payload))
    frames = ev.stack[:STACK_DEPTH]
    c.stack_depth = len(frames)
    for i, fr in enumerate(frames):
        c.stack[i].value = fr.encode()[:FRAME_MAX - 1]
    return c


def _event_from_c(c: CEvent) -> RawKernelEvent:
    # one C memcpy — slicing the c_uint8 array would materialize a PyLong
    # per byte on the delivery hot path
    payload = ctypes.string_at(c.payload, c.payload_len)
    stack = [c.stack[i].value.decode("utf-8", "replace")
             for i in range(c.stack_depth)]
    return RawKernelEvent(
        source=_U32_TO_SOURCE.get(c.source, EventSource.NETWORK_OBSERVE),
        pid=c.pid, timestamp_ns=c.timestamp_ns, fd=c.fd,
        ppid=c.ppid, ktime=c.ktime,
        local_addr=c.local_addr.decode("utf-8", "replace"),
        remote_addr=c.remote_addr.decode("utf-8", "replace"),
        direction=_DIRECTION.get(c.direction, ""),
        payload=payload,
        call_name=c.call_name.decode("utf-8", "replace"),
        path=c.path.decode("utf-8", "replace"),
        flags=c.flags, stack=stack)


class AbiMismatch(RuntimeError):
    pass


class SoAdapter(EBPFAdapter):
    """dlopen a driver library implementing the loong_ebpf_driver ABI.

    Performs the version/size handshake at load; keeps the ctypes callback
    objects alive for as long as their source is started (the driver holds
    raw function pointers)."""

    def __init__(self, so_path: Optional[str] = None):
        path = so_path or default_driver_path()
        self._lib = ctypes.CDLL(path)
        self._lib.loong_ebpf_driver_get.restype = ctypes.POINTER(CDriver)
        drv = self._lib.loong_ebpf_driver_get()
        if not drv:
            raise AbiMismatch(f"{path}: loong_ebpf_driver_get returned NULL")
        self._drv = drv.contents
        if self._drv.abi_version != ABI_VERSION:
            raise AbiMismatch(
                f"{path}: driver ABI v{self._drv.abi_version}, "
                f"collector speaks v{ABI_VERSION}")
        if self._drv.event_size != ctypes.sizeof(CEvent):
            raise AbiMismatch(
                f"{path}: event struct {self._drv.event_size} B, "
                f"collector expects {ctypes.sizeof(CEvent)} B")
        self.path = path
        self._cbs: Dict[EventSource, object] = {}   # active holders
        # trampolines are NEVER freed: the driver's poll thread may be
        # mid-invocation when stop() returns (stop only deregisters under
        # the driver lock; an already-copied cb pointer can still run).
        # Freeing the ctypes thunk there is a native use-after-free.
        # Start/stop cycles are rare (pipeline reloads), so the retired
        # list stays tiny over an agent's lifetime.
        self._retired_cbs: List[object] = []
        self._lock = threading.Lock()
        self.delivered = 0
        self.callback_errors = 0

    def _note_callback(self, ok: bool) -> None:
        """Count one delivered callback (the driver's poll thread)."""
        with self._lock:
            if ok:
                self.delivered += 1
                return
            self.callback_errors += 1
            first = self.callback_errors == 1
        if first:
            log.exception("ebpf callback raised (later ones are counted "
                          "in callback_errors only)")

    def start_plugin(self, source: EventSource, callback: Callback) -> bool:
        def c_cb(ev_ptr, _user):
            try:
                callback(_event_from_c(ev_ptr.contents))
            except Exception:  # noqa: BLE001 — never unwind into C
                self._note_callback(False)
                return
            self._note_callback(True)

        holder = _CB(c_cb)
        rc = self._drv.start(_SOURCE_TO_U32[source], holder, None)
        if rc == -2:   # ESTATE: already running (e.g. pipeline reload that
            # skipped stop) — rebind like MockAdapter by stop+start
            self._drv.stop(_SOURCE_TO_U32[source])
            with self._lock:
                old = self._cbs.pop(source, None)
                if old is not None:
                    self._retired_cbs.append(old)
            rc = self._drv.start(_SOURCE_TO_U32[source], holder, None)
        if rc != 0:
            return False
        with self._lock:
            self._cbs[source] = holder
        return True

    def stop_plugin(self, source: EventSource) -> bool:
        rc = self._drv.stop(_SOURCE_TO_U32[source])
        with self._lock:
            holder = self._cbs.pop(source, None)
            if holder is not None:
                self._retired_cbs.append(holder)
        return rc == 0

    def suspend_plugin(self, source: EventSource) -> bool:
        return self._drv.suspend(_SOURCE_TO_U32[source]) == 0

    def resume_plugin(self, source: EventSource) -> bool:
        return self._drv.resume(_SOURCE_TO_U32[source]) == 0

    def feed(self, event: RawKernelEvent) -> bool:
        """Inject through the driver's ABI hook (simulation drivers only)."""
        c = _event_to_c(event)
        return self._drv.inject(ctypes.byref(c)) == 0


def try_load_so_adapter() -> Optional["SoAdapter"]:
    path = default_driver_path()
    if not os.path.exists(path):
        return None
    try:
        return SoAdapter(path)
    except (OSError, AbiMismatch):
        return None


_default_adapter: Optional[EBPFAdapter] = None
_adapter_lock = threading.Lock()


def get_adapter() -> EBPFAdapter:
    """Process-wide adapter.  Prefers the dlopen'd driver (real or
    simulation .so) — the same code path a kernel driver would use; falls
    back to the in-process mock when no library is present."""
    global _default_adapter
    with _adapter_lock:
        if _default_adapter is None:
            _default_adapter = try_load_so_adapter() or MockAdapter()
        return _default_adapter


def set_adapter(adapter: EBPFAdapter) -> None:
    global _default_adapter
    with _adapter_lock:
        _default_adapter = adapter
