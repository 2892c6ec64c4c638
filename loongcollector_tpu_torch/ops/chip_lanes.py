"""Chip lanes: per-device dispatch lanes with worker affinity and budget
shares.

Reference: loongcollector_tpu/ops/chip_lanes.py.  One agent process that
owns several devices has two ways to use them:

* **Full-mesh sharding** (``parallel/mesh.ShardedKernel``): one dispatch
  stream splits every batch row-wise over all devices, one K8 launch a
  shard.  What a single dispatching worker takes.
* **Chip lanes** (this module): when the processor runner has several
  workers, each worker binds to a home device — ``source → worker`` is the
  runner's CRC32 affinity hash (``runner/processor_runner.shard_of``),
  ``worker → lane`` is ``worker_id % n_lanes`` — and dispatches its
  batches as single-device launches placed on that device
  (``ops/regex/engine._LanePlacedKernel``, ``FusedProgramKernel.for_lane``).
  Distinct devices run independent streams with nothing shared on the
  batch path, and per-source order survives by construction (a stable
  source → worker → lane chain and FIFO worker lanes).  Each lane accounts
  its own in-flight bytes against its share of the ``DevicePlane`` budget,
  so one slow device's backlog drains through its own lane.

Per-lane metrics (``MetricsRecord`` category ``device_plane``, component
``chip_lane``, label ``chip``) count dispatches, real and padding rows and
the bytes in flight; the router's ``status()`` goes to the ``mesh``
section of the agent's ``--stats``.

``LOONG_MESH_LANES`` forces lane routing on (=1) or off (=0); unset it is
on when more than one device is attached.  ``LOONG_MESH_CHIPS`` caps how
many devices the router and the mesh use.  Devices are the CUDA devices;
on a machine without one the router has no lanes.  Tests and
``chip_smoke.py`` hand ``reset_for_testing`` a device list of their own,
which may repeat a device (the CPU, or ``cuda:0`` four times on one card).

Left out of the port: the lane breaker (``ChipLaneBreaker``) with its
respill of an open lane's shard to host parsing, the
``device_plane.chip_lane.<i>`` chaos points and ``lane_gated``; they come
with the chaos plane and ``runner/circuit.py``.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

import torch

from ..monitor.metrics import MetricsRecord

ENV_LANES = "LOONG_MESH_LANES"
ENV_CHIPS = "LOONG_MESH_CHIPS"


def mesh_chip_cap(env=os.environ) -> Optional[int]:
    """``LOONG_MESH_CHIPS``: how many devices the lanes and the mesh use at
    most.  None: every attached device."""
    raw = env.get(ENV_CHIPS)
    if raw:
        try:
            n = int(raw)
            if n >= 1:
                return n
        except ValueError:
            pass
    return None


def lanes_enabled(env=os.environ) -> Optional[bool]:
    """Tri-state: True forced on, False forced off, None auto (on when more
    than one device is attached)."""
    raw = env.get(ENV_LANES, "").strip()
    if raw == "1":
        return True
    if raw == "0":
        return False
    return None


class ChipLane:
    """One device's dispatch lane: the device, per-lane metrics and the
    in-flight byte accounting."""

    def __init__(self, index: int, device: torch.device):
        self.index = index
        self.device = device
        self.metrics = MetricsRecord(
            category="device_plane",
            labels={"component": "chip_lane", "chip": str(index)})
        self._dispatches = self.metrics.counter("lane_dispatches_total")
        self._rows_real = self.metrics.counter("lane_rows_real_total")
        self._rows_padded = self.metrics.counter("lane_rows_padded_total")
        self._inflight_gauge = self.metrics.gauge("lane_inflight_bytes")
        self._occupancy_gauge = self.metrics.gauge("lane_row_occupancy")
        self._lock = threading.Lock()
        self._inflight = 0

    # -- dispatch accounting -------------------------------------------------

    def note_pack(self, B: int, n_real: int) -> None:
        self._dispatches.add(1)
        self._rows_real.add(n_real)
        self._rows_padded.add(B - n_real)
        self._occupancy_gauge.set(n_real / B if B else 0.0)

    def note_dispatch(self, nbytes: int) -> None:
        with self._lock:
            self._inflight += nbytes
            self._inflight_gauge.set(float(self._inflight))

    def note_done(self, nbytes: int) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - nbytes)
            self._inflight_gauge.set(float(self._inflight))

    def inflight_bytes(self) -> int:
        with self._lock:
            return self._inflight

    # -- budget share --------------------------------------------------------

    def over_share(self, plane, lane_count: int) -> bool:
        """True when this lane holds more than its share of the plane's
        budget: the dispatcher then drains its own oldest chunk first."""
        if lane_count <= 1 or not plane.budget_bytes:
            return False
        share = plane.budget_bytes // lane_count
        with self._lock:
            return self._inflight > share

    def mark_deleted(self) -> None:
        """Retire this lane's metric record (router rebuild)."""
        self.metrics.mark_deleted()

    def status(self) -> dict:
        return {
            "chip": self.index,
            "device": str(self.device),
            "inflight_bytes": self.inflight_bytes(),
            "dispatches": self._dispatches.value,
            "rows_real": self._rows_real.value,
            "rows_padded": self._rows_padded.value,
        }


class ChipLaneRouter:
    """Process-wide lane registry: device discovery, worker → lane binding
    and the status document."""

    def __init__(self, devices: Optional[list] = None):
        if devices is None:
            devices = self._discover()
        cap = mesh_chip_cap()
        if cap is not None:
            devices = devices[:cap]
        forced = lanes_enabled()
        active = forced if forced is not None else len(devices) > 1
        self.lanes: List[ChipLane] = (
            [ChipLane(i, torch.device(d)) for i, d in enumerate(devices)]
            if active else [])

    @staticmethod
    def _discover() -> list:
        """The CUDA devices; none on a machine without CUDA."""
        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]

    def lane_count(self) -> int:
        return len(self.lanes)

    def lane_for_worker(self, worker_id: int) -> Optional[ChipLane]:
        """A processor worker's home lane (``worker_id % n_lanes``); None
        when lane routing is inactive (one lane or none)."""
        if len(self.lanes) <= 1:
            return None
        return self.lanes[worker_id % len(self.lanes)]

    def lane_for_source(self, queue_key: int, source: Optional[bytes],
                        n_workers: int) -> Optional[ChipLane]:
        """source → worker → lane: the whole affinity chain, by the same
        CRC32 hash as the runner's worker routing."""
        from ..runner.processor_runner import shard_of
        return self.lane_for_worker(shard_of(queue_key, source, n_workers))

    def status(self) -> dict:
        return {
            "lane_count": self.lane_count(),
            "lanes": [lane.status() for lane in self.lanes],
        }


_router: Optional[ChipLaneRouter] = None
_router_lock = threading.Lock()
_tls = threading.local()


def router() -> ChipLaneRouter:
    global _router
    if _router is None:
        with _router_lock:
            if _router is None:
                _router = ChipLaneRouter()
    return _router


def active_router() -> Optional[ChipLaneRouter]:
    """The router if one was built (never builds one)."""
    return _router


def reset_for_testing(devices: Optional[list] = None) -> ChipLaneRouter:
    """Rebuild the router over ``devices`` (default: discovery), re-reading
    the environment; retires the old lanes' metric records."""
    global _router
    with _router_lock:
        if _router is not None:
            for lane in _router.lanes:
                lane.mark_deleted()
        _router = ChipLaneRouter(devices)
        return _router


def set_thread_lane(lane: Optional[ChipLane]) -> None:
    """Bind this thread's dispatches to a lane (runner workers, at their
    loop's entry; None unbinds at exit)."""
    _tls.lane = lane


def current_lane() -> Optional[ChipLane]:
    return getattr(_tls, "lane", None)
