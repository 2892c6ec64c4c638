"""The streaming device pipeline: batch rings, the width auto-tuner, the
pipelined dispatch window, and the staged kernel call.

Reference: loongcollector_tpu/ops/device_stream.py.

* **BatchRing / BatchSlot** — pools of reusable fixed-geometry staging
  buffers per ``(B, L)``.  A slot's ``rows``/``lengths``/``origins`` are
  host tensors, pinned when the device is CUDA (``pin_memory`` needs CUDA,
  so on the CPU they are plain tensors); ``pack()`` writes into them
  through numpy views.  A slot also owns pinned output buffers for
  ``ok``/``cap_off``/``cap_len`` (``outputs(C)``), and one flat byte
  buffer for a fused stage program's outputs (``flat_output(nbytes)``).
  Slots are leased and released exactly once; every pack records its
  padding waste.
* **StagedKernel** — the call the plane dispatches for a slot: on CUDA it
  copies the slot's rows and lengths to the device on the thread's H2D
  stream, launches the kernel on the thread's compute stream once an event
  says the copy is done, copies the outputs back into the slot's pinned
  buffers on the compute stream and records the final event (the slot's
  ``fence``).  No step synchronises the host.  On the CPU it runs the
  kernel's plain version on the slot's tensors.  A kernel with
  ``host_outputs(slot)`` (the fused stage program) names its own host
  buffers; else they are the slot's ``outputs(C)``.
* **Slot reuse** — a slot goes back to its pool only once its fence has
  completed: the copy engine may still read the pinned rows, or write the
  pinned outputs, of a dispatch released on an error path.  Until then
  the ring keeps it aside (``fenced``) and re-pools it at a later lease.
* **DeviceStream** — the pipelined dispatch window: at most ``depth``
  batches in flight, results strictly in submit order, an errored batch
  costs only its own entry.
* **WidthAutoTuner** — B floors per (lane, length bucket) driven by the
  measured row padding — lane None for the engines' stream, ``fused:<sig>``
  for each fused program, so a sparse fused pipeline does not shrink the
  staged plane's geometry — and the worker lanes' flush deadline driven by
  the plane's idle-while-backlogged accounting.

Left out of the port: the chaos fault points, the metrics instruments and
the chip-lane keys of the reference's tuner.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import xprof
from .device_batch import MIN_BATCH, pack_rows

ENV_DEPTH = "LOONG_STREAM_DEPTH"
ENV_TUNER = "LOONG_STREAM_TUNER"

DEFAULT_DEPTH = 3
MAX_DEPTH = 8

#: the tuner never shrinks a geometry floor below this
MIN_TUNED_FLOOR = 32


def stream_depth(env=os.environ) -> int:
    """How many batches one dispatch loop keeps in flight (pack N+1 /
    compute N / span-return N-1 needs 3).  ``LOONG_STREAM_DEPTH``
    overrides, clamped to [1, 8]; 1 is the synchronous round trip."""
    raw = env.get(ENV_DEPTH)
    if raw:
        try:
            return max(1, min(int(raw), MAX_DEPTH))
        except ValueError:
            pass
    return DEFAULT_DEPTH


def tuner_enabled(env=os.environ) -> bool:
    return env.get(ENV_TUNER) != "0"


class _GeometryStats:
    __slots__ = ("packs", "real_rows", "padded_rows", "real_bytes",
                 "padded_bytes", "slot_allocs", "slot_reuses")

    def __init__(self) -> None:
        self.packs = 0
        self.real_rows = 0
        self.padded_rows = 0
        self.real_bytes = 0
        self.padded_bytes = 0
        self.slot_allocs = 0
        self.slot_reuses = 0

    def as_dict(self) -> dict:
        total = self.real_bytes + self.padded_bytes
        return {
            "packs": self.packs,
            "real_rows": self.real_rows,
            "padded_rows": self.padded_rows,
            "real_bytes": self.real_bytes,
            "padded_bytes": self.padded_bytes,
            "padding_fraction": (self.padded_bytes / total) if total else 0.0,
            "slot_allocs": self.slot_allocs,
            "slot_reuses": self.slot_reuses,
        }


# ---------------------------------------------------------------------------
# batch ring


class BatchSlot:
    """One fixed-geometry staging buffer, leased from the ring.

    ``pack()`` fills ``rows``/``lengths``/``origins`` from the arena (the
    same host pages every generation); ``release()`` returns the slot,
    exactly once, after the dispatch that used it has been consumed."""

    __slots__ = ("_ring", "B", "L", "pinned", "rows", "lengths", "origins",
                 "_np", "_outs", "_flat", "fence", "_leased", "pack_t0",
                 "pack_dur")

    def __init__(self, ring: "BatchRing", B: int, L: int, pinned: bool):
        self._ring = ring
        self.B = B
        self.L = L
        self.pinned = pinned
        self.rows = torch.zeros((B, L), dtype=torch.uint8, pin_memory=pinned)
        self.lengths = torch.zeros(B, dtype=torch.int32, pin_memory=pinned)
        self.origins = torch.zeros(B, dtype=torch.int32, pin_memory=pinned)
        self._np = (self.rows.numpy(), self.lengths.numpy(),
                    self.origins.numpy())
        self._outs: Dict[int, Tuple[torch.Tensor, ...]] = {}
        self._flat: Dict[int, torch.Tensor] = {}
        # the CUDA event after the last dispatch's D2H; None on the CPU
        self.fence = None
        self._leased = False
        # the last pack()'s stopwatch while the timeline is on
        self.pack_t0: Optional[float] = None
        self.pack_dur: Optional[float] = None

    def pack(self, arena: np.ndarray, offsets: np.ndarray,
             lengths: np.ndarray, lane: Optional[str] = None):
        """Pack rows into this slot's buffers; records padding waste and
        feeds the auto-tuner (``lane``'s floors).  Returns the DeviceBatch
        of numpy views."""
        if xprof.is_active():
            self.pack_t0 = time.perf_counter()
            batch = pack_rows(arena, offsets, lengths, self.L, self.B,
                              out=self._np)
            self.pack_dur = time.perf_counter() - self.pack_t0
        else:
            self.pack_t0 = self.pack_dur = None
            batch = pack_rows(arena, offsets, lengths, self.L, self.B,
                              out=self._np)
        self._ring.record_pack(self.B, self.L, batch.n_real,
                               int(np.asarray(lengths, np.int64).sum()),
                               lane=lane)
        return batch

    def outputs(self, C: int) -> Tuple[torch.Tensor, ...]:
        """(ok bool [B], cap_off i32 [B, C], cap_len i32 [B, C]) host
        buffers the dispatch writes its results into."""
        outs = self._outs.get(C)
        if outs is None:
            pin = self.pinned
            outs = (torch.zeros(self.B, dtype=torch.bool, pin_memory=pin),
                    torch.zeros((self.B, C), dtype=torch.int32,
                                pin_memory=pin),
                    torch.zeros((self.B, C), dtype=torch.int32,
                                pin_memory=pin))
            self._outs[C] = outs
        return outs

    def flat_output(self, nbytes: int) -> torch.Tensor:
        """A u8 host buffer of ``nbytes`` a dispatch copies one flat output
        into (pinned like the slot)."""
        flat = self._flat.get(nbytes)
        if flat is None:
            flat = torch.zeros(nbytes, dtype=torch.uint8,
                               pin_memory=self.pinned)
            self._flat[nbytes] = flat
        return flat

    def nbytes(self) -> int:
        """Host bytes this slot stages for H2D (rows + lengths + origins):
        the unit of the ``ring_slots`` memory family."""
        return self.rows.nbytes + self.lengths.nbytes + self.origins.nbytes

    def idle(self) -> bool:
        """True when no device copy can still touch this slot's buffers."""
        return self.fence is None or self.fence.query()

    def release(self) -> None:
        if not self._leased:
            return
        self._leased = False
        self._ring._return(self)

    def __del__(self):
        # a leased slot dropped without release() belongs to an abandoned
        # dispatch: keep the lease count truthful.  Its pinned memory goes
        # back to PyTorch's host allocator, which holds it until the copies
        # recorded on it have completed.
        try:
            if self._leased:
                self._leased = False
                self._ring._forget(self)
        except Exception:  # noqa: BLE001 — never raise from a finaliser
            pass


class BatchRing:
    """Geometry-keyed pools of reusable BatchSlots plus the padding-waste
    ledger.  ``lease()`` never blocks: past the per-geometry pool cap it
    hands out a transient slot (dropped on release).  Back-pressure is the
    plane budget's job; the ring only recycles memory."""

    def __init__(self, slots_per_geometry: Optional[int] = None):
        self._lock = threading.Lock()
        self._pools: Dict[Tuple[int, int, bool], List[BatchSlot]] = {}
        self._fenced: List[BatchSlot] = []
        self._stats: Dict[Tuple[int, int], _GeometryStats] = {}
        self._leased = 0
        self._leases = 0
        self._returns = 0
        self._slots_per_geometry = slots_per_geometry

    def _cap(self) -> int:
        if self._slots_per_geometry is not None:
            return self._slots_per_geometry
        return stream_depth() + 2

    def _pool_locked(self, slot: BatchSlot) -> None:
        pool = self._pools.setdefault((slot.B, slot.L, slot.pinned), [])
        if len(pool) < self._cap():
            pool.append(slot)

    def lease(self, B: int, L: int, pinned: bool = False) -> BatchSlot:
        with self._lock:
            if self._fenced:
                waiting = []
                for s in self._fenced:
                    if s.idle():
                        self._pool_locked(s)
                    else:
                        waiting.append(s)
                self._fenced = waiting
            pool = self._pools.get((B, L, pinned))
            slot = pool.pop() if pool else None
            self._leased += 1
            self._leases += 1
            st = self._stats.setdefault((B, L), _GeometryStats())
            if slot is None:
                st.slot_allocs += 1
            else:
                st.slot_reuses += 1
        if slot is None:
            slot = BatchSlot(self, B, L, pinned)
        slot._leased = True
        from .device_plane import mem_note_alloc
        mem_note_alloc("ring_slots", slot.nbytes())
        return slot

    def _return(self, slot: BatchSlot) -> None:
        with self._lock:
            self._leased = max(0, self._leased - 1)
            self._returns += 1
            if slot.idle():
                self._pool_locked(slot)
            else:
                # a device copy may still read or write its buffers
                self._fenced.append(slot)
        from .device_plane import mem_note_free
        mem_note_free("ring_slots", slot.nbytes())

    def _forget(self, slot: BatchSlot) -> None:
        """A leased slot died un-released (finaliser backstop)."""
        with self._lock:
            self._leased = max(0, self._leased - 1)
        from .device_plane import mem_note_free
        mem_note_free("ring_slots", slot.nbytes())

    def record_pack(self, B: int, L: int, n_real: int,
                    real_bytes: int, lane: Optional[str] = None) -> None:
        total_bytes = B * L
        padded_bytes = max(0, total_bytes - real_bytes)
        with self._lock:
            st = self._stats.setdefault((B, L), _GeometryStats())
            st.packs += 1
            st.real_rows += n_real
            st.padded_rows += B - n_real
            st.real_bytes += real_bytes
            st.padded_bytes += padded_bytes
        auto_tuner().observe_pack(L, B, n_real, lane=lane)

    # -- observability ------------------------------------------------------

    def leased_total(self) -> int:
        with self._lock:
            return self._leased

    def pooled_total(self) -> int:
        with self._lock:
            return sum(len(p) for p in self._pools.values())

    def fenced_total(self) -> int:
        with self._lock:
            return len(self._fenced)

    def stats(self) -> Dict[str, dict]:
        """Per-geometry padding/reuse ledger, keyed "BxL"."""
        with self._lock:
            return {f"{B}x{L}": st.as_dict()
                    for (B, L), st in sorted(self._stats.items())}

    def totals(self) -> dict:
        with self._lock:
            real_b = sum(s.real_bytes for s in self._stats.values())
            pad_b = sum(s.padded_bytes for s in self._stats.values())
            return {
                "leased": self._leased,
                "leases": self._leases,
                "returns": self._returns,
                "pooled": sum(len(p) for p in self._pools.values()),
                "fenced": len(self._fenced),
                "packs": sum(s.packs for s in self._stats.values()),
                "real_rows": sum(s.real_rows for s in self._stats.values()),
                "padded_rows": sum(s.padded_rows
                                   for s in self._stats.values()),
                "real_bytes": real_b,
                "padded_bytes": pad_b,
                "padding_fraction": (pad_b / (real_b + pad_b)
                                     if real_b + pad_b else 0.0),
            }


_ring: Optional[BatchRing] = None
_ring_lock = threading.Lock()


def batch_ring() -> BatchRing:
    global _ring
    if _ring is None:
        with _ring_lock:
            if _ring is None:
                _ring = BatchRing()
    return _ring


# ---------------------------------------------------------------------------
# the staged kernel call


class StagedKernel:
    """The dispatch of one packed slot through ``kernel`` on ``device``:
    ``staged(slot, C)`` returns the slot's output buffers, as
    ``HostOutput`` handles that become ready at the slot's fence on CUDA,
    or as filled tensors on the CPU.  Legs go to the timeline of the
    enclosing dispatch."""

    def __init__(self, kernel, device: torch.device):
        self.kernel = kernel
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        # a hand kernel's wrapper records the exec leg's events right
        # around its launch; any other callable (the plain version) is
        # bracketed from here
        self._brackets_launch = bool(getattr(kernel, "brackets_launch",
                                             False))
        self._host_outputs = getattr(kernel, "host_outputs", None)

    def __call__(self, slot: BatchSlot, C: int):
        outs = (self._host_outputs(slot) if self._host_outputs is not None
                else slot.outputs(C))
        xid = xprof.current_dispatch()
        if self.device.type == "cpu":
            slot.fence = None
            t0 = time.perf_counter()
            results = self.kernel(slot.rows, slot.lengths)
            t1 = time.perf_counter()
            for dst, src in zip(outs, results):
                dst.copy_(src)
            if xid:
                xprof.leg(xid, "exec", t0, t1 - t0)
                xprof.leg(xid, "d2h", t1, time.perf_counter() - t1)
            return outs
        from .device_plane import HostOutput, thread_streams
        streams = thread_streams(self.device)
        ev = [torch.cuda.Event(enable_timing=bool(xid)) for _ in range(4)]
        done = torch.cuda.Event(enable_timing=bool(xid))
        # events take their stream explicitly: looking up the current
        # stream is a measurable share of a dispatch's host time
        with torch.cuda.stream(streams.h2d):
            ev[0].record(streams.h2d)
            rows = slot.rows.to(streams.device, non_blocking=True)
            lengths = slot.lengths.to(streams.device, non_blocking=True)
            ev[1].record(streams.h2d)
        streams.compute.wait_event(ev[1])
        with torch.cuda.stream(streams.compute):
            # allocated on the H2D stream, read on the compute stream
            rows.record_stream(streams.compute)
            lengths.record_stream(streams.compute)
            if self._brackets_launch:
                results = self.kernel(rows, lengths, ev[2:4])
            else:
                ev[2].record(streams.compute)
                results = self.kernel(rows, lengths)
                ev[3].record(streams.compute)
            for dst, src in zip(outs, results):
                dst.copy_(src, non_blocking=True)
            done.record(streams.compute)
        slot.fence = done
        if xid:
            xprof.event_leg(xid, "h2d", ev[0], ev[1])
            xprof.event_leg(xid, "exec", ev[2], ev[3])
            xprof.event_leg(xid, "d2h", ev[3], done)
        return tuple(HostOutput(t, done) for t in outs)


# ---------------------------------------------------------------------------
# width auto-tuner


class _BucketState:
    __slots__ = ("floor", "ewma_pad", "packs_since", "packs_total")

    def __init__(self) -> None:
        self.floor = MIN_BATCH
        self.ewma_pad = 0.0
        self.packs_since = 0
        self.packs_total = 0


class WidthAutoTuner:
    """Runtime batch-geometry and flush-deadline policy.

    * **B floors**: per length bucket L the padded batch floor starts at
      ``MIN_BATCH`` and halves (never below ``MIN_TUNED_FLOOR``) while the
      row padding fraction ``(B - n_real) / B`` stays above ``HIGH_PAD``,
      and doubles back while it stays under ``LOW_PAD``, one step per
      ``ADJUST_EVERY`` packs.
    * **flush deadline**: how long a worker lane lets a pending group ride
      before completing it; it doubles (to ``DEADLINE_MAX_S``) when the
      plane's ``idle_while_backlogged_ms`` grew by more than 25 ms since the
      last look, and decays back toward the default otherwise.
    """

    ADJUST_EVERY = 32
    HIGH_PAD = 0.5
    LOW_PAD = 0.05
    EWMA_ALPHA = 0.125

    DEADLINE_DEFAULT_S = 0.020
    DEADLINE_MAX_S = 0.100

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # keyed (lane, L): lane None is the engines' stream, "fused:<sig>"
        # a fused program's
        self._buckets: Dict[Tuple[Optional[str], int], _BucketState] = {}
        self._flush_deadline_s = self.DEADLINE_DEFAULT_S
        self._last_adjust = 0.0
        self._last_idle_ms: Optional[float] = None
        self._deadline_adjusts = 0

    def min_batch_for(self, L: int, lane: Optional[str] = None) -> int:
        if not tuner_enabled():
            return MIN_BATCH
        with self._lock:
            st = self._buckets.get((lane, L))
            return st.floor if st is not None else MIN_BATCH

    def observe_pack(self, L: int, B: int, n_real: int,
                     lane: Optional[str] = None) -> None:
        frac = (B - n_real) / B if B else 0.0
        with self._lock:
            st = self._buckets.setdefault((lane, L), _BucketState())
            st.packs_total += 1
            st.packs_since += 1
            st.ewma_pad += self.EWMA_ALPHA * (frac - st.ewma_pad)
            if not tuner_enabled() or st.packs_since < self.ADJUST_EVERY:
                return
            st.packs_since = 0
            if st.ewma_pad > self.HIGH_PAD and st.floor > MIN_TUNED_FLOOR:
                st.floor //= 2
            elif st.ewma_pad < self.LOW_PAD and st.floor < MIN_BATCH:
                st.floor *= 2

    def flush_deadline_s(self) -> float:
        return self._flush_deadline_s

    def maybe_adjust(self) -> None:
        """Deadline adjustment, at most once a second, from the plane's
        utilisation accounting (never constructs a plane)."""
        if not tuner_enabled():
            return
        now = time.monotonic()
        with self._lock:
            if now - self._last_adjust < 1.0:
                return
            self._last_adjust = now
        from .device_plane import DevicePlane
        plane = DevicePlane._instance
        if plane is None:
            return
        idle_ms = plane.utilization()["idle_while_backlogged_ms"]
        with self._lock:
            if self._last_idle_ms is None:
                self._last_idle_ms = idle_ms    # arm the window only
                return
            delta = idle_ms - self._last_idle_ms
            self._last_idle_ms = idle_ms
            if delta > 25.0:
                self._flush_deadline_s = min(
                    self._flush_deadline_s * 2.0, self.DEADLINE_MAX_S)
                self._deadline_adjusts += 1
            elif self._flush_deadline_s > self.DEADLINE_DEFAULT_S:
                self._flush_deadline_s = max(
                    self._flush_deadline_s / 2.0, self.DEADLINE_DEFAULT_S)
                self._deadline_adjusts += 1

    def chosen(self) -> dict:
        """The tuner's current decisions, per length bucket of the engines'
        stream (``buckets``) and per lane and bucket of the fused programs
        (``lane_buckets``, when any packed)."""
        def bucket(st: _BucketState) -> dict:
            return {"floor": st.floor,
                    "ewma_row_padding_fraction": round(st.ewma_pad, 4),
                    "packs": st.packs_total}
        with self._lock:
            items = sorted(self._buckets.items(),
                           key=lambda kv: (str(kv[0][0]), kv[0][1]))
            out = {
                "enabled": tuner_enabled(),
                "flush_deadline_ms": round(self._flush_deadline_s * 1e3, 3),
                "deadline_adjusts": self._deadline_adjusts,
                "buckets": {str(L): bucket(st) for (lane, L), st in items
                            if lane is None},
            }
            lanes: Dict[str, dict] = {}
            for (lane, L), st in items:
                if lane is not None:
                    lanes.setdefault(lane, {})[str(L)] = bucket(st)
            if lanes:
                out["lane_buckets"] = lanes
            return out


_tuner: Optional[WidthAutoTuner] = None
_tuner_lock = threading.Lock()


def auto_tuner() -> WidthAutoTuner:
    global _tuner
    if _tuner is None:
        with _tuner_lock:
            if _tuner is None:
                _tuner = WidthAutoTuner()
    return _tuner


def reset_for_testing(slots_per_geometry: Optional[int] = None) -> None:
    """Fresh ring (pooling at most ``slots_per_geometry`` slots per
    geometry, when given) and tuner."""
    global _ring, _tuner
    with _ring_lock:
        _ring = BatchRing(slots_per_geometry)
    with _tuner_lock:
        _tuner = WidthAutoTuner()


# ---------------------------------------------------------------------------
# the pipelined dispatch window


class DeviceStream:
    """Ordered pipelined dispatch over a DevicePlane.

    ``submit`` never lets more than ``depth`` batches stay in flight: a
    full window first advances (consumes the oldest batch).  ``drain()``
    consumes the rest.  Results arrive in submit order as
    ``(tag, outputs)``; an errored batch delivers ``(tag, exception)`` in
    its place.  The regex engine's PendingParse keeps the same window
    inline (``ops/regex/engine.py``); a change to the advance order or to
    slot/budget release here needs its mirror there."""

    def __init__(self, plane=None, depth: Optional[int] = None):
        if plane is None:
            from .device_plane import DevicePlane
            plane = DevicePlane.instance()
        self.plane = plane
        self.depth = max(1, depth if depth is not None else stream_depth())
        self._window: deque = deque()
        self._results: List[Tuple[object, object]] = []
        self.advances = 0

    def inflight(self) -> int:
        return len(self._window)

    def submit(self, kernel, args, nbytes: int, tag=None,
               slot: Optional[BatchSlot] = None) -> None:
        """Dispatch under the plane budget, advancing first if the window
        is full.  With ``slot`` the stream owns its release."""
        try:
            while len(self._window) >= self.depth:
                self.advance()
            fut = self.plane.submit(kernel, args, nbytes,
                                    on_wait=self._advance_if_any)
        except BaseException:
            if slot is not None:
                slot.release()
            raise
        self._window.append((tag, slot, fut))
        if slot is not None:
            xprof.note_dispatch(fut, "stream", f"{slot.B}x{slot.L}",
                                slot.pack_t0, slot.pack_dur)
        else:
            xprof.note_dispatch(fut, "stream", "-")

    def _advance_if_any(self) -> bool:
        if not self._window:
            return False
        self.advance()
        return True

    def advance(self):
        """Consume the oldest in-flight batch and append its result; the
        slot and budget always return."""
        if not self._window:
            return None
        tag, slot, fut = self._window.popleft()
        self.advances += 1
        try:
            try:
                out = fut.result()
            except Exception as e:  # noqa: BLE001 — delivered in order
                fut.release()
                out = e
            except BaseException:
                fut.release()
                raise
        finally:
            if slot is not None:
                slot.release()
        self._results.append((tag, out))
        return out

    def drain(self) -> List[Tuple[object, object]]:
        """Advance until the window empties; returns (and clears) every
        result in submit order."""
        while self._window:
            self.advance()
        out, self._results = self._results, []
        return out
