"""Structural index (K5): the host twins, the plain PyTorch version and the
kernel wrapper.

The port's copy of the JAX package's ``ops/kernels/struct_index.py``.  One
dispatch indexes a whole batch: every byte of a ``[B, L]`` row tensor is
classified into four bitmaps — in-string, structural, escaped, unescaped
quote — in JSON mode or in delimiter mode with a separator byte, each mask
packed 16 bits to an int32 word (``[B, ceil(L / 16)]``, little-endian).
The semantics: a position is escaped iff it is not a backslash and the
backslash run right before it has odd length (JSON mode only); the
in-string mask is the inclusive prefix-XOR of the unescaped quotes; every
mask is cut at the row's length.

* The **host twins** are copied from the reference as they are:
  ``struct_index_numpy`` (the no-device tier and the reference for both),
  ``unpack16``, ``native_masks_as_words16`` (the native library's uint64
  masks as 16-bit words) and ``emit_delim_spans`` (field spans of the
  RFC4180-clean rows of a quote-mode delimiter group, from the index).
* ``build_index_fn(mode, sep)`` is the **plain version**: ``_index_core``
  on tensors (``torch.cummax`` for the last-non-backslash max-scan,
  ``cumsum % 2`` for the quote parity).  It runs the CPU tests and
  ``--cpu``, and ``chip_smoke.py`` holds the kernel against it on the card.
* ``StructIndexKernel`` sends a CPU tensor to the plain version and a
  CUDA tensor to the hand-written kernel (``struct_index_cuda``, source
  ``csrc/struct_index.cu``), counted in ``launches``, or raises.
  ``index_batch`` packs a columnar group through ``ops/device_batch``'s
  length buckets into one batch and indexes it in one dispatch, as the
  reference's does; on the card the rows go up from pinned memory, the
  masks come back into pinned memory, and the host waits on its own event
  (a synchronous round trip, as the reference's ``jax.device_get``).  With
  the dispatch timeline on, each is a dispatch there (program
  ``struct_index``) with h2d, exec and d2h legs.  A group ``index_batch``
  cannot hold in one batch — a row over the largest bucket (4096 bytes),
  or more rows than ``MAX_BATCH`` — returns None and is counted in
  ``host_groups`` by reason: the caller indexes it with the numpy twin, as
  the reference's tier does (it has no such limit).

K5 replaces ``build_index_fn`` (reference ``struct_index.py:119``).  No
processor of the JAX package dispatches it; the port's quote-mode
delimiter reaches it exactly where the reference computes its function
(``processor/parse_delimiter.py``, the index tier without the native
walker), and K7 runs it as its ``struct_index`` stage.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ...utils.device import resolve_device
from .. import xprof

MODE_JSON = "json"
MODE_DELIM = "delim"

_JSON_STRUCT = (0x7B, 0x7D, 0x5B, 0x5D, 0x3A, 0x2C)  # { } [ ] : ,
_BS = 0x5C
_QUOTE = 0x22


def _pack16(bits, xp):
    """bool [B, L] -> int32 [B, ceil(L/16)] little-endian bit words."""
    B, L = bits.shape
    W = (L + 15) // 16
    pad = W * 16 - L
    if pad:
        bits = xp.concatenate(
            [bits, xp.zeros((B, pad), dtype=bool)], axis=1)
    weights = (xp.ones((), dtype=xp.int32) << xp.arange(16, dtype=xp.int32))
    return xp.sum(bits.reshape(B, W, 16).astype(xp.int32) * weights, axis=2)


def _index_core(rows, lengths, mode: str, sep: int, xp, scan_max):
    """Shared mask math: rows u8 [B, L], lengths i32 [B] ->
    (in_string, structural, escaped, quote) bool [B, L]."""
    B, L = rows.shape
    pos = xp.arange(L, dtype=xp.int32)[None, :] + xp.zeros(
        (B, 1), dtype=xp.int32)
    valid = pos < lengths.astype(xp.int32)[:, None]
    quote = (rows == _QUOTE) & valid
    if mode == MODE_JSON:
        bs = (rows == _BS) & valid
        # last non-backslash position at or before i (associative max-scan)
        lnb = scan_max(xp.where(~bs, pos, xp.int32(-1)))
        # run of backslashes ending at i-1 has length (i-1) - lnb(i-1);
        # odd run ⇒ the (non-backslash) byte at i is escaped
        run_prev = xp.concatenate(
            [xp.zeros((B, 1), dtype=xp.int32),
             (pos - lnb)[:, :-1]], axis=1)
        escaped = (~bs) & ((run_prev % 2) == 1) & valid
        st = xp.zeros((B, L), dtype=bool)
        for c in _JSON_STRUCT:
            st = st | (rows == c)
        st = st & valid
    else:
        escaped = xp.zeros((B, L), dtype=bool)
        st = (rows == sep) & valid
    q_real = quote & ~escaped
    in_string = (xp.cumsum(q_real.astype(xp.int32), axis=1) % 2) == 1
    in_string = in_string & valid
    structural = st & ~in_string
    return in_string, structural, escaped, q_real


def struct_index_numpy(rows: np.ndarray, lengths: np.ndarray,
                       mode: str = MODE_JSON, sep: int = 0x2C
                       ) -> Tuple[np.ndarray, ...]:
    """Numpy twin: packed int32 [B, W16] masks (in_string, structural,
    escaped, quote) — the degraded-tier index and the device reference."""
    rows = np.asarray(rows, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int32)

    def scan_max(a):
        return np.maximum.accumulate(a, axis=1)

    masks = _index_core(rows, lengths, mode, sep, np, scan_max)
    return tuple(_pack16(m, np) for m in masks)


def unpack16(words, L: int) -> np.ndarray:
    """int32 [B, W16] -> bool [B, L] (inverse of the kernel packing)."""
    words = np.asarray(words)
    bits = (words[:, :, None] >> np.arange(16)) & 1
    return bits.reshape(words.shape[0], -1)[:, :L].astype(bool)


def native_masks_as_words16(mask_u64: np.ndarray) -> np.ndarray:
    """uint64 [n, W] native masks -> int32 [n, W*4] 16-bit words (the
    device packing), for differential comparison on little-endian hosts."""
    u16 = mask_u64.view(np.uint16).reshape(mask_u64.shape[0], -1)
    return u16.astype(np.int32)


# ---------------------------------------------------------------------------
# the plain version


def _pack16_torch(bits: torch.Tensor) -> torch.Tensor:
    """bool [B, L] -> int32 [B, ceil(L/16)], as ``_pack16``."""
    B, L = bits.shape
    W = (L + 15) // 16
    if W * 16 != L:
        bits = torch.cat([bits, bits.new_zeros((B, W * 16 - L))], dim=1)
    weights = torch.ones((), dtype=torch.int32, device=bits.device) \
        << torch.arange(16, dtype=torch.int32, device=bits.device)
    return (bits.reshape(B, W, 16).to(torch.int32) * weights).sum(
        dim=2, dtype=torch.int32)


def build_index_fn(mode: str, sep: int):
    """The plain version: f(rows u8 [B, L], lengths i32 [B]) -> the four
    packed int32 [B, ceil(L/16)] masks, ``_index_core`` on tensors."""
    if mode not in (MODE_JSON, MODE_DELIM):
        raise ValueError(f"struct_index: unknown mode {mode!r}")

    def index(rows: torch.Tensor, lengths: torch.Tensor
              ) -> Tuple[torch.Tensor, ...]:
        B, L = rows.shape
        dev = rows.device
        pos = torch.arange(L, dtype=torch.int32, device=dev).expand(B, L)
        valid = pos < lengths.to(torch.int32)[:, None]
        quote = (rows == _QUOTE) & valid
        if mode == MODE_JSON:
            bs = (rows == _BS) & valid
            # last non-backslash position at or before i
            lnb = torch.cummax(torch.where(bs, -1, pos), dim=1).values
            run_prev = torch.cat([pos.new_zeros((B, 1)),
                                  (pos - lnb)[:, :-1]], dim=1)
            escaped = ~bs & (run_prev % 2 == 1) & valid
            st = torch.zeros((B, L), dtype=torch.bool, device=dev)
            for c in _JSON_STRUCT:
                st |= rows == c
            st &= valid
        else:
            escaped = torch.zeros((B, L), dtype=torch.bool, device=dev)
            st = (rows == sep) & valid
        q_real = quote & ~escaped
        in_string = (torch.cumsum(q_real.to(torch.int32), dim=1,
                                  dtype=torch.int32) % 2 == 1) & valid
        structural = st & ~in_string
        return tuple(_pack16_torch(m)
                     for m in (in_string, structural, escaped, q_real))

    return index


# ---------------------------------------------------------------------------
# the kernel


HOST_LONG_ROW = "row over the largest length bucket"
HOST_MANY_ROWS = "rows over MAX_BATCH"


class StructIndexKernel:
    """K5 for one (mode, separator), dispatched by tensor device.
    ``dispatch_count`` counts every index, ``launches`` the CUDA launches,
    ``device_batches`` the groups ``index_batch`` indexed in one dispatch,
    ``host_groups`` those it returned to the caller, by reason.  Runner
    workers share a kernel, so the counts are taken under a lock."""

    program = "struct_index"

    def __init__(self, mode: str = MODE_JSON, sep: int = 0x2C,
                 device: Union[str, torch.device, None] = None):
        self.mode = mode
        self.sep = int(sep)
        self.device = device
        self._plain = build_index_fn(mode, self.sep)
        self._lock = threading.Lock()
        self.dispatch_count = 0
        self.launches = 0
        self.device_batches = 0
        self.host_groups: Dict[str, int] = {}

    def reset_counts(self) -> None:
        with self._lock:
            self.dispatch_count = 0
            self.launches = 0
            self.device_batches = 0
            self.host_groups = {}

    def plain(self, rows: torch.Tensor, lengths: torch.Tensor
              ) -> Tuple[torch.Tensor, ...]:
        return self._plain(rows, lengths)

    def launch(self, rows: torch.Tensor, lengths: torch.Tensor,
               events=None) -> torch.Tensor:
        """One K5 launch on CUDA tensors: the kernel's i32 output
        ``[4, B, ceil(L/16)]``.  ``events``, a (start, end) pair of timing
        CUDA events, is recorded right around the kernel."""
        from . import struct_index_cuda
        out = struct_index_cuda.launch(rows, lengths, self.mode, self.sep,
                                       events)
        with self._lock:
            self.dispatch_count += 1
            self.launches += 1
        return out

    def __call__(self, rows: torch.Tensor, lengths: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
        """The four packed masks (on CUDA, views of the kernel's output)."""
        dev = rows.device
        if dev.type == "cpu":
            with self._lock:
                self.dispatch_count += 1
            return self.plain(rows, lengths)
        if dev.type != "cuda":
            raise ValueError(f"no struct_index kernel for {dev}")
        return tuple(self.launch(rows, lengths))

    # -- one group -----------------------------------------------------------

    def _host_group(self, reason: str) -> None:
        with self._lock:
            self.host_groups[reason] = self.host_groups.get(reason, 0) + 1

    def index_batch(self, arena: np.ndarray, offsets: np.ndarray,
                    lengths: np.ndarray):
        """Pack a columnar group into one batch (the plane's length
        buckets, ``B = pad_batch(n)``) and index it in one dispatch on the
        kernel's device (the card unless it was made for the CPU).  Returns
        (masks tuple of numpy int32 [n, W16], L), or None for a group one
        batch cannot hold (counted in ``host_groups``)."""
        from ..device_batch import (MAX_BATCH, pack_rows, pad_batch,
                                    pick_length_bucket)
        device = resolve_device(self.device)
        n = len(offsets)
        lengths = np.asarray(lengths, dtype=np.int32)
        L = pick_length_bucket(int(lengths.max()) if n else 1)
        if L is None:
            self._host_group(HOST_LONG_ROW)
            return None
        if n > MAX_BATCH:
            self._host_group(HOST_MANY_ROWS)
            return None
        B = pad_batch(n)
        offsets = np.asarray(offsets, dtype=np.int64)
        if device.type == "cpu":
            batch = pack_rows(arena, offsets, lengths, L, B)
            masks = [m.numpy() for m in self(torch.from_numpy(batch.rows),
                                             torch.from_numpy(batch.lengths))]
        else:
            masks = self._index_on_card(arena, offsets, lengths, L, B,
                                        device)
        with self._lock:
            self.device_batches += 1
        return tuple(m[:n] for m in masks), L

    def _index_on_card(self, arena, offsets, lengths, L: int, B: int,
                       device: torch.device) -> List[np.ndarray]:
        from ..device_batch import pack_rows
        rows_h = torch.empty((B, L), dtype=torch.uint8, pin_memory=True)
        lens_h = torch.empty(B, dtype=torch.int32, pin_memory=True)
        pack_rows(arena, offsets, lengths, L, B,
                  out=(rows_h.numpy(), lens_h.numpy(),
                       np.empty(B, dtype=np.int32)))
        stream = torch.cuda.current_stream(device)
        xid = xprof.begin_dispatch(rows_h.numel() + 4 * B)
        ev = None
        if xid:
            xprof.annotate(xid, self.program, f"{B}x{L}")
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record(stream)
        rows_d = rows_h.to(device, non_blocking=True)
        lens_d = lens_h.to(device, non_blocking=True)
        if xid:
            ev[1].record(stream)
        out_d = self.launch(rows_d, lens_d,
                            events=None if ev is None else ev[2:4])
        out_h = torch.empty(out_d.shape, dtype=out_d.dtype, pin_memory=True)
        out_h.copy_(out_d, non_blocking=True)
        done = ev[4] if xid else torch.cuda.Event()
        done.record(stream)
        done.synchronize()
        if xid:
            xprof.event_leg(xid, "h2d", ev[0], ev[1])
            xprof.event_leg(xid, "exec", ev[2], ev[3])
            xprof.event_leg(xid, "d2h", ev[3], done)
            xprof.close_dispatch(xid)
        return list(out_h.numpy())


_kernels: Dict[Tuple[str, int, str], StructIndexKernel] = {}
_kernels_lock = threading.Lock()


def device_kernel(mode: str, sep: int,
                  device: Union[str, torch.device, None] = None
                  ) -> StructIndexKernel:
    """The module-global kernel of (mode, separator, device), shared by
    every processor that indexes with it; ``device`` resolves as every
    entry point's does (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    key = (mode, int(sep), str(device))
    with _kernels_lock:
        kern = _kernels.get(key)
        if kern is None:
            kern = _kernels[key] = StructIndexKernel(mode, sep, device)
        return kern


def device_kernels() -> List[StructIndexKernel]:
    with _kernels_lock:
        return list(_kernels.values())


# ---------------------------------------------------------------------------
# Span emission from the index (quote-mode delimiter).
#
# Vectorised over the whole batch for the CLEAN subset — rows whose quotes
# all delimit whole fields (RFC4180 shape: quote at a field edge, no
# doubled quotes, even parity).  Everything else is flagged deviant and
# handled by the caller's counted per-row fallback; the native fused walk
# (`lct_delim_struct_parse`) handles every shape without fallback.
# ---------------------------------------------------------------------------


def emit_delim_spans(arena: np.ndarray, offsets: np.ndarray,
                     lengths: np.ndarray, quote_bits: np.ndarray,
                     sep_bits: np.ndarray, F: int):
    """arena u8; offsets i64 / lengths i32 [n]; quote_bits / sep_bits
    bool [n, L] row-local (sep_bits = structural mask: separators outside
    the quote-parity in-string interpretation).  Returns (cap_off [n,F]
    i32, cap_len [n,F] i32, nfields [n] i32, deviant bool [n])."""
    n, L = quote_bits.shape
    lengths = np.asarray(lengths, dtype=np.int32)
    offsets = np.asarray(offsets, dtype=np.int64)
    cap_off = np.zeros((n, F), dtype=np.int32)
    cap_len = np.full((n, F), -1, dtype=np.int32)

    # deviance: odd quote parity, or any quote not adjacent to a field
    # boundary (row edge / real separator), or more fields than F (the
    # join rule rewrites bytes, which the span-only path cannot express)
    qcount = quote_bits.sum(axis=1)
    row_idx = np.arange(n, dtype=np.int64)
    last = np.maximum(lengths.astype(np.int64) - 1, 0)
    prev_sep = np.zeros_like(quote_bits)
    prev_sep[:, 1:] = sep_bits[:, :-1]
    next_sep = np.zeros_like(quote_bits)
    next_sep[:, :-1] = sep_bits[:, 1:]
    at_start = np.zeros_like(quote_bits)
    at_start[:, 0] = True
    at_end = np.zeros_like(quote_bits)
    at_end[row_idx, last] = lengths > 0
    boundary_ok = at_start | at_end | prev_sep | next_sep
    deviant = (qcount % 2 == 1) | (quote_bits & ~boundary_ok).any(axis=1)

    scount = sep_bits.sum(axis=1).astype(np.int32)
    nfields = np.where(lengths >= 0, scount + 1, 0).astype(np.int32)
    deviant = deviant | (nfields > F)

    # k-th separator position per row (k < F-1), via the CSR over nonzero
    srow, spos = np.nonzero(sep_bits)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(scount, out=starts[1:])
    edges = np.full((n, F + 1), -1, dtype=np.int64)
    edges[:, 0] = 0
    for k in range(1, F):
        has = scount >= k
        idx = starts[:-1][has] + (k - 1)
        edges[has, k] = spos[idx] + 1 if len(srow) else -1
    # exclusive end per field: next separator or row end
    for k in range(F):
        start = edges[:, k]
        have = (start >= 0) & (k < nfields)
        nxt = np.where((k + 1 <= F - 1) & (edges[:, k + 1] > 0),
                       edges[:, k + 1] - 1, lengths.astype(np.int64))
        end = np.where(k == nfields - 1, lengths.astype(np.int64), nxt)
        start = np.where(have, start, 0)
        end = np.maximum(np.where(have, end, 0), start)
        # quoted-field strip: first byte is a quote (cleanliness has
        # already guaranteed the matching closing quote at the far edge)
        first_q = np.zeros(n, dtype=bool)
        nonempty = have & (end > start)
        if nonempty.any():
            first_q[nonempty] = quote_bits[row_idx[nonempty],
                                           start[nonempty]]
        strip = first_q & (end - start >= 2)
        start = start + strip
        end = end - strip
        cap_off[:, k] = np.where(have, offsets + start, 0).astype(np.int32)
        cap_len[:, k] = np.where(have, end - start, -1).astype(np.int32)
    return cap_off, cap_len, nfields, np.asarray(deviant, dtype=bool)
