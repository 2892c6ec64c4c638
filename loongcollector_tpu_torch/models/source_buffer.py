"""DMA-friendly memory arena backing all event data.

Reference: core/common/memory/SourceBuffer.h (BufferAllocator::Alloc :98-131,
CopyString :165) — a bump allocator whose chunks double 4 KB → 128 KB.

TPU-first redesign: instead of a chunk list, ONE contiguous growable buffer
(amortised doubling).  Rationale (SURVEY.md §7 step 1): the whole arena must
transfer to HBM as a single contiguous copy for the device parse kernels, and
device-returned (offset, length) spans must index the original arena so that
zero-copy StringViews stay valid downstream.  Views hold (arena, offset), not
raw pointers, so growth-induced reallocation is safe.
"""

from __future__ import annotations

import numpy as np

from ..utils.stringview import StringView

_INITIAL_CAPACITY = 4096


class SourceBuffer:
    __slots__ = ("_data", "_size")

    def __init__(self, capacity: int = _INITIAL_CAPACITY):
        self._data = bytearray(capacity)
        self._size = 0

    # -- allocation ---------------------------------------------------------

    def _reserve(self, n: int) -> None:
        need = self._size + n
        cap = len(self._data)
        if need > cap:
            while cap < need:
                cap *= 2
            # Reallocate into a NEW bytearray rather than extending in place:
            # live numpy exports (as_array views held by columnar processors)
            # keep the old buffer alive and valid, so arena growth can never
            # raise BufferError mid-batch.  StringViews resolve through
            # `self._data` and see the new buffer.
            new = bytearray(cap)
            new[: self._size] = self._data[: self._size]
            self._data = new

    def allocate(self, n: int) -> int:
        """Bump-allocate n bytes; returns the offset."""
        self._reserve(n)
        off = self._size
        self._size += n
        return off

    def copy_string(self, data) -> StringView:
        """Copy bytes/str into the arena; returns a zero-copy view."""
        if isinstance(data, str):
            data = data.encode("utf-8")
        elif isinstance(data, StringView):
            data = data.to_bytes()
        n = len(data)
        off = self.allocate(n)
        self._data[off : off + n] = data
        return StringView(self, off, n)

    def write_at(self, offset: int, data: bytes) -> None:
        self._data[offset : offset + len(data)] = data

    def view(self, offset: int, length: int) -> StringView:
        return StringView(self, offset, length)

    # -- access -------------------------------------------------------------

    @property
    def raw(self) -> bytearray:
        return self._data

    @property
    def size(self) -> int:
        return self._size

    def __len__(self) -> int:
        return self._size

    def as_array(self) -> np.ndarray:
        """Zero-copy uint8 view of the used portion, for device transfer.
        Valid until the next allocation (growth may reallocate)."""
        return np.frombuffer(self._data, dtype=np.uint8, count=self._size)
