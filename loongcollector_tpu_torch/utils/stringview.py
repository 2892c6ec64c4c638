"""Zero-copy string views into a SourceBuffer arena.

Reference: core/common/StringView.h + StringBuffer (core/common/memory/
SourceBuffer.h).  Events never own their bytes; they hold (arena, offset,
length) triples.  The arena itself is a contiguous buffer that can be
transferred to TPU HBM in one copy, and device kernels return (offset, length)
spans that become new StringViews into the *same* arena — zero-copy end to end.
"""

from __future__ import annotations

from typing import Union


class StringView:
    """A (buffer, offset, length) span. Buffer is anything supporting
    __getitem__ slicing to bytes (SourceBuffer, bytes, bytearray, memoryview).
    """

    __slots__ = ("_buf", "offset", "length")

    def __init__(self, buf, offset: int = 0, length: int = -1):
        if isinstance(buf, str):
            buf = buf.encode("utf-8")
        self._buf = buf
        self.offset = offset
        if length < 0:
            length = len(buf) - offset
        self.length = length

    def to_bytes(self) -> bytes:
        buf = self._buf
        # SourceBuffer exposes .raw (bytearray); plain bytes-like slices direct.
        raw = getattr(buf, "raw", buf)
        return bytes(raw[self.offset : self.offset + self.length])

    def to_str(self) -> str:
        return self.to_bytes().decode("utf-8", errors="replace")

    @property
    def buffer(self):
        return self._buf

    def substr(self, start: int, length: int = -1) -> "StringView":
        start = max(0, min(start, self.length))
        if length < 0 or start + length > self.length:
            length = self.length - start
        return StringView(self._buf, self.offset + start, length)

    def __len__(self) -> int:
        return self.length

    def __bool__(self) -> bool:
        return self.length > 0

    def __bytes__(self) -> bytes:
        return self.to_bytes()

    def __str__(self) -> str:
        return self.to_str()

    def __eq__(self, other) -> bool:
        if isinstance(other, StringView):
            return self.to_bytes() == other.to_bytes()
        if isinstance(other, bytes):
            return self.to_bytes() == other
        if isinstance(other, str):
            return self.to_str() == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.to_bytes())

    def __repr__(self) -> str:
        return f"StringView({self.to_bytes()!r})"


AnyStr = Union[StringView, bytes, str]


def as_bytes(s: AnyStr) -> bytes:
    if isinstance(s, StringView):
        return s.to_bytes()
    if isinstance(s, str):
        return s.encode("utf-8")
    return bytes(s)
