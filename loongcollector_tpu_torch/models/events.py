"""Pipeline event types: LOG / METRIC / SPAN / RAW.

Reference: core/models/PipelineEvent.h (4 event kinds), LogEvent
(core/models/LogEvent.h:64 — content order preserved, :120-122),
MetricEvent + MetricValue (untyped double / typed multi-value), SpanEvent,
RawEvent.  Events hold StringViews into the owning group's SourceBuffer.
"""

from __future__ import annotations

import enum
from typing import Dict, Iterable, List, Optional, Tuple

from ..utils.stringview import AnyStr, StringView, as_bytes


class EventType(enum.IntEnum):
    NONE = 0
    LOG = 1
    METRIC = 2
    SPAN = 3
    RAW = 4


class PipelineEvent:
    """Base event. `Is<T>/Cast<T>` of the reference's tagged PipelineEventPtr
    become isinstance checks; `GetType()` is the `type` attribute."""

    __slots__ = ("timestamp", "timestamp_ns")
    type: EventType = EventType.NONE

    def __init__(self, timestamp: int = 0, timestamp_ns: Optional[int] = None):
        self.timestamp = timestamp
        self.timestamp_ns = timestamp_ns

    def set_timestamp(self, ts: int, ns: Optional[int] = None) -> None:
        self.timestamp = ts
        self.timestamp_ns = ns


class LogEvent(PipelineEvent):
    """Ordered key→value contents (order preserved, LogEvent.h:120-122).

    Contents are stored as a list of (key, value) StringView pairs plus a
    dict index for O(1) lookup; both stay in sync.
    """

    __slots__ = ("_contents", "_index", "level", "file_offset")
    type = EventType.LOG

    def __init__(self, timestamp: int = 0, timestamp_ns: Optional[int] = None):
        super().__init__(timestamp, timestamp_ns)
        self._contents: List[Tuple[StringView, StringView]] = []
        self._index: Dict[bytes, int] = {}
        self.level: Optional[StringView] = None
        self.file_offset: int = 0

    def set_content(self, key: AnyStr, value: AnyStr) -> None:
        """Copy-free when key/value are already StringViews into the arena
        (the reference's SetContentNoCopy); str/bytes are wrapped as-is."""
        kv = key if isinstance(key, StringView) else StringView(as_bytes(key))
        vv = value if isinstance(value, StringView) else StringView(as_bytes(value))
        kb = kv.to_bytes()
        idx = self._index.get(kb)
        if idx is None:
            self._index[kb] = len(self._contents)
            self._contents.append((kv, vv))
        else:
            self._contents[idx] = (kv, vv)

    def get_content(self, key: AnyStr) -> Optional[StringView]:
        idx = self._index.get(as_bytes(key))
        return self._contents[idx][1] if idx is not None else None

    def has_content(self, key: AnyStr) -> bool:
        return as_bytes(key) in self._index

    def del_content(self, key: AnyStr) -> None:
        kb = as_bytes(key)
        idx = self._index.pop(kb, None)
        if idx is not None:
            del self._contents[idx]
            for k, i in self._index.items():
                if i > idx:
                    self._index[k] = i - 1

    def clear_contents(self) -> None:
        self._contents = []
        self._index = {}

    @property
    def contents(self) -> List[Tuple[StringView, StringView]]:
        return self._contents

    def __len__(self) -> int:
        return len(self._contents)

    def empty(self) -> bool:
        return not self._contents


class MetricValue:
    """Untyped single double or typed multi-value (reference MetricValue)."""

    __slots__ = ("value", "values")

    def __init__(self, value: Optional[float] = None,
                 values: Optional[Dict[bytes, float]] = None):
        self.value = value
        self.values = values

    def is_multi(self) -> bool:
        return self.values is not None


class MetricEvent(PipelineEvent):
    __slots__ = ("name", "value", "tags")
    type = EventType.METRIC

    def __init__(self, timestamp: int = 0, timestamp_ns: Optional[int] = None):
        super().__init__(timestamp, timestamp_ns)
        self.name: Optional[StringView] = None
        self.value: MetricValue = MetricValue(0.0)
        self.tags: Dict[bytes, StringView] = {}

    def set_name(self, name: AnyStr) -> None:
        self.name = name if isinstance(name, StringView) else StringView(as_bytes(name))

    def set_value(self, v: float) -> None:
        self.value = MetricValue(float(v))

    def set_multi_value(self, values: Dict[AnyStr, float]) -> None:
        self.value = MetricValue(values={as_bytes(k): float(v) for k, v in values.items()})

    def set_tag(self, key: AnyStr, value: AnyStr) -> None:
        vv = value if isinstance(value, StringView) else StringView(as_bytes(value))
        self.tags[as_bytes(key)] = vv

    def get_tag(self, key: AnyStr) -> Optional[StringView]:
        return self.tags.get(as_bytes(key))


class SpanEvent(PipelineEvent):
    """Trace span (reference core/models/SpanEvent.h)."""

    __slots__ = ("trace_id", "span_id", "parent_span_id", "name", "kind",
                 "start_time_ns", "end_time_ns", "status", "attributes",
                 "events", "links", "trace_state")
    type = EventType.SPAN

    class Kind(enum.IntEnum):
        UNSPECIFIED = 0
        INTERNAL = 1
        SERVER = 2
        CLIENT = 3
        PRODUCER = 4
        CONSUMER = 5

    class Status(enum.IntEnum):
        UNSET = 0
        OK = 1
        ERROR = 2

    def __init__(self, timestamp: int = 0, timestamp_ns: Optional[int] = None):
        super().__init__(timestamp, timestamp_ns)
        self.trace_id = b""
        self.span_id = b""
        self.parent_span_id = b""
        self.name = b""
        self.kind = SpanEvent.Kind.UNSPECIFIED
        self.start_time_ns = 0
        self.end_time_ns = 0
        self.status = SpanEvent.Status.UNSET
        self.attributes: Dict[bytes, StringView] = {}
        self.events: List[dict] = []
        self.links: List[dict] = []
        self.trace_state = b""

    def set_attribute(self, key: AnyStr, value: AnyStr) -> None:
        vv = value if isinstance(value, StringView) else StringView(as_bytes(value))
        self.attributes[as_bytes(key)] = vv


class RawEvent(PipelineEvent):
    """A raw byte chunk (reference core/models/RawEvent.h) — e.g. one whole
    file-read chunk before line splitting (LogFileReader::GenerateEventGroup
    wraps the chunk as ONE event, reader/LogFileReader.cpp:2726)."""

    __slots__ = ("content",)
    type = EventType.RAW

    def __init__(self, timestamp: int = 0, timestamp_ns: Optional[int] = None):
        super().__init__(timestamp, timestamp_ns)
        self.content: Optional[StringView] = None

    def set_content(self, content: AnyStr) -> None:
        self.content = (content if isinstance(content, StringView)
                        else StringView(as_bytes(content)))


def metric_name_str(name) -> str:
    """Metric names arrive as bytes from inputs; str(bytes) would leak the
    b'…' repr into wire output and JSON exports. Single normalization rule
    shared by every serializer."""
    if not name:
        return ""
    if isinstance(name, bytes):
        return name.decode("utf-8", "replace")
    return str(name)
