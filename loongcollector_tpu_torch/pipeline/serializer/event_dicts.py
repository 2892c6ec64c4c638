"""Shared event→dict projection for JSON-family sinks (ES bulk, ClickHouse
JSONEachRow, Loki push, OTLP/HTTP).

Mirrors JsonSerializer's field layout (one flat object per event, group tags
folded in) so every JSON sink ships the same shape the reference's Go
converter produces (pkg/protocol/converter). Columnar groups serialize
straight from span columns without materialising event objects.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from ...models import (LogEvent, MetricEvent, PipelineEventGroup, RawEvent,
                       SpanEvent)
from ...models.events import metric_name_str as _name_str


def iter_event_dicts(group: PipelineEventGroup
                     ) -> Iterator[Tuple[int, Dict[str, object]]]:
    """Yields (timestamp_seconds, flat_dict) per event."""
    tags = {k.decode("utf-8", "replace"): str(v)
            for k, v in group.tags.items()}
    cols = group.columns
    if cols is not None and not group._events:
        raw = group.source_buffer.raw
        names = [n for n in (cols.fields or {}) if n != "_partial_"]
        spans = [cols.fields[n] for n in names]
        if not cols.content_consumed and "content" not in (cols.fields or {}):
            names.insert(0, "content")
            spans.insert(0, (cols.offsets, cols.lengths))
        tss = cols.timestamps
        for i in range(len(cols)):
            obj: Dict[str, object] = dict(tags)
            for name, (offs, lens) in zip(names, spans):
                ln = int(lens[i])
                if ln >= 0:
                    o = int(offs[i])
                    obj[name] = raw[o:o + ln].decode("utf-8", "replace")
            yield int(tss[i]), obj
        return
    # canonical dict fallback: event groups / already-materialized rows —
    # the one place the NDJSON family is ALLOWED to walk row objects
    for ev in group.events:  # loonglint: disable=hot-path-materialize
        obj = dict(tags)
        ts = 0
        if isinstance(ev, LogEvent):
            ts = ev.timestamp
            for k, v in ev.contents:
                obj[k.to_str()] = v.to_str()
        elif isinstance(ev, MetricEvent):
            ts = ev.timestamp
            obj["__name__"] = _name_str(ev.name)
            if ev.value.is_multi():
                obj["__values__"] = {k.decode(): v
                                     for k, v in ev.value.values.items()}
            else:
                obj["__value__"] = ev.value.value
            obj["__labels__"] = {k.decode(): str(v)
                                 for k, v in ev.tags.items()}
        elif isinstance(ev, SpanEvent):
            obj["traceId"] = ev.trace_id.decode("utf-8", "replace")
            obj["spanId"] = ev.span_id.decode("utf-8", "replace")
            obj["name"] = ev.name.decode("utf-8", "replace")
            obj["startTimeNs"] = ev.start_time_ns
            obj["endTimeNs"] = ev.end_time_ns
            ts = ev.start_time_ns // 1_000_000_000
        elif isinstance(ev, RawEvent):
            ts = ev.timestamp
            obj["content"] = str(ev.content) if ev.content else ""
        yield ts, obj


def collect_event_dicts(groups: List[PipelineEventGroup]
                        ) -> List[Tuple[int, Dict[str, object]]]:
    out: List[Tuple[int, Dict[str, object]]] = []
    for g in groups:
        out.extend(iter_event_dicts(g))
    return out
