"""Hand-rolled SLS LogGroup protobuf wire serializer.

Reference: core/collection_pipeline/serializer/SLSSerializer.cpp:162,221-245
and core/protobuf/sls/LogGroupSerializer.cpp — the reference writes protobuf
wire bytes directly (no intermediate PB objects) for speed; we do the same.

Wire schema (public sls_logs.proto):
  Log      { uint32 Time = 1; repeated Content Contents = 2;
             fixed32 Time_ns = 4; }
  Content  { string Key = 1; string Value = 2; }
  LogTag   { string Key = 1; string Value = 2; }
  LogGroup { repeated Log Logs = 1; string Category = 2; string Topic = 3;
             string Source = 4; string MachineUUID = 5;
             repeated LogTag LogTags = 6; }

Columnar fast path serializes straight from field span columns.

The port's copy of the JAX package's
``pipeline/serializer/sls_serializer.py`` (the wire bytes of
``flusher_http``'s ``Format: sls_pb``), on the port's native
``sls_serialize``.
"""

from __future__ import annotations

from typing import List, Optional

from ...models import LogEvent, PipelineEventGroup


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_delim(field_no: int, payload: bytes) -> bytes:
    return _varint((field_no << 3) | 2) + _varint(len(payload)) + payload


def _kv(key: bytes, value: bytes) -> bytes:
    # Content/LogTag share the {Key=1, Value=2} shape
    return (b"\x0a" + _varint(len(key)) + key
            + b"\x12" + _varint(len(value)) + value)


class SLSEventGroupSerializer:
    name = "sls"

    def __init__(self, topic: bytes = b"", source: bytes = b"",
                 machine_uuid: bytes = b""):
        self.topic = topic
        self.source = source
        self.machine_uuid = machine_uuid

    def serialize(self, groups: List[PipelineEventGroup]) -> bytes:
        return b"".join(self._parts(groups))

    def _parts(self, groups: List[PipelineEventGroup]) -> List:
        # parts are joined exactly once by the caller; the native payload
        # part is a memoryview over the native output buffer (zero interim
        # copies)
        parts: List = []
        for group in groups:
            cols = group.columns
            # columnar fast path also covers the raw-tail case (no parsed
            # fields, just content spans) — falling through there would
            # materialize every line into a Python event (the reference's
            # 546 MB/s simple-line scenario lives on this path)
            if cols is not None and not group._events \
                    and (cols.fields or not cols.content_consumed):
                data = self._native_logs(group, cols)
                if data is not None:
                    parts.append(data)
                else:
                    buf = bytearray()
                    self._python_logs_from_columns(group, buf)
                    parts.append(buf)
            else:
                # canonical row fallback: groups that arrived materialized
                for ev in group.events:
                    if isinstance(ev, LogEvent):
                        parts.append(_len_delim(1, self._log(ev)))
            for k, v in group.tags.items():
                parts.append(_len_delim(6, _kv(k, v.to_bytes())))
        if self.topic:
            parts.append(_len_delim(3, self.topic))
        if self.source:
            parts.append(_len_delim(4, self.source))
        if self.machine_uuid:
            parts.append(_len_delim(5, self.machine_uuid))
        return parts

    def serialize_view(self, groups: List[PipelineEventGroup]):
        """Like serialize(), but may return a memoryview over the native
        output buffer when the payload is a single part (no tags/topic) —
        hot sinks (blackhole, SLS→LZ4) avoid one full-payload copy.  The
        result supports len()/buffer protocol but NOT bytes concatenation."""
        parts = self._parts(groups)
        if len(parts) == 1:
            return parts[0]
        return b"".join(parts)

    def _log(self, ev: LogEvent) -> bytes:
        body = bytearray(b"\x08" + _varint(ev.timestamp & 0xFFFFFFFF))
        for k, v in ev.contents:
            body += _len_delim(2, _kv(k.to_bytes(), v.to_bytes()))
        return bytes(body)

    @staticmethod
    def _columnar_spans(cols):
        names = [(n.encode() if isinstance(n, str) else n)
                 for n in cols.fields if n != "_partial_"]
        spans = [cols.fields[n] for n in cols.fields if n != "_partial_"]
        if not cols.content_consumed and b"content" not in names:
            names.insert(0, b"content")
            spans.insert(0, (cols.offsets, cols.lengths))
        return names, spans

    def _python_logs_from_columns(self, group: PipelineEventGroup,
                                  out: bytearray) -> None:
        cols = group.columns
        raw = group.source_buffer.raw
        names, spans = self._columnar_spans(cols)
        key_prefix = [b"\x0a" + _varint(len(n)) + n for n in names]
        tss = cols.timestamps
        for i in range(len(cols)):
            body = bytearray(b"\x08" + _varint(int(tss[i]) & 0xFFFFFFFF))
            for kp, (offs, lens) in zip(key_prefix, spans):
                ln = int(lens[i])
                if ln >= 0:
                    o = int(offs[i])
                    val = bytes(raw[o : o + ln])
                    content = kp + b"\x12" + _varint(ln) + val
                    body += b"\x12" + _varint(len(content)) + content
            out += b"\x0a" + _varint(len(body)) + body

    @staticmethod
    def _matrix_is_current(cols, m) -> bool:
        """The span_matrix fast path is valid only while cols.fields still
        IS the matrix: same names, same column-view tuples (by identity).
        Processors that mutate cols.fields directly (rename / drop /
        replace) bypass set_field's invalidation — detect that here instead
        of trusting the handle."""
        names, _off_mat, _len_mat, views = m
        if len(cols.fields) != len(names):
            return False
        for name, view in zip(names, views):
            if cols.fields.get(name) is not view:
                return False
        return True

    @classmethod
    def _native_logs(cls, group: PipelineEventGroup, cols):
        import numpy as _np

        from ... import native as _native
        if _native.get_lib() is None:
            return None
        m = cols.span_matrix
        if m is not None and cols.content_consumed \
                and cls._matrix_is_current(cols, m):
            # parse-kernel matrices cover the fields exactly: serialize the
            # [N, F] layout in place, no transpose/stack
            names, off_mat, len_mat, _views = m
            names = [(n.encode() if isinstance(n, str) else n)
                     for n in names]
            return _native.sls_serialize(group.source_buffer.as_array(),
                                         cols.timestamps, names,
                                         off_mat, len_mat, event_major=True)
        names, spans = cls._columnar_spans(cols)
        if not names:
            return None
        field_offs = _np.stack([s[0] for s in spans])
        field_lens = _np.stack([s[1] for s in spans])
        return _native.sls_serialize(group.source_buffer.as_array(),
                                     cols.timestamps, names,
                                     field_offs, field_lens)


def parse_loggroup(data: bytes, group: Optional[PipelineEventGroup] = None
                   ) -> PipelineEventGroup:
    """Decode LogGroup wire bytes back into an event group (the ingest-side
    mirror of the serializer; reference ProcessorParseFromPBNative decodes
    PB-transferred groups on the forward path).  Passing `group` decodes
    straight into its SourceBuffer — the forward path copies each string
    exactly once."""

    def read_varint(buf: bytes, i: int):
        shift = v = 0
        while True:
            b = buf[i]
            i += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v, i
            shift += 7

    def read_delim(buf: bytes, i: int):
        ln, i = read_varint(buf, i)
        if i + ln > len(buf):
            raise ValueError("truncated length-delimited field")
        return buf[i : i + ln], i + ln

    def parse_kv(buf: bytes):
        """{Key=1, Value=2} message (Content / LogTag share the shape)."""
        k = v = b""
        c = 0
        while c < len(buf):
            t3, c = read_varint(buf, c)
            payload, c = read_delim(buf, c)
            if t3 >> 3 == 1:
                k = payload
            elif t3 >> 3 == 2:
                v = payload
        return k, v

    if group is None:
        group = PipelineEventGroup()
    sb = group.source_buffer
    i = 0
    n = len(data)
    while i < n:
        tag, i = read_varint(data, i)
        fno, wt = tag >> 3, tag & 7
        if wt == 2:
            payload, i = read_delim(data, i)
            if fno == 1:        # Log — ingest-side DECODE, not the wire
                # hot path: PB-transferred rows become events by design
                ev = group.add_log_event(0)
                j = 0
                while j < len(payload):
                    t2, j = read_varint(payload, j)
                    f2, w2 = t2 >> 3, t2 & 7
                    if f2 == 1 and w2 == 0:       # Time
                        ts, j = read_varint(payload, j)
                        ev.timestamp = ts
                    elif f2 == 2 and w2 == 2:     # Content
                        content, j = read_delim(payload, j)
                        k, v = parse_kv(content)
                        ev.set_content(sb.copy_string(k), sb.copy_string(v))
                    elif w2 == 2:
                        _, j = read_delim(payload, j)
                    elif w2 == 0:
                        _, j = read_varint(payload, j)
                    elif w2 == 5:
                        j += 4
                    else:
                        j += 8
            elif fno == 3:      # Topic
                group.set_tag(b"__topic__", payload)
            elif fno == 4:      # Source
                group.set_tag(b"__source__", payload)
            elif fno == 6:      # LogTag
                k, v = parse_kv(payload)
                group.set_tag(k, v)
        elif wt == 0:
            _, i = read_varint(data, i)
        elif wt == 5:
            i += 4
        else:
            i += 8
    return group
