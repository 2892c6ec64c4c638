"""flusher_prometheus — Prometheus remote-write 1.0 sink.

Reference: plugins/flusher/prometheus/ (Go remote-write client). Wire
format (public spec): snappy-block-compressed protobuf WriteRequest —

    WriteRequest { repeated TimeSeries timeseries = 1; }
    TimeSeries   { repeated Label labels = 1; repeated Sample samples = 2; }
    Label        { string name = 1; string value = 2; }
    Sample       { double value = 1; int64 timestamp = 2; }  // ms

The protobuf writer is hand-rolled (same approach as the SLS serializer —
no intermediate PB objects); snappy rides the native lib's block codec.
MetricEvents map 1:1; LOG-kind events are skipped (remote write carries
samples only).

The port's copy of the JAX package's ``flusher/prometheus_rw.py``, with
its columnar rollup route (``_columnar_series``) and its dict route
(``_rollup_series_from_events``); snappy is the port's native binding.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

from ..models import MetricEvent, PipelineEventGroup
from .http_base import HttpSinkFlusher, basic_auth_header


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited field."""
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _label(name: bytes, value: bytes) -> bytes:
    return _ld(1, _ld(1, name) + _ld(2, value))


def _sample(value: float, ts_ms: int) -> bytes:
    body = bytes([0x09]) + struct.pack("<d", value)          # field 1 fixed64
    body += _varint((2 << 3) | 0) + _varint(ts_ms & (2**64 - 1))
    return _ld(2, body)


def encode_write_request(series: List[Tuple[List[Tuple[bytes, bytes]],
                                            float, int]]) -> bytes:
    """series: [(labels, value, ts_ms)]; labels must include __name__."""
    out = bytearray()
    for labels, value, ts_ms in series:
        ts_body = bytearray()
        # spec: labels sorted by name, __name__ first naturally ('_' < alpha)
        for name, val in sorted(labels):
            ts_body += _label(name, val)
        ts_body += _sample(value, ts_ms)
        out += _ld(1, bytes(ts_body))
    return bytes(out)


#: rollup columns that are NOT label columns in the remote-write mapping
_AGG_VALUE_FIELDS = {"sum", "count", "min", "max", "last"}
_AGG_META_FIELDS = _AGG_VALUE_FIELDS | {"hist", "window_start",
                                        "window_end"}


class FlusherPrometheus(HttpSinkFlusher):
    name = "flusher_prometheus"
    content_type = "application/x-protobuf"
    #: loongagg: rollup groups arrive as span columns and serialize
    #: straight into the WriteRequest — no per-event materialization
    supports_columnar = True

    def _init_sink(self, config: Dict[str, Any]) -> bool:
        self.endpoint = config.get("Endpoint", "")
        self.auth = basic_auth_header(config)
        from ..pipeline.compression import SnappyCompressor
        try:
            self._snappy = SnappyCompressor()
            self._snappy.compress(b"probe")
        except RuntimeError:
            return False        # remote write REQUIRES snappy
        return bool(self.endpoint)

    def init(self, config, context) -> bool:
        ok = super().init(config, context)
        if ok:
            # the base compressor must NOT double-compress: snappy is applied
            # here (it is part of the protocol, not a negotiated encoding)
            from ..pipeline.compression import Compressor
            self.compressor = Compressor()
        return ok

    def _columnar_series(self, g: PipelineEventGroup, series: list) -> bool:
        """loongagg rollup groups: one sample per aggregate column per
        row, named ``<metric>_sum`` / ``_count`` / ``_min`` / ``_max`` /
        ``_last`` (the remote-write shape of a windowed rollup), labels
        read as spans from the columnar arena.  Returns False when the
        group is not a rollup (the caller falls back to the per-event
        route).  Gated on the ``__rollup__`` tag the aggregator stamps —
        shape-sniffing field names would misserialize ordinary columnar
        log groups whose parsed fields happen to be called "count"."""
        if g.get_tag(b"__rollup__") is None:
            return False
        cols = g.columns
        if cols is None or g._events:
            return self._rollup_series_from_events(g, series)
        fields = cols.fields
        name_pair = None
        label_cols = []
        agg_cols = []
        for fname, pair in fields.items():
            key = fname if isinstance(fname, str) else fname.decode(
                "utf-8", "replace")
            if key == "__name__":
                name_pair = pair
            elif key in _AGG_VALUE_FIELDS:
                agg_cols.append((("_" + key).encode(), pair))
            elif key not in _AGG_META_FIELDS:
                label_cols.append((key.encode(), pair))
        if name_pair is None or not agg_cols:
            return False
        raw = g.source_buffer.raw

        def span(pair, r):
            off, ln = int(pair[0][r]), int(pair[1][r])
            if ln < 0:
                return None
            return bytes(raw[off:off + ln])

        ts = cols.timestamps
        for r in range(len(cols)):
            name = span(name_pair, r)
            if name is None:
                continue
            base = []
            for lk, pair in label_cols:
                lv = span(pair, r)
                if lv is not None:
                    base.append((lk, lv))
            ts_ms = int(ts[r]) * 1000
            for suffix, pair in agg_cols:
                sv = span(pair, r)
                if sv is None:
                    continue
                try:
                    value = float(sv)
                except ValueError:
                    continue
                series.append(([(b"__name__", name + suffix)] + base,
                               value, ts_ms))
        return True

    def _rollup_series_from_events(self, g: PipelineEventGroup,
                                   series: list) -> bool:
        """Dict-mode route for the same rollup groups: the sink boundary
        materialized the rows into LogEvents (``LOONG_COLUMNAR=0``), so
        the per-event MetricEvent route would silently discard them —
        read the rollup contents off the LogEvents instead."""
        from ..models import LogEvent
        for ev in g.events:
            if not isinstance(ev, LogEvent):
                continue
            name = ev.get_content(b"__name__")
            if name is None:
                continue
            name = bytes(name)
            base = []
            agg_vals = []
            for k, v in ev.contents:
                kb = bytes(k)
                key = kb.decode("utf-8", "replace")
                if kb == b"__name__":
                    continue
                if key in _AGG_VALUE_FIELDS:
                    try:
                        agg_vals.append((b"_" + kb, float(bytes(v))))
                    except ValueError:
                        continue
                elif key not in _AGG_META_FIELDS:
                    base.append((kb, bytes(v)))
            ts_ms = int(ev.timestamp) * 1000
            for suffix, value in agg_vals:
                series.append(([(b"__name__", name + suffix)] + base,
                               value, ts_ms))
        return True

    def build_payload(self, groups: List[PipelineEventGroup]
                      ) -> Optional[Tuple[bytes, Dict[str, str]]]:
        series = []
        for g in groups:
            if self._columnar_series(g, series):
                continue
            for ev in g.events:
                if not isinstance(ev, MetricEvent):
                    continue
                name = bytes(ev.name) if ev.name else b""
                base = [(b"__name__", name)]
                base += [(bytes(k), bytes(str(v).encode()
                                          if not isinstance(v, bytes) else v))
                         for k, v in ev.tags.items()]
                ts_ms = ev.timestamp * 1000
                if ev.value.is_multi():
                    for sub, val in ev.value.values.items():
                        labels = [(b"__name__", name + b"_" + sub)] + base[1:]
                        series.append((labels, float(val), ts_ms))
                else:
                    series.append((base, float(ev.value.value), ts_ms))
        if not series:
            return None
        body = self._snappy.compress(encode_write_request(series))
        headers = dict(self.auth)
        headers["Content-Encoding"] = "snappy"
        headers["X-Prometheus-Remote-Write-Version"] = "0.1.0"
        return body, headers

    def endpoint_url(self, item) -> str:
        return self.endpoint
