"""Influx line-protocol and (dog)statsd wire decoders.

Reference: pkg/protocol/decoder/influxdb/decoder.go (points → multi-value
metric events) and pkg/protocol/decoder/statsd/ (statsd datagrams), which
back `ext_default_decoder` Format "influxdb"/"statsd" and through it the
telegraf bridge (plugins/input/telegraf/) and jmxfetch statsd ingest
(plugins/input/jmxfetch/manager.go:173).

Both decoders emit MetricEvents: influx points keep their field set as a
multi-value metric named after the measurement; statsd lines become
single-value metrics with dogstatsd #tags.

The port's copy of the JAX package's ``input/metric_protocols.py``: the
same parse, event for event.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from ..models import PipelineEventGroup

_PRECISION_NS = {"ns": 1, "n": 1, "us": 1_000, "u": 1_000, "ms": 1_000_000,
                 "s": 1_000_000_000, "m": 60 * 1_000_000_000,
                 "h": 3600 * 1_000_000_000}


def _unescape(s: str, specials: str) -> str:
    if "\\" not in s:
        return s
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s) and s[i + 1] in specials + "\\":
            out.append(s[i + 1])
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _split_unescaped(s: str, sep: str) -> List[str]:
    """Split on `sep` outside backslash escapes and double quotes."""
    parts: List[str] = []
    cur: List[str] = []
    in_quote = False
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            cur.append(c)
            cur.append(s[i + 1])
            i += 2
            continue
        if c == '"':
            in_quote = not in_quote
        if c == sep and not in_quote:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    parts.append("".join(cur))
    return parts


def _parse_field_value(raw: str) -> Tuple[Optional[float], Optional[str]]:
    """→ (numeric, string): exactly one is non-None."""
    if not raw:
        return None, ""
    if raw[0] == '"':
        body = raw[1:-1] if raw.endswith('"') and len(raw) >= 2 else raw[1:]
        return None, body.replace('\\"', '"').replace("\\\\", "\\")
    if raw in ("t", "T", "true", "True", "TRUE"):
        return 1.0, None
    if raw in ("f", "F", "false", "False", "FALSE"):
        return 0.0, None
    if raw[-1] in "iu":           # 42i / 42u integer suffixes
        raw = raw[:-1]
    try:
        return float(raw), None
    except ValueError:
        return None, raw


def parse_influx_lines(body: bytes, group: PipelineEventGroup,
                       precision: str = "") -> int:
    """Influx line protocol → multi-value MetricEvents in `group`.

    Unparseable lines are skipped (the reference decoder rejects the whole
    batch; per-line skip keeps a telegraf stream alive across one bad
    point).  Returns the number of events added."""
    scale = _PRECISION_NS.get(precision or "ns", 1)
    sb = group.source_buffer
    n = 0
    now_ns = time.time_ns()
    for raw_line in body.splitlines():
        line = raw_line.strip()
        if not line or line.startswith(b"#"):
            continue
        try:
            text = line.decode("utf-8", "replace")
            # measurement[,tags] <space> fields [<space> timestamp]
            head_fields = _split_unescaped(text, " ")
            head_fields = [p for p in head_fields if p != ""]
            if len(head_fields) < 2:
                continue
            head = head_fields[0]
            fields_part = head_fields[1]
            ts_ns = now_ns
            if len(head_fields) >= 3:
                try:
                    ts_ns = int(head_fields[2]) * scale
                except ValueError:
                    pass
            tag_parts = _split_unescaped(head, ",")
            measurement = _unescape(tag_parts[0], ", ")
            tags: Dict[str, str] = {}
            for tp in tag_parts[1:]:
                kv = _split_unescaped(tp, "=")
                if len(kv) == 2:
                    tags[_unescape(kv[0], ",= ")] = _unescape(kv[1], ",= ")
            values: Dict[str, float] = {}
            str_fields: Dict[str, str] = {}
            for fp in _split_unescaped(fields_part, ","):
                kv = _split_unescaped(fp, "=")
                if len(kv) != 2:
                    continue
                key = _unescape(kv[0], ",= ")
                num, s = _parse_field_value(kv[1])
                if num is not None:
                    values[key] = num
                else:
                    str_fields[key] = s or ""
            if not values and not str_fields:
                continue
            ev = group.add_metric_event(int(ts_ns // 1_000_000_000))
            ev.timestamp_ns = ts_ns % 1_000_000_000
            ev.set_name(sb.copy_string(measurement.encode()))
            for k, v in tags.items():
                ev.set_tag(sb.copy_string(k.encode()),
                           sb.copy_string(v.encode()))
            if values:
                ev.set_multi_value(values)
            for k, v in str_fields.items():
                # string fields ride as tags prefixed per the reference's
                # typed-value channel (models.ValueTypeString)
                ev.set_tag(sb.copy_string(("_string_" + k).encode()),
                           sb.copy_string(v.encode()))
            n += 1
        except Exception:  # noqa: BLE001 # loonglint: disable=unledgered-drop
            # one bad point must not kill ingest; the reject happens while
            # the group is still being BUILT — pre-admit, so the event
            # never crossed the ledger's ingest boundary
            continue
    return n


def parse_statsd_packet(body: bytes, group: PipelineEventGroup) -> int:
    """(dog)statsd datagram → MetricEvents.

    `name:v[:v2...]|type[|@rate][|#k:v,k2]`; counters are scaled by
    1/sample-rate like every statsd server.  Returns events added."""
    sb = group.source_buffer
    now = int(time.time())
    n = 0
    for raw_line in body.splitlines():
        line = raw_line.strip()
        if not line:
            continue
        try:
            text = line.decode("utf-8", "replace")
            name_part, _, rest = text.partition(":")
            if not rest:
                continue
            sections = rest.split("|")
            value_part = sections[0]
            mtype = sections[1] if len(sections) > 1 else "g"
            rate = 1.0
            tags: Dict[str, str] = {}
            for extra in sections[2:]:
                if extra.startswith("@"):
                    try:
                        rate = float(extra[1:]) or 1.0
                    except ValueError:
                        pass
                elif extra.startswith("#"):
                    for t in extra[1:].split(","):
                        k, _, v = t.partition(":")
                        if k:
                            tags[k] = v
            for one in value_part.split(":"):
                if mtype == "s":          # set: cardinality marker
                    val = 1.0
                else:
                    try:
                        val = float(one)
                    except ValueError:
                        continue
                if mtype == "c" and rate > 0:
                    val = val / rate
                ev = group.add_metric_event(now)
                ev.set_name(sb.copy_string(name_part.encode()))
                ev.set_value(val)
                ev.set_tag(b"__statsd_type__", sb.copy_string(mtype.encode()))
                for k, v in tags.items():
                    ev.set_tag(sb.copy_string(k.encode()),
                               sb.copy_string(v.encode()))
                n += 1
        except Exception:  # noqa: BLE001 # loonglint: disable=unledgered-drop
            # malformed sample skipped mid-build: pre-admit, never ledgered
            continue
    return n
