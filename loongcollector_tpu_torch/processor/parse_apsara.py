"""processor_parse_apsara — Alibaba Apsara log format parser.

Reference: core/plugin/processor/ProcessorParseApsaraNative.cpp — lines like
  [2024-01-02 03:04:05.123456]\t[LEVEL]\t[thread]\t[file:line]\tk1:v1\tk2:v2
Leading microsecond timestamp in brackets, bracketed level/thread/location,
then tab-separated key:value pairs.  Sets the pipeline topic flag in the
reference (CollectionPipeline.cpp:147-149).

The port's copy of the JAX package's ``processor/parse_apsara.py``.
"""

from __future__ import annotations

import calendar
import time
from typing import Any, Dict

import numpy as np

from ..models import PipelineEventGroup
from ..pipeline.plugin.interface import PluginContext, Processor
from .common import RAW_LOG_KEY, extract_source


class ProcessorParseApsara(Processor):
    name = "processor_parse_apsara_native"
    supports_columnar = True

    def __init__(self) -> None:
        super().__init__()
        self.source_key = b"content"
        self.keep_source_on_fail = True
        self.renamed_source_key = RAW_LOG_KEY
        self.timezone_offset = None
        self._memo: Dict[bytes, int] = {}

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.source_key = config.get("SourceKey", "content").encode()
        self.keep_source_on_fail = bool(config.get("KeepingSourceWhenParseFail", True))
        tz = config.get("SourceTimezone")
        if tz and ("+" in tz or "-" in tz):
            sign = 1 if "+" in tz else -1
            hh_mm = tz.split("+")[-1].split("-")[-1]
            try:
                hh, mm = hh_mm.split(":")
                self.timezone_offset = sign * (int(hh) * 3600 + int(mm) * 60)
            except ValueError:
                self.timezone_offset = None
        return True

    def _parse_time(self, data: bytes) -> int:
        ts = self._memo.get(data)
        if ts is not None:
            return ts
        txt = data.decode("ascii", "replace")
        try:
            if txt.isdigit():  # epoch (s or us)
                ts = int(txt[:10])
            else:
                st = time.strptime(txt[:19], "%Y-%m-%d %H:%M:%S")
                if self.timezone_offset is not None:
                    ts = int(calendar.timegm(st)) - self.timezone_offset
                else:
                    ts = int(time.mktime(st))
        except ValueError:
            ts = -1
        if len(self._memo) > 4096:
            self._memo.clear()
        self._memo[data] = ts
        return ts

    def _parse_line(self, data: bytes):
        """Returns (ts, fields: list[(k, v)]) or None."""
        if not data.startswith(b"["):
            return None
        end = data.find(b"]")
        if end < 0:
            return None
        ts = self._parse_time(data[1:end])
        if ts < 0:
            return None
        fields = []
        rest = data[end + 1:]
        # bracketed positional fields: level, thread, file:line
        positional = [b"__LEVEL__", b"__THREAD__", b"__FILE__"]
        pi = 0
        while rest.startswith(b"\t[") and pi < len(positional):
            e = rest.find(b"]")
            if e < 0:
                break
            val = rest[2:e]
            if pi == 2 and b":" in val:
                f, _, ln = val.rpartition(b":")
                fields.append((b"__FILE__", f))
                fields.append((b"__LINE__", ln))
            else:
                fields.append((positional[pi], val))
            pi += 1
            rest = rest[e + 1:]
        for part in rest.split(b"\t"):
            if not part:
                continue
            k, sep, v = part.partition(b":")
            if sep:
                fields.append((k, v))
        return ts, fields

    def process(self, group: PipelineEventGroup) -> None:
        src = extract_source(group, self.source_key)
        if src is None:
            return
        sb = group.source_buffer
        if src.columnar:
            cols = group.columns
            n = len(src.offsets)
            raw = src.arena
            field_offs: Dict[bytes, "np.ndarray"] = {}
            field_lens: Dict[bytes, "np.ndarray"] = {}
            ok = np.zeros(n, dtype=bool)
            for i in range(n):
                if not src.present[i]:
                    continue
                o, ln = int(src.offsets[i]), int(src.lengths[i])
                parsed = self._parse_line(raw[o : o + ln].tobytes())
                if parsed is None:
                    continue
                ok[i] = True
                ts, fields = parsed
                cols.timestamps[i] = ts
                for k, v in fields:
                    if k not in field_offs:
                        field_offs[k] = np.zeros(n, dtype=np.int32)
                        field_lens[k] = np.full(n, -1, dtype=np.int32)
                    view = sb.copy_string(v)
                    field_offs[k][i] = view.offset
                    field_lens[k][i] = view.length
            for k in field_offs:
                cols.set_field(k.decode("utf-8", "replace"),
                               field_offs[k], field_lens[k])
            if self.keep_source_on_fail and (~ok & src.present).any():
                cols.set_field(self.renamed_source_key,
                               src.offsets.astype("int32"),
                               np.where(~ok & src.present, src.lengths,
                                        -1).astype("int32"))
            cols.parse_ok = ok
            if src.from_content:
                cols.content_consumed = True
            return
        from .common import finish_row_keep
        renamed = self.renamed_source_key.encode()
        for ev in group.events:
            if not hasattr(ev, "get_content"):
                continue
            raw = ev.get_content(self.source_key)
            if raw is None:
                continue
            parsed = self._parse_line(raw.to_bytes())
            if parsed is None:
                # shared reference ordering: the source is consumed either
                # way; keep_fail re-adds it under the renamed key
                finish_row_keep(ev, raw, False, self.source_key, False,
                                self.keep_source_on_fail, False, renamed)
                continue
            ts, fields = parsed
            ev.timestamp = ts
            overwritten = False
            for k, val in fields:
                kb = k if isinstance(k, bytes) else k.encode()
                ev.set_content(sb.copy_string(kb), sb.copy_string(val))
                if kb == self.source_key:
                    overwritten = True
            finish_row_keep(ev, raw, True, self.source_key, overwritten,
                            self.keep_source_on_fail, False, renamed)
