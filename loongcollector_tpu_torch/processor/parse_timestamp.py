"""processor_parse_timestamp — event-time rewrite from a time field.

Reference: core/plugin/processor/ProcessorParseTimestampNative.cpp
(strptime-class parsing via common/Strptime.h, rewrites event timestamps).

Host execution with a per-batch memo: log streams repeat second-resolution
timestamps heavily, so unique-value caching makes this one strptime per
distinct string.  Where the JAX package raises a PARSE_TIME_FAIL alarm, the
port (no alarm plane yet) counts the failure in ``parse_fail_count`` and
logs one warning per group that had failures.
"""

from __future__ import annotations

import calendar
import time
from typing import Any, Dict

from ..models import PipelineEventGroup
from ..pipeline.plugin.interface import PluginContext, Processor
from ..utils.logger import get_logger
from .common import extract_source

log = get_logger("processor")


class ProcessorParseTimestamp(Processor):
    name = "processor_parse_timestamp_native"

    def __init__(self) -> None:
        super().__init__()
        self.source_key = b"time"
        self.source_format = "%Y-%m-%d %H:%M:%S"
        self.source_timezone_offset = None  # seconds east of UTC, None=local
        self._memo: Dict[bytes, int] = {}
        self.parse_fail_count = 0

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.source_key = config.get("SourceKey", "time").encode()
        self.source_format = config.get("SourceFormat", "%Y-%m-%d %H:%M:%S")
        tz = config.get("SourceTimezone")  # e.g. "GMT+08:00"
        if tz:
            sign = 1 if "+" in tz else -1
            hh_mm = tz.split("+")[-1].split("-")[-1]
            try:
                hh, mm = hh_mm.split(":")
                self.source_timezone_offset = sign * (int(hh) * 3600 + int(mm) * 60)
            except ValueError:
                self.source_timezone_offset = None
        return True

    def _parse_one(self, data: bytes) -> int:
        ts = self._memo.get(data)
        if ts is not None:
            if ts < 0:
                # memoized failure: still counted, once per event
                self.parse_fail_count += 1
            return ts
        try:
            st = time.strptime(data.decode("utf-8", "replace"), self.source_format)
            if self.source_timezone_offset is not None:
                ts = int(calendar.timegm(st)) - self.source_timezone_offset
            else:
                ts = int(time.mktime(st))
        except ValueError:
            ts = -1
            self.parse_fail_count += 1
        if len(self._memo) > 4096:
            self._memo.clear()
        self._memo[data] = ts
        return ts

    def process(self, group: PipelineEventGroup) -> None:
        src = extract_source(group, self.source_key)
        if src is None:
            return
        fails_before = self.parse_fail_count
        if src.columnar:
            raw = src.arena
            tss = group.columns.timestamps
            for i in range(len(src.offsets)):
                if not src.present[i]:
                    continue
                o, ln = int(src.offsets[i]), int(src.lengths[i])
                ts = self._parse_one(raw[o: o + ln].tobytes())
                if ts >= 0:
                    tss[i] = ts
        else:
            for ev in group.events:
                if not hasattr(ev, "get_content"):
                    continue
                v = ev.get_content(self.source_key)
                if v is None:
                    continue
                ts = self._parse_one(v.to_bytes())
                if ts >= 0:
                    ev.timestamp = ts
        failed = self.parse_fail_count - fails_before
        if failed:
            log.warning("timestamp parse failed for %d events (format %r)",
                        failed, self.source_format)
