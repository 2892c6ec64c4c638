"""processor_timestamp_filter — drop events outside a time window.

Reference: core/plugin/processor/ProcessorTimestampFilterNative.cpp (260 LoC)
— relative or absolute bounds on event time.  Columnar path is a pure
vectorised compare + compaction.

The port's copy of the JAX package's ``processor/timestamp_filter.py``.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np

from ..models import PipelineEventGroup
from ..pipeline.plugin.interface import PluginContext, Processor
from .filter import compact_columns


class ProcessorTimestampFilter(Processor):
    name = "processor_timestamp_filter_native"
    supports_columnar = True

    def __init__(self) -> None:
        super().__init__()
        self.start = None   # absolute epoch seconds
        self.end = None
        self.relative_window = None  # keep events within last N seconds

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        if "StartTime" in config:
            self.start = int(config["StartTime"])
        if "EndTime" in config:
            self.end = int(config["EndTime"])
        if "RelativeWindowSeconds" in config:
            self.relative_window = int(config["RelativeWindowSeconds"])
        return (self.start is not None or self.end is not None
                or self.relative_window is not None)

    def process(self, group: PipelineEventGroup) -> None:
        now = int(time.time())
        lo = self.start if self.start is not None else -(1 << 62)
        hi = self.end if self.end is not None else (1 << 62)
        if self.relative_window is not None:
            lo = max(lo, now - self.relative_window)
        cols = group.columns
        if cols is not None and not group._events:
            ts = cols.timestamps
            keep = (ts >= lo) & (ts <= hi)
            if not keep.all():
                group.set_columns(compact_columns(cols, np.asarray(keep)))
            return
        group._events = [ev for ev in group.events
                         if lo <= ev.timestamp <= hi]
