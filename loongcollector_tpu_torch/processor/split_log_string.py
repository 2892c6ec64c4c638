"""Inner processor: split a raw file chunk into per-line events — columnar.

Reference: core/plugin/processor/inner/ProcessorSplitLogStringNative.cpp —
the file reader emits ONE RawEvent per read chunk (zero-copy,
LogFileReader.cpp:2726); this processor slices it into per-line events.

TPU-first: the output is a ColumnarLogs (offset/length arrays over the SAME
arena) — no per-line Python objects, ready for device batch packing.  Line
boundary discovery is one vectorised numpy pass (np.where on the byte
array), the host-side analogue of a memchr sweep.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np

from ..models import ColumnarLogs, PipelineEventGroup, RawEvent
from ..native import split_lines as native_split
from ..pipeline.plugin.interface import PluginContext, Processor


def split_chunk_spans(arena: np.ndarray, start: int, ln: int,
                      split_char: int):
    """Line spans (offsets int64, lengths int32) of one chunk at
    [start, start+ln) in the arena — native pass with the vectorised
    numpy fallback.  Shared with the file reader's columnar group
    assembly (loongcolumn) so reader-side and processor-side splitting
    cannot diverge."""
    seg = arena[start : start + ln]
    spans = native_split(seg, split_char, start)
    if spans is not None:
        offs, lens = spans
        return offs.astype(np.int64), lens
    nl = np.nonzero(seg == split_char)[0].astype(np.int64)
    # line starts: 0 and nl+1; line ends: nl and ln (if trailing bytes)
    starts = np.concatenate([[0], nl + 1])
    ends = np.concatenate([nl, [ln]])
    # empty lines between separators are kept (reference behaviour);
    # only the zero-length tail produced by a trailing \n is dropped
    if len(starts) > 1 and starts[-1] >= ln:
        starts = starts[:-1]
        ends = ends[:-1]
    return starts + start, (ends - starts).astype(np.int32)


class ProcessorSplitLogString(Processor):
    name = "processor_split_log_string_native"

    def __init__(self) -> None:
        super().__init__()
        self.split_char = ord("\n")
        self.append_new_line_when_missing = False

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        ch = config.get("SplitChar", "\n")
        self.split_char = ord(ch) if isinstance(ch, str) else int(ch)
        return True

    def process(self, group: PipelineEventGroup) -> None:
        if group.columns is not None and not group._events:
            return  # already split
        raw_events = [ev for ev in group.events if isinstance(ev, RawEvent)]
        if not raw_events:
            return
        arena = group.source_buffer.as_array()
        all_offsets: List[np.ndarray] = []
        all_lengths: List[np.ndarray] = []
        all_ts: List[np.ndarray] = []
        now = int(time.time())
        for ev in raw_events:
            sv = ev.content
            if sv is None or sv.length == 0:
                continue
            offs, lens = split_chunk_spans(arena, sv.offset, sv.length,
                                           self.split_char)
            all_offsets.append(offs)
            all_lengths.append(lens)
            ts = ev.timestamp if ev.timestamp else now
            all_ts.append(np.full(len(offs), ts, dtype=np.int64))
        if not all_offsets:
            group.set_columns(ColumnarLogs(np.zeros(0, np.int32),
                                           np.zeros(0, np.int32)))
            return
        cols = ColumnarLogs(
            offsets=np.concatenate(all_offsets).astype(np.int32),
            lengths=np.concatenate(all_lengths),
            timestamps=np.concatenate(all_ts))
        group.set_columns(cols)
