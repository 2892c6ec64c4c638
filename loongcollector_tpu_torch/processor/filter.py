"""processor_filter — keep/drop events by field regex conditions.

Reference: core/plugin/processor/ProcessorFilterNative.cpp — Include map
(field → full-match regex, all must match) and Exclude map (any match
drops) — and the JAX package's ``processor/filter.py``, whose staged path
this is.  Each condition is one ``RegexEngine.match_batch`` over the
field's spans on the pipeline's device (K1 for a Tier-1 pattern, K2 for a
DFA-tier one); columnar groups drop events by boolean-mask compaction of
the span columns.  Left out: the fused-pipeline stage
(``fused_stage_spec``), which is K3's and K7's.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..models import ColumnarLogs, PipelineEventGroup
from ..ops.regex.engine import RegexEngine, get_engine
from ..pipeline.plugin.interface import PluginContext, Processor
from .common import extract_source


def compact_columns(cols: ColumnarLogs, keep: np.ndarray) -> ColumnarLogs:
    out = ColumnarLogs(cols.offsets[keep], cols.lengths[keep],
                       cols.timestamps[keep])
    for name, (offs, lens) in cols.fields.items():
        out.set_field(name, offs[keep], lens[keep])
    if cols.parse_ok is not None:
        out.parse_ok = cols.parse_ok[keep]
    out.content_consumed = cols.content_consumed
    return out


class ProcessorFilter(Processor):
    name = "processor_filter_native"

    def __init__(self) -> None:
        super().__init__()
        self.include: List = []   # [(key bytes, engine)]
        self.exclude: List = []

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        dev = context.device
        for k, pattern in (config.get("Include") or {}).items():
            self.include.append((k.encode(), get_engine(pattern, dev)))
        for k, pattern in (config.get("Exclude") or {}).items():
            self.exclude.append((k.encode(), get_engine(pattern, dev)))
        return True

    def _match_field(self, group: PipelineEventGroup, key: bytes,
                     engine: RegexEngine, n: int) -> np.ndarray:
        src = extract_source(group, key)
        if src is None:
            return np.zeros(n, dtype=bool)
        ok = engine.match_batch(src.arena, src.offsets, src.lengths)
        return ok & src.present

    def process(self, group: PipelineEventGroup) -> None:
        n = len(group)
        if n == 0:
            return
        keep = np.ones(n, dtype=bool)
        for key, engine in self.include:
            keep &= self._match_field(group, key, engine, n)
        for key, engine in self.exclude:
            keep &= ~self._match_field(group, key, engine, n)
        if keep.all():
            return
        cols = group.columns
        if cols is not None and not group._events:
            group.set_columns(compact_columns(cols, keep))
        else:
            group._events = [ev for i, ev in enumerate(group.events) if keep[i]]
