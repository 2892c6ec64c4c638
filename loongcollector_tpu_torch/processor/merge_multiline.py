"""Inner processor: merge partial lines (container stdout continuation).

Reference: core/plugin/processor/inner/ProcessorMergeMultilineLogNative.cpp —
MergeType "regex" (same start/continue semantics as the splitter) or "flag"
(merge events marked partial by the container-log parser until one is final).

The port's copy of the JAX package's ``processor/merge_multiline.py``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..models import ColumnarLogs, PipelineEventGroup
from ..pipeline.plugin.interface import PluginContext, Processor
from .split_multiline import ProcessorSplitMultilineLogString

PARTIAL_FLAG_FIELD = "_partial_"


class ProcessorMergeMultilineLog(Processor):
    name = "processor_merge_multiline_log_native"
    supports_columnar = True
    requires_columnar = True

    def __init__(self) -> None:
        super().__init__()
        self.merge_type = "regex"
        self._regex_impl = ProcessorSplitMultilineLogString()

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.merge_type = config.get("MergeType", "regex")
        if self.merge_type == "regex":
            return self._regex_impl.init(config, context)
        return True

    def process(self, group: PipelineEventGroup) -> None:
        if self.merge_type == "regex":
            self._regex_impl.process(group)
            return
        # flag mode: merge consecutive partial events (columnar)
        cols = group.columns
        if cols is None or group._events:
            return
        flags = cols.fields.get(PARTIAL_FLAG_FIELD)
        if flags is None:
            return
        _, flag_lens = flags
        partial = flag_lens >= 0
        n = len(cols)
        offs = cols.offsets.astype(np.int64)
        lens = cols.lengths.astype(np.int64)
        sb = group.source_buffer
        arena = group.source_buffer.as_array()
        records = []
        i = 0
        while i < n:
            j = i
            while j < n and partial[j]:
                j += 1
            last = min(j, n - 1)
            if last == i:
                records.append((i, int(offs[i]), int(lens[i])))
            else:
                # copy-concatenate the partial pieces (they are separated by
                # CRI prefixes in the arena, so span arithmetic cannot apply)
                parts = [arena[int(offs[k]): int(offs[k] + lens[k])].tobytes()
                         for k in range(i, last + 1)]
                view = sb.copy_string(b"".join(parts))
                records.append((i, view.offset, view.length))
            i = last + 1
        out = ColumnarLogs(
            offsets=np.array([r[1] for r in records], dtype=np.int32),
            lengths=np.array([r[2] for r in records], dtype=np.int32),
            timestamps=np.array([cols.timestamps[r[0]] for r in records],
                                dtype=np.int64))
        for name, (foffs, flens) in cols.fields.items():
            if name == PARTIAL_FLAG_FIELD:
                continue
            out.set_field(name,
                          np.array([foffs[r[0]] for r in records], np.int32),
                          np.array([flens[r[0]] for r in records], np.int32))
        group.set_columns(out)
