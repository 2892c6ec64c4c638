"""Inner processor: containerd / docker-json stdout unwrap — columnar.

Reference: core/plugin/processor/inner/ProcessorParseContainerLogNative.cpp
(and the reader's per-format GetLastLine parsers, LogFileReader.cpp:2401-2525):

containerd (CRI) lines:  `2024-01-02T03:04:05.999999999Z stdout P partial…`
  → time, stream (stdout/stderr), flag (P = partial, F = full), content
docker json-file lines:  `{"log":"…\\n","stream":"stdout","time":"…"}`

Partial CRI lines mark `_partial_` for the downstream merge processor
(processor_merge_multiline_log_native, flag mode).

Columnar: the CRI unwrap is span arithmetic over the columnar form — the
timestamp/stream/flag fields sit at delimiter-separated offsets, so the
content span is the original arena span minus a computed prefix; no copies.

The port's copy of the JAX package's ``processor/parse_container_log.py``.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

from ..models import ColumnarLogs, PipelineEventGroup
from ..pipeline.plugin.interface import PluginContext, Processor
from .merge_multiline import PARTIAL_FLAG_FIELD

_STDOUT = b"stdout"
_STDERR = b"stderr"


class ProcessorParseContainerLog(Processor):
    name = "processor_parse_container_log_native"
    supports_columnar = True
    requires_columnar = True

    def __init__(self) -> None:
        super().__init__()
        self.format = "containerd_text"  # or docker_json-file
        self.ignore_stdout = False
        self.ignore_stderr = False
        self.keep_time = False  # KeepTimestamp: emit _time_ (CRI time span)

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.format = config.get("Format", "containerd_text")
        self.ignore_stdout = bool(config.get("IgnoringStdout", False))
        self.ignore_stderr = bool(config.get("IgnoringStderr", False))
        self.keep_time = bool(config.get("KeepTimestamp", False))
        return True

    def process(self, group: PipelineEventGroup) -> None:
        cols = group.columns
        if cols is None or group._events:
            return
        if self.format == "docker_json-file":
            self._process_docker_json(group, cols)
        else:
            self._process_cri(group, cols)

    # -- containerd CRI text ------------------------------------------------

    def _process_cri(self, group: PipelineEventGroup, cols: ColumnarLogs) -> None:
        arena = group.source_buffer.as_array()
        n = len(cols)
        offs = cols.offsets.astype(np.int64)
        lens = cols.lengths.astype(np.int64)
        keep = np.ones(n, dtype=bool)
        new_offs = cols.offsets.copy()
        new_lens = cols.lengths.copy()
        part_offs = np.zeros(n, dtype=np.int32)
        part_lens = np.full(n, -1, dtype=np.int32)
        stream_offs = np.zeros(n, dtype=np.int32)
        stream_lens = np.full(n, -1, dtype=np.int32)
        time_offs = np.zeros(n, dtype=np.int32)
        time_lens = np.full(n, -1, dtype=np.int32)
        sb = group.source_buffer
        sv_stdout = sb.copy_string(_STDOUT)
        sv_stderr = sb.copy_string(_STDERR)
        sv_partial = sb.copy_string(b"P")
        for i in range(n):
            o, ln = int(offs[i]), int(lens[i])
            line = arena[o : o + ln].tobytes()
            sp1 = line.find(b" ")
            if sp1 < 0:
                continue  # not CRI: leave as-is
            sp2 = line.find(b" ", sp1 + 1)
            if sp2 < 0:
                continue
            stream = line[sp1 + 1 : sp2]
            if stream not in (_STDOUT, _STDERR):
                continue
            if (stream == _STDOUT and self.ignore_stdout) or \
               (stream == _STDERR and self.ignore_stderr):
                keep[i] = False
                continue
            sp3 = line.find(b" ", sp2 + 1)
            flag = line[sp2 + 1 : sp3] if sp3 > 0 else b"F"
            content_start = (sp3 + 1) if sp3 > 0 and flag in (b"P", b"F") else sp2 + 1
            new_offs[i] = o + content_start
            new_lens[i] = ln - content_start
            if flag == b"P":
                part_offs[i] = sv_partial.offset
                part_lens[i] = sv_partial.length
            if self.keep_time:
                time_offs[i] = o
                time_lens[i] = sp1  # zero-copy CRI timestamp span
            sv = sv_stdout if stream == _STDOUT else sv_stderr
            stream_offs[i] = sv.offset
            stream_lens[i] = sv.length
        cols.offsets = new_offs
        cols.lengths = new_lens
        cols.set_field(PARTIAL_FLAG_FIELD, part_offs, part_lens)
        cols.set_field("_source_", stream_offs, stream_lens)
        if self.keep_time:
            cols.set_field("_time_", time_offs, time_lens)
        if not keep.all():
            from .filter import compact_columns
            group.set_columns(compact_columns(cols, keep))

    # -- docker json-file ---------------------------------------------------

    def _process_docker_json(self, group: PipelineEventGroup,
                             cols: ColumnarLogs) -> None:
        arena = group.source_buffer.as_array()
        sb = group.source_buffer
        n = len(cols)
        keep = np.ones(n, dtype=bool)
        new_offs = cols.offsets.copy()
        new_lens = cols.lengths.copy()
        stream_offs = np.zeros(n, dtype=np.int32)
        stream_lens = np.full(n, -1, dtype=np.int32)
        for i in range(n):
            o, ln = int(cols.offsets[i]), int(cols.lengths[i])
            try:
                # docker json-file rows ({log,stream,time}) parse one at a
                # time on the host, as in the JAX package
                obj = json.loads(arena[o : o + ln].tobytes())
            except ValueError:
                continue
            stream = obj.get("stream", "stdout")
            if (stream == "stdout" and self.ignore_stdout) or \
               (stream == "stderr" and self.ignore_stderr):
                keep[i] = False
                continue
            content = obj.get("log", "")
            if content.endswith("\n"):
                content = content[:-1]
            view = sb.copy_string(content)
            new_offs[i] = view.offset
            new_lens[i] = view.length
            svs = sb.copy_string(stream)
            stream_offs[i] = svs.offset
            stream_lens[i] = svs.length
        cols.offsets = new_offs
        cols.lengths = new_lens
        cols.set_field("_source_", stream_offs, stream_lens)
        if not keep.all():
            from .filter import compact_columns
            group.set_columns(compact_columns(cols, keep))
