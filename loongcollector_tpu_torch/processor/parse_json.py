"""processor_parse_json — expand a JSON-object field into event fields.

Reference: core/plugin/processor/ProcessorParseJsonNative.cpp (rapidjson
parse of one key into fields, keep/discard semantics shared with regex
parser).

Execution (loongstruct): columnar groups parse on the structural-index
plane — `lct_json_struct_parse` classifies every row into per-bit
structural bitmaps (simdjson-style escape-carry + in-string prefix-XOR)
and emits field spans straight from the index, so schema-stable AND
schema-drifting AND escape-bearing rows all stay on the columnar
zero-materialization path: string values keep zero-copy spans, escaped
values decode ONCE into a per-group side arena (appended to the source
buffer in one allocation, never per event), unknown keys install from the
CSR extras stream.  Rows the index cannot prove well-formed fall back to
per-row `json.loads` — counted in `parse_fallback_rows_total` and alarmed
via PARSE_FALLBACK_DEGRADED when sustained (docs/performance.md
"Structural-index parsing").  Values are raw source tokens
(numbers/bools keep their source spelling); the fallback canonicalises
via str()/json.dumps — the two differ only in number/whitespace spelling
of unusual inputs.  ``LOONG_STRUCT=0`` disables the structural plane
(the pre-loongstruct schema-discovery path; the bench's r09-style
comparator).

The port's copy of the JAX package's ``processor/parse_json.py``; both
planes run the repo's native host library through the port's bridge.
Fallback rows are counted in ``parse_telemetry``, which the port logs
instead of alarming.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

from ..models import ColumnarLogs, PipelineEventGroup
from ..pipeline.plugin.interface import PluginContext, Processor
from .common import RAW_LOG_KEY, extract_source


def _struct_enabled() -> bool:
    return os.environ.get("LOONG_STRUCT", "1") != "0"


class ProcessorParseJson(Processor):
    name = "processor_parse_json_tpu"
    supports_columnar = True

    def __init__(self) -> None:
        super().__init__()
        self.source_key = b"content"
        self.keep_source_on_fail = True
        self.keep_source_on_success = False
        self.renamed_source_key = RAW_LOG_KEY
        self._pipeline = ""
        self._struct = _struct_enabled()

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.source_key = config.get("SourceKey", "content").encode()
        self.keep_source_on_fail = bool(config.get("KeepingSourceWhenParseFail", True))
        self.keep_source_on_success = bool(config.get("KeepingSourceWhenParseSucceed", False))
        self.renamed_source_key = config.get("RenamedSourceKey", RAW_LOG_KEY)
        self._pipeline = getattr(context, "pipeline_name", "") or ""
        self._struct = _struct_enabled()
        return True

    def process(self, group: PipelineEventGroup) -> None:
        src = extract_source(group, self.source_key)
        if src is None:
            return
        n = len(src.offsets)
        if src.columnar:
            cols = group.columns
            ok = np.zeros(n, dtype=bool)
            field_offs: Dict[str, np.ndarray] = {}
            field_lens: Dict[str, np.ndarray] = {}
            raw = src.arena

            todo = np.nonzero(src.present)[0]
            keys = self._discover_schema(raw, src, todo)
            handled = False
            drift_rows = 0
            if keys is not None and self._struct:
                handled, drift_rows = self._process_struct(
                    group, src, raw, keys, ok, field_offs, field_lens)
            if not handled and keys is not None:
                # r09-style plane (LOONG_STRUCT=0 / native unavailable):
                # one stable-schema native pass, everything else per row
                from .. import native as _native
                res = _native.json_extract(raw, src.offsets, src.lengths,
                                           keys)
                if res is not None:
                    f_offs, f_lens, c_ok, _ = res
                    c_ok = c_ok & src.present
                    for fi, k in enumerate(keys):
                        name = k.decode("utf-8", "replace")
                        field_offs[name] = f_offs[fi].copy()
                        field_lens[name] = np.where(c_ok, f_lens[fi], -1)
                    ok |= c_ok
            todo = np.nonzero(src.present & ~ok)[0]
            self._fallback_rows(group, src, raw, todo, ok,
                                field_offs, field_lens, count=handled,
                                drift_rows=drift_rows)
            for k in field_offs:
                cols.set_field(k, field_offs[k], field_lens[k])
            if not src.from_content:
                from .common import consume_named_source
                consume_named_source(cols, self.source_key,
                                     set(field_offs))
            self._retain_source(cols, src, ok)
            cols.parse_ok = ok
            if src.from_content:
                cols.content_consumed = True
            return

        self._process_rows(group)

    # -- structural-index plane --------------------------------------------

    def _process_struct(self, group, src, raw, keys, ok,
                        field_offs, field_lens) -> bool:
        """Columnar parse via lct_json_struct_parse.  Returns
        (handled, drift_row_count); handled False when the native plane is
        unavailable (caller uses the r09-style path).  On success,
        `ok`/field dicts hold every row except the counted per-row
        fallbacks (still False in `ok`)."""
        from .. import native as _native
        res = _native.json_struct_parse(raw, src.offsets, src.lengths, keys)
        if res is None:
            return False, 0
        f_offs, f_lens, status, side, extras = res
        arena_len = len(raw)
        n = len(status)
        sb = group.source_buffer

        # one side-arena append per group: decoded escape bytes land in the
        # source buffer ONCE; side-sentinel offsets rebase vectorised
        from .common import append_side_arena, rebase_side_spans
        rebase = append_side_arena(sb, side, arena_len)
        c_ok = (status != 1) & src.present
        all_ok = bool(c_ok.all())
        for fi, k in enumerate(keys):
            name = k.decode("utf-8", "replace")
            lens_f = f_lens[fi]
            offs_f = rebase_side_spans(f_offs[fi], lens_f, arena_len,
                                       rebase)
            field_offs[name] = offs_f
            # steady state (every row parsed): install the kernel columns
            # as-is instead of re-masking them per field
            field_lens[name] = lens_f if all_ok \
                else np.where(c_ok, lens_f, -1)
        # schema drift: unknown keys arrive as a CSR extras stream of raw
        # spans — installed as columns without touching json.loads
        e_rows, e_koffs, e_klens, e_voffs, e_vlens = extras
        for j in range(len(e_rows)):
            i = int(e_rows[j])
            kb = raw[int(e_koffs[j]): int(e_koffs[j]) + int(e_klens[j])]
            name = kb.tobytes().decode("utf-8", "replace")
            if name not in field_offs:
                field_offs[name] = np.zeros(n, dtype=np.int32)
                field_lens[name] = np.full(n, -1, dtype=np.int32)
            vo = int(e_voffs[j])
            if vo >= arena_len:
                vo += rebase
            field_offs[name][i] = vo
            field_lens[name][i] = int(e_vlens[j])
        ok |= c_ok
        return True, int((status == 2).sum())

    def _fallback_rows(self, group, src, raw, todo, ok,
                       field_offs, field_lens, count: bool,
                       drift_rows: int = 0) -> None:
        """Per-row json.loads for rows the index could not prove
        well-formed.  The ONLY per-row Python left on this processor —
        counted, and alarmed when sustained."""
        n = len(src.offsets)
        sb = group.source_buffer
        n_fallback = 0
        for i in todo:
            n_fallback += 1
            o, ln = int(src.offsets[i]), int(src.lengths[i])
            try:
                # the counted fallback tier the structural plane demotes
                # malformed rows to (parse_fallback_rows_total)
                # loonglint: disable=per-row-parse
                obj = json.loads(raw[o : o + ln].tobytes())
                if not isinstance(obj, dict):
                    raise ValueError
            except Exception:  # noqa: BLE001
                continue
            ok[i] = True
            for k, v in obj.items():
                if k not in field_offs:
                    field_offs[k] = np.zeros(n, dtype=np.int32)
                    field_lens[k] = np.full(n, -1, dtype=np.int32)
                if isinstance(v, str):
                    vb = v.encode("utf-8")
                elif isinstance(v, (dict, list)):
                    vb = json.dumps(v, ensure_ascii=False).encode("utf-8")
                elif isinstance(v, bool):
                    vb = b"true" if v else b"false"
                elif v is None:
                    vb = b"null"
                else:
                    vb = str(v).encode("utf-8")
                view = sb.copy_string(vb)
                field_offs[k][i] = view.offset
                field_lens[k][i] = view.length
        if count:
            from . import parse_telemetry
            parse_telemetry.note_rows(self.name, self._pipeline,
                                      int(src.present.sum()), n_fallback,
                                      drift=drift_rows)

    # -- row path -----------------------------------------------------------

    def _process_rows(self, group: PipelineEventGroup) -> None:
        # row path keep/discard: the shared reference ordering (capture
        # raw, delete unless overwritten, re-add under the renamed key)
        from .common import finish_row_keep
        sb = group.source_buffer
        renamed = self.renamed_source_key.encode()
        for ev in group.events:
            if not hasattr(ev, "get_content"):
                continue
            raw = ev.get_content(self.source_key)
            if raw is None:
                continue
            try:
                # non-columnar groups (per-event plugins upstream) have no
                # arena to index
                # loonglint: disable=per-row-parse
                obj = json.loads(raw.to_bytes())
                if not isinstance(obj, dict):
                    raise ValueError
            except Exception:  # noqa: BLE001
                finish_row_keep(ev, raw, False, self.source_key, False,
                                self.keep_source_on_fail,
                                self.keep_source_on_success, renamed)
                continue
            overwritten = False
            for k, val in obj.items():
                if not isinstance(val, str):
                    val = json.dumps(val, ensure_ascii=False) \
                        if isinstance(val, (dict, list)) else \
                        ("true" if val is True else "false" if val is False
                         else "null" if val is None else str(val))
                kb = k.encode() if isinstance(k, str) else k
                ev.set_content(sb.copy_string(kb), sb.copy_string(val))
                if kb == self.source_key:
                    overwritten = True
            finish_row_keep(ev, raw, True, self.source_key, overwritten,
                            self.keep_source_on_fail,
                            self.keep_source_on_success, renamed)

    @staticmethod
    def _discover_schema(raw, src, candidates):
        for i in candidates[:4]:
            o, ln = int(src.offsets[i]), int(src.lengths[i])
            try:
                # bounded schema probe (<= 4 rows per group), not a tail
                # loonglint: disable=per-row-parse
                obj = json.loads(raw[o : o + ln].tobytes())
            except ValueError:
                continue
            if isinstance(obj, dict) and obj and len(obj) <= 128:
                return [k.encode("utf-8") for k in obj.keys()]
        return None

    def _retain_source(self, cols: ColumnarLogs, src, ok: np.ndarray) -> None:
        if self.keep_source_on_fail and self.keep_source_on_success:
            keep = src.present
        elif self.keep_source_on_fail:
            keep = (~ok) & src.present
        elif self.keep_source_on_success:
            keep = ok & src.present
        else:
            keep = np.zeros(len(ok), dtype=bool)
        if keep.any():
            cols.set_field(self.renamed_source_key,
                           src.offsets.astype(np.int32),
                           np.where(keep, src.lengths, -1).astype(np.int32))
