"""processor_parse_regex — regex field extraction on the CUDA device.

Reference: core/plugin/processor/ProcessorParseRegexNative.cpp — full-match
with capture groups → fields (SetContentNoCopy spans, :249-251); keep/discard
semantics from CommonParserOptions (:153-165): KeepingSourceWhenParseFail
(default true ⇒ failed events keep the raw line under `rawLog`),
KeepingSourceWhenParseSucceed, RenamedSourceKey.

The whole group parses as ONE batch through ops.regex.RegexEngine on the
pipeline's device (context.device); returned spans index the group's own
arena, so downstream serialization stays zero-copy.  Columnar groups take
the span-matrix path, per-event groups the row path — both as in the JAX
package's processor.  ``process_dispatch`` leaves the parse in flight on
the device and ``process_complete`` applies it (reference
``processor/parse_regex.py:98-118``); a parse that completed at dispatch is
applied at once.  In a fused run the parse is the program's ``extract``
stage (``fused_stage_spec``).
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..models import PipelineEventGroup
from ..ops.regex.engine import RegexEngine, get_engine
from ..pipeline.plugin.interface import PluginContext, Processor
from .common import (RAW_LOG_KEY, apply_parse_spans, extract_source,
                     finish_row_keep)


class ProcessorParseRegex(Processor):
    name = "processor_parse_regex_tpu"

    def __init__(self) -> None:
        super().__init__()
        self.source_key = b"content"
        self.regex = ""
        self.keys: List[str] = []
        self.keep_source_on_fail = True
        self.keep_source_on_success = False
        self.renamed_source_key = RAW_LOG_KEY
        self.engine: RegexEngine = None  # type: ignore

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.source_key = config.get("SourceKey", "content").encode()
        self.regex = config.get("Regex", "(.*)")
        self.keys = list(config.get("Keys", []))
        self.keep_source_on_fail = bool(
            config.get("KeepingSourceWhenParseFail", True))
        self.keep_source_on_success = bool(
            config.get("KeepingSourceWhenParseSucceed", False))
        self.renamed_source_key = config.get("RenamedSourceKey", RAW_LOG_KEY)
        self.engine = get_engine(self.regex, context.device)
        # name capture groups: config Keys win; else named groups; else g{N}
        if not self.keys:
            self.keys = [self.engine.group_names.get(i, f"g{i+1}")
                         for i in range(self.engine.num_caps)]
        return True

    supports_async_dispatch = True

    def fused_stage_spec(self, ctx):
        """A SEGMENT-tier parse joins a fused program as an ``extract``
        stage (reference ``parse_regex.py:65-96``): one packed source column
        in, capture spans out, which a later filter condition on a parsed
        key reads where they were computed.  The parsed keys register as
        capture columns; the consumed source key leaves the run's
        bindings, as ``apply_parse_spans`` consumes it."""
        from ..ops.regex.program import PatternTier
        eng = self.engine
        if eng is None or eng.tier is not PatternTier.SEGMENT \
                or eng.kernel is None:
            return None
        if not ctx.bind_source(self.source_key):
            return None
        from ..ops import fused_pipeline as fp
        from ..pipeline.fused_chain import FusedMemberStage
        spec = fp.StageSpec("extract", eng.kernel.program,
                            ["extract", eng.pattern], staged=eng.kernel,
                            label=f"extract:{self.name}")
        ctx.note_fields(ctx.n_stages, self.keys[:eng.num_caps])
        ctx.note_consumed(self.source_key)
        return FusedMemberStage(spec, self._fused_apply)

    def _fused_apply(self, group, src, out, rowmap):
        from ..ops.regex.engine import BatchParseResult
        from .common import subset_source
        ok, off, ln = out
        self._apply(group, subset_source(src, rowmap),
                    BatchParseResult(ok[rowmap], off[rowmap], ln[rowmap]))
        return rowmap

    def process_dispatch(self, group: PipelineEventGroup):
        """Dispatch the group's parse and return the pending handle; the
        device works while the runner handles neighbouring groups."""
        src = extract_source(group, self.source_key)
        if src is None:
            return None
        pending = self.engine.parse_batch_async(
            src.arena, src.offsets, src.lengths)
        if pending.done:
            self._apply(group, src, pending.result())
            return None
        return src, pending

    def process_complete(self, group: PipelineEventGroup, token) -> None:
        if token is None:
            return
        src, pending = token
        self._apply(group, src, pending.result())

    def process(self, group: PipelineEventGroup) -> None:
        self.process_complete(group, self.process_dispatch(group))

    def _apply(self, group: PipelineEventGroup, src, res) -> None:
        if src.columnar:
            apply_parse_spans(group, src, res, self.keys,
                              self.keep_source_on_fail,
                              self.keep_source_on_success,
                              self.renamed_source_key,
                              source_key=self.source_key)
            return

        # row path (non-columnar groups) — reference ordering
        # (ProcessorParseRegexNative.cpp ProcessEvent): capture the raw
        # source FIRST (a key may overwrite it), delete the source unless a
        # successful parse overwrote it, then re-add under the renamed key
        # per the keep flags
        ok = res.ok & src.present
        sb = group.source_buffer
        key_bytes = [k.encode() for k in self.keys]
        renamed = self.renamed_source_key.encode()
        for i, ev in enumerate(group.events):
            if not hasattr(ev, "get_content"):
                continue  # RawEvent/metric/span rows don't carry fields
            raw = ev.get_content(self.source_key)
            overwritten = False
            if ok[i]:
                for g in range(min(self.engine.num_caps, len(self.keys))):
                    ln = int(res.cap_len[i, g])
                    if ln >= 0:
                        o = int(res.cap_off[i, g])
                        data = bytes(src.arena[o: o + ln].tobytes())
                        ev.set_content(key_bytes[g], sb.copy_string(data))
                        if key_bytes[g] == self.source_key:
                            overwritten = True
            finish_row_keep(ev, raw, bool(ok[i]), self.source_key,
                            overwritten, self.keep_source_on_fail,
                            self.keep_source_on_success, renamed)
