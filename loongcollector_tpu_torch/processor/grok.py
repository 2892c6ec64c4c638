"""processor_grok — grok pattern field extraction.

Reference: plugins/processor/grok/ (Go) — pattern library + %{NAME:field}
expansion; multiple Match patterns are tried IN ORDER per event until one
fully matches — and the JAX package's ``processor/grok.py``, whose staged
path this is.  Expansion feeds the tiered ``RegexEngine`` on the
pipeline's device, so kernel-friendly grok runs on K1; with several Match
patterns one fused scan (K4) classifies them all and each event runs only
its first-matching pattern's extract.  In a fused run the classify scan is
the program's ``scan`` stage (``fused_stage_spec``, reference
``grok.py:86-115``); the extracts still run per matching subset.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from ..models import PipelineEventGroup
from ..ops.regex.engine import RegexEngine, get_engine
from ..ops.regex.grok import GrokError, expand
from ..pipeline.plugin.interface import PluginContext, Processor
from .common import RAW_LOG_KEY, extract_source


class ProcessorGrok(Processor):
    name = "processor_grok"

    def __init__(self) -> None:
        super().__init__()
        self.source_key = b"content"
        self.keep_source_on_fail = True
        self.renamed_source_key = RAW_LOG_KEY
        self._engines: List[Tuple[RegexEngine, List[str]]] = []
        self._fused_set = None

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        match = config.get("Match", [])
        if isinstance(match, str):
            match = [match]
        if not match:
            return False
        custom = config.get("CustomPatterns", {}) or {}
        self.source_key = config.get("SourceKey", "content").encode()
        self.keep_source_on_fail = bool(
            config.get("KeepingSourceWhenParseFail", True))
        import re as _re
        for pattern in match:
            try:
                regex = expand(pattern, custom)
                engine = get_engine(regex, context.device)
            except (GrokError, _re.error):
                return False
            # only NAMED groups become fields (grok semantics)
            keys = [engine.group_names.get(i, "") for i in range(engine.num_caps)]
            self._engines.append((engine, keys))
        # with several Match patterns, one fused scan classifies them all:
        # each event runs ONLY its first-matching pattern's extract program
        # instead of trying every engine in order
        self._fused_set = None
        if len(self._engines) > 1:
            from ..ops.regex.fuse import try_build_set
            self._fused_set = try_build_set(
                [e.pattern for e, _ in self._engines],
                names=[f"match{i}" for i in range(len(self._engines))],
                device=context.device)
        return True

    def process(self, group: PipelineEventGroup) -> None:
        src = extract_source(group, self.source_key)
        if src is None:
            return
        n = len(src.offsets)
        if n == 0:
            return
        if src.columnar:
            member_masks = None
            if self._fused_set is not None:
                tags = self._fused_set.classify(
                    src.arena, src.offsets.astype(np.int64), src.lengths)
                member_masks = self._fused_set.member_masks(tags)
            self._apply_columnar(group, src, member_masks)
            return

        self._process_rows(group)

    def fused_stage_spec(self, ctx):
        """The multi-pattern classify scan as a ``scan`` stage of a fused
        program (one tag mask a row); each pattern's extract then runs on
        its matching rows.  Grok's fields are extracted on the host, so
        they never register as capture columns a later member could bind."""
        fs = self._fused_set
        if fs is None or not fs.fdfa.device_ok or fs.kernel is None:
            return None
        if not ctx.bind_source(self.source_key):
            return None
        from ..ops import fused_pipeline as fp
        from ..pipeline.fused_chain import FusedMemberStage
        spec = fp.StageSpec("scan", fs.fdfa,
                            ["scan"] + list(fs.fdfa.patterns),
                            staged=fs.kernel, label="grok-classify")
        ctx.note_consumed(self.source_key)
        return FusedMemberStage(spec, self._fused_apply)

    def _fused_apply(self, group, src, out, rowmap):
        from .common import subset_source
        tags = np.asarray(out[0]).astype(np.uint32)[rowmap]
        masks = self._fused_set.member_masks(tags)
        self._apply_columnar(group, subset_source(src, rowmap), masks)
        return rowmap

    def _apply_columnar(self, group, src, member_masks) -> None:
        n = len(src.offsets)
        cols = group.columns
        remaining = src.present.copy()
        matched = np.zeros(n, dtype=bool)
        field_offs: Dict[str, np.ndarray] = {}
        field_lens: Dict[str, np.ndarray] = {}
        for pat_i, (engine, keys) in enumerate(self._engines):
            if not remaining.any():
                break
            if member_masks is not None \
                    and member_masks[pat_i] is not None:
                # fused member: the scan already classified it — run
                # its extract program only on its matching rows.
                # Demoted members (mask None) keep the per-pattern
                # probe over everything still unmatched.
                idx = np.nonzero(remaining & member_masks[pat_i])[0]
                if not len(idx):
                    continue
            else:
                idx = np.nonzero(remaining)[0]
            res = engine.parse_batch(src.arena, src.offsets[idx],
                                     src.lengths[idx])
            hit = idx[res.ok]
            if not len(hit):
                continue
            for g, key in enumerate(keys):
                if not key:
                    continue
                if key not in field_offs:
                    field_offs[key] = np.zeros(n, dtype=np.int32)
                    field_lens[key] = np.full(n, -1, dtype=np.int32)
                field_offs[key][hit] = res.cap_off[res.ok, g]
                field_lens[key][hit] = res.cap_len[res.ok, g]
            matched[hit] = True
            remaining[hit] = False
        for key in field_offs:
            cols.set_field(key, field_offs[key], field_lens[key])
        if self.keep_source_on_fail:
            fail = (~matched) & src.present
            if fail.any():
                cols.set_field(self.renamed_source_key,
                               src.offsets.astype(np.int32),
                               np.where(fail, src.lengths, -1).astype(np.int32))
        cols.parse_ok = matched
        if src.from_content:
            cols.content_consumed = True

    def _process_rows(self, group: PipelineEventGroup) -> None:
        # row path — shared reference keep/discard ordering
        from .common import finish_row_keep
        sb = group.source_buffer
        renamed = self.renamed_source_key.encode()
        for i, ev in enumerate(group.events):
            if not hasattr(ev, "get_content"):
                continue
            raw = ev.get_content(self.source_key)
            if raw is None:
                continue
            data = raw.to_bytes()
            hit = False
            overwritten = False
            for engine, keys in self._engines:
                m = engine._re.fullmatch(data)
                if m is None:
                    continue
                hit = True
                for g, key in enumerate(keys):
                    if key and m.group(g + 1) is not None:
                        kb = key.encode()
                        ev.set_content(kb, sb.copy_string(m.group(g + 1)))
                        if kb == self.source_key:
                            overwritten = True
                break
            finish_row_keep(ev, raw, hit, self.source_key, overwritten,
                            self.keep_source_on_fail, False, renamed)
