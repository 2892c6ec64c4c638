"""processor_filter — keep/drop events by field regex conditions.

Reference: core/plugin/processor/ProcessorFilterNative.cpp — Include map
(field → full-match regex, all must match) and Exclude map (any match
drops) — and the JAX package's ``processor/filter.py``, whose staged path
this is.  Each condition is one ``RegexEngine.match_batch`` over the
field's spans on the pipeline's device (K1 for a Tier-1 pattern, K2 for a
DFA-tier one); columnar groups drop events by boolean-mask compaction of
the span columns.  In a fused run the whole condition set is one ``keep``
stage of the program (``fused_stage_spec``, reference ``filter.py:51-116``):
a condition on the run's source is a Tier-1 ok bit or a DFA match, one on a
field the run parsed a DFA match over that capture's span (K3's walk).
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

    def fused_stage_spec(self, ctx):
        """The Include/Exclude set as ONE ``keep`` stage: each condition a
        Tier-1 or DFA match over the packed source rows or, for a field an
        earlier member's extract stage produced, a DFA match over that
        capture's span.  A condition that cannot bind statically (a field
        minted outside the run, a consumed source, a pattern with neither
        a Tier-1 nor a DFA form) keeps the filter on its per-stage path."""
        if not self.include and not self.exclude:
            return None
        from ..ops import fused_pipeline as fp
        from ..ops.kernels.dfa_scan import LazySpanMatchKernel
        from ..ops.regex.dfa import DFAUnsupported, compile_dfa
        from ..ops.regex.program import PatternTier
        from ..pipeline.fused_chain import FusedMemberStage
        conds = []
        for negate, pairs in ((False, self.include), (True, self.exclude)):
            for key, engine in pairs:
                binding = ctx.resolve(key)
                if binding is None:
                    return None
                if binding == "source":
                    if not ctx.bind_source(key):
                        return None
                    if engine.tier is PatternTier.SEGMENT:
                        conds.append(fp.StageCond(
                            "extract_ok", engine.kernel.program,
                            ["extract_ok", engine.pattern, negate],
                            negate=negate, staged=engine.kernel))
                    elif engine.tier is PatternTier.DFA:
                        conds.append(fp.StageCond(
                            "match", engine.dfa_kernel.dfa,
                            ["match", engine.pattern, negate],
                            negate=negate, staged=engine.dfa_kernel))
                    else:
                        return None
                else:
                    _tag, prod, cap = binding
                    try:
                        dfa = compile_dfa(engine.pattern)
                    except DFAUnsupported:
                        return None
                    conds.append(fp.StageCond(
                        "span_match", dfa,
                        ["span_match", engine.pattern, prod, cap, negate],
                        binding=(prod, cap), negate=negate,
                        staged=LazySpanMatchKernel(dfa)))
        spec = fp.StageSpec("keep", conds,
                            ["keep"] + [list(c.ident) for c in conds],
                            label="filter")
        return FusedMemberStage(spec, self._fused_apply)

    def _fused_apply(self, group, src, out, rowmap):
        keep = np.asarray(out[0], dtype=bool)[rowmap]
        if keep.all():
            return rowmap
        cols = group.columns
        if cols is not None and not group._events:
            group.set_columns(compact_columns(cols, keep))
        else:
            group._events = [ev for i, ev in enumerate(group.events)
                             if keep[i]]
        return rowmap[keep]

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
