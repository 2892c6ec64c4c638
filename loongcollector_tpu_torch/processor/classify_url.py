"""processor_classify_url — rule-based URL/category classification.

Reference: loongcollector_tpu/processor/classify_url.py, the
``BASELINE.json`` scenario "eBPF HTTP/network events → regex URL
classification": each rule is a regex over a source field (default
``path``); the first matching rule's name becomes the category
(``TargetKey``), and a row no rule takes gets ``DefaultCategory``.

On a columnar group each rule is one ``RegexEngine.match_batch`` over the
field's span column on the pipeline's device (K1 for a Tier-1 rule, K2 for
a DFA-tier one), and each rule runs only over the rows no earlier rule
took.  On an object group (the eBPF inputs build those) every event is
classified on Python ``re``, as in the reference; ``re_rows`` counts them.
No ``fused_stage_spec``: the rules run per stage.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Tuple

import numpy as np

from ..models import PipelineEventGroup
from ..ops.regex.engine import RegexEngine, get_engine
from ..pipeline.plugin.interface import PluginContext, Processor
from .common import extract_source


class ProcessorClassifyUrl(Processor):
    name = "processor_classify_url_tpu"
    supports_columnar = True

    def __init__(self) -> None:
        super().__init__()
        self.source_key = b"path"
        self.target_key = "category"
        self.default = b"other"
        self.rules: List[Tuple[bytes, RegexEngine]] = []
        self.re_rows = 0
        self._count_lock = threading.Lock()

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.source_key = config.get("SourceKey", "path").encode()
        self.target_key = config.get("TargetKey", "category")
        self.default = config.get("DefaultCategory", "other").encode()
        for rule in config.get("Rules", []):
            name = rule.get("Name", "")
            pattern = rule.get("Regex", "")
            if not name or not pattern:
                return False
            self.rules.append((name.encode(),
                               get_engine(pattern, context.device)))
        return bool(self.rules)

    def process(self, group: PipelineEventGroup) -> None:
        src = extract_source(group, self.source_key)
        if src is None:
            return
        n = len(src.offsets)
        if n == 0:
            return
        sb = group.source_buffer
        cat_views = [sb.copy_string(name) for name, _ in self.rules]
        default_view = sb.copy_string(self.default)

        if src.columnar:
            cols = group.columns
            offs = np.full(n, default_view.offset, dtype=np.int32)
            lens = np.where(src.present, default_view.length,
                            -1).astype(np.int32)
            unassigned = src.present.copy()
            for (name, engine), view in zip(self.rules, cat_views):
                if not unassigned.any():
                    break
                idx = np.nonzero(unassigned)[0]
                ok = engine.match_batch(src.arena, src.offsets[idx],
                                        src.lengths[idx])
                hit = idx[ok]
                offs[hit] = view.offset
                lens[hit] = view.length
                unassigned[hit] = False
            cols.set_field(self.target_key, offs, lens)
            return

        rows = 0
        for ev in group.events:
            if not hasattr(ev, "get_content"):
                continue
            v = ev.get_content(self.source_key)
            if v is None:
                continue
            data = v.to_bytes()
            rows += 1
            label = default_view
            for (name, engine), view in zip(self.rules, cat_views):
                if engine._re.fullmatch(data):
                    label = view
                    break
            ev.set_content(self.target_key.encode(), label)
        with self._count_lock:
            self.re_rows += rows
