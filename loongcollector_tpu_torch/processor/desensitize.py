"""processor_desensitize — mask sensitive spans in a field.

Reference: core/plugin/processor/ProcessorDesensitizeNative.cpp — const or
md5 replacement of the content matched after a regex prefix.  The reference
semantics: `Regex` matches a prefix group and the sensitive part
(`ReplacingString` replaces the second part).

Host substitution path (find-all on-device is a later kernel — fullmatch
kernels don't locate interior spans yet).

The port's copy of the JAX package's ``processor/desensitize.py``.
"""

from __future__ import annotations

import hashlib
import re
from typing import Any, Dict

from ..models import PipelineEventGroup
from ..pipeline.plugin.interface import PluginContext, Processor


class ProcessorDesensitize(Processor):
    name = "processor_desensitize_native"
    supports_columnar = True

    def __init__(self) -> None:
        super().__init__()
        self.source_key = b"content"
        self.method = "const"        # const | md5
        self.replacing = b"********"
        self.regex = None

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.source_key = config.get("SourceKey", "content").encode()
        self.method = config.get("Method", "const")
        self.replacing = config.get("ReplacingString", "********").encode()
        pattern = config.get("Regex", "")
        if not pattern:
            return False
        self.regex = re.compile(pattern.encode())
        return True

    def _mask(self, m: "re.Match") -> bytes:
        # group 1 is kept as-is; group 2 (the sensitive span) is replaced
        prefix = m.group(1) if m.lastindex and m.lastindex >= 1 else b""
        if self.method == "md5":
            target = m.group(2) if m.lastindex and m.lastindex >= 2 else m.group(0)
            return prefix + hashlib.md5(target).hexdigest().encode()
        return prefix + self.replacing

    def process(self, group: PipelineEventGroup) -> None:
        sb = group.source_buffer
        cols = group.columns
        if cols is not None and not group._events:
            skey = self.source_key.decode()
            target = cols.fields.get(skey)
            if target is None and not cols.fields:
                # operate on raw content spans
                offs, lens = cols.offsets, cols.lengths
            elif target is None:
                return
            else:
                offs, lens = target
            raw = group.source_buffer.as_array()
            new_offs = offs.copy()
            new_lens = lens.copy()
            for i in range(len(offs)):
                ln = int(lens[i])
                if ln < 0:
                    continue
                o = int(offs[i])
                data = raw[o : o + ln].tobytes()
                masked = self.regex.sub(self._mask, data)
                if masked != data:
                    view = sb.copy_string(masked)
                    new_offs[i] = view.offset
                    new_lens[i] = view.length
                    raw = group.source_buffer.as_array()  # arena may have grown
            if target is None and not cols.fields:
                cols.offsets, cols.lengths = new_offs, new_lens
            else:
                cols.set_field(skey, new_offs, new_lens)
            return
        for ev in group.events:
            if not hasattr(ev, "get_content"):
                continue
            v = ev.get_content(self.source_key)
            if v is None:
                continue
            data = v.to_bytes()
            masked = self.regex.sub(self._mask, data)
            if masked != data:
                ev.set_content(self.source_key, sb.copy_string(masked))
