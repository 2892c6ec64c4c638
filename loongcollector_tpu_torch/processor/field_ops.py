"""Common field-manipulation processors from the Go long tail.

Reference: loongcollector_tpu/processor/field_ops.py, after
plugins/processor/addfields (static enrichment), plugins/processor/rename,
plugins/processor/drop (drop events whose field matches) and
plugins/processor/strreplace.  Columnar groups take span-level paths
(constant columns, field-map renames, device match + compact); object
events edit contents in place.  ``processor_drop``'s ``Match`` conditions
are ``RegexEngine.match_batch`` calls on the pipeline's device (K1 for a
Tier-1 pattern, K2 for a DFA-tier one), as the reference's, one a
condition over a columnar group and one an event over an object group.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np

from ..models import PipelineEventGroup
from ..ops.regex.engine import get_engine
from ..pipeline.plugin.interface import PluginContext, Processor
from .filter import compact_columns


def _event_field(ev, key: bytes):
    get = getattr(ev, "get_content", None)
    if get is None:
        return None
    v = get(key)
    return v.to_bytes() if v is not None else None


class ProcessorAddFields(Processor):
    """Static fields on every event (plugins/processor/addfields).
    IgnoreIfExist preserves an existing value."""

    name = "processor_add_fields"
    supports_columnar = True

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.fields = {str(k): str(v)
                       for k, v in (config.get("Fields") or {}).items()}
        self.ignore_if_exist = bool(config.get("IgnoreIfExist", False))
        return bool(self.fields)

    def process(self, group: PipelineEventGroup) -> None:
        sb = group.source_buffer
        cols = group.columns
        if cols is not None and not group._events:
            n = len(cols)
            for k, v in self.fields.items():
                view = sb.copy_string(v.encode())
                if self.ignore_if_exist and k in cols.fields:
                    # fill only rows where the field is ABSENT (lens < 0) —
                    # per-event semantics, matching the object path
                    offs, lens = cols.fields[k]
                    missing = lens < 0
                    if not missing.any():
                        continue
                    offs = np.where(missing, view.offset, offs).astype(
                        np.int32)
                    lens = np.where(missing, view.length, lens).astype(
                        np.int32)
                    cols.set_field(k, offs, lens)
                    continue
                cols.set_field(k,
                               np.full(n, view.offset, np.int32),
                               np.full(n, view.length, np.int32))
            return
        for ev in group.events:
            if not hasattr(ev, "set_content"):
                continue
            for k, v in self.fields.items():
                if self.ignore_if_exist and ev.get_content(k.encode()):
                    continue
                ev.set_content(sb.copy_string(k.encode()),
                               sb.copy_string(v.encode()))


class ProcessorRenameFields(Processor):
    """Field renames (plugins/processor/rename): SourceKeys → DestKeys."""

    name = "processor_rename"
    supports_columnar = True

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        src = config.get("SourceKeys") or []
        dst = config.get("DestKeys") or []
        self.mapping = dict(zip(map(str, src), map(str, dst)))
        return bool(self.mapping) and len(src) == len(dst)

    def process(self, group: PipelineEventGroup) -> None:
        cols = group.columns
        if cols is not None and not group._events:
            for old, new in self.mapping.items():
                if old in cols.fields:
                    cols.fields[new] = cols.fields.pop(old)
                elif old == "content" and not cols.content_consumed:
                    # the raw-content pseudo-field renames like any other
                    cols.set_field(new, np.array(cols.offsets, copy=True),
                                   np.array(cols.lengths, copy=True))
                    cols.content_consumed = True
            return
        for ev in group.events:
            if not hasattr(ev, "get_content"):
                continue
            for old, new in self.mapping.items():
                v = ev.get_content(old.encode())
                if v is not None:
                    ev.set_content(new.encode(), v)
                    ev.del_content(old.encode())


class ProcessorDrop(Processor):
    """Two drop modes sharing the Go plugin's name:

    * `DropKeys: [field, ...]` — remove FIELDS from every event (the Go
      plugins/processor/drop semantics);
    * `Match: {field: regex}` — drop whole EVENTS whose field full-matches
      (the match runs on the device tier when the pattern compiles there).
    """

    name = "processor_drop"
    supports_columnar = True

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.drop_keys = [str(k) for k in (config.get("DropKeys") or [])]
        self.conditions = [(str(k).encode(),
                            get_engine(str(p), context.device))
                           for k, p in (config.get("Match") or {}).items()]
        return bool(self.drop_keys) or bool(self.conditions)

    def _drop_fields(self, group: PipelineEventGroup) -> None:
        cols = group.columns
        if cols is not None and not group._events:
            for k in self.drop_keys:
                cols.fields.pop(k, None)
                if k == "content":
                    cols.content_consumed = True
            return
        for ev in group.events:
            if hasattr(ev, "del_content"):
                for k in self.drop_keys:
                    ev.del_content(k.encode())

    def process(self, group: PipelineEventGroup) -> None:
        if self.drop_keys:
            self._drop_fields(group)
        if not self.conditions:
            return
        cols = group.columns
        if cols is not None and not group._events:
            n = len(cols)
            arena = group.source_buffer.as_array()
            drop = np.zeros(n, dtype=bool)
            for key, eng in self.conditions:
                name = key.decode()
                spans = cols.fields.get(name)
                if spans is None:
                    if name == "content" and not cols.content_consumed:
                        spans = (cols.offsets, cols.lengths)
                    else:
                        continue
                offs, lens = spans
                present = lens >= 0
                ok = eng.match_batch(arena,
                                     offs.astype(np.int64),
                                     np.maximum(lens, 0))
                drop |= present & ok
            if drop.any():
                group.set_columns(compact_columns(cols, ~drop))
            return
        kept = []
        for ev in group.events:
            matched = False
            for key, eng in self.conditions:
                v = _event_field(ev, key)
                if v is None:
                    continue
                data = np.frombuffer(v, dtype=np.uint8)
                if bool(eng.match_batch(data, np.array([0], np.int64),
                                        np.array([len(v)], np.int32))[0]):
                    matched = True
                    break
            if not matched:
                kept.append(ev)
        group._events = kept
        group._columns = None


class ProcessorStrReplace(Processor):
    """Regex replacement on a field (plugins/processor/strreplace)."""

    name = "processor_strreplace"
    supports_columnar = True

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.source_key = str(config.get("SourceKey", "content")).encode()
        method = config.get("Method", "regex")
        match = str(config.get("Match", "") or "")
        self.replacement = str(config.get("ReplaceString", "")).encode()
        if not match:
            return False
        if method == "const":
            match = re.escape(match)
        try:
            self.rx = re.compile(match.encode())
        except (re.error, UnicodeEncodeError):
            return False
        return True

    def process(self, group: PipelineEventGroup) -> None:
        sb = group.source_buffer
        cols = group.columns
        name = self.source_key.decode()
        if cols is not None and not group._events:
            raw = group.source_buffer.as_array()
            spans = cols.fields.get(name)
            use_content = spans is None and name == "content" \
                and not cols.content_consumed
            if use_content:
                spans = (cols.offsets, cols.lengths)
            if spans is None:
                return
            offs, lens = spans
            n = len(cols)
            new_offs = np.array(offs, dtype=np.int32, copy=True)
            new_lens = np.array(lens, dtype=np.int32, copy=True)
            for i in range(n):
                if lens[i] < 0:
                    continue
                o = int(offs[i])
                val = raw[o:o + int(lens[i])].tobytes()
                rep = self.rx.sub(self.replacement, val)
                if rep != val:
                    view = sb.copy_string(rep)
                    new_offs[i], new_lens[i] = view.offset, view.length
            if use_content:
                cols.offsets, cols.lengths = new_offs, new_lens
            else:
                cols.set_field(name, new_offs, new_lens)
            return
        for ev in group.events:
            v = _event_field(ev, self.source_key)
            if v is None:
                continue
            rep = self.rx.sub(self.replacement, v)
            if rep != v:
                ev.set_content(self.source_key, sb.copy_string(rep))
