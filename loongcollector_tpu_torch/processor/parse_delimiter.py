"""processor_parse_delimiter — delimited fields on the CUDA device.

Reference: core/plugin/processor/ProcessorParseDelimiterNative.cpp (single /
multi-char separators; quote mode via the CSV FSM in
core/parser/DelimiterModeFsmParser.h:27-56).

The port's copy of the JAX package's ``processor/parse_delimiter.py``, with
its three tiers:

* non-quote: a delimiter split IS a Tier-1 segment program —
  ``([^d]*)d([^d]*)d...(.*)`` — so it runs on the regex engine's extraction
  kernel (K1) on the pipeline's device, through ``parse_batch_async``, and
  joins a fused run as a K7 ``extract`` stage (``fused_stage_spec``);
* quote mode with the native walker: ``lct_delim_struct_parse`` derives
  field spans from quote/separator bitmaps with the doubled-quote rule
  resolved in the same carry pass; fields needing byte rewrites (doubled
  quotes, quoted-head + tail) decode once into a per-group side arena;
* quote mode without it (``LOONG_DISABLE_NATIVE=1``, or a library without
  ``lct_delim_struct_parse``): the index tier.  The group's structural
  index comes from K5 (``StructIndexKernel.index_batch``) on the
  pipeline's device — the hand-written kernel on the card, the plain
  version under ``--cpu`` — where the reference computes the same masks
  with its numpy twin; a vectorised emitter covers the RFC4180-clean
  subset, and only index-deviant rows walk the reference FSM per row
  (counted in ``parse_telemetry``).  A group one batch cannot hold (a row
  over 4096 bytes, more rows than ``MAX_BATCH``) is indexed by the numpy
  twin, counted by reason in K5's ``host_groups``.

``_csv_fsm_split`` remains the per-row semantic reference and the row-group
/ deviant-row tier.  ``LOONG_STRUCT=0`` turns the structural tiers off (the
per-row FSM for every group), as in the reference.
"""

from __future__ import annotations

import os
import re as _re
from typing import Any, Dict, List

import numpy as np

from ..models import PipelineEventGroup
from ..ops.regex.engine import RegexEngine, get_engine
from ..pipeline.plugin.interface import PluginContext, Processor
from .common import (RAW_LOG_KEY, apply_parse_spans,
                     extract_source, finish_row_keep)


class _SpanResult:
    """BatchParseResult-shaped container for apply_parse_spans."""

    __slots__ = ("ok", "cap_off", "cap_len")

    def __init__(self, ok, cap_off, cap_len):
        self.ok = ok
        self.cap_off = cap_off
        self.cap_len = cap_len


def _csv_fsm_split(data: bytes, sep: bytes, quote: int = 0x22) -> List[bytes]:
    """Quote-mode split (reference DelimiterModeFsmParser state table):
    fields may be quoted; doubled quotes inside quoted fields escape."""
    fields: List[bytes] = []
    cur = bytearray()
    in_quote = False
    i, n = 0, len(data)
    s = sep[0]
    while i < n:
        b = data[i]
        if in_quote:
            if b == quote:
                if i + 1 < n and data[i + 1] == quote:
                    cur.append(quote)
                    i += 1
                else:
                    in_quote = False
            else:
                cur.append(b)
        elif b == quote and not cur:
            in_quote = True
        elif b == s and data[i : i + len(sep)] == sep:
            fields.append(bytes(cur))
            cur = bytearray()
            i += len(sep) - 1
        else:
            cur.append(b)
        i += 1
    fields.append(bytes(cur))
    return fields


class ProcessorParseDelimiter(Processor):
    name = "processor_parse_delimiter_tpu"
    supports_columnar = True

    def __init__(self) -> None:
        super().__init__()
        self.source_key = b"content"
        self.separator = b","
        self.quote_mode = False
        self.keys: List[str] = []
        self.keep_source_on_fail = True
        self.keep_source_on_success = False
        self.renamed_source_key = RAW_LOG_KEY
        self.engine: RegexEngine = None  # type: ignore
        self.allow_not_enough = False
        self._pipeline = ""
        self._device = None

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.source_key = config.get("SourceKey", "content").encode()
        sep = config.get("Separator", ",")
        self.separator = sep.encode() if isinstance(sep, str) else bytes(sep)
        self.quote_mode = bool(config.get("Quote", "")) or \
            config.get("Mode", "") == "quote"
        self.keys = list(config.get("Keys", []))
        self.keep_source_on_fail = bool(
            config.get("KeepingSourceWhenParseFail", True))
        self.keep_source_on_success = bool(
            config.get("KeepingSourceWhenParseSucceed", False))
        self.renamed_source_key = config.get("RenamedSourceKey", RAW_LOG_KEY)
        self.allow_not_enough = bool(config.get("AcceptNoEnoughKeys", False))
        self._pipeline = getattr(context, "pipeline_name", "") or ""
        self._device = context.device
        if not self.keys:
            return False
        if not self.quote_mode:
            # ([^s]*)s([^s]*)s...s(.*)  — Tier-1; last field takes the rest
            esc = _re.escape(self.separator.decode("latin-1"))
            neg = f"[^{esc}]" if len(self.separator) == 1 else None
            if neg is not None:
                parts = [f"({neg}*)"] * (len(self.keys) - 1) + ["(.*)"] \
                    if len(self.keys) > 1 else ["(.*)"]
                pattern = esc.join(parts)
                self.engine = get_engine(pattern, context.device)
        return True

    supports_async_dispatch = True

    def fused_stage_spec(self, ctx):
        """The non-quote delimiter split IS a Tier-1 segment program, so it
        joins a fused program exactly like regex extraction — same stage
        kind, same content identity (two plugins with the same derived
        pattern share one compiled program).  Quote mode keeps the
        structural-index plane."""
        from ..ops.regex.program import PatternTier
        eng = self.engine
        if self.quote_mode or self.allow_not_enough or eng is None \
                or eng.tier is not PatternTier.SEGMENT \
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
        from .common import subset_source
        ok, off, ln = out
        self._apply_device(group, subset_source(src, rowmap),
                           _SpanResult(ok[rowmap], off[rowmap], ln[rowmap]))
        return rowmap

    def process_dispatch(self, group: PipelineEventGroup):
        """The delimiter segment program dispatches now and its spans apply
        in process_complete while the device moves on to the next group.
        Quote-mode columnar groups take the synchronous structural-index
        plane instead (span derivation IS the whole computation there)."""
        if self.quote_mode and len(self.separator) == 1 and self.keys:
            # row groups skip the source pack entirely (extract_source
            # would copy every event's bytes just to be discarded) and go
            # straight to the per-event host tier
            if group.columns is None or group._events:
                self._process_host(group)
                return None
            src = extract_source(group, self.source_key)
            if src is None:
                return None
            if src.columnar and self._process_quote_struct(group, src):
                return None
            self._process_host(group)
            return None
        if self.engine is None or self.quote_mode or self.allow_not_enough:
            # configs that can never take the device path skip the source
            # row-pack entirely
            self._process_host(group)
            return None
        src = extract_source(group, self.source_key)
        if src is None:
            return None
        if not src.columnar:
            self._process_host(group)
            return None
        pending = self.engine.parse_batch_async(
            src.arena, src.offsets, src.lengths)
        if pending.done:
            self._apply_device(group, src, pending.result())
            return None
        return src, pending

    def process_complete(self, group: PipelineEventGroup, token) -> None:
        if token is None:
            return
        src, pending = token
        self._apply_device(group, src, pending.result())

    def process(self, group: PipelineEventGroup) -> None:
        self.process_complete(group, self.process_dispatch(group))

    def _apply_device(self, group: PipelineEventGroup, src, res) -> None:
        apply_parse_spans(group, src, res, self.keys,
                          self.keep_source_on_fail,
                          self.keep_source_on_success,
                          self.renamed_source_key,
                          source_key=self.source_key)

    # -- quote mode: structural-index plane ---------------------------------

    def _process_quote_struct(self, group: PipelineEventGroup, src) -> bool:
        """Quote-mode CSV from the structural index: the native fused walk
        when the library is loaded, else K5's masks + the vectorised
        clean-subset emitter with a counted per-row FSM tier for deviant
        rows.  Returns False only when no structural tier applies (caller
        falls back to the per-row host path wholesale)."""
        if os.environ.get("LOONG_STRUCT", "1") == "0":
            return False
        from .. import native as _native
        F = len(self.keys)
        sep = self.separator[0]
        sb = group.source_buffer
        arena_len = len(src.arena)
        n_fallback = 0

        res = _native.delim_struct_parse(src.arena, src.offsets,
                                         src.lengths, sep, 0x22, F)
        if res is not None:
            from .common import append_side_arena, rebase_side_spans
            cap_off, cap_len, nfields, side = res
            rebase = append_side_arena(sb, side, arena_len)
            cap_off = rebase_side_spans(cap_off, cap_len, arena_len,
                                        rebase)
        else:
            cap_off, cap_len, nfields, n_fallback = \
                self._quote_struct_index(group, src, F, sep)
        ok = nfields >= F
        if self.allow_not_enough:
            ok = nfields >= 1
        self._apply_device(group, src,
                           _SpanResult(ok & src.present, cap_off, cap_len))
        from . import parse_telemetry
        parse_telemetry.note_rows(self.name, self._pipeline,
                                  int(src.present.sum()), n_fallback)
        return True

    def _index_masks(self, src, sep: int):
        """(quote_bits, sep_bits) bool [n, L] of the group: K5 on the
        pipeline's device in one dispatch; the numpy twin for a group one
        batch cannot hold (K5 counts it in ``host_groups``)."""
        from ..ops.kernels import struct_index as _si
        lengths = np.asarray(src.lengths, dtype=np.int32)
        got = _si.device_kernel(_si.MODE_DELIM, sep, self._device) \
            .index_batch(src.arena, src.offsets, lengths)
        if got is not None:
            masks, L = got
        else:
            n = len(src.offsets)
            L = max(1, int(lengths.max()) if n else 1)
            rows = np.zeros((n, L), dtype=np.uint8)
            for i in range(n):
                o, ln = int(src.offsets[i]), int(lengths[i])
                if ln > 0:
                    rows[i, :ln] = src.arena[o : o + ln]
            masks = _si.struct_index_numpy(rows, lengths,
                                           mode=_si.MODE_DELIM, sep=int(sep))
        return _si.unpack16(masks[3], L), _si.unpack16(masks[1], L)

    def _quote_struct_index(self, group, src, F: int, sep: int):
        """No-native tier: K5 index + vectorised emission; rows the
        clean-subset emitter cannot express (doubled quotes, literal
        mid-field quotes, joins) run the reference FSM per row — counted.
        Returns (cap_off, cap_len, nfields, n_fallback)."""
        from ..ops.kernels import struct_index as _si
        lengths = np.asarray(src.lengths, dtype=np.int32)
        arena = src.arena
        quote_bits, sep_bits = self._index_masks(src, sep)
        cap_off, cap_len, nfields, deviant = _si.emit_delim_spans(
            arena, src.offsets, lengths, quote_bits, sep_bits, F)
        sb = group.source_buffer
        n_fallback = 0
        sep_b = bytes([sep])
        for i in np.nonzero(deviant & src.present)[0]:
            n_fallback += 1
            o, ln = int(src.offsets[i]), int(lengths[i])
            # the counted deviant-row tier of the index tier
            fields = _csv_fsm_split(arena[o : o + ln].tobytes(), sep_b)
            nfields[i] = len(fields)
            if len(fields) > F:
                fields = fields[: F - 1] + [sep_b.join(fields[F - 1:])]
            for k in range(F):
                if k < len(fields):
                    view = sb.copy_string(fields[k])
                    cap_off[i, k] = view.offset
                    cap_len[i, k] = view.length
                else:
                    cap_len[i, k] = -1
        return cap_off, cap_len, nfields, n_fallback

    def _process_host(self, group: PipelineEventGroup) -> None:
        # host path: quote-mode FSM or row groups.  Keep/discard follows
        # the reference ordering shared with apply_parse_spans: capture the
        # raw source, delete it unless a key overwrote it, re-add under the
        # renamed key per the keep flags.
        sb = group.source_buffer
        key_bytes = [k.encode() for k in self.keys]
        renamed = self.renamed_source_key.encode()
        for ev in group.events:
            if not hasattr(ev, "get_content"):
                continue
            raw = ev.get_content(self.source_key)
            if raw is None:
                continue
            data = raw.to_bytes()
            fields = (_csv_fsm_split(data, self.separator)
                      if self.quote_mode else data.split(self.separator))
            if len(fields) < len(self.keys) and not self.allow_not_enough:
                finish_row_keep(ev, raw, False, self.source_key, False,
                                self.keep_source_on_fail,
                                self.keep_source_on_success, renamed)
                continue
            if len(fields) > len(self.keys):
                head = fields[: len(self.keys) - 1]
                tail = self.separator.join(fields[len(self.keys) - 1:])
                fields = head + [tail]
            overwritten = False
            for key, val in zip(key_bytes, fields):
                ev.set_content(key, sb.copy_string(val))
                if key == self.source_key:
                    overwritten = True
            finish_row_keep(ev, raw, True, self.source_key, overwritten,
                            self.keep_source_on_fail,
                            self.keep_source_on_success, renamed)
