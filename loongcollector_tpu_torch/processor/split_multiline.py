"""Inner processor: multiline log assembly (stacktrace merging), columnar.

Reference: core/plugin/processor/inner/ProcessorSplitMultilineLogStringNative
.cpp with MultilineOptions (file_server/MultilineOptions.h:38-47), and the
JAX package's ``processor/split_multiline.py``, whose staged path this is:
start/continue/end regexes group physical lines into logical events;
UnmatchedContentTreatment = discard | single_line.

Line classification runs on the device: with one pattern, that engine's
``match_batch`` (K1 for a Tier-1 pattern, K2 for a DFA-tier one); with
several, ONE fused scan classifies start, continue and end together (K4,
``ops/regex/fuse.FusedSetExec``).  Because split lines are contiguous
slices of the same arena, merging a block of lines is span arithmetic: the
merged event is the arena span from the first line's offset to the last
line's end, newlines included.  Start-only and end-only modes are
vectorised; start+continue and start+end walk the lines in Python, as the
reference does.

Cross-chunk carry: when the reader marks a group ``ML_PARTIAL_TAIL`` (its
last record may continue in the next chunk) and the follow-up
``ML_CONTINUE``, the open record's bytes are stashed per source
(``path:inode``) and stitched onto the next chunk's leading lines.  Held
records ship on the pipeline's stop (``drain_groups``);
``flush_timeout_groups`` releases those held past ``CARRY_FLUSH_S``, for
the timeout tick that comes with tail mode.  With several patterns the
classify scan can end a fused run as its terminal ``scan`` stage
(``fused_stage_spec``, reference ``split_multiline.py:121-152``): the block
walk then reads the program's tag masks.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..models import ColumnarLogs, EventGroupMetaKey, PipelineEventGroup
from ..ops.regex.engine import RegexEngine, get_engine
from ..pipeline.plugin.interface import PluginContext, Processor

CARRY_CAP_BYTES = 1 << 20   # give up stitching records larger than this
CARRY_FLUSH_S = 5.0         # idle carries flush via the pipeline timeout tick
CARRY_TTL_S = 30.0          # orphaned stashes flush through the next group


class ProcessorSplitMultilineLogString(Processor):
    name = "processor_split_multiline_log_string_native"

    def __init__(self) -> None:
        super().__init__()
        self.start: Optional[RegexEngine] = None
        self.cont: Optional[RegexEngine] = None
        self.end: Optional[RegexEngine] = None
        self.unmatched = "single_line"  # or "discard"
        # per-source open-record stash: key → (bytes, event_ts, stashed_at);
        # locked: _finish runs on processor threads, flush_timeout_groups on
        # thread 0's timeout tick (same contract as Batcher)
        self._carry: Dict[str, Tuple[bytes, int, float]] = {}
        self._carry_lock = threading.Lock()

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        mcfg = config.get("Multiline", config)
        sp = mcfg.get("StartPattern")
        cp = mcfg.get("ContinuePattern")
        ep = mcfg.get("EndPattern")
        dev = context.device
        self.start = get_engine(sp, dev) if sp else None
        self.cont = get_engine(cp, dev) if cp else None
        self.end = get_engine(ep, dev) if ep else None
        self.unmatched = mcfg.get("UnmatchedContentTreatment", "single_line")
        # classify start/continue/end in ONE scan (one device pass)
        # instead of a match batch per pattern
        self._fused_set = None
        self._fused_slots: Dict[str, int] = {}
        pats = [(name, eng.pattern) for name, eng in
                (("start", self.start), ("cont", self.cont),
                 ("end", self.end)) if eng is not None]
        if len(pats) > 1:
            from ..ops.regex.fuse import try_build_set
            self._fused_set = try_build_set([p for _, p in pats],
                                            names=[n for n, _ in pats],
                                            device=dev)
            if self._fused_set is not None:
                self._fused_slots = {n: i for i, (n, _) in enumerate(pats)}
        return self.start is not None or self.end is not None

    @staticmethod
    def _classify(masks, name, engine, arena, offs, lens) -> np.ndarray:
        """Fused classification when the pattern joined the set; the
        per-pattern match batch when it was demoted or the set didn't
        fuse — identical booleans either way."""
        got = masks.get(name)
        if got is not None:
            return got
        return engine.match_batch(arena, offs, lens)

    def process(self, group: PipelineEventGroup) -> None:
        cols = group.columns
        if cols is None or group._events:
            return  # expects the line-split columnar form
        n = len(cols)
        if n == 0:
            return
        arena = group.source_buffer.as_array()
        offs = cols.offsets.astype(np.int64)
        lens = cols.lengths

        masks: Dict[str, Optional[np.ndarray]] = {}
        if self._fused_set is not None:
            member = self._fused_set.member_masks(
                self._fused_set.classify(arena, offs, lens))
            masks = {name: member[slot]
                     for name, slot in self._fused_slots.items()}
        self._classify_blocks(group, cols, arena, offs, lens, masks)

    def fused_stage_spec(self, ctx):
        """The start/continue/end classify scan as the LAST stage of a fused
        program (``terminal``: the block merge rebuilds the rows, so no
        later member can read the packed ones); the block walk and the
        carry are unchanged host logic over the scan's tag masks."""
        fs = self._fused_set
        if fs is None or not fs.fdfa.device_ok or fs.kernel is None:
            return None
        if not ctx.bind_source(b"content"):
            return None
        from ..ops import fused_pipeline as fp
        from ..pipeline.fused_chain import FusedMemberStage
        spec = fp.StageSpec("scan", fs.fdfa,
                            ["scan"] + list(fs.fdfa.patterns),
                            staged=fs.kernel, terminal=True,
                            label="multiline-classify")
        return FusedMemberStage(spec, self._fused_apply)

    def _fused_apply(self, group, src, out, rowmap):
        cols = group.columns
        if cols is None or group._events or len(rowmap) != len(cols):
            return rowmap
        arena = group.source_buffer.as_array()
        tags = np.asarray(out[0]).astype(np.uint32)[rowmap]
        member = self._fused_set.member_masks(tags)
        masks = {name: member[slot]
                 for name, slot in self._fused_slots.items()}
        self._classify_blocks(group, cols, arena,
                              cols.offsets.astype(np.int64), cols.lengths,
                              masks)
        return rowmap

    def _classify_blocks(self, group, cols, arena, offs, lens,
                         masks: Dict[str, Optional[np.ndarray]]) -> None:
        n = len(cols)
        is_start = (self._classify(masks, "start", self.start, arena, offs,
                                   lens)
                    if self.start else np.zeros(n, dtype=bool))
        is_end = (self._classify(masks, "end", self.end, arena, offs, lens)
                  if self.end else None)
        is_cont = (self._classify(masks, "cont", self.cont, arena, offs,
                                  lens)
                   if self.cont else None)

        # blocks as parallel arrays (first[k], last[k]) + sorted unmatched
        # indices — vectorised in the hot modes (start-only, end-only);
        # start+end / start+cont have a sequential absorb dependency and
        # walk Python lists
        if self.start is not None:
            starts_idx = np.nonzero(is_start)[0]
            if is_end is not None or is_cont is not None:
                first, last, unmatched = self._walk_blocks(
                    n, is_start.tolist(),
                    is_end.tolist() if is_end is not None else None,
                    is_cont.tolist() if is_cont is not None else None)
            else:
                # start-only: block k spans starts_idx[k] ..
                # (starts_idx[k+1] - 1); leading lines are unmatched
                if len(starts_idx):
                    first = starts_idx.astype(np.int64)
                    last = np.concatenate([starts_idx[1:] - 1, [n - 1]])
                    unmatched = np.arange(int(starts_idx[0]), dtype=np.int64)
                else:
                    first = np.zeros(0, dtype=np.int64)
                    last = np.zeros(0, dtype=np.int64)
                    unmatched = np.arange(n, dtype=np.int64)
        else:
            # end-only mode: block closes at each end-match
            ends_idx = np.nonzero(is_end)[0].astype(np.int64)
            if len(ends_idx):
                last = ends_idx
                first = np.concatenate([[0], ends_idx[:-1] + 1])
                tail_start = int(ends_idx[-1]) + 1
            else:
                first = last = np.zeros(0, dtype=np.int64)
                tail_start = 0
            unmatched = np.arange(tail_start, n, dtype=np.int64)

        self._finish(group, cols, arena, first, last, unmatched, is_end)

    @staticmethod
    def _walk_blocks(n, s_l, e_l, c_l):
        """start+end / start+cont block walk (sequential absorb dependency:
        a start line inside an open block is consumed by it, so this cannot
        vectorise).  end mode closes at an end-match; cont mode extends
        while the NEXT line continues."""
        firsts: List[int] = []
        lasts: List[int] = []
        unmatched_l: List[int] = []
        i = 0
        while i < n:
            if s_l[i]:
                j = i
                if e_l is not None:
                    while j < n and not e_l[j]:
                        j += 1
                    if j >= n:
                        j = n - 1
                else:
                    while j + 1 < n and c_l[j + 1]:
                        j += 1
                firsts.append(i)
                lasts.append(j)
                i = j + 1
            else:
                unmatched_l.append(i)
                i += 1
        return (np.array(firsts, dtype=np.int64),
                np.array(lasts, dtype=np.int64),
                np.array(unmatched_l, dtype=np.int64))

    # -- carry stitching + emission -----------------------------------------

    def _source_key(self, group: PipelineEventGroup) -> str:
        path = group.get_metadata(EventGroupMetaKey.LOG_FILE_PATH) or ""
        ino = group.get_metadata(EventGroupMetaKey.LOG_FILE_INODE) or ""
        return f"{path}:{ino}"

    def _finish(self, group, cols, arena, first, last, unmatched,
                is_end) -> None:
        n = len(cols)
        offs = cols.offsets.astype(np.int64)
        lens = cols.lengths.astype(np.int64)
        tss = cols.timestamps
        key = self._source_key(group)
        ml_continue = group.get_metadata(EventGroupMetaKey.ML_CONTINUE) == "1"
        ml_partial = group.get_metadata(
            EventGroupMetaKey.ML_PARTIAL_TAIL) == "1"
        with self._carry_lock:
            carried = self._carry.pop(key, None)

        # injected: (order, bytes, ts) — carried records copied into the
        # group's arena at emit time (offset-stable across buffer growth)
        injected: List[Tuple[int, bytes, int]] = []

        # expire orphaned stashes (source rotated/deleted and never came
        # back): deliver their bytes through THIS group rather than losing
        # them — content intact, group-level source meta may differ
        now = time.monotonic()
        with self._carry_lock:
            for k in list(self._carry):
                b, t, at = self._carry[k]
                if now - at > CARRY_TTL_S:
                    del self._carry[k]
                    injected.append((-2, b, t))

        # leading run of unmatched lines (contiguous from line 0) — the
        # lines a carried open record can continue into
        m = len(unmatched)
        brk = np.nonzero(unmatched != np.arange(m))[0]
        lead_end = int(brk[0]) if len(brk) else m

        lead_consumed = 0
        if carried is not None:
            cbytes, cts, _ = carried
            take = 0               # leading lines absorbed into the carry
            closed = False         # the absorbed run CLOSES the record
            if ml_continue:
                if self.end is not None and self.start is None:
                    # end-only mode: continuation lines close at an
                    # end-match and therefore form blocks[0], not unmatched
                    if len(first) and first[0] == 0:
                        take = int(last[0]) + 1
                        first, last = first[1:], last[1:]
                        closed = True
                    elif not len(first) and lead_end == n:
                        take = n   # no END yet: whole chunk continues
                else:
                    # start modes: absorb the leading unmatched run, but in
                    # start+end mode STOP at the first end-match — lines
                    # after it are ordinary unmatched content
                    take = lead_end
                    if is_end is not None:
                        hits = np.nonzero(is_end[:lead_end])[0]
                        if len(hits):
                            take = int(hits[0]) + 1
                            closed = True
            if take > 0:
                span_lo = int(offs[0])
                span_hi = int(offs[take - 1] + lens[take - 1])
                # line spans exclude their trailing newline, so the joint
                # between the carried half and this chunk needs it back
                merged = cbytes + b"\n" + bytes(
                    arena[span_lo:span_hi].tobytes())
                lead_consumed = take
                if ml_partial and not closed and take == n and not len(first):
                    # the whole chunk is still the SAME open record —
                    # keep carrying (unless it outgrew the cap)
                    self._stash(key, merged, cts, injected)
                else:
                    injected.append((-1, merged, cts))
            else:
                # record ended exactly at the chunk boundary (next line is a
                # start) or the continuation never arrived: emit standalone
                injected.append((-1, cbytes, cts))

        # tail record to stash when this chunk breaks mid-record (skip when
        # the whole chunk was already re-stashed as the carried record)
        if ml_partial and lead_consumed < n:
            if len(last) and last[-1] == n - 1:
                f_, l_ = int(first[-1]), int(last[-1])
                first, last = first[:-1], last[:-1]
                lo = int(offs[f_])
                hi = int(offs[l_] + lens[l_])
                self._stash(key, bytes(arena[lo:hi].tobytes()),
                            int(tss[f_]), injected)
            else:
                # trailing contiguous unmatched run ending at the last line
                # continues an open record
                m = len(unmatched)
                rev_brk = np.nonzero(
                    unmatched[::-1] != (n - 1 - np.arange(m)))[0]
                run = int(rev_brk[0]) if len(rev_brk) else m
                run = min(run, n - lead_consumed)
                if run > 0:
                    tail_run = unmatched[m - run:]
                    unmatched = unmatched[:m - run]
                    lo = int(offs[tail_run[0]])
                    hi = int(offs[tail_run[-1]] + lens[tail_run[-1]])
                    self._stash(key, bytes(arena[lo:hi].tobytes()),
                                int(tss[tail_run[0]]), injected)

        kept = (unmatched[unmatched >= lead_consumed]
                if self.unmatched != "discard"
                else np.zeros(0, dtype=np.int64))
        # records, vectorised: blocks are [offs[first], offs[last]+lens[last])
        # spans (newlines included — contiguous arena slices), unmatched
        # lines are their own spans; `order` (the block's first line index)
        # restores input order
        rec_order = np.concatenate([first, kept])
        rec_off = np.concatenate([offs[first], offs[kept]])
        rec_len = np.concatenate(
            [offs[last] + lens[last] - offs[first], lens[kept]])
        rec_ts = (tss[rec_order] if tss is not None
                  else np.zeros(len(rec_order), dtype=np.int64))
        self._emit(group, rec_order, rec_off, rec_len, rec_ts, injected)

    def _stash(self, key, data: bytes, ts: int, injected) -> None:
        if len(data) > CARRY_CAP_BYTES:
            injected.append((1 << 30, data, ts))  # too big: emit as-is, last
            return
        with self._carry_lock:
            prev = self._carry.pop(key, None)
            self._carry[key] = (data, ts, time.monotonic())
        if prev is not None:
            # With multiple processor threads, chunks of one source can be
            # processed out of order: a concurrent worker stashed for this
            # key between our pop and this stash. Overwriting would LOSE
            # that open record — emit it standalone instead (degraded
            # stitching, zero loss).
            injected.append((-3, prev[0], prev[1]))

    # -- pipeline drain hooks (idle/shutdown delivery of held records) ------

    def _carry_group(self, key: str, data: bytes,
                     ts: int) -> PipelineEventGroup:
        from ..models import SourceBuffer
        sb = SourceBuffer(len(data) + 64)
        g = PipelineEventGroup(sb)
        view = sb.copy_string(data)
        g.set_columns(ColumnarLogs(
            offsets=np.array([view.offset], np.int32),
            lengths=np.array([len(data)], np.int32),
            timestamps=np.array([ts or int(time.time())], np.int64)))
        path, _, ino = key.rpartition(":")
        if path:
            g.set_metadata(EventGroupMetaKey.LOG_FILE_PATH, path)
        if ino:
            g.set_metadata(EventGroupMetaKey.LOG_FILE_INODE, ino)
        return g

    def flush_timeout_groups(self) -> List[PipelineEventGroup]:
        """Carried records whose continuation never arrived flush on the
        pipeline's timeout tick, so an idle source still delivers its last
        record (reference flush-timeout semantics)."""
        now = time.monotonic()
        expired: List[Tuple[str, bytes, int]] = []
        with self._carry_lock:
            for key in list(self._carry):
                data, ts, at = self._carry[key]
                if now - at >= CARRY_FLUSH_S:
                    del self._carry[key]
                    expired.append((key, data, ts))
        return [self._carry_group(k, d, t) for k, d, t in expired]

    def drain_groups(self) -> List[PipelineEventGroup]:
        """Shutdown: every held record ships (pipeline stop drain)."""
        with self._carry_lock:
            held = list(self._carry.items())
            self._carry.clear()
        return [self._carry_group(k, d, t) for k, (d, t, _) in held]

    def _emit(self, group, rec_order, rec_off, rec_len, rec_ts,
              injected) -> None:
        sb = group.source_buffer
        if injected:
            extra = []
            for order, data, ts in injected:
                view = sb.copy_string(data)
                extra.append((order, view.offset, len(data), ts))
            rec_order = np.concatenate(
                [rec_order, [r[0] for r in extra]])
            rec_off = np.concatenate([rec_off, [r[1] for r in extra]])
            rec_len = np.concatenate([rec_len, [r[2] for r in extra]])
            rec_ts = np.concatenate([rec_ts, [r[3] for r in extra]])
        idx = np.argsort(rec_order, kind="stable")
        group.set_columns(ColumnarLogs(
            offsets=rec_off[idx].astype(np.int32),
            lengths=rec_len[idx].astype(np.int32),
            timestamps=rec_ts[idx].astype(np.int64)))
