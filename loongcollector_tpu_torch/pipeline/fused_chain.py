"""Plan and run fused stage runs (resident stage fusion).

Reference: loongcollector_tpu/pipeline/fused_chain.py.  ``plan_fusion``
walks a pipeline's processor chain at init and asks each plugin for its
resident stage form (``Processor.fused_stage_spec``): every maximal run of
two or more consecutive fusable stages becomes a ``FusedRun`` backed by
one ``FusedProgramKernel`` (``ops/fused_pipeline.py``, K7 on the card).
At process time the run packs the group's source column once, dispatches
the one program a chunk, and applies each member's host epilogue in order
over a row-index map: a filter's compaction re-indexes every later
member's outputs, which the program computed for all packed rows (member
stages are per-row independent).

Binding rules (``FusionPlanContext``): the run packs ONE source column;
members either read those rows or bind a capture column an earlier member
produced.  A stage whose inputs cannot be proven statically — a field
minted outside the run, a source key an earlier member consumed — refuses
to fuse and ends the run; it keeps its per-stage path.

A group the run cannot take runs the members per-stage, inline: a group
that is not columnar or has no rows, and a group holding a row longer
than the largest length bucket (4096 bytes) — the reference's group-level
rule (``fused_chain.py:150``), counted in ``long_row_groups``.

Each member's apply and per-stage ``process`` run through the caller's
``stage`` hook (the pipeline's ``_stage``: the member's host seconds and,
with the ledger on, its population change, after the earlier members'
compaction; reference ``fused_chain.py:170-190``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.device_batch import LENGTH_BUCKETS
from ..ops.fused_pipeline import (FusedDispatch, fusion_enabled,
                                  get_fused_program)


class FusionPlanContext:
    """What the planner knows while growing one run: the packed source
    column, capture columns produced by earlier members (name →
    (stage_idx, cap_idx)), and which keys a member consumed."""

    def __init__(self) -> None:
        self.source_key: Optional[bytes] = None
        self.consumed: set = set()
        self.fields: Dict[str, Tuple[int, int]] = {}
        self.n_stages = 0

    def bind_source(self, key) -> bool:
        """True when this stage may read the run's packed source rows."""
        skey = key.decode("latin-1") if isinstance(key, bytes) else key
        if skey in self.consumed:
            return False
        if self.source_key is None:
            self.source_key = key if isinstance(key, bytes) else key.encode()
            return True
        return skey == self.source_key.decode("latin-1")

    def resolve(self, key) -> Optional[object]:
        """'source', ("capture", stage_idx, cap_idx), or None (not
        statically resident: the stage must not fuse)."""
        skey = key.decode("latin-1") if isinstance(key, bytes) else key
        got = self.fields.get(skey)
        if got is not None:
            return ("capture", got[0], got[1])
        if self.source_key is not None \
                and skey == self.source_key.decode("latin-1") \
                and skey not in self.consumed:
            return "source"
        if self.source_key is None:
            # a filter heading the run establishes the source column
            return "source"
        return None

    def note_fields(self, stage_idx: int, names: Sequence[str]) -> None:
        for cap, name in enumerate(names):
            if name:
                self.fields[name] = (stage_idx, cap)

    def note_consumed(self, key) -> None:
        skey = key.decode("latin-1") if isinstance(key, bytes) else key
        self.consumed.add(skey)


class FusedMemberStage:
    """One processor's part of a run: its StageSpec and its host epilogue,
    ``apply(group, src, stage_out, rowmap) -> rowmap`` (outputs computed
    over the run's packed rows, indexed through ``rowmap``)."""

    __slots__ = ("spec", "apply")

    def __init__(self, spec, apply):
        self.spec = spec
        self.apply = apply


# stage-seconds callback of the pipeline: timed(name, fn, *args)
Timed = Callable[..., object]


def _untimed(_name, fn, *args):
    return fn(*args)


def _unstaged(_plugin, fn, group, *args):
    return fn(group, *args)


class FusedRun:
    """A planned run of consecutive fusable stages [head, end) on
    ``device``, its program built at first use (and the kernel built and
    its descriptor uploaded there, on the card).  Counts, under a lock
    (runner workers share the pipeline): ``fused_groups`` dispatched as one
    program, ``long_row_groups`` run per-stage for a row over 4096 bytes,
    ``other_groups`` run per-stage otherwise."""

    def __init__(self, head: int, end: int, instances, members,
                 source_key: bytes, device: Optional[torch.device]):
        self.head = head
        self.end = end
        self.instances = list(instances)
        self.members: List[FusedMemberStage] = list(members)
        self.source_key = source_key
        self.device = device
        self._program = None
        self._lock = threading.Lock()
        self.fused_groups = 0
        self.long_row_groups = 0
        self.other_groups = 0

    def enabled(self) -> bool:
        return fusion_enabled(self.device)

    def program(self):
        if self._program is None:
            with self._lock:
                if self._program is None:
                    program = get_fused_program([m.spec for m in self.members])
                    program.warm(self.device)
                    self._program = program
        return self._program

    def reset_counts(self) -> None:
        with self._lock:
            self.fused_groups = self.long_row_groups = self.other_groups = 0

    def _note(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)

    # -- execution ------------------------------------------------------------

    def dispatch(self, groups, timed: Timed = _untimed,
                 stage: Timed = _unstaged) -> List:
        """A token a group; a group the run cannot take runs the member
        processors per-stage inline here and gets None.  ``timed(name, fn,
        *args)`` times the run's own steps, ``stage(member, fn, group,
        *args)`` a member's work on a group."""
        tokens: List = []
        try:
            for g in groups:
                tok = timed("fused_dispatch", self._dispatch_group, g)
                if tok is None:
                    for inst in self.instances:
                        stage(inst, inst.process, g)
                tokens.append(tok)
        except BaseException:
            self._release(tokens)
            raise
        return tokens

    @staticmethod
    def _release(tokens) -> None:
        """Release the dispatches of tokens that will not complete."""
        for tok in tokens:
            if tok is not None:
                tok[1].abandon()

    def _dispatch_group(self, group):
        from ..processor.common import extract_source
        src = extract_source(group, self.source_key)
        if src is None or not src.columnar or len(src.offsets) == 0:
            self._note("other_groups")
            return None
        if int(src.lengths.max()) > LENGTH_BUCKETS[-1]:
            # rows over the largest bucket keep the per-stage path (the
            # reference's group-level rule)
            self._note("long_row_groups")
            return None
        d = FusedDispatch(self.program(), src.arena, src.offsets,
                          src.lengths, self.device).dispatch()
        self._note("fused_groups")
        return (src, d)

    def complete(self, groups, tokens, timed: Timed = _untimed,
                 stage: Timed = _unstaged) -> None:
        for i, (g, tok) in enumerate(zip(groups, tokens)):
            if tok is None:
                continue
            src, d = tok
            try:
                res = timed("fused_result", d.result)
            except BaseException:
                self._release(tokens[i + 1:])
                raise
            rowmap = np.arange(res.n)
            for inst, member, out in zip(self.instances, self.members,
                                         res.stages):
                rowmap = stage(inst, member.apply, g, src, out, rowmap)


def plan_fusion(chain, device: Optional[torch.device] = None
                ) -> List[FusedRun]:
    """Every maximal run of two or more consecutive stages whose plugins
    give a statically bindable StageSpec becomes a FusedRun on ``device``.
    Planning is description: no kernel build, no device transfer."""
    runs: List[FusedRun] = []
    i = 0
    n = len(chain)
    while i < n:
        ctx = FusionPlanContext()
        members: List[FusedMemberStage] = []
        insts = []
        j = i
        while j < n:
            hook = getattr(chain[j], "fused_stage_spec", None)
            ms = hook(ctx) if hook is not None else None
            if ms is None:
                break
            ctx.n_stages += 1
            members.append(ms)
            insts.append(chain[j])
            j += 1
            if ms.spec.terminal:
                break
        if len(members) >= 2:
            runs.append(FusedRun(i, j, insts, members, ctx.source_key,
                                 device))
            i = j
        else:
            i += 1
    return runs
