"""loongledger: end-to-end event-conservation accounting.

The zero-loss guarantee the chaos storms assert post-hoc becomes
an always-on observability plane: every hand-off on the event path records
into a per-(pipeline, boundary) ledger of event/byte totals, so the
conservation residual

    residual = (ingest + process_expand + fanout + replay)
             - (send_ok + process_drop + spill + quarantine + drop)
             - inflight

is computable at any instant from one snapshot.  At a QUIESCED instant —
two identical consecutive snapshots and zero observed live occupancy —
``inflight`` is zero and a nonzero residual means an event crossed into
the agent and vanished without a ledger entry: a silent loss (or a code
path that discards without ``ledger.record`` — loonglint's
``unledgered-drop`` checker is the static side of the same contract).

Boundary catalogue (docs/observability.md#event-conservation-ledger):

  ingest               input read (file reader, test/bench harnesses)
  enqueue / dequeue    watermark process queues (enqueue at queue admit,
                       dequeue at queue pop); the dequeue→process_in gap
                       covers the dispatch hop + per-worker inboxes,
                       whose occupancy live_inflight() observes directly
  process_in           events entering the processor chain
  process_expand       events CREATED mid-chain (split 1 raw -> N lines;
                       also drain re-entry of held multiline carries)
  process_drop         events retired mid-chain, attributed to the
                       dropping plugin (includes events HELD across
                       groups by stateful processors — the matching
                       release records process_expand tag="drain")
  process_out          events leaving the chain toward the flushers
  device_submit /      group enters / leaves a worker lane's overlapped
  device_materialize   device ring (loongstream), tagged per lane
  serialize            events serialized into a sink payload
  send_ok / send_fail  terminal delivery / one failed attempt (partial-ack
                       aware: a Kafka ack-window cut ledgers the acked
                       prefix as send_ok, the unacked tail as send_fail
                       and retries it — never double-counted)
  spill / replay /     disk buffer traffic (breaker spill-on-open, exit
  quarantine           drain, corrupt-at-rest quarantine)
  fanout               extra copies minted when the router matches more
                       than one flusher
  drop                 explicit terminal discard, reason-tagged
  agg_in / agg_fold /  the loongagg windowed rollup contraction: rows in,
  agg_emit             rows consumed by the fold (sink), rollup rows
                       minted at window close (source); open windows are
                       live occupancy via the aggregator's
                       open_window_rows probe

The ledger is OFF by default and every hook is one module-global read
(``ledger.is_on()``) + branch.  ``LOONG_LEDGER=1`` turns the accounting
on.

The port's copy of the JAX package's ``monitor/ledger.py``: the
boundaries, the ledger, the module hooks and the residual math.  The port
records at the boundaries its paths cross (ingest at the process-queue
admit, enqueue and dequeue, process_in / out / drop / expand per plugin
and per fused run, device_submit / device_materialize at the runner's
lanes, serialize and send_ok at the flushers, and the rollup's agg_in /
agg_fold / agg_emit / drop).  Not ported yet: the continuous auditor
(``LOONG_LEDGER_AUDIT``), the live-occupancy probe it reads, the lag
watermarks and the export records.  ``--once`` reads the residual after
the run has drained, when nothing is in flight.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

ENV_LEDGER = "LOONG_LEDGER"

# -- boundary names ---------------------------------------------------------

B_INGEST = "ingest"
B_ENQUEUE = "enqueue"
B_DEQUEUE = "dequeue"
B_PROCESS_IN = "process_in"
B_PROCESS_OUT = "process_out"
B_PROCESS_DROP = "process_drop"
B_PROCESS_EXPAND = "process_expand"
B_DEVICE_SUBMIT = "device_submit"
B_DEVICE_MATERIALIZE = "device_materialize"
B_SERIALIZE = "serialize"
B_SEND_OK = "send_ok"
B_SEND_FAIL = "send_fail"
B_SPILL = "spill"
B_REPLAY = "replay"
B_QUARANTINE = "quarantine"
B_FANOUT = "fanout"
B_DROP = "drop"
# loongagg: the windowed fold is an N→M contraction with its own counted,
# attributed boundaries — agg_in (rows entering the rollup aggregator,
# informational like process_in), agg_fold (rows CONSUMED by the fold: a
# residual sink — the events are accounted for, their content now lives
# in open-window partials the auditor counts as live occupancy), agg_emit
# (rollup rows MINTED at window close: a residual source that then flows
# to the normal serialize/send_ok exits)
B_AGG_IN = "agg_in"
B_AGG_FOLD = "agg_fold"
B_AGG_EMIT = "agg_emit"

BOUNDARIES = (B_INGEST, B_ENQUEUE, B_DEQUEUE, B_PROCESS_IN, B_PROCESS_OUT,
              B_PROCESS_DROP, B_PROCESS_EXPAND, B_DEVICE_SUBMIT,
              B_DEVICE_MATERIALIZE, B_SERIALIZE, B_SEND_OK, B_SEND_FAIL,
              B_SPILL, B_REPLAY, B_QUARANTINE, B_FANOUT, B_DROP,
              B_AGG_IN, B_AGG_FOLD, B_AGG_EMIT)

#: residual = sum(sources) - sum(sinks) - inflight
SOURCE_BOUNDARIES = (B_INGEST, B_PROCESS_EXPAND, B_FANOUT, B_REPLAY,
                     B_AGG_EMIT)
SINK_BOUNDARIES = (B_SEND_OK, B_PROCESS_DROP, B_SPILL, B_QUARANTINE, B_DROP,
                   B_AGG_FOLD)


class EventLedger:
    """Per-(pipeline, boundary[, tag]) event/byte totals.

    One short lock around two integer adds per record() — the counters are
    process-lifetime absolutes (never drained), so a snapshot is directly
    comparable across time and the residual needs no delta bookkeeping."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (pipeline, boundary, tag) -> [events, bytes]
        self._cells: Dict[Tuple[str, str, str], List[int]] = {}

    def record(self, pipeline: str, boundary: str, events: int,
               nbytes: int = 0, tag: str = "") -> None:
        key = (pipeline or "", boundary, tag)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = [0, 0]
            cell[0] += events
            cell[1] += nbytes

    def total(self, pipeline: str, boundary: str) -> int:
        """Event total at one boundary, summed over tags."""
        with self._lock:
            return sum(c[0] for (p, b, _t), c in self._cells.items()
                       if p == pipeline and b == boundary)

    def pipelines(self) -> List[str]:
        with self._lock:
            return sorted({p for (p, _b, _t) in self._cells})

    def snapshot(self) -> dict:
        """{pipeline: {boundary: {"events", "bytes", "tags"?}}} — plain
        nested dicts, directly comparable (two equal snapshots == no
        boundary crossed in between)."""
        with self._lock:
            cells = dict(self._cells)
        out: Dict[str, dict] = {}
        for (p, b, t), (ev, by) in sorted(cells.items()):
            brow = out.setdefault(p, {}).setdefault(
                b, {"events": 0, "bytes": 0})
            brow["events"] += ev
            brow["bytes"] += by
            if t:
                brow.setdefault("tags", {})[t] = {"events": ev, "bytes": by}
        return out

    def reset(self) -> None:
        """Tests only: forget every total."""
        with self._lock:
            self._cells.clear()


# ---------------------------------------------------------------------------
# module-global hook (chaos-plane idiom: one global read when off)

_ledger: Optional[EventLedger] = None


def is_on() -> bool:
    return _ledger is not None


def active_ledger() -> Optional[EventLedger]:
    return _ledger


def record(pipeline: str, boundary: str, events: int,
           nbytes: int = 0, tag: str = "") -> None:
    """Record one boundary crossing.  No-op (one global read + branch)
    while the ledger is disabled; hot paths with non-trivial argument
    expressions guard with ``if ledger.is_on():`` so the disabled cost
    stays one branch."""
    led = _ledger
    if led is None:
        return
    led.record(pipeline, boundary, events, nbytes, tag)


def enable() -> EventLedger:
    global _ledger
    if _ledger is None:
        _ledger = EventLedger()
    return _ledger


def disable() -> None:
    """Turn accounting off."""
    global _ledger
    _ledger = None


def install_from_env(env=os.environ) -> bool:
    """``LOONG_LEDGER=1`` enables accounting.  Returns True when the ledger
    came on."""
    if env.get(ENV_LEDGER, "") in ("", "0"):
        return False
    enable()
    return True


# ---------------------------------------------------------------------------
# residual math

def residual_of(pipe_snap: dict, inflight: int = 0) -> int:
    """Conservation residual for one pipeline's snapshot row."""
    ev = lambda b: pipe_snap.get(b, {}).get("events", 0)  # noqa: E731
    sources = sum(ev(b) for b in SOURCE_BOUNDARIES)
    sinks = sum(ev(b) for b in SINK_BOUNDARIES)
    return sources - sinks - inflight


def residuals(snap: dict) -> Dict[str, int]:
    """Per-pipeline QUIESCED residuals over a full snapshot (inflight is
    provably zero at quiesce, the only instant residuals are evaluated).
    The "" pipeline row (boundary traffic with no pipeline attribution)
    is skipped — it has no entry boundary to conserve against."""
    return {p: residual_of(rows) for p, rows in snap.items() if p}


def record_delta(pipeline: str, n_in: int, n_out: int, tag: str) -> None:
    """A stage that changed the event population either minted events
    (split: process_expand) or retired or held them (filter, multiline
    carry: process_drop), attributed to ``tag`` (the plugin).  The
    reference books this on its ``ProcessorInstance`` (``_ledger_delta``);
    the port's pipeline and fused runs call it around each stage."""
    delta = n_out - n_in
    if delta > 0:
        record(pipeline, B_PROCESS_EXPAND, delta, tag=tag)
    elif delta < 0:
        record(pipeline, B_PROCESS_DROP, -delta, tag=tag)
