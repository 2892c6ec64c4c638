"""Plugin interfaces: Input / Processor / Flusher.

Reference: core/collection_pipeline/plugin/interface/{Input,Processor,
Flusher}.h — Init(config, context), Start/Stop for inputs, Process(group) for
processors, Send(group)/FlushAll for flushers — and the JAX package's
dispatch/complete protocol for device-backed processors
(``loongcollector_tpu/pipeline/plugin/interface.py:88-140``), with the
default ``fused_stage_spec`` hook of resident stage fusion (reference
``interface.py:126``).  The ack-watermark's terminal hooks live in the
flushers and the pipeline's drop boundaries.  ``Flusher`` carries the JAX
package's send-path surface (``interface.py:148-253``):
``ledger_terminal`` (a ``send`` that is delivery, booked ``send_ok`` by the
pipeline), ``spill_identity`` (the disk buffer's header), ``flush`` /
``flush_all`` and the ``_ledger_drop`` / ``_ledger_terminal_write``
helpers, which observe the SLO plane's drop and send_ok terminals as the
JAX package's do.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from ...models import PipelineEventGroup
from ...monitor import ledger, slo
from ...runner import ack_watermark


class PluginContext:
    """Per-pipeline context handed to every plugin instance (reference
    CollectionPipelineContext).  ``device`` is where device-backed plugins
    run their kernels; inputs push what they read into the pipeline's
    process queue (``process_queue_manager``, ``process_queue_key``);
    ``tail`` is true when the agent runs in tail mode (without
    ``--once``), where a file input follows its files.  ``extensions``
    holds the named extension instances of the pipeline's
    ``extensions:`` section (key ``<type>`` or ``<type>/<alias>``; JAX
    package ``interface.py:31-38``)."""

    def __init__(self, pipeline_name: str = "", config: Optional[dict] = None,
                 device: Optional[torch.device] = None,
                 process_queue_manager=None, process_queue_key: int = 0,
                 tail: bool = False):
        self.pipeline_name = pipeline_name
        self.config = config or {}
        self.device = device
        self.process_queue_manager = process_queue_manager
        self.process_queue_key = process_queue_key
        self.tail = tail
        self.extensions: Dict[str, Any] = {}

    def get_extension(self, ref: str):
        """Resolve an extension reference from another plugin's config."""
        return self.extensions.get(ref)


class Plugin:
    name: str = "plugin_base"

    def __init__(self) -> None:
        self.context: Optional[PluginContext] = None
        self.config: Dict[str, Any] = {}

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        self.context = context
        self.config = config
        return True


class Input(Plugin):
    name = "input_base"

    def inner_processor_configs(self) -> List[Dict[str, Any]]:
        return []

    def start(self, should_abort: Callable[[], bool] = lambda: False
              ) -> bool:  # pragma: no cover - interface
        """One-shot read of everything available now into the pipeline's
        process queue, stopping early once ``should_abort()`` is true; in
        tail mode, bind the input to its singleton runner."""
        raise NotImplementedError

    def stop(self) -> bool:
        return True


class Processor(Plugin):
    """Process mutates the group in place (reference Processor.h:28-37).

    Device-backed processors also implement the dispatch/complete split
    (``supports_async_dispatch = True``): ``process_dispatch`` starts the
    device work and returns an opaque token (None when nothing stays in
    flight); ``process_complete`` consumes it and applies the results.  The
    runner overlaps group N's device work with its neighbours' host
    stages."""

    name = "processor_base"
    supports_async_dispatch = False

    def process(self, group: PipelineEventGroup) -> None:  # pragma: no cover
        raise NotImplementedError

    def process_dispatch(self, group: PipelineEventGroup):
        """Start work on ``group``; sync plugins run to completion and
        return no token."""
        self.process(group)
        return None

    def process_complete(self, group: PipelineEventGroup, token) -> None:
        """Finish the work started by ``process_dispatch``."""

    def fused_stage_spec(self, ctx):
        """This plugin's device work as one stage of a fused program
        (``pipeline/fused_chain.FusedMemberStage``), or None when it cannot
        join one: no device tier, inputs not statically bindable against
        ``ctx`` (``FusionPlanContext``), or no device half at all.  A member
        keeps its own ``process`` path for the groups a run cannot take."""
        return None


class Flusher(Plugin):
    name = "flusher_base"

    #: True for sinks whose ``send()`` terminates delivery inline (local
    #: file, stdout): the pipeline then books ``send_ok`` for them.  Sinks
    #: that queue or batch toward a network hop keep False and book at
    #: their real delivery boundary (the flusher runner).
    ledger_terminal = False

    #: True when this sink's serialize path consumes span columns
    #: directly, so columnar groups reach the wire without per-event
    #: objects.
    supports_columnar = False

    def __init__(self) -> None:
        super().__init__()
        self.queue_key: int = 0
        self.sender_queue = None
        self.plugin_id: str = ""  # set by the pipeline: "<type>/<index>"

    def _ledger_pipeline(self) -> str:
        """Pipeline attribution for this sink's ledger records ("" when
        the flusher was never init()ed)."""
        return getattr(getattr(self, "context", None),
                       "pipeline_name", "") or ""

    def _ledger_drop(self, tag: str, n_events: int = 0, n_bytes: int = 0,
                     group: Optional[PipelineEventGroup] = None) -> None:
        """Reason-tagged terminal ``drop`` record for events this flusher
        discards.  Pass ``group`` to defer the count until the ledger is
        confirmed on; a dropped group is acked (forced) either way."""
        if group is not None:
            ack_watermark.ack_groups([group], force=True)
            if slo.is_on():
                slo.observe_groups(self._ledger_pipeline(), [group],
                                   slo.OUTCOME_DROP)
        if not ledger.is_on():
            return
        if group is not None:
            n_events, n_bytes = len(group), group.data_size()
        ledger.record(self._ledger_pipeline(), ledger.B_DROP,
                      n_events, n_bytes, tag=tag)

    def _ledger_terminal_write(self, groups: List[PipelineEventGroup],
                               write_fn) -> bool:
        """Run ``write_fn()`` — the sink's actual write of ``groups`` —
        with the write-through terminal accounting around it: ``send_ok``
        once the write lands, ``drop`` tagged ``flush_write_failed`` when
        it raises (logged, not re-raised: nothing upstream can retry a
        batch that left the batcher).  Returns False on a failed write."""
        led = ledger.is_on()
        n_events = sum(len(g) for g in groups)
        n_bytes = sum(g.data_size() for g in groups) if led else 0
        try:
            write_fn()
        except Exception:  # noqa: BLE001
            from ...utils.logger import get_logger
            get_logger("flusher").exception(
                "%s flush write failed; %d events dropped", self.name,
                n_events)
            ack_watermark.ack_groups(groups)
            if slo.is_on():
                slo.observe_groups(self._ledger_pipeline(), groups,
                                   slo.OUTCOME_DROP)
            if led:
                ledger.record(self._ledger_pipeline(), ledger.B_DROP,
                              n_events, n_bytes, tag="flush_write_failed")
            return False
        ack_watermark.ack_groups(groups)
        if slo.is_on():
            slo.observe_groups(self._ledger_pipeline(), groups,
                               slo.OUTCOME_SEND_OK)
        if led:
            ledger.record(self._ledger_pipeline(), ledger.B_SEND_OK,
                          n_events, n_bytes, tag=self.name)
        return True

    def spill_identity(self) -> Dict[str, str]:
        """Identity persisted with disk-buffered payloads; must uniquely
        address this flusher instance within its pipeline."""
        return {
            "pipeline": getattr(self.context, "pipeline_name", ""),
            "flusher_type": self.name,
            "plugin_id": self.plugin_id,
        }

    def send(self, group: PipelineEventGroup) -> bool:  # pragma: no cover
        raise NotImplementedError

    def flush(self, key: int = 0) -> bool:
        return True

    def flush_all(self) -> bool:
        return True

    def stop(self, is_pipeline_removing: bool = False) -> bool:
        return True
