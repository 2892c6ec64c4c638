"""Plugin interfaces: Input / Processor / Flusher.

Reference: core/collection_pipeline/plugin/interface/{Input,Processor,
Flusher}.h — Init(config, context), Start/Stop for inputs, Process(group) for
processors, Send(group)/FlushAll for flushers — and the JAX package's
dispatch/complete protocol for device-backed processors
(``loongcollector_tpu/pipeline/plugin/interface.py:88-140``), with the
default ``fused_stage_spec`` hook of resident stage fusion (reference
``interface.py:126``).  The ack-watermark's terminal hooks live in the
flushers and the pipeline's drop boundaries; no ledger or SLO hooks here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from ...models import PipelineEventGroup


class PluginContext:
    """Per-pipeline context handed to every plugin instance (reference
    CollectionPipelineContext).  ``device`` is where device-backed plugins
    run their kernels; inputs push what they read into the pipeline's
    process queue (``process_queue_manager``, ``process_queue_key``);
    ``tail`` is true when the agent runs in tail mode (without
    ``--once``), where a file input follows its files."""

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

    def send(self, group: PipelineEventGroup) -> bool:  # pragma: no cover
        raise NotImplementedError
