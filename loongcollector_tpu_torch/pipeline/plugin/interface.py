"""Plugin interfaces: Input / Processor / Flusher.

Reference: core/collection_pipeline/plugin/interface/{Input,Processor,
Flusher}.h — Init(config, context), Start/Stop for inputs, Process(group) for
processors, Send(group)/FlushAll for flushers.  The port's slice keeps the
synchronous surface only: no ledger, SLO or ack-watermark hooks and no
async dispatch protocol.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import torch

from ...models import PipelineEventGroup


class PluginContext:
    """Per-pipeline context handed to every plugin instance (reference
    CollectionPipelineContext).  ``device`` is where device-backed plugins
    run their kernels."""

    def __init__(self, pipeline_name: str = "", config: Optional[dict] = None,
                 device: Optional[torch.device] = None):
        self.pipeline_name = pipeline_name
        self.config = config or {}
        self.device = device


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

    def read_all(self) -> Iterator[PipelineEventGroup]:  # pragma: no cover
        """One-shot read of everything available now."""
        raise NotImplementedError


class Processor(Plugin):
    """Process mutates the group in place (reference Processor.h:28-37)."""

    name = "processor_base"

    def process(self, group: PipelineEventGroup) -> None:  # pragma: no cover
        raise NotImplementedError


class Flusher(Plugin):
    name = "flusher_base"

    def send(self, group: PipelineEventGroup) -> bool:  # pragma: no cover
        raise NotImplementedError
