"""The aggregator interface.

Reference: loongcollector_tpu/aggregator/base.py:29-37 (pkg/pipeline/
aggregator.go:24-51, the Add/Flush contract between the processor and
flusher stages).  The port has one aggregator, ``aggregator_metric_rollup``;
the reference's regrouping aggregators (``aggregator_base``,
``aggregator_context``, ``aggregator_metadata_group``,
``aggregator_shardhash``, ``aggregator_content_value_group``,
``aggregator_logstore_router``) come with a later slice.
"""

from __future__ import annotations

from typing import List

from ..models import PipelineEventGroup
from ..pipeline.plugin.interface import Plugin


class Aggregator(Plugin):
    """add() may buffer; returns completed groups. flush() drains all."""

    def add(self, group: PipelineEventGroup) -> List[PipelineEventGroup]:
        raise NotImplementedError

    def flush(self) -> List[PipelineEventGroup]:
        return []
