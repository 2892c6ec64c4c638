"""Inner processor: decode PB-encoded LogGroups back into events.

Reference: core/plugin/processor/inner/ProcessorParseFromPBNative.cpp —
the forward path (gRPC ingest, agent-to-agent transfer) carries serialized
SLS LogGroup bytes; this processor expands them into ordinary events so
the rest of the pipeline sees what the sending agent saw.

Decoding reuses the serializer module's wire reader (the exact inverse of
the SLS serializer, differentially tested against it).

The port's copy of the JAX package's ``processor/parse_from_pb.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..models import LogEvent, PipelineEventGroup, RawEvent
from ..pipeline.plugin.interface import PluginContext, Processor
from ..pipeline.serializer.sls_serializer import parse_loggroup
from ..utils.logger import get_logger

log = get_logger("parse_from_pb")


class ProcessorParseFromPB(Processor):
    name = "processor_parse_from_pb_native"

    def __init__(self) -> None:
        super().__init__()
        self.source_key = b"content"

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.source_key = config.get("SourceKey", "content").encode()
        return True

    def process(self, group: PipelineEventGroup) -> None:
        payloads: List[bytes] = []
        keep = []
        for ev in group.events:
            data = None
            if isinstance(ev, RawEvent) and ev.content is not None:
                data = ev.content.to_bytes()
            elif isinstance(ev, LogEvent):
                v = ev.get_content(self.source_key)
                if v is not None:
                    data = v.to_bytes()
            if data is None:
                keep.append(ev)
                continue
            payloads.append(data)
        if not payloads:
            return
        group._events = keep
        for data in payloads:
            try:
                # decode straight into THIS group's buffer: each string is
                # copied exactly once on the forward ingest path
                parse_loggroup(data, group=group)
            except (ValueError, IndexError) as e:
                log.warning("undecodable LogGroup payload (%d bytes): %s",
                            len(data), e)
