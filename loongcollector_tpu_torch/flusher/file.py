"""flusher_file — local file sink (reference
core/plugin/flusher/file/FlusherFile.cpp: spdlog-based JSON sink).

The port flushes once per group, in place of the JAX package's Batcher;
the bytes written are the same.  With the ledger on, each group's
serialized payload is booked at ``serialize`` (the pipeline books the
send_ok once ``send`` returns)."""

from __future__ import annotations

import os
from typing import Any, Dict

from ..models import PipelineEventGroup
from ..monitor import ledger
from ..pipeline.plugin.interface import Flusher, PluginContext
from ..pipeline.serializer.json_serializer import JsonSerializer


class FlusherFile(Flusher):
    name = "flusher_file"

    def __init__(self) -> None:
        super().__init__()
        self.file_path = ""
        self.serializer = JsonSerializer()

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.file_path = config.get("FilePath", "")
        if not self.file_path:
            return False
        d = os.path.dirname(self.file_path)
        if d:
            os.makedirs(d, exist_ok=True)
        return True

    def send(self, group: PipelineEventGroup) -> bool:
        data = self.serializer.serialize([group])
        if ledger.is_on():
            ledger.record(self.context.pipeline_name, ledger.B_SERIALIZE,
                          len(group), len(data))
        with open(self.file_path, "ab") as f:
            f.write(data)
        return True
