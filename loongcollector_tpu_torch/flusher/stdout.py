"""flusher_stdout — JSON lines to stdout (quick-start sink).

The port flushes once per group, in place of the JAX package's Batcher;
the bytes written are the same.  With the ledger on, each group's
serialized payload is booked at ``serialize``."""

from __future__ import annotations

import sys

from ..models import PipelineEventGroup
from ..monitor import ledger
from ..pipeline.plugin.interface import Flusher
from ..pipeline.serializer.json_serializer import JsonSerializer


class FlusherStdout(Flusher):
    name = "flusher_stdout"

    def __init__(self) -> None:
        super().__init__()
        self.serializer = JsonSerializer()

    def send(self, group: PipelineEventGroup) -> bool:
        data = self.serializer.serialize([group])
        if ledger.is_on():
            ledger.record(self.context.pipeline_name, ledger.B_SERIALIZE,
                          len(group), len(data))
        sys.stdout.write(data.decode("utf-8", "replace"))
        sys.stdout.flush()
        return True
