"""input_file — reads FilePaths and supplies the line-split inner processor.

Reference: core/plugin/input/InputFile.cpp:213-250 — the input creates the
inner split processor and registers its discovery options with the file
server.  The port's slice reads the existing content of every matching
file once (``start``), pushing each group into the pipeline's bounded
process queue and waiting while the queue is at its high watermark, until
its feedback says it fell under the low one (JAX package
``input/file/input_file.py:107-108``).  With ``Multiline`` (a
``StartPattern`` or ``EndPattern``) the inner processors are the line
split and then ``processor_split_multiline_log_string_native``, as the
reference's (``input_file.py:47-52``), and the reader rolls back to whole
records.  Tailing and discovery options come with the file-server slice.
"""

from __future__ import annotations

import glob
import threading
import time
from typing import Any, Callable, Dict, Iterator, List

from ...models import PipelineEventGroup
from ...pipeline.plugin.interface import Input, PluginContext
from ...pipeline.queue.bounded_queue import FeedbackInterface
from .reader import LogFileReader


class _QueueFeedback(FeedbackInterface):
    """Wakes the blocked reader when its queue falls under the low
    watermark."""

    def __init__(self) -> None:
        self.event = threading.Event()

    def feedback(self, key: int) -> None:
        self.event.set()


class InputFile(Input):
    name = "input_file"

    # longest wait for the queue's feedback before the push is retried
    FEEDBACK_WAIT_S = 0.05

    def __init__(self) -> None:
        super().__init__()
        self.paths: List[str] = []
        self.multiline: Dict[str, Any] = {}
        self.read_seconds = 0.0
        self.groups_pushed = 0

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.paths = list(config.get("FilePaths", []))
        self.multiline = config.get("Multiline") or {}
        return bool(self.paths)

    def inner_processor_configs(self) -> List[Dict[str, Any]]:
        out = [{"Type": "processor_split_log_string_native"}]
        if self.multiline.get("StartPattern") \
                or self.multiline.get("EndPattern"):
            out.append({"Type": "processor_split_multiline_log_string_native",
                        "Multiline": self.multiline})
        return out

    def start(self, should_abort: Callable[[], bool] = lambda: False
              ) -> bool:
        """Read every matching file once into the pipeline's process
        queue.  Returns False when ``should_abort()`` stopped it early."""
        pqm = self.context.process_queue_manager
        key = self.context.process_queue_key
        fb = _QueueFeedback()
        pqm.get_queue(key).set_feedback(fb)
        groups = self.read_all()
        while True:
            t0 = time.perf_counter()
            group = next(groups, None)
            self.read_seconds += time.perf_counter() - t0
            if group is None:
                return True
            while True:
                fb.event.clear()
                if pqm.push_queue(key, group):
                    self.groups_pushed += 1
                    break
                if should_abort():
                    groups.close()
                    return False
                # at the high watermark: wait for the queue's feedback
                fb.event.wait(self.FEEDBACK_WAIT_S)

    def read_all(self) -> Iterator[PipelineEventGroup]:
        for pattern in self.paths:
            for path in sorted(glob.glob(pattern, recursive="**" in pattern)):
                reader = LogFileReader(
                    path, multiline_start=self.multiline.get("StartPattern"),
                    multiline_end=self.multiline.get("EndPattern"))
                if not reader.open():
                    continue
                try:
                    while True:
                        group = reader.read()
                        if group is None:
                            # ship the final partial line (no trailing \n)
                            group = reader.read(force_flush=True)
                            if group is None:
                                break
                        yield group
                finally:
                    reader.close()
