"""input_file — reads FilePaths and supplies the line-split inner processor.

Reference: core/plugin/input/InputFile.cpp:213-250 — the input creates the
inner split processor and registers its discovery options with the file
server.  In tail mode (``context.tail``, the agent without ``--once``)
``start`` registers the input with the ``FileServer`` singleton
(``file_server.py``) and starts it, as the JAX package's input does
(``input/file/input_file.py:61-70``): the server's thread discovers the
files (``FilePaths`` globs, ``ExcludeFilePaths`` / ``ExcludeFiles`` /
``ExcludeDirs``), follows them through appends and rotation, resumes them
from their checkpoints and pushes what it reads; ``TailingAllMatchedFiles``
(or ``TailExisted``, default true) reads the files found at start from
their beginning, else from their end.  ``stop`` unregisters it.

``--once`` keeps the one-shot read: ``start`` reads the existing content
of every matching file once, pushing each group into the pipeline's
bounded process queue and waiting while the queue is at its high
watermark, until its feedback says it fell under the low one.  It does not
resume from checkpoints, where the JAX package's ``--once`` does
(``ROADMAP.md`` Queue 3).

With ``Multiline`` (a ``StartPattern`` or ``EndPattern``) the inner
processors are the line split and then
``processor_split_multiline_log_string_native``, as the reference's
(``input_file.py:47-52``), and the reader rolls back to whole records.
``FileEncoding: gbk`` transcodes what is read to UTF-8.
"""

from __future__ import annotations

import glob
import threading
import time
from typing import Any, Callable, Dict, Iterator, List

from ...models import PipelineEventGroup
from ...pipeline.plugin.interface import Input, PluginContext
from ...pipeline.queue.bounded_queue import FeedbackInterface
from .file_server import FileServer
from .polling import FileDiscoveryConfig
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
        self.discovery: FileDiscoveryConfig = None  # type: ignore
        self.multiline: Dict[str, Any] = {}
        self.tail_existing = True
        self.encoding = "utf8"
        self.config_name = ""
        self.read_seconds = 0.0
        self._once_pushed = 0
        self._fs_state = None   # the file server's state of this input

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.paths = list(config.get("FilePaths", []))
        if not self.paths:
            return False
        self.discovery = FileDiscoveryConfig(
            file_paths=list(self.paths),
            exclude_file_paths=config.get("ExcludeFilePaths"),
            exclude_files=config.get("ExcludeFiles"),
            exclude_dirs=config.get("ExcludeDirs"))
        self.multiline = config.get("Multiline") or {}
        self.tail_existing = bool(config.get("TailingAllMatchedFiles",
                                             config.get("TailExisted", True)))
        self.encoding = config.get("FileEncoding", "utf8")
        # unique key per plugin instance: a pipeline may hold several
        # input_file plugins, each with its own discovery registration
        self.config_name = f"{context.pipeline_name}#{id(self)}"
        return True

    @property
    def groups_pushed(self) -> int:
        """Groups pushed into the process queue, by the one-shot read or by
        the file server for this input."""
        st = self._fs_state
        return self._once_pushed + (st.groups_pushed if st is not None else 0)

    def inner_processor_configs(self) -> List[Dict[str, Any]]:
        out = [{"Type": "processor_split_log_string_native"}]
        if self.multiline.get("StartPattern") \
                or self.multiline.get("EndPattern"):
            out.append({"Type": "processor_split_multiline_log_string_native",
                        "Multiline": self.multiline})
        return out

    def start(self, should_abort: Callable[[], bool] = lambda: False
              ) -> bool:
        """Tail mode: register with the file server and start it.  Else
        read every matching file once into the pipeline's process queue;
        returns False when ``should_abort()`` stopped it early."""
        if self.context.tail:
            fs = FileServer.instance()
            self._fs_state = fs.add_config(
                self.config_name, self.discovery,
                self.context.process_queue_key,
                tail_existing=self.tail_existing,
                multiline_start=self.multiline.get("StartPattern"),
                multiline_end=self.multiline.get("EndPattern"),
                encoding=self.encoding)
            fs.start()
            return True
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
                    self._once_pushed += 1
                    break
                if should_abort():
                    groups.close()
                    return False
                # at the high watermark: wait for the queue's feedback
                fb.event.wait(self.FEEDBACK_WAIT_S)

    def stop(self) -> bool:
        if self._fs_state is not None:
            FileServer.instance().remove_config(self.config_name)
        return True

    def read_all(self) -> Iterator[PipelineEventGroup]:
        """The one-shot read: every matching file from its start, the open
        multiline record of its end shipped at once."""
        for pattern in self.paths:
            for path in sorted(glob.glob(pattern, recursive="**" in pattern)):
                reader = LogFileReader(
                    path, multiline_start=self.multiline.get("StartPattern"),
                    multiline_end=self.multiline.get("EndPattern"),
                    ml_flush_timeout=0.0, encoding=self.encoding)
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
