"""input_file — reads FilePaths and supplies the line-split inner processor.

Reference: core/plugin/input/InputFile.cpp:213-250 — the input creates the
inner split processor and registers its discovery options with the file
server.  The port's slice reads the existing content of every matching
file once (``read_all``); tailing, discovery options and multiline come
with the file-server slice.
"""

from __future__ import annotations

import glob
from typing import Any, Dict, Iterator, List

from ...models import PipelineEventGroup
from ...pipeline.plugin.interface import Input, PluginContext
from ...utils.logger import get_logger
from .reader import LogFileReader

log = get_logger("input_file")


class InputFile(Input):
    name = "input_file"

    def __init__(self) -> None:
        super().__init__()
        self.paths: List[str] = []

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.paths = list(config.get("FilePaths", []))
        multiline = config.get("Multiline") or {}
        if multiline.get("StartPattern") or multiline.get("EndPattern"):
            log.error("input_file: Multiline is not supported by this port "
                      "yet")
            return False
        return bool(self.paths)

    def inner_processor_configs(self) -> List[Dict[str, Any]]:
        return [{"Type": "processor_split_log_string_native"}]

    def read_all(self) -> Iterator[PipelineEventGroup]:
        for pattern in self.paths:
            for path in sorted(glob.glob(pattern, recursive="**" in pattern)):
                reader = LogFileReader(path)
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
