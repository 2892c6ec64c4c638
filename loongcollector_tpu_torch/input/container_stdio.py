"""input_container_stdio — tail container stdout/stderr logs.

Reference: core/plugin/input/InputContainerStdio.cpp — binds container
discovery to file tailing with the container-log unwrap + partial-merge
inner processors (ProcessorParseContainerLogNative →
ProcessorMergeMultilineLogNative flag mode).  The port's copy of the JAX
package's ``input/container_stdio.py``.

Discovery (``container_manager.ContainerManager``) gives the matched
containers' log paths (globs); ``ContainerFilters`` (``K8sNamespaceRegex``,
``K8sPodRegex``, label include/exclude) picks among them.  In tail mode
``start`` registers the paths with the ``FileServer`` singleton, whose
``tag_provider`` hook stamps every group read from a container's log with
its ``_container_name_`` / ``_container_id_`` / ``_image_name_`` /
``_namespace_`` / ``_pod_name_`` / ``pod.label.*`` tags (resolved once per
concrete path, 8192 entries at most), and a thread re-runs discovery every
``REFRESH_S`` seconds (container churn).  A failed re-discovery is skipped,
as in the JAX package, and counted (``monitor/fail_soft.py``, site
``container_stdio.refresh``).  ``--once`` reads the matched logs once,
from their start, with the same tags.
"""

from __future__ import annotations

import fnmatch
import glob
import threading
from typing import Any, Dict, Iterator, List

from ..container_manager import ContainerFilters, ContainerManager
from ..models import PipelineEventGroup
from ..pipeline.plugin.interface import Input, PluginContext
from .file.file_server import FileServer
from .file.input_file import InputFile
from .file.polling import FileDiscoveryConfig
from .file.reader import LogFileReader

REFRESH_S = 5.0


class InputContainerStdio(InputFile):
    name = "input_container_stdio"

    def __init__(self) -> None:
        super().__init__()
        self.filters = ContainerFilters()
        self.fmt = "containerd_text"
        self._stop_refresh = threading.Event()
        self._refresh_thread = None
        self._tag_map: Dict[str, Dict[bytes, bytes]] = {}
        self._resolved: Dict[str, Any] = {}
        self._tag_lock = threading.Lock()

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        Input.init(self, config, context)
        self.filters = ContainerFilters(config.get("ContainerFilters", config))
        self.fmt = config.get("Format", "containerd_text")
        self.multiline = config.get("Multiline", {}) or {}
        self.config_name = f"{context.pipeline_name}#stdio{id(self)}"
        return True

    def inner_processor_configs(self) -> List[Dict[str, Any]]:
        out = [
            {"Type": "processor_split_log_string_native"},
            {"Type": "processor_parse_container_log_native",
             "Format": self.fmt,
             "IgnoringStdout": bool(self.config.get("IgnoringStdout", False)),
             "IgnoringStderr": bool(self.config.get("IgnoringStderr", False))},
            {"Type": "processor_merge_multiline_log_native",
             "MergeType": "flag"},
        ]
        if self.multiline.get("StartPattern"):
            out.append({"Type": "processor_split_multiline_log_string_native",
                        "Multiline": self.multiline})
        return out

    def _matched_paths(self) -> List[str]:
        mgr = ContainerManager.instance()
        paths = []
        tag_map = {}
        for info in mgr.discover():
            if not info.log_path:
                continue  # no tailable path (e.g. non-K8s CRI container)
            if self.filters.match(info):
                paths.append(info.log_path)
                tags = {b"_container_name_": info.name.encode(),
                        b"_container_id_": info.id.encode()[:12]}
                if info.image:
                    tags[b"_image_name_"] = info.image.encode()
                if info.k8s_pod:
                    tags[b"_namespace_"] = info.k8s_namespace.encode()
                    tags[b"_pod_name_"] = info.k8s_pod.encode()
                for lk, lv in info.labels.items():
                    if lk.startswith("pod.label."):
                        tags[lk.encode()] = lv.encode()
                tag_map[info.log_path] = tags
        with self._tag_lock:
            self._tag_map = tag_map
            self._resolved.clear()   # concrete-path cache keys old patterns
        return paths

    def _tags_for(self, path: str):
        """Reader paths are concrete files; discovery paths may be globs —
        match either exactly or by pattern.  Resolution is cached per
        concrete path: this runs on the FileServer drain path, once per
        chunk."""
        with self._tag_lock:
            if path in self._resolved:
                return self._resolved[path]
            tag_map = self._tag_map
        hit = tag_map.get(path)
        if hit is None:
            for pattern, tags in tag_map.items():
                if fnmatch.fnmatch(path, pattern):
                    hit = tags
                    break
        with self._tag_lock:
            if len(self._resolved) > 8192:
                self._resolved.clear()
            self._resolved[path] = hit
        return hit

    def start(self, should_abort=lambda: False) -> bool:
        paths = self._matched_paths()
        if not self.context.tail:
            self.paths = paths
            return super().start(should_abort)
        fs = FileServer.instance()
        self._fs_state = fs.add_config(
            self.config_name,
            FileDiscoveryConfig(file_paths=paths or ["/nonexistent"]),
            self.context.process_queue_key, tail_existing=True,
            tag_provider=self._tags_for)
        fs.start()
        # periodic re-discovery updates the glob set (container churn)
        self._stop_refresh.clear()
        self._refresh_thread = threading.Thread(
            target=self._refresh, name="stdio-discovery", daemon=True)
        self._refresh_thread.start()
        return True

    def _refresh(self) -> None:
        while not self._stop_refresh.wait(REFRESH_S):
            try:
                FileServer.instance().update_config_paths(
                    self.config_name, self._matched_paths())
            except Exception as e:  # noqa: BLE001
                from ..monitor import fail_soft
                fail_soft.note("container_stdio.refresh", e)

    def stop(self) -> bool:
        self._stop_refresh.set()
        if self._refresh_thread is not None:
            self._refresh_thread.join(timeout=10)
            self._refresh_thread = None
        return super().stop()

    def read_all(self) -> Iterator[PipelineEventGroup]:
        """The one-shot read: every matched log from its start, each group
        with its container's tags."""
        for pattern in self.paths:
            for path in sorted(glob.glob(pattern)):
                reader = LogFileReader(path, ml_flush_timeout=0.0)
                if not reader.open():
                    continue
                tags = self._tags_for(path) or {}
                try:
                    while True:
                        group = reader.read()
                        if group is None:
                            group = reader.read(force_flush=True)
                            if group is None:
                                break
                        for k, v in tags.items():
                            group.set_tag(k, v)
                        yield group
                finally:
                    reader.close()
