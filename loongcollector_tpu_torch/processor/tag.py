"""Inner processor: host/agent tags → group tags with rename policies.

Reference: core/plugin/processor/inner/ProcessorTagNative.cpp — appends
host name/ip and agent tags to every group; PipelineMetaTagKey rename/
delete policies.

The port's copy of the JAX package's ``processor/tag.py``.
"""

from __future__ import annotations

import socket
from typing import Any, Dict

from ..models import PipelineEventGroup
from ..pipeline.plugin.interface import PluginContext, Processor

_DEFAULT_KEYS = {
    "HOST_NAME": "host.name",
    "HOST_IP": "host.ip",
}


class ProcessorTag(Processor):
    name = "processor_tag_native"
    supports_columnar = True

    def __init__(self) -> None:
        super().__init__()
        self.pipeline_meta_tag_key: Dict[str, str] = {}
        self.agent_tags: Dict[str, str] = {}
        self._host_name = socket.gethostname()
        try:
            self._host_ip = socket.gethostbyname(self._host_name)
        except OSError:
            self._host_ip = "127.0.0.1"

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.pipeline_meta_tag_key = dict(config.get("PipelineMetaTagKey", {}))
        self.agent_tags = dict(config.get("AgentEnvMetaTagKey", {}))
        return True

    def _tag_name(self, key: str) -> str:
        policy = self.pipeline_meta_tag_key.get(key, "__default__")
        if policy == "__default__":
            return _DEFAULT_KEYS.get(key, key.lower())
        return policy  # empty string ⇒ delete

    def process(self, group: PipelineEventGroup) -> None:
        name = self._tag_name("HOST_NAME")
        if name:
            group.set_tag(name, self._host_name)
        name = self._tag_name("HOST_IP")
        if name:
            group.set_tag(name, self._host_ip)
        for k, v in self.agent_tags.items():
            group.set_tag(k, v)
