"""flusher_loki — Loki push API sink.

Reference: plugins/flusher/loki/flusher_loki.go — static + dynamic labels,
tenant header; body is /loki/api/v1/push JSON: streams of [ts_ns, line]
pairs grouped by label set.

The port's copy of the JAX package's ``flusher/loki.py``.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

from ..models import PipelineEventGroup
from ..pipeline.serializer.event_dicts import iter_event_dicts
from .http_base import HttpSinkFlusher, basic_auth_header


def _label_name(key: str) -> str:
    """Loki label names must match [a-zA-Z_:][a-zA-Z0-9_:]* — anything else
    gets the batch 400'd (and dropped) at the push endpoint."""
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", key)
    if not name or not re.match(r"[a-zA-Z_:]", name[0]):
        name = "_" + name
    return name


class FlusherLoki(HttpSinkFlusher):
    name = "flusher_loki"
    supports_columnar = True

    def _init_sink(self, config: Dict[str, Any]) -> bool:
        self.url = (config.get("URL") or "").rstrip("/")
        self.tenant = config.get("TenantID", "")
        self.static_labels: Dict[str, str] = {
            str(k): str(v)
            for k, v in (config.get("StaticLabels") or {}).items()}
        self.dynamic_labels: List[str] = list(
            config.get("DynamicLabels") or [])
        self.auth = basic_auth_header(config)
        return bool(self.url)

    def build_payload(self, groups: List[PipelineEventGroup]
                      ) -> Optional[Tuple[bytes, Dict[str, str]]]:
        streams: Dict[Tuple, Dict] = {}
        for g in groups:
            for ts, obj in iter_event_dicts(g):
                labels = dict(self.static_labels)
                for key in self.dynamic_labels:
                    v = obj.pop(key, None)
                    if v is not None:
                        labels[_label_name(key)] = str(v)
                if "content" in obj and len(obj) == 1:
                    line = str(obj["content"])
                else:
                    # the loki stream body re-wraps the line as a JSON
                    # string value, so rows stay str here (an encode/decode
                    # round trip through the bytes helper would be waste)
                    line = json.dumps(obj, ensure_ascii=False) if obj else ""
                k = tuple(sorted(labels.items()))
                entry = streams.setdefault(k, {"stream": labels,
                                               "values": []})
                entry["values"].append([str(ts * 1_000_000_000), line])
        if not streams:
            return None
        headers = dict(self.auth)
        if self.tenant:
            headers["X-Scope-OrgID"] = self.tenant
        body = json.dumps({"streams": list(streams.values())},
                          ensure_ascii=False).encode()
        return body, headers

    def endpoint_url(self, item) -> str:
        return f"{self.url}/loki/api/v1/push"
