"""flusher_elasticsearch — bulk NDJSON sink.

Reference: plugins/flusher/elasticsearch/flusher_elasticsearch.go — config
Addresses, Index (dynamic %{field} patterns), Authentication.PlainText;
events ship as `_bulk` action/source line pairs.

The port's copy of the JAX package's ``flusher/elasticsearch.py``: the same
``_bulk`` body byte for byte, on the port's ``http_base.py`` and
``pipeline/serializer/batch_json.py``: a static ``Index`` on columnar
groups whose timestamps lie in range takes the batched row writer, and
every other group the dict path (``resolve_dynamic`` per row, ISO-8601
``@timestamp``).
"""

from __future__ import annotations

import json
import re
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..models import PipelineEventGroup
from ..pipeline.serializer.batch_json import (TS_ISO8601, dumps_row,
                                              native_group_rows)
from ..pipeline.serializer.event_dicts import iter_event_dicts
from .http_base import AddressRotator, HttpSinkFlusher, basic_auth_header

_PATTERN = re.compile(r"%\{([^}]+)\}")


def resolve_dynamic(template: str, obj: Dict[str, object]) -> str:
    """%{content.key} / %{tag.key} / %{key} → value from the event dict
    (the Go flusher's dynamic index convention)."""
    def sub(m):
        key = m.group(1)
        for k in (key, key.split(".", 1)[-1]):
            v = obj.get(k)
            if v is not None:
                return str(v)
        return "unknown"
    return _PATTERN.sub(sub, template)


class FlusherElasticsearch(HttpSinkFlusher):
    name = "flusher_elasticsearch"
    supports_columnar = True
    content_type = "application/x-ndjson"

    def _init_sink(self, config: Dict[str, Any]) -> bool:
        self.rotator = AddressRotator(config.get("Addresses", []))
        self.index = config.get("Index", "")
        self.auth = basic_auth_header(config)
        return bool(self.rotator) and bool(self.index)

    def build_payload(self, groups: List[PipelineEventGroup]
                      ) -> Optional[Tuple[bytes, Dict[str, str]]]:
        parts: List = []
        empty = True
        dynamic = "%{" in self.index
        action = json.dumps({"index": {"_index": self.index}}).encode() \
            + b"\n"
        for g in groups:
            fast = None
            if not dynamic and self._ts_in_range(g):
                # shared batched serializer (loongshard): action line rides
                # as the row head, @timestamp appended as ISO-8601 —
                # byte-identical to the dict loop below
                fast = native_group_rows(g, "@timestamp",
                                         ts_mode=TS_ISO8601,
                                         ts_first=False, head=action)
            if fast is not None:
                if len(fast):
                    parts.append(fast)
                    empty = False
                continue
            for ts, obj in iter_event_dicts(g):
                idx = resolve_dynamic(self.index, obj) if dynamic \
                    else self.index
                # ISO-8601: ES date fields parse bare ints as epoch_MILLIS,
                # which would land epoch-seconds logs in January 1970
                obj.setdefault("@timestamp", datetime.fromtimestamp(
                    ts, tz=timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ"))
                parts.append(json.dumps(
                    {"index": {"_index": idx}}).encode() + b"\n")
                parts.append(dumps_row(obj) + b"\n")
                empty = False
        if empty:
            return None
        return b"".join(parts), self.auth

    #: last epoch second of year 9999 — datetime.fromtimestamp raises past
    #: it, so the canonical dict path would surface such timestamps as a
    #: flusher error; the fast path must not silently serialize them
    _TS_MAX = 253402300799

    @classmethod
    def _ts_in_range(cls, group: PipelineEventGroup) -> bool:
        """Fast path only for sane epochs (0 <= ts <= year 9999):
        strftime("%Y") padding for years before 1000 is platform libc
        behaviour the native ISO-8601 writer does not chase, and a
        millisecond-epoch outlier must fail loudly on the dict path, not
        ship a five-digit year."""
        cols = group.columns
        if cols is None:
            return False
        tss = np.asarray(cols.timestamps)
        return bool(len(tss) == 0
                    or (int(tss.min()) >= 0
                        and int(tss.max()) <= cls._TS_MAX))

    def endpoint_url(self, item) -> str:
        return f"{self.rotator.next()}/_bulk"
