"""flusher_clickhouse — HTTP-interface INSERT sink.

Reference: plugins/flusher/clickhouse/flusher_clickhouse.go — the Go
flusher drives clickhouse-go; the HTTP interface (`POST /?query=INSERT INTO
db.table FORMAT JSONEachRow`) carries identical rows without a client
library, which is the idiomatic shape for this framework's sender path.

The port's copy of the JAX package's ``flusher/clickhouse.py``: the same
JSONEachRow body and query URL.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import quote

from ..models import PipelineEventGroup
from ..pipeline.serializer.batch_json import ndjson_payload
from .http_base import AddressRotator, HttpSinkFlusher, basic_auth_header


class FlusherClickHouse(HttpSinkFlusher):
    name = "flusher_clickhouse"
    supports_columnar = True
    content_type = "application/x-ndjson"

    def _init_sink(self, config: Dict[str, Any]) -> bool:
        self.rotator = AddressRotator(config.get("Addresses", []))
        self.table = config.get("Table", "")
        self.database = config.get("Database", "default")
        self.auth = basic_auth_header(config)
        return bool(self.rotator) and bool(self.table)

    def build_payload(self, groups: List[PipelineEventGroup]
                      ) -> Optional[Tuple[bytes, Dict[str, str]]]:
        # shared batched serializer (loongshard): columnar groups assemble
        # JSONEachRow bytes natively, identical to the old per-row
        # json.dumps loop (tests/test_batch_json.py goldens)
        body = ndjson_payload(groups, ts_key="_timestamp")
        if body is None:
            return None
        return body, self.auth

    def endpoint_url(self, item) -> str:
        q = quote(f"INSERT INTO {self.database}.{self.table} "
                  f"FORMAT JSONEachRow")
        return f"{self.rotator.next()}/?query={q}"
