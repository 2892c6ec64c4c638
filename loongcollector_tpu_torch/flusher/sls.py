"""flusher_sls — SLS-protocol sink.

Reference: core/plugin/flusher/sls/FlusherSLS.cpp (1419 LoC): Batcher →
hand-rolled PB serialize → LZ4/ZSTD → sender queue (FlusherSLS.h:124-159);
per-region endpoints, quota/backoff response handling; disk buffering of
failed payloads.  This implementation covers the wire path (serialize,
compress, auth headers, endpoint) through the shared sender-queue/HttpSink
machinery; disk-buffer spill lives in runner/disk_buffer.py.

The port's copy of the JAX package's ``flusher/sls.py`` on the port's
``FlusherHTTP``, Batcher, ``sls_serializer`` and ``compression``: the same
request (URL, headers, signature) and verdicts, endpoint pool feedback
included.  Its ``chaos`` point is left out, as in every ported module, and
so is the exactly-once mode: a config that asks for ``ExactlyOnce`` is
refused, as ``flusher_http``'s is.
"""

from __future__ import annotations

import hashlib
import hmac
import time
from typing import Any, Dict, List

from ..models import PipelineEventGroup
from ..pipeline.batch.batcher import Batcher
from ..pipeline.batch.flush_strategy import FlushStrategy
from ..pipeline.compression import create_compressor
from ..pipeline.plugin.interface import PluginContext
from ..pipeline.queue.sender_queue import SenderQueueItem
from ..pipeline.serializer.sls_serializer import SLSEventGroupSerializer
from ..utils.logger import get_logger
from .http import FlusherHTTP, HttpRequest
from .sls_client import EndpointPool, classify_response

log = get_logger("flusher_sls")


class FlusherSLS(FlusherHTTP):
    name = "flusher_sls"
    supports_columnar = True

    def __init__(self) -> None:
        super().__init__()
        self.project = ""
        self.logstore = ""
        self.region = ""
        self.endpoint = ""
        self.access_key_id = ""
        self.access_key_secret = ""
        self.endpoint_pool: EndpointPool = None  # type: ignore

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        self.context = context
        self.project = config.get("Project", "")
        self.logstore = config.get("Logstore", "")
        self.region = config.get("Region", "")
        self.endpoint = config.get("Endpoint", "")
        self.access_key_id = config.get("AccessKeyId", "")
        self.access_key_secret = config.get("AccessKeySecret", "")
        # multi-endpoint region pool with fallback + primary probe-back
        # (SLSClientManager.cpp); "Endpoints" extends the single "Endpoint"
        endpoints = list(config.get("Endpoints", []))
        if self.endpoint and self.endpoint not in endpoints:
            endpoints.insert(0, self.endpoint)
        self.endpoint_pool = EndpointPool(endpoints) if endpoints else None
        self.remote_url = (f"http://{self.project}.{self.endpoint}"
                           f"/logstores/{self.logstore}/shards/lb"
                           if self.endpoint else "")
        self.serializer = SLSEventGroupSerializer(
            topic=config.get("Topic", "").encode())
        self.compressor = create_compressor(
            config.get("CompressType", "lz4"))
        strategy = FlushStrategy(
            min_cnt=int(config.get("MinCnt", 4096)),
            min_size_bytes=int(config.get("MinSizeBytes", 512 * 1024)),
            max_size_bytes=int(config.get("MaxSizeBytes", 5 * 1024 * 1024)),
            timeout_secs=float(config.get("TimeoutSecs", 1.0)))
        if config.get("ExactlyOnce"):
            log.error("flusher_sls: ExactlyOnce is not supported by the port")
            return False
        self.batcher = Batcher(strategy, on_flush=self._serialize_and_push,
                               flusher_id=self.name,
                               pipeline_name=context.pipeline_name)
        return bool(self.logstore)

    def build_request(self, item: SenderQueueItem) -> HttpRequest:
        endpoint = (self.endpoint_pool.current() if self.endpoint_pool
                    else self.endpoint)
        item.tag["sls_endpoint"] = endpoint
        date = time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime())
        md5 = hashlib.md5(item.data).hexdigest().upper()
        headers = {
            "Content-Type": "application/x-protobuf",
            "Content-MD5": md5,
            "Date": date,
            "Host": f"{self.project}.{endpoint}",
            "x-log-apiversion": "0.6.0",
            "x-log-bodyrawsize": str(item.raw_size),
            "x-log-signaturemethod": "hmac-sha1",
        }
        if self.compressor.name != "none":
            headers["x-log-compresstype"] = self.compressor.name
        if self.access_key_id:
            resource = f"/logstores/{self.logstore}/shards/lb"
            canon_headers = "".join(
                f"{k}:{headers[k]}\n" for k in sorted(headers)
                if k.startswith("x-log-") or k.startswith("x-acs-"))
            sign_str = (f"POST\n{md5}\napplication/x-protobuf\n{date}\n"
                        f"{canon_headers}{resource}")
            sig = hmac.new(self.access_key_secret.encode(),
                           sign_str.encode(), hashlib.sha1).digest()
            import base64
            headers["Authorization"] = (
                f"LOG {self.access_key_id}:"
                f"{base64.b64encode(sig).decode()}")
        url = (f"http://{self.project}.{endpoint}"
               f"/logstores/{self.logstore}/shards/lb")
        return HttpRequest("POST", url, headers, item.data)

    def on_send_done(self, item: SenderQueueItem, status: int,
                     body: bytes) -> str:
        verdict = classify_response(status, body)
        endpoint = item.tag.pop("sls_endpoint", None)
        if self.endpoint_pool is not None and endpoint:
            # endpoint health feedback: ANY HTTP response proves the
            # endpoint is reachable — quota (retry_slow) and 4xx (drop)
            # responses count as endpoint-healthy so a pending primary
            # probe always resolves; only network/5xx failures rotate
            if verdict == "ok" or (400 <= status < 500):
                self.endpoint_pool.on_success(endpoint)
            elif verdict in ("retry", "retry_slow"):
                self.endpoint_pool.on_fail(endpoint)
        return verdict
