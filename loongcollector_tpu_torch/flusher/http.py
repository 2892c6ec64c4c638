"""flusher_http — generic HTTP sink through the sender-queue path.

Reference: the HttpFlusher interface (collection_pipeline/plugin/interface/
HttpFlusher.h): BuildRequest produces the request for the sink thread;
OnSendDone handles the response.  Payloads are serialized + compressed, then
queued as SenderQueueItems for FlusherRunner → HttpSink dispatch.

The port's copy of the JAX package's ``flusher/http.py`` (``HttpRequest``,
``FlusherHTTP``): ``Format`` ``json`` (the default) or ``sls_pb``
(``pipeline/serializer/sls_serializer.py``), ``Compression``, ``Headers``,
the Batcher's ``MinCnt`` / ``MinSizeBytes`` / ``MaxSizeBytes`` /
``TimeoutSecs``, and the extension hooks (``flusher/http_base.py``):
``Authenticator`` signs each request, ``RequestBreaker`` fails a send fast
while open and hears each outcome, ``FlushInterceptor`` drops the groups
it filters out, and an ``Encoder`` extension builds the payload in place
of ``Format``.  The exactly-once mode (``ExactlyOnce``) is not ported: a
config that asks for it is refused.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..models import PipelineEventGroup
from ..monitor import ledger, slo
from ..runner import ack_watermark
from ..pipeline.batch.batcher import Batcher
from ..pipeline.compression import create_compressor
from ..pipeline.plugin.interface import Flusher, PluginContext
from ..pipeline.queue.sender_queue import SenderQueueItem
from ..pipeline.serializer.json_serializer import JsonSerializer
from ..pipeline.serializer.sls_serializer import SLSEventGroupSerializer
from ..utils.logger import get_logger

log = get_logger("flusher_http")


class HttpRequest:
    __slots__ = ("method", "url", "headers", "body", "timeout")

    def __init__(self, method: str, url: str, headers: Dict[str, str],
                 body: bytes, timeout: float = 15.0):
        self.method = method
        self.url = url
        self.headers = headers
        self.body = body
        self.timeout = timeout


class FlusherHTTP(Flusher):
    name = "flusher_http"
    supports_columnar = True

    def __init__(self) -> None:
        super().__init__()
        self.remote_url = ""
        self.headers: Dict[str, str] = {}
        self.serializer = None
        self.compressor = None
        self.batcher: Batcher = None  # type: ignore
        self.authenticator = None     # extension refs (resolve_http_extensions)
        self.breaker = None
        self.flush_interceptor = None
        self._encoder_ext = None

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.remote_url = config.get("RemoteURL", "")
        if not self.remote_url:
            return False
        self.headers = dict(config.get("Headers", {}))
        from .http_base import flush_strategy, resolve_http_extensions
        if not resolve_http_extensions(self, config, context):
            return False
        if config.get("ExactlyOnce"):
            log.error("flusher_http: ExactlyOnce is not supported by the "
                      "port")
            return False
        fmt = config.get("Format", "json")
        # an encoder EXTENSION ref overrides the built-in Format choice
        enc_ref = config.get("Encoder")
        self._encoder_ext = (context.get_extension(str(enc_ref))
                             if enc_ref else None)
        if enc_ref and self._encoder_ext is None:
            log.error("flusher_http: Encoder %r names no extension of the "
                      "pipeline", enc_ref)
            return False
        self.serializer = (SLSEventGroupSerializer() if fmt == "sls_pb"
                           else JsonSerializer())
        self.compressor = create_compressor(config.get("Compression"))
        self.batcher = Batcher(flush_strategy(config),
                               on_flush=self._serialize_and_push,
                               flusher_id=self.name,
                               pipeline_name=context.pipeline_name)
        return True

    def send(self, group: PipelineEventGroup) -> bool:
        from .http_base import intercepted
        if intercepted(self, group):
            return True
        self.batcher.add(group)
        return True

    def _serialize_and_push(self, groups: List[PipelineEventGroup]) -> None:
        from .http_base import push_refused
        n_events = sum(len(g) for g in groups)
        if self._encoder_ext is not None:
            data = self._encoder_ext.encode(groups)
        else:
            # view path: the compressor consumes the serializer's buffer
            # directly (a memoryview over the native output, or bytes)
            data = self.serializer.serialize_view(groups)
        raw_size = len(data)
        if ledger.is_on():
            ledger.record(self._ledger_pipeline(), ledger.B_SERIALIZE,
                          n_events, raw_size)
        payload = self.compressor.compress(data)
        item = SenderQueueItem(payload, raw_size, flusher=self,
                               queue_key=self.queue_key, event_cnt=n_events,
                               spans=ack_watermark.spans_of(groups),
                               stamps=slo.stamps_of(groups))
        push_refused(self, item)

    def build_request(self, item: SenderQueueItem) -> HttpRequest:
        from .http_base import check_breaker
        check_breaker(self)
        headers = dict(self.headers)
        if self._encoder_ext is not None:
            # the encoder EXTENSION owns the payload format
            wire_pb = getattr(self._encoder_ext, "fmt", "") in ("sls",
                                                                "sls_pb")
        else:
            wire_pb = isinstance(self.serializer, SLSEventGroupSerializer)
        headers.setdefault("Content-Type",
                           "application/x-protobuf" if wire_pb
                           else "application/json")
        if self.compressor.name != "none":
            headers["Content-Encoding"] = self.compressor.name
            headers["x-log-bodyrawsize"] = str(item.raw_size)
        req = HttpRequest("POST", self.remote_url, headers, item.data)
        if self.authenticator is not None:
            self.authenticator.apply(req)
        return req

    def on_send_done(self, item: SenderQueueItem, status: int,
                     body: bytes) -> str:
        """Returns 'ok' | 'retry' | 'drop' (reference OnSendDone semantics)."""
        if self.breaker is not None:
            self.breaker.on_result(200 <= status < 300)
        if 200 <= status < 300:
            return "ok"
        if status in (429, 500, 502, 503, 504) or status <= 0:
            return "retry"
        return "drop"

    def flush_all(self) -> bool:
        self.batcher.flush_all()
        return True

    def stop(self, is_pipeline_removing: bool = False) -> bool:
        self.batcher.flush_all()
        self.batcher.close()
        return True
