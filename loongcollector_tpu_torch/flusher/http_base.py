"""Shared machinery for HTTP-family sinks (ES, Loki, ClickHouse, OTLP,
Prometheus remote-write): batch → build payload → compress → sender queue →
FlusherRunner → HttpSink.

Reference shape: the Go flusher long tail (plugins/flusher/*) all follow
converter + HTTP client; here each sink is just `build_payload` (+ URL and
static headers) on top of the same native sender path the SLS flusher uses
(SenderQueueItem retry state, AIMD + rate gates, drain-on-exit).

The port's copy of the JAX package's ``flusher/http_base.py``.  The port
has no extension plane: a config that names an ``Authenticator``,
``RequestBreaker`` or ``FlushInterceptor`` is refused
(``resolve_http_extensions`` returns False) rather than run without it.
A payload carries the SLO ingest stamps of the groups it serialized
(``SenderQueueItem.stamps``; JAX package ``http_base.py:91-122``), and a
payload that is terminal before its queue (skipped, refused) is their drop
terminal.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..models import PipelineEventGroup
from ..monitor import ledger, slo
from ..runner import ack_watermark
from ..pipeline.batch.batcher import Batcher
from ..pipeline.batch.flush_strategy import FlushStrategy
from ..pipeline.compression import create_compressor
from ..pipeline.plugin.interface import Flusher, PluginContext
from ..pipeline.queue.sender_queue import SenderQueueItem
from ..utils.logger import get_logger
from .http import HttpRequest

log = get_logger("flusher_http")

#: extension references the JAX package resolves and the port refuses
EXTENSION_KEYS = ("Authenticator", "RequestBreaker", "FlushInterceptor")


class HttpSinkFlusher(Flusher):
    """Subclasses implement `_init_sink` and `build_payload`; optionally
    override `endpoint_url` (e.g. address rotation) and `extra_headers`."""

    default_compression: Optional[str] = None
    content_type = "application/json"

    def __init__(self) -> None:
        super().__init__()
        self.headers: Dict[str, str] = {}
        self.compressor = None
        self.batcher: Batcher = None  # type: ignore

    # -- subclass surface ---------------------------------------------------

    def _init_sink(self, config: Dict[str, Any]) -> bool:
        raise NotImplementedError

    def build_payload(self, groups: List[PipelineEventGroup]
                      ) -> Optional[Tuple[bytes, Dict[str, str]]]:
        """Returns (body, per-item headers) or None to skip the batch."""
        raise NotImplementedError

    def endpoint_url(self, item: SenderQueueItem) -> str:
        raise NotImplementedError

    # -- framework ----------------------------------------------------------

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        if not self._init_sink(config):
            return False
        if not resolve_http_extensions(self, config, context):
            return False
        self.headers = dict(config.get("Headers", {}))
        self.compressor = create_compressor(
            config.get("Compression", self.default_compression))
        self.batcher = Batcher(flush_strategy(config),
                               on_flush=self._serialize_and_push,
                               flusher_id=self.name,
                               pipeline_name=context.pipeline_name)
        return True

    def send(self, group: PipelineEventGroup) -> bool:
        self.batcher.add(group)
        return True

    def _serialize_and_push(self, groups: List[PipelineEventGroup]) -> None:
        n_events = sum(len(g) for g in groups)
        spans = ack_watermark.spans_of(groups)
        # serialization erases group identity: the ingest stamps ride the
        # item (the spans shape) so the real terminal observes the sojourn
        stamps = slo.stamps_of(groups)
        built = self.build_payload(groups)
        if built is None:
            # the sink's payload builder skipped the whole batch: terminal
            self._ledger_drop("payload_skipped", n_events)
            ack_watermark.ack_spans(spans, force=True)
            slo.observe_stamps(self._ledger_pipeline(), stamps,
                               slo.OUTCOME_DROP)
            return
        body, item_headers = built
        raw_size = len(body)
        if ledger.is_on():
            ledger.record(self._ledger_pipeline(), ledger.B_SERIALIZE,
                          n_events, raw_size)
        payload = self.compressor.compress(body)
        item = SenderQueueItem(payload, raw_size, flusher=self,
                               queue_key=self.queue_key,
                               tag={"headers": item_headers},
                               event_cnt=n_events, spans=spans,
                               stamps=stamps)
        push_refused(self, item)

    def build_request(self, item: SenderQueueItem) -> HttpRequest:
        headers = dict(self.headers)
        headers.setdefault("Content-Type", self.content_type)
        headers.update(item.tag.get("headers") or {})
        if self.compressor is not None and self.compressor.name != "none":
            enc = {"zlib": "deflate"}.get(self.compressor.name,
                                          self.compressor.name)
            headers["Content-Encoding"] = enc
        return HttpRequest("POST", self.endpoint_url(item), headers,
                           item.data)

    def on_send_done(self, item: SenderQueueItem, status: int,
                     body: bytes) -> str:
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


def flush_strategy(config: Dict[str, Any]) -> FlushStrategy:
    """The batch strategy of an HTTP-family flusher's config (the JAX
    package's defaults: no count trigger, 256 KiB, 5 MiB cap, 1 s)."""
    return FlushStrategy(
        min_cnt=int(config.get("MinCnt", 0)),
        min_size_bytes=int(config.get("MinSizeBytes", 256 * 1024)),
        max_size_bytes=int(config.get("MaxSizeBytes", 5 * 1024 * 1024)),
        timeout_secs=float(config.get("TimeoutSecs", 1.0)))


def push_refused(flusher: Flusher, item: SenderQueueItem) -> bool:
    """Push ``item`` to the flusher's sender queue; when there is none or
    it refuses (a retired queue), the payload is terminal here: a tagged
    drop, its spans acked.  Returns True when the push was refused."""
    if flusher.sender_queue is None:
        tag = "no_sender_queue"
    elif not flusher.sender_queue.push(item):
        tag = "queue_retired"
    else:
        return False
    flusher._ledger_drop(tag, item.event_cnt)
    ack_watermark.ack_spans(item.spans, force=True)
    slo.observe_stamps(flusher._ledger_pipeline(), item.stamps,
                       slo.OUTCOME_DROP)
    return True


def resolve_http_extensions(flusher, config: Dict[str, Any],
                            context: PluginContext) -> bool:
    """The JAX package resolves Authenticator / RequestBreaker /
    FlushInterceptor references against the pipeline's ``extensions:``;
    the port has none, so a config that names one is refused (False)."""
    named = [k for k in EXTENSION_KEYS if config.get(k)]
    if named:
        log.error("%s: extension references %s are not supported by the "
                  "port", flusher.name, named)
        return False
    return True


def basic_auth_header(config: Dict[str, Any]) -> Dict[str, str]:
    """Authentication.PlainText.{Username,Password} → Authorization header
    (the Go flushers' shared auth extension shape)."""
    auth = (config.get("Authentication") or {}).get("PlainText") or {}
    user = auth.get("Username") or config.get("Username")
    pwd = auth.get("Password") or config.get("Password")
    if not user:
        return {}
    import base64
    token = base64.b64encode(f"{user}:{pwd or ''}".encode()).decode()
    return {"Authorization": f"Basic {token}"}
