"""Aggregator implementations.

Reference: pkg/pipeline/aggregator.go:24-51 (Add/Flush contract between the
processor and flusher stages) and the Go plugins it hosts —
plugins/aggregator/baseagg (pack logs into capped groups per logstore/topic),
aggregator/context (per-source grouping preserving order), shardhash
(SLS shard routing hash), metadatagroup (regroup by metadata keys).

Aggregators regroup EVENTS across incoming groups into output groups keyed
by a per-event or per-group key.  Output groups SHARE the input group's
SourceBuffer, so regrouping is span bookkeeping, never a byte copy.
Columnar groups are keyed by group-level tags/metadata only: the packing
aggregators pass a columnar batch through intact, and the routers
(``aggregator_logstore_router``, ``aggregator_opentelemetry``) materialize
it first.  The port's copy of the JAX package's ``aggregator/base.py``; the
pipeline's aggregator stage (``pipeline/pipeline.py``) drives ``add``,
its timeout hook ``flush_timeout`` (buckets older than ``TimeoutSecs``) and
the stop-time drain ``flush``.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..models import EventGroupMetaKey, PipelineEventGroup
from ..pipeline.plugin.interface import Plugin, PluginContext


class Aggregator(Plugin):
    """add() may buffer; returns completed groups. flush() drains all."""

    def add(self, group: PipelineEventGroup) -> List[PipelineEventGroup]:
        raise NotImplementedError

    def flush(self) -> List[PipelineEventGroup]:
        return []


class _Bucket:
    __slots__ = ("group", "count", "born")

    def __init__(self, group: PipelineEventGroup):
        self.group = group
        self.count = 0
        self.born = time.monotonic()


_agg_metrics = None
_agg_metrics_lock = threading.Lock()


def _bucket_metrics():
    """Process-lifetime aggregator-stage counters (one module-level
    record): bucket completions at MaxLogCount and arena rotation, and
    timeout flushes, are counted.  Locked lazy init: add() runs on
    multiple processor threads, and a racing double-construct would
    register an orphaned record for good."""
    global _agg_metrics
    if _agg_metrics is None:
        with _agg_metrics_lock:
            if _agg_metrics is None:
                from ..monitor.metrics import MetricsRecord
                _agg_metrics = MetricsRecord(
                    category="agent", labels={"component": "aggregator"})
    return _agg_metrics


class AggregatorBase(Aggregator):
    """Pack events into groups capped at MaxLogCount, keyed by topic tag
    (reference plugins/aggregator/baseagg: MaxLogCount=1024 per group)."""

    name = "aggregator_base"

    def __init__(self) -> None:
        super().__init__()
        self.max_count = 1024
        self.timeout_s = 3.0
        self._buckets: Dict[Tuple, _Bucket] = {}
        # add() runs on processor threads, flush_timeout() on thread 0's
        # timeout tick — same contract as Batcher, same lock discipline
        self._lock = threading.Lock()

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.max_count = int(config.get("MaxLogCount", 1024))
        self.timeout_s = float(config.get("TimeoutSecs", 3.0))
        return True

    @staticmethod
    def _tag_fingerprint(group: PipelineEventGroup) -> Tuple:
        """Groups with different tag sets must never merge — their events
        would ship under the first group's labels."""
        return tuple(sorted((bytes(k), bytes(v))
                            for k, v in group.tags.items()))

    def _key(self, group: PipelineEventGroup, ev) -> Tuple:
        return (self._tag_fingerprint(group),)

    def _group_meta(self, out: PipelineEventGroup, key: Tuple,
                    src: PipelineEventGroup) -> None:
        for k, v in src.tags.items():
            out.set_tag(k, v)
        for k, v in src._metadata.items():
            out.set_metadata(k, v)

    def add(self, group: PipelineEventGroup) -> List[PipelineEventGroup]:
        cols = group.columns
        if cols is not None and not group._events:
            # columnar batches pass through intact (see module docstring)
            return [group]
        done: List[PipelineEventGroup] = []
        with self._lock:
            for ev in group.events:
                key = self._key(group, ev)
                b = self._buckets.get(key)
                if b is None:
                    out = PipelineEventGroup(group.source_buffer)
                    self._group_meta(out, key, group)
                    b = self._buckets[key] = _Bucket(out)
                elif b.group.source_buffer is not group.source_buffer:
                    # events reference THEIR arena: a bucket can only hold
                    # events of one arena — rotate the bucket out
                    done.append(b.group)
                    out = PipelineEventGroup(group.source_buffer)
                    self._group_meta(out, key, group)
                    b = self._buckets[key] = _Bucket(out)
                b.group.events.append(ev)
                b.count += 1
                if b.count >= self.max_count:
                    done.append(b.group)
                    del self._buckets[key]
        if done:
            _bucket_metrics().counter(
                "agg_bucket_completions_total").add(len(done))
        return done

    def flush(self) -> List[PipelineEventGroup]:
        with self._lock:
            out = [b.group for b in self._buckets.values() if b.count]
            self._buckets.clear()
        return out

    def flush_timeout(self) -> List[PipelineEventGroup]:
        """Buckets older than the timeout complete (driven by the pipeline's
        timeout-flush hook, same cadence as batchers)."""
        now = time.monotonic()
        out: List[PipelineEventGroup] = []
        with self._lock:
            for key in list(self._buckets):
                b = self._buckets[key]
                if b.count and now - b.born >= self.timeout_s:
                    out.append(b.group)
                    del self._buckets[key]
        if out:
            _bucket_metrics().counter(
                "agg_bucket_timeout_flushes_total").add(len(out))
        return out


class AggregatorContext(AggregatorBase):
    """Per-source grouping preserving order (plugins/aggregator/context)."""

    name = "aggregator_context"

    def _key(self, group: PipelineEventGroup, ev) -> Tuple:
        return (str(group.get_metadata(EventGroupMetaKey.LOG_FILE_PATH)
                    or ""),
                str(group.get_metadata(EventGroupMetaKey.LOG_FILE_INODE)
                    or ""),
                self._tag_fingerprint(group))


class AggregatorMetadataGroup(AggregatorBase):
    """Regroup by event-field values (plugins/aggregator/metadatagroup):
    GroupMetadataKeys name LogEvent fields whose values key the output
    group and land in its tags."""

    name = "aggregator_metadata_group"

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.keys = [k.encode() if isinstance(k, str) else k
                     for k in config.get("GroupMetadataKeys", [])]
        return bool(self.keys)

    def _key(self, group: PipelineEventGroup, ev) -> Tuple:
        vals = []
        get = getattr(ev, "get_content", None)
        for k in self.keys:
            v = get(k) if get is not None else None
            vals.append(bytes(v) if v is not None else b"")
        return tuple(vals)

    def _group_meta(self, out, key, src) -> None:
        super()._group_meta(out, key, src)
        for k, v in zip(self.keys, key):
            out.set_tag(k, v)


class AggregatorContentValueGroup(AggregatorMetadataGroup):
    """Group logs whose named content fields share values; the values
    become group tags (plugins/aggregator/contentvaluegroup).  `GroupKeys`
    names the fields; `Topic` optionally stamps the output groups;
    `ErrIfKeyNotFound` only affects logging in the reference — missing
    keys group under the empty value either way."""

    name = "aggregator_content_value_group"

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        cfg = dict(config)
        cfg["GroupMetadataKeys"] = config.get("GroupKeys", [])
        if not AggregatorMetadataGroup.init(self, cfg, context):
            return False
        self.topic = str(config.get("Topic", "")).encode()
        return True

    def _group_meta(self, out, key, src) -> None:
        super()._group_meta(out, key, src)
        if self.topic:
            out.set_tag(b"__topic__", self.topic)


class AggregatorLogstoreRouter(AggregatorBase):
    """Route each log to a logstore by regex on one field's value
    (plugins/aggregator/logstorerouter): RouterRegex[i] sends matching
    logs toward RouterLogstore[i] (recorded as the output group's
    __logstore__ tag for FlusherSLS routing); non-matching logs keep the
    default logstore unless DropDisMatch."""

    name = "aggregator_logstore_router"

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        if not AggregatorBase.init(self, config, context):
            return False
        import re as _re
        self.source_key = str(config.get("SourceKey", "content")).encode()
        regexes = config.get("RouterRegex", [])
        stores = config.get("RouterLogstore", [])
        if len(regexes) != len(stores) or not regexes:
            return False
        self.routes = [(_re.compile(str(r).encode()), str(s).encode())
                       for r, s in zip(regexes, stores)]
        self.drop_dismatch = bool(config.get("DropDisMatch", False))
        return True

    _DROP = object()

    def _route(self, ev) -> object:
        get = getattr(ev, "get_content", None)
        val = get(self.source_key) if get is not None else None
        if val is not None:
            data = bytes(val)
            for rx, store in self.routes:
                # unanchored, like the Go plugin's regexp.MatchString
                if rx.search(data):
                    return store
        return self._DROP if self.drop_dismatch else b""

    def _key(self, group: PipelineEventGroup, ev) -> Tuple:
        return (self._route(ev), self._tag_fingerprint(group))

    def add(self, group: PipelineEventGroup) -> List[PipelineEventGroup]:
        cols = group.columns
        if cols is not None and not group._events:
            group.materialize()     # routing needs per-event field access
        done: List[PipelineEventGroup] = []
        with self._lock:
            for ev in group.events:
                key = self._key(group, ev)
                if key[0] is self._DROP:
                    continue
                b = self._buckets.get(key)
                if b is None or \
                        b.group.source_buffer is not group.source_buffer:
                    if b is not None:
                        done.append(b.group)
                    out = PipelineEventGroup(group.source_buffer)
                    self._group_meta(out, key, group)
                    if key[0]:
                        out.set_tag(b"__logstore__", key[0])
                    b = self._buckets[key] = _Bucket(out)
                b.group.events.append(ev)
                b.count += 1
                if b.count >= self.max_count:
                    done.append(b.group)
                    del self._buckets[key]
        return done


class AggregatorShardHash(Aggregator):
    """Set the SLS shard-hash metadata from key field/tag values
    (plugins/aggregator/shardhash; FlusherSLS's shard routing)."""

    name = "aggregator_shardhash"

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.keys = [k.encode() if isinstance(k, str) else k
                     for k in config.get("ShardHashKeys", [])]
        return bool(self.keys)

    def add(self, group: PipelineEventGroup) -> List[PipelineEventGroup]:
        parts = []
        for k in self.keys:
            v = group.get_tag(k)
            parts.append(bytes(v) if v is not None else b"")
        digest = hashlib.md5(b"_".join(parts)).hexdigest()
        group.set_metadata(EventGroupMetaKey.SOURCE_ID, digest)
        return [group]

    def flush(self) -> List[PipelineEventGroup]:
        return []


class AggregatorTelemetryRouter(AggregatorBase):
    """Route events to per-signal logstores by their TYPE.

    Covers aggregator_opentelemetry and aggregator_skywalking
    (plugins/aggregator/{opentelemetry,skywalking}): both fan one mixed
    stream into metrics/trace/log logstores.  The Go plugins infer the
    signal from the content-pair count (≤5 → metric, ≥19 → trace); this
    event model is typed, so MetricEvent/SpanEvent route exactly."""

    name = "aggregator_opentelemetry"
    default_prefix = "otlp"

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        if not AggregatorBase.init(self, config, context):
            return False
        p = self.default_prefix
        self.metrics_store = str(config.get("MetricsLogstore",
                                            f"{p}-metrics")).encode()
        self.trace_store = str(config.get("TraceLogstore",
                                          f"{p}-traces")).encode()
        self.log_store = str(config.get("LogLogstore",
                                        f"{p}-logs")).encode()
        self.topic = str(config.get("Topic", "")).encode()
        return True

    def _route(self, ev) -> bytes:
        from ..models.events import MetricEvent, SpanEvent
        if isinstance(ev, MetricEvent):
            return self.metrics_store
        if isinstance(ev, SpanEvent):
            return self.trace_store
        return self.log_store

    def _key(self, group: PipelineEventGroup, ev) -> Tuple:
        return (self._route(ev), self._tag_fingerprint(group))

    def _group_meta(self, out: PipelineEventGroup, key: Tuple,
                    src: PipelineEventGroup) -> None:
        AggregatorBase._group_meta(self, out, key, src)
        out.set_tag(b"__logstore__", key[0])
        if self.topic:
            out.set_tag(b"__topic__", self.topic)

    def add(self, group: PipelineEventGroup) -> List[PipelineEventGroup]:
        cols = group.columns
        if cols is not None and not group._events:
            group.materialize()     # routing needs per-event types
        return AggregatorBase.add(self, group)


class AggregatorSkywalking(AggregatorTelemetryRouter):
    """plugins/aggregator/skywalking — same router, skywalking-* stores."""

    name = "aggregator_skywalking"
    default_prefix = "skywalking"
