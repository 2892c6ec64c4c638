"""Extension plugin layer: named, shareable helper components.

Reference: plugins/extension/ + pkg/pipeline/extensions/ — extensions are
plugin instances declared in a pipeline's `extensions:` section and
referenced BY NAME from other plugins' configs (an HTTP flusher points at
an authenticator, a request breaker, an encoder; an HTTP-server input
points at a decoder).  Roles mirror the reference interfaces:

  ClientAuthenticator  mutates an outgoing HttpRequest   (ext_basicauth)
  RequestInterceptor   gates sends / records outcomes    (ext_request_breaker)
  Decoder              bytes -> event groups             (ext_default_decoder)
  Encoder              event groups -> bytes             (ext_default_encoder)
  FlushInterceptor     drops/filters groups before send  (ext_groupinfo_filter)

Lookup: PluginContext.get_extension("<type>" or "<type>/<alias>") resolves
instances created by CollectionPipeline.init from the `extensions:` config
list; plugins keep working without any extensions configured.

The port's copy of the JAX package's ``pipeline/plugin/extension.py``: the
same five extensions, under the same type names, with the same behaviour.
``ExtRequestBreaker`` also counts its trips (``opened``) and the first
request it lets through after each (``closed``); ``stats()`` returns them
for ``--stats`` ``extensions``, where the JAX package keeps no count.
"""

from __future__ import annotations

import base64
import threading
import time
from typing import Any, Dict, List, Optional

from .interface import Plugin, PluginContext


class Extension(Plugin):
    """Base for all extensions; `stop()` mirrors the reference lifecycle."""

    name = "extension_base"

    def stop(self) -> None:  # pragma: no cover — default no-op
        pass

    def stats(self) -> Optional[Dict[str, Any]]:
        """Counts for ``--stats`` ``extensions``, or None."""
        return None


# --------------------------------------------------------------- basicauth


class ExtBasicAuth(Extension):
    """plugins/extension/basicauth — adds Authorization to each request."""

    name = "ext_basicauth"

    def __init__(self) -> None:
        super().__init__()
        self._header = ""

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        user = config.get("Username", "")
        pwd = config.get("Password", "")
        if not user:
            return False
        token = base64.b64encode(f"{user}:{pwd}".encode()).decode()
        self._header = f"Basic {token}"
        return True

    def apply(self, request) -> None:
        """ClientAuthenticator: mutate the outgoing HttpRequest."""
        request.headers["Authorization"] = self._header


# ---------------------------------------------------------- request breaker


class BreakerOpen(RuntimeError):
    pass


class ExtRequestBreaker(Extension):
    """plugins/extension/request_breaker — fail-fast circuit breaker.

    Sliding-window failure ratio: when the ratio of failed sends within
    WindowInSeconds exceeds FailureRatio, allow() returns False (callers
    fail fast without hitting the endpoint) until the window cools down.
    A half-open probe is let through once per cooldown interval."""

    name = "ext_request_breaker"

    def __init__(self) -> None:
        super().__init__()
        self.failure_ratio = 0.10
        self.window_s = 10.0
        self._events: List = []          # (ts, ok)
        self._lock = threading.Lock()
        self._open_until = 0.0
        self.opened = 0                  # trips
        self.closed = 0                  # first allow() past a trip
        self._tripped = False

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.failure_ratio = float(config.get("FailureRatio", 0.10))
        self.window_s = float(config.get("WindowInSeconds", 10) or 10)
        return True

    def allow(self) -> bool:
        now = time.monotonic()
        with self._lock:
            if now < self._open_until:
                return False
            if self._tripped:
                self._tripped = False
                self.closed += 1
            self._trim(now)
            total = len(self._events)
            if total < 4:                # not enough signal to trip
                return True
            fails = sum(1 for _, ok in self._events if not ok)
            if fails / total > self.failure_ratio:
                # trip: fail fast for one window, then allow a probe
                self._open_until = now + self.window_s
                self._events.clear()
                self._tripped = True
                self.opened += 1
                return False
            return True

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"opened": self.opened, "closed": self.closed,
                    "open": time.monotonic() < self._open_until}

    def on_result(self, ok: bool) -> None:
        now = time.monotonic()
        with self._lock:
            self._events.append((now, ok))
            self._trim(now)

    def _trim(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.pop(0)


# ---------------------------------------------------------- decoder/encoder


class ExtDefaultDecoder(Extension):
    """plugins/extension/default_decoder — bytes → event groups by Format
    (json lines, sls protobuf, raw)."""

    name = "ext_default_decoder"

    def __init__(self) -> None:
        super().__init__()
        self.fmt = "json"

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.fmt = str(config.get("Format", "json")).lower()
        return self.fmt in ("json", "sls", "sls_pb", "raw",
                            "statsd", "influx", "influxdb")

    def decode(self, body: bytes, headers: Optional[dict] = None):
        from ...models import PipelineEventGroup
        if self.fmt in ("sls", "sls_pb"):
            from ..serializer.sls_serializer import parse_loggroup
            return [parse_loggroup(body)]
        group = PipelineEventGroup()
        sb = group.source_buffer
        if self.fmt == "statsd":
            from ...input.metric_protocols import parse_statsd_packet
            return [group] if parse_statsd_packet(body, group) else []
        if self.fmt in ("influx", "influxdb"):
            from ...input.metric_protocols import parse_influx_lines
            return [group] if parse_influx_lines(body, group) else []
        if self.fmt == "raw":
            ev = group.add_log_event(int(time.time()))
            ev.set_content(sb.copy_string(b"content"), sb.copy_string(body))
            return [group]
        import json as _json
        for line in body.splitlines():
            if not line.strip():
                continue
            ev = group.add_log_event(int(time.time()))
            try:
                doc = _json.loads(line)
            except ValueError:
                ev.set_content(sb.copy_string(b"content"),
                               sb.copy_string(line))
                continue
            if isinstance(doc, dict):
                for k, v in doc.items():
                    if not isinstance(v, (bytes, str)):
                        v = _json.dumps(v)
                    ev.set_content(sb.copy_string(str(k).encode()),
                                   sb.copy_string(v.encode()
                                                  if isinstance(v, str)
                                                  else v))
            else:
                ev.set_content(sb.copy_string(b"content"),
                               sb.copy_string(line))
        return [group]


class ExtDefaultEncoder(Extension):
    """plugins/extension/default_encoder — event groups → bytes by Format
    (json lines or sls protobuf)."""

    name = "ext_default_encoder"

    def __init__(self) -> None:
        super().__init__()
        self.fmt = "json"

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        self.fmt = str(config.get("Format", "json")).lower()
        return self.fmt in ("json", "sls", "sls_pb")

    def encode(self, groups) -> bytes:
        if self.fmt in ("sls", "sls_pb"):
            from ..serializer.sls_serializer import SLSEventGroupSerializer
            return SLSEventGroupSerializer().serialize(groups)
        from ..serializer.json_serializer import JsonSerializer
        return JsonSerializer().serialize(groups)


# ------------------------------------------------------- group info filter


class ExtGroupInfoFilter(Extension):
    """plugins/extension/group_info_filter — FlushInterceptor that keeps
    only groups whose tags match the configured exact values."""

    name = "ext_groupinfo_filter"

    def __init__(self) -> None:
        super().__init__()
        self.tags: Dict[bytes, bytes] = {}

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        for k, v in (config.get("Tags") or {}).items():
            self.tags[str(k).encode()] = str(v).encode()
        return True

    def filter(self, groups):
        if not self.tags:
            return list(groups)
        kept = []
        for g in groups:
            tags = {k: v.to_bytes() for k, v in g.tags.items()}
            if all(tags.get(k) == v for k, v in self.tags.items()):
                kept.append(g)
        return kept


ALL_EXTENSIONS = [ExtBasicAuth, ExtRequestBreaker, ExtDefaultDecoder,
                  ExtDefaultEncoder, ExtGroupInfoFilter]


def register_all(registry) -> None:
    for cls in ALL_EXTENSIONS:
        registry.register_extension(cls.name, cls)
