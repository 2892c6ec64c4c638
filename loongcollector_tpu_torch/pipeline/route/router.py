"""Event routing to flushers.

Reference: core/collection_pipeline/route/Router.h:32-35 + Condition.h —
per-flusher match conditions (event-type / tag equality); Route(group)
returns the indices of flushers that should receive the group.  The port's
copy of the JAX package's ``pipeline/route/router.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ...models import EventType, PipelineEventGroup

_EVENT_TYPES = {
    "log": EventType.LOG,
    "metric": EventType.METRIC,
    "trace": EventType.SPAN,
    "span": EventType.SPAN,
    "raw": EventType.RAW,
}


class Condition:
    """Match condition: {"Type": "event_type", "Value": "log"} or
    {"Type": "tag", "Key": ..., "Value": ...}."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self._config = config or {}
        self._kind = self._config.get("Type", "always")

    def check(self, group: PipelineEventGroup) -> bool:
        if self._kind == "always":
            return True
        if self._kind == "event_type":
            want = _EVENT_TYPES.get(str(self._config.get("Value", "")).lower())
            return want is not None and group.event_type() == want
        if self._kind == "tag":
            v = group.get_tag(self._config.get("Key", ""))
            return v is not None and v == str(self._config.get("Value", ""))
        return False


class Router:
    """Holds (flusher_idx, condition) pairs; unconditional flushers always
    receive the group."""

    def __init__(self) -> None:
        self._conditional: List[tuple] = []
        self._unconditional: List[int] = []

    def init(self, configs: List[tuple]) -> bool:
        """configs: list of (flusher_idx, match_config_or_None)."""
        for idx, cfg in configs:
            if cfg is None:
                self._unconditional.append(idx)
            else:
                self._conditional.append((idx, Condition(cfg)))
        return True

    def route(self, group: PipelineEventGroup) -> List[int]:
        out = list(self._unconditional)
        for idx, cond in self._conditional:
            if cond.check(group):
                out.append(idx)
        return out
