from .event_group import (ColumnarLogs, EventGroupMetaKey,  # noqa: F401
                          PipelineEventGroup, churn_stats, columnar_enabled,
                          reset_churn_stats, set_columnar_enabled)
from .events import (EventType, LogEvent, MetricEvent,  # noqa: F401
                     MetricValue, PipelineEvent, RawEvent, SpanEvent)
from .source_buffer import SourceBuffer  # noqa: F401
