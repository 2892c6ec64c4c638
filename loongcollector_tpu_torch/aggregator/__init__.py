"""Aggregator plugins of the port, under the JAX package's names
(``aggregator/__init__.py`` there): the regrouping aggregators of
``base.py`` and ``aggregator_metric_rollup``."""


def register_all(registry) -> None:
    from .base import (AggregatorBase, AggregatorContentValueGroup,
                       AggregatorContext, AggregatorLogstoreRouter,
                       AggregatorMetadataGroup, AggregatorShardHash,
                       AggregatorSkywalking, AggregatorTelemetryRouter)

    registry.register_aggregator("aggregator_base", AggregatorBase)
    registry.register_aggregator("aggregator_context", AggregatorContext)
    registry.register_aggregator("aggregator_metadata_group",
                                 AggregatorMetadataGroup)
    registry.register_aggregator("aggregator_shardhash", AggregatorShardHash)
    registry.register_aggregator("aggregator_content_value_group",
                                 AggregatorContentValueGroup)
    registry.register_aggregator("aggregator_logstore_router",
                                 AggregatorLogstoreRouter)
    registry.register_aggregator("aggregator_opentelemetry",
                                 AggregatorTelemetryRouter)
    registry.register_aggregator("aggregator_skywalking",
                                 AggregatorSkywalking)
    registry.register_aggregator("aggregator_default", AggregatorBase)

    from .metric_rollup import AggregatorMetricRollup
    registry.register_aggregator("aggregator_metric_rollup",
                                 AggregatorMetricRollup)
