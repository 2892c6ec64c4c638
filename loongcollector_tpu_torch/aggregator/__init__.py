"""Aggregator plugins of the port: ``aggregator_metric_rollup``."""


def register_all(registry) -> None:
    from .metric_rollup import AggregatorMetricRollup
    registry.register_aggregator("aggregator_metric_rollup",
                                 AggregatorMetricRollup)
