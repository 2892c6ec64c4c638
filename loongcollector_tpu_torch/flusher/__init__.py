"""Flusher plugins of the port: ``flusher_stdout`` and ``flusher_file``
(inline writes), ``flusher_http``, ``flusher_prometheus``,
``flusher_loki``, ``flusher_elasticsearch``, ``flusher_clickhouse`` and
``flusher_sls`` (the send path: Batcher, sender queue, flusher runner,
HTTP sink)."""


def register_all(registry) -> None:
    from .clickhouse import FlusherClickHouse
    from .elasticsearch import FlusherElasticsearch
    from .file import FlusherFile
    from .http import FlusherHTTP
    from .loki import FlusherLoki
    from .prometheus_rw import FlusherPrometheus
    from .sls import FlusherSLS
    from .stdout import FlusherStdout
    registry.register_flusher("flusher_stdout", FlusherStdout)
    registry.register_flusher("flusher_file", FlusherFile)
    registry.register_flusher("flusher_http", FlusherHTTP)
    registry.register_flusher("flusher_prometheus", FlusherPrometheus)
    registry.register_flusher("flusher_loki", FlusherLoki)
    registry.register_flusher("flusher_elasticsearch", FlusherElasticsearch)
    registry.register_flusher("flusher_clickhouse", FlusherClickHouse)
    registry.register_flusher("flusher_sls", FlusherSLS)
