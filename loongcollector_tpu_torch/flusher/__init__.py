"""Flusher plugins of the port: ``flusher_stdout`` and ``flusher_file``
(inline writes), ``flusher_http`` and ``flusher_prometheus`` (the send
path: Batcher, sender queue, flusher runner, HTTP sink)."""


def register_all(registry) -> None:
    from .file import FlusherFile
    from .http import FlusherHTTP
    from .prometheus_rw import FlusherPrometheus
    from .stdout import FlusherStdout
    registry.register_flusher("flusher_stdout", FlusherStdout)
    registry.register_flusher("flusher_file", FlusherFile)
    registry.register_flusher("flusher_http", FlusherHTTP)
    registry.register_flusher("flusher_prometheus", FlusherPrometheus)
