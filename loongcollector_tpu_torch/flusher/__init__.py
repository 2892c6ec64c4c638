"""Flusher plugins of the port: ``flusher_stdout`` and ``flusher_file``."""


def register_all(registry) -> None:
    from .file import FlusherFile
    from .stdout import FlusherStdout
    registry.register_flusher("flusher_stdout", FlusherStdout)
    registry.register_flusher("flusher_file", FlusherFile)
