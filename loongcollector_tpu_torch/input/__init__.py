"""Input plugins of the port: ``input_file`` (one-shot read of FilePaths)."""


def register_all(registry) -> None:
    from .file.input_file import InputFile
    registry.register_input("input_file", InputFile)
