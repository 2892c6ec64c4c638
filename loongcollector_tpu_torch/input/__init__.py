"""Input plugins of the port: ``input_file`` (one-shot read of FilePaths)
and the five eBPF inputs (``input/ebpf/server.py``), under the reference's
names."""


def register_all(registry) -> None:
    from .ebpf.server import (InputCpuProfiling, InputFileSecurity,
                              InputNetworkObserver, InputNetworkSecurity,
                              InputProcessSecurity)
    from .file.input_file import InputFile
    registry.register_input("input_file", InputFile)
    registry.register_input("input_network_observer", InputNetworkObserver)
    registry.register_input("input_process_security", InputProcessSecurity)
    registry.register_input("input_file_security", InputFileSecurity)
    registry.register_input("input_network_security", InputNetworkSecurity)
    registry.register_input("input_cpu_profiling", InputCpuProfiling)
