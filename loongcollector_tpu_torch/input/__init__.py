"""Input plugins of the port: ``input_file`` (one-shot read of FilePaths),
the five eBPF inputs (``input/ebpf/server.py``) and the two internal
self-monitor inputs (``input/internal.py``), under the reference's
names."""


def register_all(registry) -> None:
    from .ebpf.server import (InputCpuProfiling, InputFileSecurity,
                              InputNetworkObserver, InputNetworkSecurity,
                              InputProcessSecurity)
    from .file.input_file import InputFile
    from .internal import InputInternalAlarms, InputInternalMetrics
    registry.register_input("input_file", InputFile)
    registry.register_input("input_internal_metrics", InputInternalMetrics)
    registry.register_input("input_internal_alarms", InputInternalAlarms)
    registry.register_input("input_network_observer", InputNetworkObserver)
    registry.register_input("input_process_security", InputProcessSecurity)
    registry.register_input("input_file_security", InputFileSecurity)
    registry.register_input("input_network_security", InputNetworkSecurity)
    registry.register_input("input_cpu_profiling", InputCpuProfiling)
