"""Input plugins of the port: ``input_file`` (one-shot read of FilePaths,
or tail mode), ``input_container_stdio`` (container stdout,
``input/container_stdio.py``), the five eBPF inputs
(``input/ebpf/server.py``), the three internal inputs
(``input/internal.py``), ``input_http_server`` and ``input_otlp``
(``input/http_server.py``), and ``input_host_monitor``,
``input_host_meta`` and ``input_process_entity``
(``input/host_monitor.py``), under the reference's names."""


def register_all(registry) -> None:
    from .ebpf.server import (InputCpuProfiling, InputFileSecurity,
                              InputNetworkObserver, InputNetworkSecurity,
                              InputProcessSecurity)
    from .container_stdio import InputContainerStdio
    from .file.input_file import InputFile
    from .host_monitor import (InputHostMeta, InputHostMonitor,
                               InputProcessEntity)
    from .http_server import InputHTTPServer, InputOTLP
    from .internal import (InputInternalAlarms,
                           InputInternalMatchedContainerInfo,
                           InputInternalMetrics)
    registry.register_input("input_file", InputFile)
    registry.register_input("input_container_stdio", InputContainerStdio)
    registry.register_input("input_internal_matched_container_info",
                            InputInternalMatchedContainerInfo)
    registry.register_input("input_internal_metrics", InputInternalMetrics)
    registry.register_input("input_internal_alarms", InputInternalAlarms)
    registry.register_input("input_network_observer", InputNetworkObserver)
    registry.register_input("input_process_security", InputProcessSecurity)
    registry.register_input("input_file_security", InputFileSecurity)
    registry.register_input("input_network_security", InputNetworkSecurity)
    registry.register_input("input_cpu_profiling", InputCpuProfiling)
    registry.register_input("input_host_monitor", InputHostMonitor)
    registry.register_input("input_host_meta", InputHostMeta)
    registry.register_input("input_process_entity", InputProcessEntity)
    registry.register_input("input_http_server", InputHTTPServer)
    registry.register_input("input_otlp", InputOTLP)
