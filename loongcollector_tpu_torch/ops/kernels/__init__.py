"""Device kernels of the port.

* ``field_extract`` — Tier-1 segment-program extraction (K1): the plain
  PyTorch version and the ``ExtractKernel`` wrapper that launches the CUDA
  kernel (``field_extract_cuda``, source ``csrc/field_extract.cu``) for
  CUDA tensors.
* ``dfa_scan`` — the Tier-2 DFA walk: K2 (``DFAMatchKernel``, one DFA, a
  bool per row) and K4 (``FusedScanKernel``, a fused multi-accept DFA, a
  tag mask per row), plain versions and wrappers that launch the CUDA
  kernels (``dfa_scan_cuda``, source ``csrc/dfa_scan.cu``).
"""
