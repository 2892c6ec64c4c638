"""Device kernels of the port.

* ``field_extract`` — Tier-1 segment-program extraction (K1): the plain
  PyTorch version and the ``ExtractKernel`` wrapper that launches the CUDA
  kernel (``field_extract_cuda``, source ``csrc/field_extract.cu``) for
  CUDA tensors.
* ``dfa_scan`` — the Tier-2 DFA walk: K2 (``DFAMatchKernel``, one DFA, a
  bool per row), K3 (``DFASpanMatchKernel``, K2 over a row-relative span of
  each row, the fused program's span condition and its per-stage twin) and
  K4 (``FusedScanKernel``, a fused multi-accept DFA, a tag mask per row),
  plain versions and wrappers that launch the CUDA kernels
  (``dfa_scan_cuda``, source ``csrc/dfa_scan.cu``).
* ``fused_program_cuda`` — K7, the fused stage program: one launch a chunk
  runs a pipeline's extract, scan and keep stages over rows staged once
  (source ``csrc/fused_program.cu``); its plain version and wrapper are
  ``ops/fused_pipeline.py``'s ``build_fused_fn`` and
  ``FusedProgramKernel``.  The Tier-1 walker and the DFA byte walk are
  shared headers (``csrc/extract_walk.cuh``, ``csrc/dfa_walk.cuh``).
"""
