"""Device kernels of the port.

* ``field_extract`` — Tier-1 segment-program extraction: the plain PyTorch
  version and the ``ExtractKernel`` wrapper that launches the CUDA kernel
  (``field_extract_cuda``, source ``csrc/field_extract.cu``) for CUDA
  tensors.
"""
