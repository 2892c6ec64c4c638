"""loongcollector_tpu_torch — the PyTorch/CUDA port of loongcollector_tpu.

The same agent data plane (file input → split → regex parse → timestamp →
NDJSON flush) with the Tier-1 field-extraction kernel written by hand in
CUDA C++ for Hopper (``ops/kernels/csrc/field_extract.cu``).  The package
imports ``torch`` and never ``jax`` or the JAX package; entry points run on
the CUDA device unless the caller asks for the CPU (``device="cpu"`` /
``--cpu``), where the kernel's plain PyTorch version runs instead.
"""

__version__ = "0.1.0"
