"""loongcollector_tpu_torch — the PyTorch/CUDA port of loongcollector_tpu.

The same agent data plane (file input → split → multiline → regex or grok
parse → filter → timestamp → NDJSON flush) with its kernels written by
hand in CUDA C++ for Hopper: the Tier-1 field extraction
(``ops/kernels/csrc/field_extract.cu``) and the Tier-2 DFA walk
(``ops/kernels/csrc/dfa_scan.cu``).  The package imports ``torch`` and
never ``jax`` or the JAX package; entry points run on the CUDA device
unless the caller asks for the CPU (``device="cpu"`` / ``--cpu``), where
the kernels' plain PyTorch versions run instead.
"""

__version__ = "0.1.0"
