"""SpDISTAL in PyTorch and CUDA: the port of the JAX package ``repro``.

Subpackages mirror the reference's: :mod:`.core` (TIN, formats, TDN,
schedules, partitioning, lowering), :mod:`.kernels` (the Hopper kernels and
their plain versions), :mod:`.runtime` (tracing and metrics) and
:mod:`.data` (generators). Entry points run on the card unless the caller
passes ``device="cpu"``. The package imports neither JAX nor ``repro``.
"""
