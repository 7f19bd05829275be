"""The six examples of the JAX package's ``examples/``, ported: each runs as
``python -m repro_torch.examples.<name>`` on the card (``--device cpu``
for the CPU) and has a ``main(argv=None)`` that returns the figures it
prints.

- :mod:`.quickstart` — the paper's Figure 1 program, distributed SpMV;
- :mod:`.spmv_distributed` — row- against non-zero-based SpMV on a skewed
  matrix, and ``to_spmd`` over gloo ranks when started with ``torchrun``;
- :mod:`.moe_sparse_dispatch` — MoE routing as a sparse tensor;
- :mod:`.long_context_block_sparse` — block-sparse sliding-window
  attention;
- :mod:`.serve_batched` — batched band-mask decode and the
  ``SparseKernelServer``;
- :mod:`.train_e2e` — the ``Trainer`` end to end with checkpoints.
"""
