"""Mixture-of-Experts sparse dispatch as the paper's sparse matrix.

The router output is a sparse (tokens × experts) matrix with top-k
non-zeros per row: :func:`dispatch_tensor` stores it in CSR, and
:func:`combine_kernel` lowers the combine ``y = dispatch @ c`` as a batched
serving kernel over it (the Hopper SpMM kernels).

The expert layer itself (``moe_init``, ``moe_apply``) belongs to the MoE
model family and waits for it (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import numpy as np

from ..core import formats as F
from ..core.tensor import Tensor


def dispatch_tensor(tope, topw, n_experts: int,
                    name: str = "dispatch") -> Tensor:
    """The router's top-k assignment as the paper's sparse matrix: a
    (tokens × experts) CSR Tensor whose row ``t`` holds token ``t``'s
    combine weights at its chosen expert columns."""
    tope = np.asarray(tope)
    topw = np.asarray(topw, np.float32)
    N, k = tope.shape
    coords = np.stack([np.repeat(np.arange(N, dtype=np.int64), k),
                       tope.reshape(-1).astype(np.int64)], axis=1)
    return Tensor.from_coo(name, (N, int(n_experts)), coords,
                           topw.reshape(-1), F.CSR(), dedupe=True)


def combine_kernel(disp: Tensor, machine, *, batch: int = 8,
                   schedule=None, device=None):
    """The MoE combine ``y(t) = dispatch(t, e) * c(e)`` lowered as a
    batched serving kernel on ``device`` (the card when None): each
    request is one model-dimension column of the stacked per-expert
    outputs, and ``run_many`` folds a batch of columns into a single SpMM
    against the frozen dispatch matrix. Returns a
    :class:`repro_torch.core.lower.BatchedKernel`."""
    from ..core.lower import lower_batched
    from ..core.tin import parse_tin
    N, E = disp.shape
    stmt = parse_tin("y(i) = dispatch(i,j) * c(j)",
                     y=Tensor.zeros_dense("y", (int(N),)),
                     dispatch=disp,
                     c=Tensor.zeros_dense("c", (int(E),)))
    return lower_batched(stmt, machine, batch=batch, schedule=schedule,
                         device=device)
