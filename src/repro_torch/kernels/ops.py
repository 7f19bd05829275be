"""Single-shard wrappers over the sparse kernels: the public compute API.

Every op takes ``impl``, mirroring the JAX package's ``"xla"|"pallas"``:

- ``"torch"``: the plain PyTorch leaves of :mod:`.ref`.
- ``"cuda"``: the Hopper kernels, fed the CSR / COO arrays as they are
  (the TPU kernels' ELL and padded-COO packs are not needed). On CPU
  tensors the kernel wrappers run their plain versions.

Inputs are numpy arrays or tensors; they are moved to ``device`` (the card
when None, see :func:`repro_torch.core.device.resolve_device`). Results
are tensors on that device.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from . import ref
from .spmm import spmm_csr_rows
from .spmv import spmv_coo_nnz, spmv_csr_rows


def _on(device, *arrays):
    return [torch.as_tensor(a).to(device).contiguous() for a in arrays]


def _check_impl(impl: str) -> None:
    if impl not in ("torch", "cuda"):
        raise ValueError(f"impl must be 'torch' or 'cuda', got {impl!r}")


def spmv(pos, crd, vals, c, impl: str = "torch", device=None):
    """y (n,) = CSR(pos, crd, vals) @ c."""
    _check_impl(impl)
    pos, crd, vals, c = _on(resolve_device(device), pos, crd, vals, c)
    if impl == "torch":
        return ref.leaf_spmv_rows(pos, crd, vals, c)
    return spmv_csr_rows(pos[None], crd[None], vals[None], c)[0]


def spmv_nnz(rows, cols, vals, c, n_rows: int, impl: str = "torch",
             device=None):
    """y (n_rows,) from COO whose ``rows`` are sorted: the nnz-strategy leaf
    and its merge."""
    _check_impl(impl)
    rows, cols, vals, c = _on(resolve_device(device), rows, cols, vals, c)
    if impl == "torch":
        return ref.leaf_spmv_nnz(rows, cols, vals, c, n_rows)
    return spmv_coo_nnz(rows[None], cols[None], vals[None], c, n_rows)[0]


def spmm(pos, crd, vals, C, impl: str = "torch", device=None):
    """Y (n, J) = CSR(pos, crd, vals) @ C (K, J)."""
    _check_impl(impl)
    pos, crd, vals, C = _on(resolve_device(device), pos, crd, vals, C)
    if impl == "torch":
        return ref.leaf_spmm_rows(pos, crd, vals, C)
    return spmm_csr_rows(pos[None], crd[None], vals[None], C)[0]
