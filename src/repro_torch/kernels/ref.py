"""Plain PyTorch oracles for the SpMV and SpMM leaf kernels.

Two families, as in the JAX package:

1. **Dense oracles** (``dense_*``): einsum on densified inputs.
2. **Shard leaves** (``leaf_*``): one piece's shard in, one piece's local
   output out, on the padded shard layouts of :mod:`repro_torch.core.partition`
   (``pos``/``crd`` pairs for row walks, coordinate columns for position
   splits). These are the plain versions the Hopper kernels are held
   against, and the CPU path of the lowered kernels.

Index handling differs from the JAX leaves on purpose: ``jnp.take`` never
raises on an out-of-range index and ``segment_sum`` drops out-of-range
segment ids, while ``torch.index_select`` / ``index_add_`` raise. So every
gather clips its index into range and every segment sum masks the ids
outside ``[0, num_segments)`` explicitly. The shards never carry an
out-of-range column, and padded slots have ``vals == 0``.
"""
from __future__ import annotations

import torch


def dense_spmv(B: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ij,j->i", B, c)


def dense_spmm(B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ik,kj->ij", B, C)


def rows_from_pos(pos: torch.Tensor, n_positions: int) -> torch.Tensor:
    """Expand a local pos array (R+1,) to a per-position row id (n_positions,).
    Padded positions (>= pos[-1]) clip to the last row; their vals are 0."""
    p = torch.arange(n_positions, dtype=pos.dtype, device=pos.device)
    r = torch.searchsorted(pos, p, right=True) - 1
    return r.clamp(0, max(pos.shape[0] - 2, 0))


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x[idx.long().clamp(0, max(x.shape[0] - 1, 0))]


def _segment_sum(prod: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """``segment_sum`` over axis 0 that drops ids outside [0, num_segments)."""
    seg = seg.long()
    keep = (seg >= 0) & (seg < num_segments)
    if prod.dim() > 1:
        keep = keep.reshape((-1,) + (1,) * (prod.dim() - 1))
    out = torch.zeros((num_segments,) + tuple(prod.shape[1:]),
                      dtype=prod.dtype, device=prod.device)
    if num_segments == 0:
        return out
    return out.index_add_(0, seg.clamp(0, num_segments - 1),
                          torch.where(keep, prod, torch.zeros_like(prod)))


def leaf_spmv_rows(pos, crd, vals, c):
    """y_local (R,) from a CSR row shard; c replicated."""
    rows = rows_from_pos(pos, crd.shape[0])
    return _segment_sum(vals * _gather(c, crd), rows, pos.shape[0] - 1)


def leaf_spmv_nnz(rows_local, cols, vals, c, max_rows: int):
    """y_local (max_rows,) from an equal-nnz COO shard whose rows are
    already rebased to the shard's root window."""
    return _segment_sum(vals * _gather(c, cols), rows_local, max_rows)


def leaf_spmm_rows(pos, crd, vals, C):
    """Y_local (R, J) = local CSR @ C, C (K, J) replicated."""
    rows = rows_from_pos(pos, crd.shape[0])
    return _segment_sum(vals[:, None] * _gather(C, crd), rows,
                        pos.shape[0] - 1)


def leaf_spmm_nnz(rows_local, cols, vals, C, max_rows: int):
    return _segment_sum(vals[:, None] * _gather(C, cols), rows_local,
                        max_rows)
