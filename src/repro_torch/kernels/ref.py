"""Plain PyTorch oracles for the SpMV, SpMM, SDDMM, SpTTV and SpMTTKRP
leaf kernels.

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


def dense_sddmm(Bpat: torch.Tensor, C: torch.Tensor,
                D: torch.Tensor) -> torch.Tensor:
    """A(i,j) = B(i,j) * C(i,k) * D(k,j): the dense product sampled at B."""
    return Bpat * torch.einsum("ik,kj->ij", C, D)


def dense_spttv(B: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ijk,k->ij", B, c)


def dense_spmttkrp(B: torch.Tensor, C: torch.Tensor,
                   D: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ijk,jl,kl->il", B, C, D)


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


def leaf_sddmm_nnz(rows, cols, vals, C, D):
    """out_vals (N,) = vals * <C[rows, :], D[:, cols]>, the fused SDDMM leaf
    over coordinate columns."""
    Cg = _gather(C, rows)                            # (N, K)
    Dg = _gather(D.t(), cols)                        # (N, K)
    return vals * (Cg * Dg).sum(dim=1)


def leaf_sddmm_rows(pos, crd, vals, C_local, D):
    """Row-window SDDMM leaf: a CSR row shard, C's matching row block local,
    D replicated. Output vals stay aligned with the shard's positions."""
    rows = rows_from_pos(pos, crd.shape[0])
    return leaf_sddmm_nnz(rows, crd, vals, C_local, D)


def leaf_spttv_rows(pos1, crd1, pos2, crd2, vals, c):
    """A(i,j) = B(i,j,k)·c(k) over a CSF row shard: vals aligned with the
    shard's level-1 (i, j) positions."""
    ij_of_nnz = rows_from_pos(pos2, crd2.shape[0])
    return _segment_sum(vals * _gather(c, crd2), ij_of_nnz, crd1.shape[0])


def leaf_spttv_flat(k, vals, c):
    """The flat walk's per-position SpTTV products vals·c[k]; the (i, j)
    assembly happens on the host. No TPU kernel: the reference computes
    them in jnp inside its emitter."""
    return vals * _gather(c, k)


def leaf_spttv_nnz(ij_local, k, vals, c, max_ij: int):
    return _segment_sum(vals * _gather(c, k), ij_local, max_ij)


def leaf_spmttkrp_rows(pos1, crd1, pos2, crd2, vals, C, D):
    """A(i,l) = B(i,j,k)·C(j,l)·D(k,l) over a CSF row shard -> (R, L)."""
    ij_of_nnz = rows_from_pos(pos2, crd2.shape[0])   # level-1 position per nnz
    i_of_ij = rows_from_pos(pos1, crd1.shape[0])     # row per level-1 position
    j = _gather(crd1, ij_of_nnz)
    i = _gather(i_of_ij, ij_of_nnz)
    return leaf_spmttkrp_nnz(i, j, crd2, vals, C, D, pos1.shape[0] - 1)


def leaf_spmttkrp_nnz(i_local, j, k, vals, C, D, max_rows: int):
    contrib = vals[:, None] * _gather(C, j) * _gather(D, k)
    return _segment_sum(contrib, i_local, max_rows)
