"""Plain PyTorch oracles for the SpMV, SpMM, SpAdd3, SDDMM, SpTTV and
SpMTTKRP leaf kernels, scalar and blocked.

Two families, as in the JAX package:

1. **Dense oracles** (``dense_*``): einsum on densified inputs.
2. **Shard leaves** (``leaf_*``): one piece's shard in, one piece's local
   output out, on the padded shard layouts of :mod:`repro_torch.core.partition`
   (``pos``/``crd`` pairs for row walks, coordinate columns for position
   splits, ``(br, bc)`` tile stacks for blocked walks). These are the
   plain versions the Hopper kernels are held against, and the CPU path
   of the lowered kernels.

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


def dense_spadd3(B: torch.Tensor, C: torch.Tensor,
                 D: torch.Tensor) -> torch.Tensor:
    return B + C + D


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


# Blocked (BCSR) leaves: every stored position carries a dense (br, bc)
# value tile, so the inner op per position is a dense tile product. Dense
# co-operands arrive packed into matching blocks (``kernels.layout``);
# boundary blocks keep their zero padding, which multiplies away.

def leaf_bcsr_spmv_rows(pos, crd, bvals, c_blk):
    """y_local (R*br,) from a blocked row shard: per stored block a
    (br, bc) @ (bc,) tile matvec, segment-summed over block-rows. ``c_blk``
    is the dense vector in column blocks, (grid_cols, bc)."""
    brow = rows_from_pos(pos, crd.shape[0])
    prod = torch.einsum("nrc,nc->nr", bvals, _gather(c_blk, crd))
    return _segment_sum(prod, brow, pos.shape[0] - 1).reshape(-1)


def leaf_bcsr_spmv_nnz(brow_local, bcol, bvals, c_blk, max_brows: int):
    """Equal-stored-block shard: block-rows already rebased to the shard's
    block-row window; padding blocks have zero tiles."""
    prod = torch.einsum("nrc,nc->nr", bvals, _gather(c_blk, bcol))
    return _segment_sum(prod, brow_local, max_brows).reshape(-1)


def leaf_bcsr_spmm_rows(pos, crd, bvals, C_blk):
    """Y_local (R*br, J): per stored block a dense (br, bc) @ (bc, J)
    product. ``C_blk`` is the dense operand in row blocks, (grid_cols, bc,
    J)."""
    brow = rows_from_pos(pos, crd.shape[0])
    prod = torch.einsum("nrc,ncj->nrj", bvals, _gather(C_blk, crd))
    return _segment_sum(prod, brow, pos.shape[0] - 1).reshape(
        -1, C_blk.shape[-1])


def leaf_bcsr_spmm_nnz(brow_local, bcol, bvals, C_blk, max_brows: int):
    prod = torch.einsum("nrc,ncj->nrj", bvals, _gather(C_blk, bcol))
    return _segment_sum(prod, brow_local, max_brows).reshape(
        -1, C_blk.shape[-1])


def leaf_bcsr_sddmm(brow, bcol, bvals, C_blk, D_blk):
    """out tiles (NB, br, bc) = bvals ⊙ (C row-block @ D col-block), the
    pattern-preserving sampled product at block granularity. ``C_blk``
    (n_brow_blocks, br, K) row blocks (shard-local under rows, the full
    grid under nnz); ``D_blk`` (grid_cols, K, bc) column blocks."""
    sampled = torch.einsum("nrk,nkc->nrc", _gather(C_blk, brow),
                           _gather(D_blk, bcol))
    return bvals * sampled


def _lexsort(cols: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((cols, rows))``: the stable order by row, then column."""
    order = torch.sort(cols, stable=True).indices
    return order[torch.sort(rows[order], stable=True).indices]


def _tile_union(rows, cols, vals, valid):
    """The two-phase union of the SpAdd leaves over a (row, col) keyed stream
    of scalars (``vals`` (n,)) or of (br, bc) tiles: lexsort, sum the entries
    of each run of equal coordinates in stream order, compact. ``rows`` must
    already carry the past-every-valid sentinel on invalid slots. Returns
    (rows, cols, vals, count), padded to n with zeros past ``count``."""
    n = rows.shape[0]
    rows, cols = rows.int(), cols.int()
    if n == 0:                   # empty operands: a statically-empty stream
        return rows, cols, vals, torch.zeros((), dtype=torch.int32)
    order = _lexsort(cols, rows)
    r_s, c_s, v_s, valid_s = rows[order], cols[order], vals[order], \
        valid[order]
    newseg = torch.ones(n, dtype=torch.bool, device=rows.device)
    newseg[1:] = (r_s[1:] != r_s[:-1]) | (c_s[1:] != c_s[:-1])
    seg = torch.cumsum(newseg, 0) - 1
    sums = torch.zeros_like(v_s).index_add_(0, seg, v_s)
    first = torch.nonzero(newseg).squeeze(1)
    count = int((newseg & valid_s).sum())
    out_r = torch.zeros_like(rows)
    out_c = torch.zeros_like(cols)
    out_v = torch.zeros_like(vals)
    out_r[:count] = r_s[first[:count]]
    out_c[:count] = c_s[first[:count]]
    out_v[:count] = sums[:count]
    return out_r, out_c, out_v, torch.tensor(count, dtype=torch.int32)


def _valid_slots(pos, n_slots: int) -> torch.Tensor:
    """Slots of a padded shard that hold stored entries: the first
    ``pos[-1] - pos[0]`` (padding has vals == 0 and is masked out)."""
    return torch.arange(n_slots, device=pos.device) < (pos[-1] - pos[0])


def _union_rows(pos1, crd1, v1, pos2, crd2, v2, pos3, crd3, v3):
    R = pos1.shape[0] - 1
    rows = torch.cat([rows_from_pos(p, c.shape[0])
                      for p, c in ((pos1, crd1), (pos2, crd2), (pos3, crd3))])
    valid = torch.cat([_valid_slots(p, c.shape[0])
                       for p, c in ((pos1, crd1), (pos2, crd2), (pos3, crd3))])
    rows = torch.where(valid, rows, torch.full_like(rows, R))
    return _tile_union(rows, torch.cat([crd1, crd2, crd3]),
                       torch.cat([v1, v2, v3]), valid)


def leaf_spadd3_rows(pos1, crd1, v1, pos2, crd2, v2, pos3, crd3, v3,
                     n_cols: int):
    """Fused three-way sparse add over a row shard: the union of the three
    operands' (row, col) streams, duplicates summed in operand order.
    Returns a padded union COO (rows, cols, vals, count) of static size
    N1+N2+N3, int32 throughout (no fused key), as the reference leaf."""
    del n_cols
    return _union_rows(pos1, crd1, v1, pos2, crd2, v2, pos3, crd3, v3)


def leaf_spadd_union_chunk(rows, cols, vals, count, n_rows: int):
    """Per-chunk union leaf of the nnz SpAdd strategy: the chunk is a slice
    of the concatenated entry stream of all addends; duplicates that
    straddle chunks merge in the cross-chunk assembly."""
    valid = torch.arange(rows.shape[0], device=rows.device) < count
    rows = torch.where(valid, rows, torch.full_like(rows, n_rows))
    return _tile_union(rows, cols, vals, valid)


def leaf_spadd3_dense_rows(pos1, crd1, v1, pos2, crd2, v2, pos3, crd3, v3,
                           n_cols: int):
    """Dense-row-accumulate variant (the TPU kernel's contract): all three
    operands added into dense local rows (R, n_cols)."""
    R = pos1.shape[0] - 1
    out = torch.zeros((R, n_cols), dtype=v1.dtype, device=v1.device)
    for pos, crd, v in ((pos1, crd1, v1), (pos2, crd2, v2), (pos3, crd3, v3)):
        rows = rows_from_pos(pos, crd.shape[0]).long()
        cols = crd.long().clamp(0, max(n_cols - 1, 0))
        if R and n_cols:
            out.index_put_((rows, cols), v, accumulate=True)
    return out


def leaf_bcsr_spadd3_rows(pos1, crd1, t1, pos2, crd2, t2, pos3, crd3, t3):
    """Fused three-way blocked add over a block-row shard: the union of the
    three block coordinate streams, duplicate blocks merged by summing
    their (br, bc) tiles. Returns (brows_local, bcols, tiles, count)."""
    return _union_rows(pos1, crd1, t1, pos2, crd2, t2, pos3, crd3, t3)


def leaf_bcsr_spadd_union_chunk(brows, bcols, tiles, count, n_brows: int):
    """Per-chunk union leaf of the blocked nnz SpAdd strategy: the chunk
    slices the concatenated block stream of all addends."""
    return leaf_spadd_union_chunk(brows, bcols, tiles, count, n_brows)


def leaf_bcsr_spadd3_dense(pos1, crd1, t1, pos2, crd2, t2, pos3, crd3, t3,
                           grid_cols: int):
    """Dense-accumulate variant of the blocked add (the TPU kernel's
    contract): all three tile streams added into a dense block grid,
    returned row-major as (R*br, grid_cols*bc)."""
    R = pos1.shape[0] - 1
    br, bc = t1.shape[1], t1.shape[2]
    out = torch.zeros((R, grid_cols, br, bc), dtype=t1.dtype,
                      device=t1.device)
    for pos, crd, t in ((pos1, crd1, t1), (pos2, crd2, t2), (pos3, crd3, t3)):
        brow = rows_from_pos(pos, crd.shape[0]).long()
        bcol = crd.long().clamp(0, max(grid_cols - 1, 0))
        if R and grid_cols:
            out.index_put_((brow, bcol), t, accumulate=True)
    return out.permute(0, 2, 1, 3).reshape(R * br, grid_cols * bc)


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
