"""Single-shard wrappers over the sparse kernels: the public compute API.

Every op takes ``impl``, mirroring the JAX package's ``"xla"|"pallas"``:

- ``"torch"``: the plain PyTorch leaves of :mod:`.ref`.
- ``"cuda"``: the Hopper kernels, fed the CSR / COO / BCSR arrays as they
  are (the TPU kernels' ELL, padded-COO and ``bcsr_ell_pack`` packs and
  their tiling arguments are not needed). On CPU tensors the kernel
  wrappers run their plain versions.

Inputs are numpy arrays or tensors; they are moved to ``device`` (the card
when None, see :func:`repro_torch.core.device.resolve_device`). Results
are tensors on that device.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from . import ref
from .bcsr import bcsr_sddmm, bcsr_spmm, bcsr_spmv
from .sddmm import sddmm_coo
from .spadd3 import (bcsr_spadd3_dense_rows, bcsr_spadd3_dense_rows_plain,
                     spadd3_dense_rows, spadd3_dense_rows_plain)
from .spmm import spmm_csr_rows
from .spmttkrp import flatten_csf, spmttkrp_coo
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


def sddmm(rows, cols, vals, C, D, impl: str = "torch", device=None):
    """out_vals (nnz,) = vals ⊙ (C @ D) sampled at (rows, cols)."""
    _check_impl(impl)
    rows, cols, vals, C, D = _on(resolve_device(device), rows, cols, vals,
                                 C, D)
    if impl == "torch":
        return ref.leaf_sddmm_nnz(rows, cols, vals, C, D)
    return sddmm_coo(rows[None], cols[None], vals[None], C,
                     D.t().contiguous())[0]


def _pad_rows(x, n: int):
    """``x`` (m, ...) zero-padded along its first axis to n rows: a dense
    co-operand in whole blocks of a blocked operand's grid."""
    out = x.new_zeros((n,) + tuple(x.shape[1:]))
    out[:x.shape[0]] = x
    return out


def spmv_bcsr(pos, crd, tiles, c, impl: str = "torch", device=None):
    """y (grid_rows·br,) = BCSR(pos, crd, tiles) @ c; slice to n_rows."""
    _check_impl(impl)
    pos, crd, tiles, c = _on(resolve_device(device), pos, crd, tiles, c)
    bc = tiles.shape[2]
    grid_cols = -(-c.shape[0] // bc)
    c_blk = _pad_rows(c, grid_cols * bc).reshape(grid_cols, bc)
    if impl == "torch":
        return ref.leaf_bcsr_spmv_rows(pos, crd, tiles, c_blk)
    return bcsr_spmv(ref.rows_from_pos(pos, crd.shape[0]).int()[None],
                     crd.int()[None], tiles[None], c_blk,
                     pos.shape[0] - 1)[0]


def spmm_bcsr(pos, crd, tiles, C, impl: str = "torch", device=None):
    """Y (grid_rows·br, J) = BCSR(pos, crd, tiles) @ C (K, J); slice to
    n_rows."""
    _check_impl(impl)
    pos, crd, tiles, C = _on(resolve_device(device), pos, crd, tiles, C)
    bc = tiles.shape[2]
    grid_cols = -(-C.shape[0] // bc)
    C_blk = _pad_rows(C, grid_cols * bc).reshape(grid_cols, bc, C.shape[1])
    if impl == "torch":
        return ref.leaf_bcsr_spmm_rows(pos, crd, tiles, C_blk)
    return bcsr_spmm(ref.rows_from_pos(pos, crd.shape[0]).int()[None],
                     crd.int()[None], tiles[None], C_blk,
                     pos.shape[0] - 1)[0]


def sddmm_bcsr(brow, bcol, tiles, C, D, impl: str = "torch", device=None):
    """out tiles (nb, br, bc) = tiles ⊙ the (br, bc) blocks of C (n, K) @
    D (K, m) at the stored blocks' global coordinates (brow, bcol)."""
    _check_impl(impl)
    brow, bcol, tiles, C, D = _on(resolve_device(device), brow, bcol, tiles,
                                  C, D)
    br, bc = tiles.shape[1], tiles.shape[2]
    K = C.shape[1]
    C = _pad_rows(C, -(-C.shape[0] // br) * br)
    Dt = _pad_rows(D.t(), -(-D.shape[1] // bc) * bc)
    if impl == "torch":
        return ref.leaf_bcsr_sddmm(brow, bcol, tiles, C.reshape(-1, br, K),
                                   Dt.reshape(-1, bc, K).transpose(1, 2))
    return bcsr_sddmm(brow.int()[None], bcol.int()[None], tiles[None], C,
                      Dt)[0]


def _check_distinct(pos, crd, what: str) -> None:
    """The dense kernels' contract: within each row (block-row) of one
    operand the columns (block columns) strictly increase, so every cell
    is written by one thread. Canonical CSR / BCSR storage satisfies it."""
    rows = torch.repeat_interleave(
        torch.arange(pos.shape[0] - 1, device=pos.device),
        (pos[1:] - pos[:-1]).long())
    n = rows.shape[0]
    if bool(((crd[1:n] <= crd[:n - 1]) & (rows[1:] == rows[:-1])).any()):
        raise ValueError(f"{what}: columns must strictly increase within "
                         "each row")


def _spadd3_dense(triples, n_rows, n_cols, impl, device, plain, kernel):
    _check_impl(impl)
    dev = resolve_device(device)
    flat = [x for t in triples for x in _on(dev, *t)]
    if impl == "torch":
        return plain(*flat, n_rows, n_cols)
    for i in range(3):
        _check_distinct(flat[3 * i], flat[3 * i + 1], f"operand {i + 1}")
    return kernel(*flat, n_rows, n_cols)


def spadd3_dense(csr1, csr2, csr3, n_rows: int, n_cols: int,
                 impl: str = "torch", device=None):
    """Dense (n_rows, n_cols) = B + C + D from three CSR triples (pos, crd,
    vals)."""
    return _spadd3_dense((csr1, csr2, csr3), n_rows, n_cols, impl, device,
                         spadd3_dense_rows_plain, spadd3_dense_rows)


def spadd3_bcsr_dense(bcsr1, bcsr2, bcsr3, n_rows: int, n_cols: int,
                      impl: str = "torch", device=None):
    """Dense (n_rows, n_cols) = B + C + D from three blocked (pos, crd,
    tiles) triples sharing one block shape; the padding of ragged boundary
    blocks is sliced off."""
    return _spadd3_dense((bcsr1, bcsr2, bcsr3), n_rows, n_cols, impl, device,
                         bcsr_spadd3_dense_rows_plain, bcsr_spadd3_dense_rows)


def spttv(pos1, crd1, pos2, crd2, vals, c, impl: str = "torch",
          device=None):
    """out_vals aligned with a CSF tensor's (i, j) positions: A(i,j) =
    B(i,j,k)·c(k). The kernel is the SpMV rows kernel over the level-1
    positions."""
    _check_impl(impl)
    pos1, crd1, pos2, crd2, vals, c = _on(resolve_device(device), pos1, crd1,
                                          pos2, crd2, vals, c)
    if impl == "torch":
        return ref.leaf_spttv_rows(pos1, crd1, pos2, crd2, vals, c)
    return spmv_csr_rows(pos2[None], crd2[None], vals[None], c)[0]


def spmttkrp(pos1, crd1, pos2, crd2, vals, C, D, impl: str = "torch",
             device=None):
    """A (n, L) = B(i,j,k)·C(j,l)·D(k,l) from a CSF tensor's arrays; the
    kernel takes the flattened (row, j, k, val) stream."""
    _check_impl(impl)
    pos1, crd1, pos2, crd2, vals, C, D = _on(
        resolve_device(device), pos1, crd1, pos2, crd2, vals, C, D)
    if impl == "torch":
        return ref.leaf_spmttkrp_rows(pos1, crd1, pos2, crd2, vals, C, D)
    rows, j = flatten_csf(pos1, crd1, pos2, crd2.shape[0])
    return spmttkrp_coo(rows[None], j[None], crd2[None], vals[None], C, D,
                        pos1.shape[0] - 1)[0]
