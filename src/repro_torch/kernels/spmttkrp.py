"""SpMTTKRP leaf ``A(i,l) = B(i,j,k) · C(j,l) · D(k,l)`` for both
distribution strategies; the format query also serves SpTTV.

One Hopper kernel (``csrc/spmttkrp.cu``) with its plain PyTorch version
beside it: :func:`spmttkrp_coo`, over the flattened, row-sorted per-entry
stream (row, j, k, val) of each piece, batched over pieces. Replaces the
TPU kernel ``repro/kernels/spmttkrp.py::spmttkrp_ell``. As there, one kernel
serves every lowered leaf: the CSF rows strategy flattens its shard once
(:func:`flatten_csf`), while COO3 rows and the nnz strategy already hold
the stream. A wrapper runs the plain version only when its inputs lie on
the CPU; on a CUDA tensor it launches the kernel or raises.

SpTTV (``A(i,j) = B(i,j,k)·c(k)``) needs no kernel of its own: over CSF
row shards it is the SpMV rows kernel over the level-1 (i, j) positions.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core import formats as fmt
from . import ref
from ._build import check_launch, library, on_cpu

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # rows, j, k, vals, C, D, head, tail, group, A, P, N, J, K, L, max_rows,
    # stream
    "spmttkrp_coo": (_P,) * 10 + (_I, _L, _I, _I, _I, _I, _P),
}
SEGMENT = 256       # entries per segment, kSeg in csrc/spmttkrp.cu
GROUP = 64          # segments per group sum, kGroup in csrc/segment_fold.cuh


def supports(format: "fmt.Format", space: str) -> bool:
    """Format-dispatch query for 3-D MTTKRP (and TTV). Universe needs a
    row-partitionable root plus a walkable body: a grouped (non-singleton
    compressed) middle level feeds the two-level pos/crd leaf (CSF
    directly, DCSF via the densified row window), and trailing-singleton
    trees (COO3) feed the flat per-position leaf bucketed by row window.
    The nnz leaf consumes flat per-nnz (i, j, k) coordinates, which every
    unblocked 3-D sparse format provides."""
    caps = fmt.capabilities(format)
    if caps.order != 3:
        return False
    if space == "universe":
        grouped = (format.levels[1].compressed
                   and not format.levels[1].singleton)
        trailing = all(l.singleton for l in format.levels[1:])
        return caps.row_partitionable and (grouped or trailing)
    return caps.nnz_partitionable


def flatten_csf(pos1: torch.Tensor, crd1: torch.Tensor, pos2: torch.Tensor,
                n_positions: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, j) per stored position of one CSF row shard, the stream the
    kernel takes: ``rows`` is the shard-local row owning each position's
    (i, j) fibre and ``j`` the fibre's level-1 coordinate, expanded as
    ``ref.leaf_spmttkrp_rows`` does. The padding tail (positions at or past
    ``pos2[-1]``) gets the dropped row id R = len(pos1) - 1 rather than the
    last row that ``rows_from_pos`` gives it: the kernel skips a segment of
    dropped ids, while a last-row tail would be one long run whose
    gathers and chained partials it would all compute."""
    ij = ref.rows_from_pos(pos2, n_positions)
    i_of_ij = ref.rows_from_pos(pos1, crd1.shape[0])
    pad = torch.arange(n_positions, device=pos2.device) >= pos2[-1]
    rows = torch.where(pad, pos1.shape[0] - 1, ref._gather(i_of_ij, ij))
    return rows.int(), ref._gather(crd1, ij).int()


def spmttkrp_coo_plain(rows, j, k, vals, C, D, max_rows: int):
    return torch.stack([ref.leaf_spmttkrp_nnz(rows[p], j[p], k[p], vals[p],
                                              C, D, max_rows)
                        for p in range(rows.shape[0])])


def spmttkrp_coo(rows: torch.Tensor, j: torch.Tensor, k: torch.Tensor,
                 vals: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                 max_rows: int) -> torch.Tensor:
    """A (P, max_rows, L): A[p, r] = Σ vals[p, e]·C[j[p, e]]⊙D[k[p, e]] over
    the entries of piece p with rows[p, e] == r, summed in a fixed order.
    ``rows`` (P, N) must be non-decreasing within each piece (the kernel's
    contract, as :func:`spmm.spmm_coo_nnz`'s); ids outside [0, max_rows)
    are dropped. ``C`` is (J, L), ``D`` (K, L)."""
    if rows.dim() != 2 or j.shape != rows.shape or k.shape != rows.shape \
            or vals.shape != rows.shape or C.dim() != 2 or D.dim() != 2 \
            or C.shape[1] != D.shape[1]:
        raise ValueError(f"spmttkrp_coo: bad shapes rows {tuple(rows.shape)} "
                         f"j {tuple(j.shape)} k {tuple(k.shape)} "
                         f"vals {tuple(vals.shape)} C {tuple(C.shape)} "
                         f"D {tuple(D.shape)}")
    if on_cpu("spmttkrp_coo", {"rows": rows, "j": j, "k": k},
              {"vals": vals, "C": C, "D": D}):
        return spmttkrp_coo_plain(rows, j, k, vals, C, D, max_rows)
    P, N = rows.shape
    (J, L), K = C.shape, D.shape[0]
    A = torch.zeros((P, max_rows, L), dtype=torch.float32, device=rows.device)
    if P * max_rows * L == 0 or N == 0 or J * K == 0:
        return A                       # nothing to launch: no stored entry
    nseg = -(-N // SEGMENT)
    head = torch.empty((P, nseg, L), dtype=torch.float32, device=rows.device)
    tail = torch.empty_like(head)
    group = torch.empty((P, nseg // GROUP, L), dtype=torch.float32,
                        device=rows.device)
    with torch.cuda.device(rows.device):
        err = library("spmttkrp", _SIGNATURES).spmttkrp_coo(
            rows.data_ptr(), j.data_ptr(), k.data_ptr(), vals.data_ptr(),
            C.data_ptr(), D.data_ptr(), head.data_ptr(), tail.data_ptr(),
            group.data_ptr(), A.data_ptr(), P, N, J, K, L, int(max_rows),
            torch.cuda.current_stream().cuda_stream)
    check_launch("spmttkrp_coo", err)
    return A
