"""SpMM leaves ``A(i,j) = B(i,k) · C(k,j)`` for both distribution strategies.

Two Hopper kernels (``csrc/spmm.cu``), each with its plain PyTorch version
beside it, batched over pieces:

- :func:`spmm_csr_rows`, the rows leaf over CSR row shards, split by merge
  path over 32-column tiles (:func:`spmv.spmv_csr_rows`' scheme). Replaces
  the TPU kernel ``repro/kernels/spmm.py::spmm_ell``.
- :func:`spmm_coo_nnz`, the nnz leaf over row-sorted COO shards, a
  deterministic segmented reduction (``spmv_coo_nnz``'s scheme over
  32-column tiles, with the rows kernel's fold through sums of 64-segment
  groups). The reference has no TPU kernel here: it runs
  ``repro/kernels/ref.py::leaf_spmm_nnz``, a ``segment_sum``.

A wrapper runs the plain version only when its inputs lie on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import formats as fmt
from . import ref, spmv
from ._build import check_launch, library, on_cpu

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # pos, crd, vals, C, head, tail, group, Y, P, R, N, K, J, stream
    "spmm_csr_rows": (_P,) * 8 + (_I, _I, _L, _I, _I, _P),
    # rows, cols, vals, C, head, tail, group, Y, P, N, K, J, max_rows, stream
    "spmm_coo_nnz": (_P,) * 8 + (_I, _L, _I, _I, _I, _P),
}
SEGMENT = 256       # entries per segment, kSeg in csrc/spmm.cu
GROUP = 64          # chunks or segments per group sum, kGroup in csrc/spmm.cu


def supports(format: "fmt.Format", space: str) -> bool:
    """Same capability contract as the SpMV family (the sparse operand is
    iterated the same way; only the dense operand changes)."""
    return fmt.supports_2d_default(format, space)


def spmm_csr_rows_plain(pos, crd, vals, C):
    return torch.stack([ref.leaf_spmm_rows(pos[p], crd[p], vals[p], C)
                        for p in range(pos.shape[0])])


def spmm_csr_rows(pos: torch.Tensor, crd: torch.Tensor, vals: torch.Tensor,
                  C: torch.Tensor) -> torch.Tensor:
    """Y (P, R, J): Y[p, r] = Σ vals[p, e]·C[crd[p, e]] over e in
    [pos[p, r], pos[p, r+1]). ``pos`` (P, R+1) holds piece-local offsets
    into ``crd`` and ``vals`` (P, N); ``C`` is (K, J) row-major."""
    if pos.dim() != 2 or crd.dim() != 2 or crd.shape != vals.shape \
            or crd.shape[0] != pos.shape[0] or C.dim() != 2:
        raise ValueError(f"spmm_csr_rows: bad shapes pos {tuple(pos.shape)} "
                         f"crd {tuple(crd.shape)} vals {tuple(vals.shape)} "
                         f"C {tuple(C.shape)}")
    if on_cpu("spmm_csr_rows", {"pos": pos, "crd": crd},
              {"vals": vals, "C": C}):
        return spmm_csr_rows_plain(pos, crd, vals, C)
    P, R, N = pos.shape[0], pos.shape[1] - 1, crd.shape[1]
    K, J = C.shape
    Y = torch.empty((P, R, J), dtype=torch.float32, device=pos.device)
    if P * R * J == 0 or K == 0:   # nothing to launch: no stored entry exists
        return Y.zero_()
    n_chunks = spmv.merge_chunks(R, N)
    head = torch.empty((P, n_chunks, J), dtype=torch.float32,
                       device=pos.device)
    tail = torch.empty_like(head)
    group = torch.empty((P, n_chunks // GROUP, J), dtype=torch.float32,
                        device=pos.device)
    with torch.cuda.device(pos.device):
        err = library("spmm", _SIGNATURES).spmm_csr_rows(
            pos.data_ptr(), crd.data_ptr(), vals.data_ptr(), C.data_ptr(),
            head.data_ptr(), tail.data_ptr(), group.data_ptr(), Y.data_ptr(),
            P, R, N, K, J, torch.cuda.current_stream().cuda_stream)
    check_launch("spmm_csr_rows", err)
    return Y


def spmm_coo_nnz_plain(rows, cols, vals, C, max_rows: int):
    return torch.stack([ref.leaf_spmm_nnz(rows[p], cols[p], vals[p], C,
                                          max_rows)
                        for p in range(rows.shape[0])])


def spmm_coo_nnz(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                 C: torch.Tensor, max_rows: int) -> torch.Tensor:
    """Y (P, max_rows, J): Y[p, r] = Σ vals[p, e]·C[cols[p, e]] over the
    entries of piece p with rows[p, e] == r, summed in a fixed order.
    ``rows`` (P, N) must be non-decreasing within each piece (the kernel's
    contract, as :func:`spmv_coo_nnz`'s); ids outside [0, max_rows) are
    dropped. ``C`` is (K, J) row-major."""
    if rows.dim() != 2 or cols.shape != rows.shape \
            or vals.shape != rows.shape or C.dim() != 2 \
            or rows.shape[1] >= 2**31:
        raise ValueError(f"spmm_coo_nnz: bad shapes rows {tuple(rows.shape)} "
                         f"cols {tuple(cols.shape)} vals {tuple(vals.shape)} "
                         f"C {tuple(C.shape)}")
    if on_cpu("spmm_coo_nnz", {"rows": rows, "cols": cols},
              {"vals": vals, "C": C}):
        return spmm_coo_nnz_plain(rows, cols, vals, C, max_rows)
    (P, N), (K, J) = rows.shape, C.shape
    Y = torch.empty((P, max_rows, J), dtype=torch.float32, device=rows.device)
    if P * max_rows * J == 0 or N == 0 or K == 0:
        return Y.zero_()       # nothing to launch: no entry is summed
    nseg = -(-N // SEGMENT)
    head = torch.empty((P, nseg, J), dtype=torch.float32, device=rows.device)
    tail = torch.empty_like(head)
    group = torch.empty((P, nseg // GROUP, J), dtype=torch.float32,
                        device=rows.device)
    with torch.cuda.device(rows.device):
        err = library("spmm", _SIGNATURES).spmm_coo_nnz(
            rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), C.data_ptr(),
            head.data_ptr(), tail.data_ptr(), group.data_ptr(), Y.data_ptr(),
            P, N, K, J, int(max_rows),
            torch.cuda.current_stream().cuda_stream)
    check_launch("spmm_coo_nnz", err)
    return Y
