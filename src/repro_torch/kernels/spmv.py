"""SpMV leaves ``a(i) = B(i,j) · c(j)`` for both distribution strategies.

Two Hopper kernels (``csrc/spmv.cu``), each with its plain PyTorch version
beside it:

- :func:`spmv_csr_rows`, the rows (universe) leaf over CSR row shards,
  split by merge path (row ends and entries cut into equal chunks, so no
  row sets the time) and folded in a fixed order. Replaces the TPU kernel
  ``repro/kernels/spmv.py::spmv_ell``.
- :func:`spmv_coo_nnz`, the nnz (position-space) leaf over row-sorted COO
  shards, a deterministic two-phase segmented reduction: fixed blocks of
  entries write the row runs inside them, and only the runs that cross a
  block edge are folded in a second phase. Replaces
  ``repro/kernels/spmv.py::spmv_coo_phase1`` and the ``segment_sum`` merge
  of ``repro/kernels/ops.py::spmv_nnz``.

Both take the lowered path's stacked per-piece shards, batched over the
piece axis. A wrapper runs the plain version only when its inputs lie on
the CPU; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import formats as fmt
from . import ref
from ._build import check_launch, library, on_cpu

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # pos, crd, vals, c, head, tail, y, P, R, N, m, stream
    "spmv_csr_rows": (_P,) * 7 + (_I, _I, _L, _I, _P),
    # rows, cols, vals, c, head, tail, y, P, N, m, max_rows, stream
    "spmv_coo_nnz": (_P,) * 7 + (_I, _L, _I, _I, _P),
}
ITEMS = 256         # merge items per chunk, kItems in csrc/merge_rows.cuh
NNZ_BLOCK = 1024    # entries per nnz phase-1 block, kNnzBlock in csrc/spmv.cu


def merge_chunks(R: int, N: int) -> int:
    """Chunks of the rows kernels' merge-path split of a piece with R rows
    and at most N entries: the size of their head / tail scratch."""
    return -(-(R + N) // ITEMS)


def supports(format: "fmt.Format", space: str) -> bool:
    """Format-dispatch query of core.lower: the 2-D formats the reference's
    SpMV family iterates directly. Blocked operands (BCSR, BCSC) go to the
    blocked leaves of :mod:`.bcsr`."""
    return fmt.supports_2d_default(format, space)


def spmv_csr_rows_plain(pos, crd, vals, c):
    return torch.stack([ref.leaf_spmv_rows(pos[p], crd[p], vals[p], c)
                        for p in range(pos.shape[0])])


def spmv_csr_rows(pos: torch.Tensor, crd: torch.Tensor, vals: torch.Tensor,
                  c: torch.Tensor) -> torch.Tensor:
    """y (P, R): y[p, r] = Σ vals[p, e]·c[crd[p, e]] over e in
    [pos[p, r], pos[p, r+1]). ``pos`` (P, R+1) holds piece-local offsets
    into ``crd`` and ``vals`` (P, N); ``c`` is (m,)."""
    if pos.dim() != 2 or crd.dim() != 2 or crd.shape != vals.shape \
            or crd.shape[0] != pos.shape[0] or c.dim() != 1:
        raise ValueError(f"spmv_csr_rows: bad shapes pos {tuple(pos.shape)} "
                         f"crd {tuple(crd.shape)} vals {tuple(vals.shape)} "
                         f"c {tuple(c.shape)}")
    if on_cpu("spmv_csr_rows", {"pos": pos, "crd": crd},
              {"vals": vals, "c": c}):
        return spmv_csr_rows_plain(pos, crd, vals, c)
    P, R, N, m = pos.shape[0], pos.shape[1] - 1, crd.shape[1], c.shape[0]
    y = torch.empty((P, R), dtype=torch.float32, device=pos.device)
    if P * R == 0 or m == 0:       # nothing to launch: no stored entry exists
        return y.zero_()
    head = torch.empty((P, merge_chunks(R, N)), dtype=torch.float32,
                       device=pos.device)
    tail = torch.empty_like(head)
    with torch.cuda.device(pos.device):
        err = library("spmv", _SIGNATURES).spmv_csr_rows(
            pos.data_ptr(), crd.data_ptr(), vals.data_ptr(), c.data_ptr(),
            head.data_ptr(), tail.data_ptr(), y.data_ptr(), P, R, N, m,
            torch.cuda.current_stream().cuda_stream)
    check_launch("spmv_csr_rows", err)
    return y


def spmv_coo_nnz_plain(rows, cols, vals, c, max_rows: int):
    return torch.stack([ref.leaf_spmv_nnz(rows[p], cols[p], vals[p], c,
                                          max_rows)
                        for p in range(rows.shape[0])])


def spmv_coo_nnz(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                 c: torch.Tensor, max_rows: int) -> torch.Tensor:
    """y (P, max_rows): y[p, r] = Σ vals[p, e]·c[cols[p, e]] over the
    entries of piece p with rows[p, e] == r. ``rows`` (P, N) must be
    non-decreasing within each piece (the kernel's contract, as the TPU
    kernel's); ids outside [0, max_rows) are dropped."""
    if rows.dim() != 2 or cols.shape != rows.shape \
            or vals.shape != rows.shape or c.dim() != 1 \
            or rows.shape[1] >= 2**31:
        raise ValueError(f"spmv_coo_nnz: bad shapes rows {tuple(rows.shape)} "
                         f"cols {tuple(cols.shape)} vals {tuple(vals.shape)} "
                         f"c {tuple(c.shape)}")
    if on_cpu("spmv_coo_nnz", {"rows": rows, "cols": cols},
              {"vals": vals, "c": c}):
        return spmv_coo_nnz_plain(rows, cols, vals, c, max_rows)
    P, N, m = rows.shape[0], rows.shape[1], c.shape[0]
    y = torch.empty((P, max_rows), dtype=torch.float32, device=rows.device)
    if P * max_rows == 0 or N == 0 or m == 0:
        return y.zero_()
    head = torch.empty((P, -(-N // NNZ_BLOCK)), dtype=torch.float32,
                       device=rows.device)
    tail = torch.empty_like(head)
    with torch.cuda.device(rows.device):
        err = library("spmv", _SIGNATURES).spmv_coo_nnz(
            rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), c.data_ptr(),
            head.data_ptr(), tail.data_ptr(), y.data_ptr(),
            P, N, m, int(max_rows),
            torch.cuda.current_stream().cuda_stream)
    check_launch("spmv_coo_nnz", err)
    return y
