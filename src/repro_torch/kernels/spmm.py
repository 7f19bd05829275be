"""SpMM leaf ``A(i,j) = B(i,k) · C(k,j)`` for the rows strategy.

One Hopper kernel (``csrc/spmm.cu``) with its plain PyTorch version beside
it: :func:`spmm_csr_rows` over CSR row shards, batched over pieces.
Replaces the TPU kernel ``repro/kernels/spmm.py::spmm_ell``. A wrapper runs
the plain version only when its inputs lie on the CPU; on a CUDA tensor it
launches the kernel or raises.

The nnz strategy's leaf, ``ref.leaf_spmm_nnz``, has no TPU kernel in the
reference and runs as plain PyTorch here too.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import formats as fmt
from . import ref
from ._build import check_launch, library, on_cpu

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # pos, crd, vals, C, Y, P, R, N, K, J, stream
    "spmm_csr_rows": (_P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _P),
}


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
    with torch.cuda.device(pos.device):
        err = library("spmm", _SIGNATURES).spmm_csr_rows(
            pos.data_ptr(), crd.data_ptr(), vals.data_ptr(), C.data_ptr(),
            Y.data_ptr(), P, R, N, K, J,
            torch.cuda.current_stream().cuda_stream)
    check_launch("spmm_csr_rows", err)
    return Y
