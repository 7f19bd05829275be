"""SDDMM leaf ``A(i,j) = B(i,j) · C(i,k) · D(k,j)`` for both distribution
strategies.

One Hopper kernel (``csrc/sddmm.cu``) with its plain PyTorch version beside
it: :func:`sddmm_coo`, the sampled dense-dense product over per-piece
coordinate streams, batched over pieces. Replaces the TPU kernel
``repro/kernels/sddmm.py::sddmm_coo``. The rows strategy hands it each
piece's row block of C and the shard's rows expanded from ``pos1``; the nnz
strategy the global rows and one shared C. A wrapper runs the plain version
only when its inputs lie on the CPU; on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import formats as fmt
from . import ref
from ._build import check_launch, library, on_cpu

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # rows, cols, vals, C, Dt, out, P, N, n_c, c_stride, m, K, stream
    "sddmm_coo": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _L, _I, _I, _P),
}


def supports(format: "fmt.Format", space: str) -> bool:
    """Format-dispatch query of core.lower. SDDMM is pattern-preserving and
    its leaf works per stored position (per stored block for BCSR and BCSC,
    :mod:`.bcsr`), so any 2-D format the reference iterates directly works
    (CSC and BCSC through the transpose walk under rows, in storage order
    under nnz)."""
    return fmt.supports_2d_default(format, space)


def sddmm_coo_plain(rows, cols, vals, C, Dt):
    return torch.stack([
        ref.leaf_sddmm_nnz(rows[p], cols[p], vals[p],
                           C[p] if C.dim() == 3 else C, Dt.t())
        for p in range(rows.shape[0])])


def sddmm_coo(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
              C: torch.Tensor, Dt: torch.Tensor) -> torch.Tensor:
    """out (P, N): out[p, e] = vals[p, e]·Σ_k C[rows[p, e], k]·Dt[cols[p, e], k].
    ``C`` is (n, K), shared by every piece, or (P, n, K), one row block per
    piece; ``Dt`` is D transposed, (m, K). Indices are clamped into range
    (padded positions carry vals == 0). The kernel gathers 16 bytes a lane
    when K % 4 == 0 and C and Dt start on 16-byte boundaries, and takes
    its scalar path otherwise (a view may start anywhere)."""
    if rows.dim() != 2 or cols.shape != rows.shape \
            or vals.shape != rows.shape or C.dim() not in (2, 3) \
            or (C.dim() == 3 and C.shape[0] != rows.shape[0]) \
            or Dt.dim() != 2 or Dt.shape[1] != C.shape[-1]:
        raise ValueError(f"sddmm_coo: bad shapes rows {tuple(rows.shape)} "
                         f"cols {tuple(cols.shape)} vals {tuple(vals.shape)} "
                         f"C {tuple(C.shape)} Dt {tuple(Dt.shape)}")
    if on_cpu("sddmm_coo", {"rows": rows, "cols": cols},
              {"vals": vals, "C": C, "Dt": Dt}):
        return sddmm_coo_plain(rows, cols, vals, C, Dt)
    P, N = rows.shape
    n_c, K = C.shape[-2], C.shape[-1]
    m = Dt.shape[0]
    out = torch.empty((P, N), dtype=torch.float32, device=rows.device)
    if P * N == 0 or n_c * K * m == 0:   # nothing to launch: no product
        return out.zero_()
    c_stride = n_c * K if C.dim() == 3 else 0
    with torch.cuda.device(rows.device):
        err = library("sddmm", _SIGNATURES).sddmm_coo(
            rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), C.data_ptr(),
            Dt.data_ptr(), out.data_ptr(), P, N, n_c, c_stride, m, K,
            torch.cuda.current_stream().cuda_stream)
    check_launch("sddmm_coo", err)
    return out
