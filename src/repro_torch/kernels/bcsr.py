"""Blocked (BCSR, BCSC) leaves of SpMV, SpMM and SDDMM for both distribution
strategies.

Three Hopper kernels (``csrc/bcsr.cu``), each with its plain PyTorch version
beside it, over the lowered path's stacked per-piece streams of stored
blocks: a block-row id, a block-column and a (br, bc) tile per slot.

- :func:`bcsr_spmv` replaces the TPU kernel ``repro/kernels/bcsr.py::
  bcsr_spmv`` and :func:`bcsr_spmm` ``repro/kernels/bcsr.py::bcsr_spmm``:
  block-row sums of the tile products, cut into fixed 128-block segments
  and folded in a fixed order (``csrc/segment_fold.cuh``, through sums of
  64 segments), so a block-row of any length is spread over many warps.
- :func:`bcsr_sddmm` replaces ``repro/kernels/bcsr.py::bcsr_sddmm``: each
  stored tile times the (br, bc) block of C·D it samples.

The rows strategy expands the shard's ``pos`` into block-row ids once at
lower time; the nnz strategy rebases and clips its block-rows. A wrapper
runs the plain version only when its inputs lie on the CPU; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from ._build import check_launch, library, on_cpu

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # brow, bcol, tiles, c, head, tail, group, y, P, N, br, bc, grid_cols,
    # R, stream
    "bcsr_spmv": (_P,) * 8 + (_I, _L, _I, _I, _I, _I, _P),
    # brow, bcol, tiles, C, head, tail, group, Y, P, N, br, bc, grid_cols,
    # J, R, stream
    "bcsr_spmm": (_P,) * 8 + (_I, _L, _I, _I, _I, _I, _I, _P),
    # brow, bcol, tiles, C, Dt, out, P, N, br, bc, n_c, c_stride, m, K,
    # stream
    "bcsr_sddmm": (_P,) * 6 + (_I, _L, _I, _I, _I, _L, _I, _I, _P),
}
SEGMENT = 128       # stored blocks per segment, kSeg in csrc/bcsr.cu
GROUP = 64          # segments per group sum, kGroup in csrc/segment_fold.cuh


def _stream(name, brow, bcol, tiles, **dense):
    """Check a (brow, bcol, tiles) stream and its dense operands; True when
    all lie on the CPU. Every kernel takes any block shape."""
    if brow.dim() != 2 or bcol.shape != brow.shape or tiles.dim() != 4 \
            or tiles.shape[:2] != brow.shape:
        raise ValueError(f"{name}: bad shapes brow {tuple(brow.shape)} "
                         f"bcol {tuple(bcol.shape)} tiles "
                         f"{tuple(tiles.shape)}")
    return on_cpu(name, {"brow": brow, "bcol": bcol},
                  {"tiles": tiles, **dense})


def _scratch(P, N, width, device):
    """The fold's f32 scratch, views of one allocation: head and tail
    (P, nseg, *width) partials of the 128-block segments and group
    (P, nseg // 64, *width) sums."""
    nseg = -(-N // SEGMENT)
    w = int(torch.Size(width).numel())
    flat = torch.empty(P * (2 * nseg + nseg // GROUP) * w,
                       dtype=torch.float32, device=device)
    head, tail, group = flat.split([P * nseg * w, P * nseg * w,
                                    P * (nseg // GROUP) * w])
    return (head.view((P, nseg) + width), tail.view((P, nseg) + width),
            group.view((P, nseg // GROUP) + width))


def bcsr_spmv_plain(brow, bcol, tiles, c_blk, max_brows: int):
    return torch.stack([ref.leaf_bcsr_spmv_nnz(brow[p], bcol[p], tiles[p],
                                               c_blk, max_brows)
                        for p in range(brow.shape[0])])


def bcsr_spmv(brow: torch.Tensor, bcol: torch.Tensor, tiles: torch.Tensor,
              c_blk: torch.Tensor, max_brows: int) -> torch.Tensor:
    """y (P, max_brows·br): y[p, b·br + r] =
    Σ_e tiles[p, e, r]·c_blk[bcol[p, e]] over the stored blocks e of piece
    p with brow[p, e] == b. ``c_blk`` is the vector in column blocks,
    (grid_cols, bc). ``brow`` must be non-decreasing within each piece
    (the kernel's contract); ids outside [0, max_brows) are dropped. The
    (4, 4) block with tile and c bases on 16-byte boundaries takes its own
    instance, any other the generic one; they sum a block-row's products
    in different orders, each fixed by the stream alone."""
    if c_blk.dim() != 2 or c_blk.shape[1] != tiles.shape[-1]:
        raise ValueError(f"bcsr_spmv: c_blk {tuple(c_blk.shape)} is not "
                         f"(grid_cols, {tiles.shape[-1]})")
    if _stream("bcsr_spmv", brow, bcol, tiles, c_blk=c_blk):
        return bcsr_spmv_plain(brow, bcol, tiles, c_blk, max_brows)
    (P, N, br, bc), grid_cols = tiles.shape, c_blk.shape[0]
    y = torch.zeros((P, max_brows * br), dtype=torch.float32,
                    device=brow.device)
    if y.numel() == 0 or N == 0 or grid_cols == 0:
        return y                       # nothing to launch: no stored block
    head, tail, group = _scratch(P, N, (br,), y.device)
    with torch.cuda.device(y.device):
        err = library("bcsr", _SIGNATURES).bcsr_spmv(
            brow.data_ptr(), bcol.data_ptr(), tiles.data_ptr(),
            c_blk.data_ptr(), head.data_ptr(), tail.data_ptr(),
            group.data_ptr(), y.data_ptr(), P, N, br, bc, grid_cols,
            int(max_brows),
            torch.cuda.current_stream().cuda_stream)
    check_launch("bcsr_spmv", err)
    return y


def bcsr_spmm_plain(brow, bcol, tiles, C_blk, max_brows: int):
    return torch.stack([ref.leaf_bcsr_spmm_nnz(brow[p], bcol[p], tiles[p],
                                               C_blk, max_brows)
                        for p in range(brow.shape[0])])


def bcsr_spmm(brow: torch.Tensor, bcol: torch.Tensor, tiles: torch.Tensor,
              C_blk: torch.Tensor, max_brows: int) -> torch.Tensor:
    """Y (P, max_brows·br, J): block-row b of piece p is
    Σ_e tiles[p, e] @ C_blk[bcol[p, e]] over its stored blocks e.
    ``C_blk`` is the dense operand in row blocks, (grid_cols, bc, J). The
    contract on ``brow`` is :func:`bcsr_spmv`'s. The kernel's result does
    not depend on its instance (templated on the block, or generic for
    other blocks and for tiles off a 16-byte boundary): the same adds in
    the same order."""
    if C_blk.dim() != 3 or C_blk.shape[1] != tiles.shape[-1]:
        raise ValueError(f"bcsr_spmm: C_blk {tuple(C_blk.shape)} is not "
                         f"(grid_cols, {tiles.shape[-1]}, J)")
    if _stream("bcsr_spmm", brow, bcol, tiles, C_blk=C_blk):
        return bcsr_spmm_plain(brow, bcol, tiles, C_blk, max_brows)
    (P, N, br, bc), (grid_cols, _, J) = tiles.shape, C_blk.shape
    Y = torch.zeros((P, max_brows * br, J), dtype=torch.float32,
                    device=brow.device)
    if Y.numel() == 0 or N == 0 or grid_cols == 0:
        return Y                       # nothing to launch: no stored block
    head, tail, group = _scratch(P, N, (br, J), Y.device)
    with torch.cuda.device(Y.device):
        err = library("bcsr", _SIGNATURES).bcsr_spmm(
            brow.data_ptr(), bcol.data_ptr(), tiles.data_ptr(),
            C_blk.data_ptr(), head.data_ptr(), tail.data_ptr(),
            group.data_ptr(), Y.data_ptr(), P, N, br, bc, grid_cols, J,
            int(max_brows),
            torch.cuda.current_stream().cuda_stream)
    check_launch("bcsr_spmm", err)
    return Y


def bcsr_sddmm_plain(brow, bcol, tiles, C, Dt):
    br, bc = tiles.shape[2], tiles.shape[3]
    K = Dt.shape[1]
    C_blk = C.reshape(C.shape[:-2] + (-1, br, K))
    D_blk = Dt.reshape(-1, bc, K).transpose(1, 2)
    return torch.stack([
        ref.leaf_bcsr_sddmm(brow[p], bcol[p], tiles[p],
                            C_blk[p] if C.dim() == 3 else C_blk, D_blk)
        for p in range(brow.shape[0])])


def bcsr_sddmm(brow: torch.Tensor, bcol: torch.Tensor, tiles: torch.Tensor,
               C: torch.Tensor, Dt: torch.Tensor) -> torch.Tensor:
    """out (P, N, br, bc): out[p, e] = tiles[p, e] ⊙ (C rows of block-row
    brow[p, e]) @ (D columns of block-column bcol[p, e]). ``C`` is (n_c, K),
    shared by every piece, or (P, n_c, K), one row window per piece, in
    whole block-rows (n_c a multiple of br); ``Dt`` is D transposed,
    (m, K), in whole block-columns. Ids are clamped into range (padding
    slots hold zero tiles)."""
    if C.dim() not in (2, 3) \
            or (C.dim() == 3 and C.shape[0] != brow.shape[0]) \
            or Dt.dim() != 2 or Dt.shape[1] != C.shape[-1] \
            or tiles.dim() != 4 or C.shape[-2] % tiles.shape[2] \
            or Dt.shape[0] % tiles.shape[3]:
        raise ValueError(f"bcsr_sddmm: bad shapes C {tuple(C.shape)} "
                         f"Dt {tuple(Dt.shape)} for tiles "
                         f"{tuple(tiles.shape)}")
    if _stream("bcsr_sddmm", brow, bcol, tiles, C=C, Dt=Dt):
        return bcsr_sddmm_plain(brow, bcol, tiles, C, Dt)
    P, N, br, bc = tiles.shape
    n_c, K = C.shape[-2], C.shape[-1]
    m = Dt.shape[0]
    out = torch.empty_like(tiles)
    if out.numel() == 0 or n_c * K * m == 0:   # nothing to launch: no product
        return out.zero_()
    c_stride = n_c * K if C.dim() == 3 else 0
    with torch.cuda.device(out.device):
        err = library("bcsr", _SIGNATURES).bcsr_sddmm(
            brow.data_ptr(), bcol.data_ptr(), tiles.data_ptr(), C.data_ptr(),
            Dt.data_ptr(), out.data_ptr(), P, N, br, bc, n_c, c_stride, m, K,
            torch.cuda.current_stream().cuda_stream)
    check_launch("bcsr_sddmm", err)
    return out
