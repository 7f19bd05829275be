"""Dense-operand packing for the blocked leaves.

Reshape unblocked co-operands into blocks aligned with a blocked sparse
operand's (br, bc) grid: host-side, lower-time work in numpy, as in the JAX
package's ``kernels/layout.py``. Only the four packers the blocked emitters
call are here; the TPU's row-block ELL and padded-COO packs are not needed
by the Hopper kernels, which read the emitters' shards as they are.
"""
from __future__ import annotations

import numpy as np


def pack_vec_blocks(c: np.ndarray, grid_cols: int, bc: int) -> np.ndarray:
    """Dense vector (m,) -> column blocks (grid_cols, bc), zero-padded."""
    c = np.asarray(c)
    out = np.zeros((grid_cols * bc,), dtype=c.dtype)
    out[: c.shape[0]] = c
    return out.reshape(grid_cols, bc)


def pack_mat_row_blocks(C: np.ndarray, grid: int, b: int) -> np.ndarray:
    """Dense matrix (n, K) -> leading-dim blocks (grid, b, K), zero-padded."""
    C = np.asarray(C)
    out = np.zeros((grid * b, C.shape[1]), dtype=C.dtype)
    out[: C.shape[0]] = C
    return out.reshape(grid, b, C.shape[1])


def pack_rowwindow_blocks(Cv: np.ndarray, max_brows: int, b: int,
                          ) -> np.ndarray:
    """Per-color dense row windows (P, max_rows, K) -> block-grid row blocks
    (P, max_brows, b, K), zero-padding rows past each window (the local C
    operand of the blocked row-based SDDMM)."""
    Cv = np.asarray(Cv)
    pad = max_brows * b - Cv.shape[1]
    Cv = np.pad(Cv, ((0, 0), (0, max(pad, 0)), (0, 0)))[:, : max_brows * b]
    return Cv.reshape(Cv.shape[0], max_brows, b, Cv.shape[2])


def pack_mat_inner_blocks(D: np.ndarray, grid: int, b: int) -> np.ndarray:
    """Dense matrix (K, m) -> trailing-dim blocks (grid, K, b): the column
    blocks an SDDMM leaf gathers by block-column."""
    D = np.asarray(D)
    out = np.zeros((D.shape[0], grid * b), dtype=D.dtype)
    out[:, : D.shape[1]] = D
    return np.ascontiguousarray(
        out.reshape(D.shape[0], grid, b).transpose(1, 0, 2))
