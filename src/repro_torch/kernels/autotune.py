"""Plan-level layout tuner: the reference's ELL group shape, scored on the
host.

The JAX package's Pallas kernels walk a blocked operand in groups of
``block_r`` block-rows by ``block_n`` stored entries (an ELL pack), and
the group shape trades alignment against padding waste. The tuner scores
candidate ``(block_r, block_n)`` pairs over the ACTUAL pos array (no
execution: a plan-time decision, like the partitioner's imbalance
metric):

    cost = padded_nnz · (1 + block_r / block_n)  subject to the budget,

where padded_nnz counts ELL slots and ``block_r / block_n`` the one-hot
rows of the reference's matmul reduction. Heavy-row matrices prefer
small row blocks, uniform ones larger blocks.

**What the tile means in the port.** No Hopper kernel takes a
``(block_R, block_nb)`` group: the port's kernels read the per-piece
CSR/COO shards directly, with their own fixed segment and warp shapes
(ROADMAP: the ELL packs are a TPU workaround, not ported). The tuned tile
rides on ``SchedulePoint.tile`` and ``Strategy.tile`` as plan provenance
and as part of the autoscheduler's plan key, and
``core.lower.rebuild_schedule`` carries it across a re-plan; nothing
launches with it. The one budget is the group's working set (index and
value slots, the one-hot tile, the output block) against ``SMEM_BYTES``,
the H100's opt-in shared memory per thread block (227 KiB), in place of
the reference's 16 MiB of TPU VMEM.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

SMEM_BYTES = 232448              # H100: opt-in shared memory per block
DEFAULT_BLOCK_R = (4, 8, 16, 32)
DEFAULT_BLOCK_N = (128, 256, 512)
# Candidate groups for the block-row-group (BCSR) layout, where one
# stored entry is a whole (br, bc) tile rather than a scalar.
DEFAULT_BLOCK_GRID_R = (2, 4, 8, 16)
DEFAULT_BLOCK_GRID_N = (8, 16, 32)


@dataclasses.dataclass
class TuneResult:
    block_r: int
    block_n: int
    padded_nnz: int
    waste: float
    cost: float
    feasible: bool
    # True when no candidate fit the budget and the smallest tile was
    # returned anyway: callers (the planner) skip the point's tile.
    fallback: bool = False


def ell_cost(pos: np.ndarray, block_r: int, block_n: int,
             dense_cols_bytes: int = 0, *, tile_elems: int = 1,
             smem_bytes: int = SMEM_BYTES) -> TuneResult:
    """Cost of one (block_r, block_n) ELL layout for a CSR pos array.

    ``tile_elems`` scales the per-entry value footprint for blocked
    layouts, where each stored entry is a dense (br, bc) tile instead of
    one scalar."""
    pos = np.asarray(pos, dtype=np.int64)
    n_rows = pos.shape[0] - 1
    nnz = int(pos[-1])
    n_rb = max(-(-n_rows // block_r), 1)
    bpos = pos[np.minimum(np.arange(n_rb + 1) * block_r, n_rows)]
    bcounts = np.diff(bpos)
    bnnz = int(bcounts.max()) if bcounts.size else 0
    bnnz = max(-(-bnnz // block_n) * block_n, block_n)
    padded = n_rb * bnnz
    waste = 0.0 if padded == 0 else 1.0 - nnz / padded
    # working set: rows/crd slots + value tiles + one-hot tile + output
    footprint = 2 * block_n * 4 + block_n * 4 * tile_elems \
        + block_r * block_n * 4 + block_r * 4 * tile_elems \
        + dense_cols_bytes
    onehot_overhead = block_r / block_n
    cost = padded * (1.0 + onehot_overhead)
    return TuneResult(block_r, block_n, padded, waste, cost,
                      feasible=footprint <= smem_bytes)


def tune_ell(pos: np.ndarray, *,
             block_r_candidates: Sequence[int] = DEFAULT_BLOCK_R,
             block_n_candidates: Sequence[int] = DEFAULT_BLOCK_N,
             dense_cols_bytes: int = 0, tile_elems: int = 1,
             smem_bytes: int = SMEM_BYTES) -> TuneResult:
    """Pick the cheapest feasible (block_r, block_n) for this matrix.

    When no candidate fits the budget the smallest tile is still
    returned, so callers always get a layout, but the fallback is
    explicit: the result carries ``feasible=False, fallback=True`` and a
    warning is logged."""
    best: Optional[TuneResult] = None
    for br in block_r_candidates:
        for bn in block_n_candidates:
            r = ell_cost(pos, br, bn, dense_cols_bytes,
                         tile_elems=tile_elems, smem_bytes=smem_bytes)
            if not r.feasible:
                continue
            if best is None or r.cost < best.cost:
                best = r
    if best is None:  # fall back to the smallest tile, explicitly
        best = ell_cost(pos, min(block_r_candidates),
                        min(block_n_candidates), dense_cols_bytes,
                        tile_elems=tile_elems, smem_bytes=smem_bytes)
        best.fallback = True
        log.warning(
            "tune_ell: no (block_r, block_n) candidate fits shared memory "
            "(%d bytes); falling back to smallest tile (%d, %d) with "
            "feasible=False", smem_bytes, best.block_r, best.block_n)
    return best


def tune_block_ell(pos: np.ndarray, block_shape: Tuple[int, int], *,
                   block_r_candidates: Sequence[int] = DEFAULT_BLOCK_GRID_R,
                   block_n_candidates: Sequence[int] = DEFAULT_BLOCK_GRID_N,
                   dense_cols_bytes: int = 0,
                   smem_bytes: int = SMEM_BYTES) -> TuneResult:
    """Tune the (block_R, block_nb) group shape for a blocked-CSR operand
    whose ``pos`` indexes the block grid and whose entries are dense
    ``block_shape`` tiles."""
    br, bc = block_shape
    return tune_ell(pos, block_r_candidates=block_r_candidates,
                    block_n_candidates=block_n_candidates,
                    dense_cols_bytes=dense_cols_bytes,
                    tile_elems=int(br) * int(bc), smem_bytes=smem_bytes)


def heavy_row_split(pos: np.ndarray, crd: np.ndarray, vals: np.ndarray,
                    threshold_factor: float = 8.0):
    """Split heavy rows into a COO overflow lane: every row keeps at most
    ``cap = ceil(threshold_factor · mean_degree)`` entries in the ELL
    part; the overflow beyond that cap goes to a sorted COO list.

    Returns ((pos', crd', vals'), (rows_t, cols_t, vals_t)): the capped
    CSR and the COO tail. The two results combine by addition."""
    pos = np.asarray(pos, dtype=np.int64)
    deg = np.diff(pos)
    n = deg.shape[0]
    mean = max(deg.mean(), 1.0)
    cap = int(max(np.ceil(threshold_factor * mean), 1))
    keep_counts = np.minimum(deg, cap)
    new_pos = np.zeros(n + 1, np.int64)
    np.cumsum(keep_counts, out=new_pos[1:])
    new_crd = np.zeros(int(new_pos[-1]), crd.dtype)
    new_vals = np.zeros(int(new_pos[-1]), vals.dtype)
    t_rows, t_cols, t_vals = [], [], []
    for r in range(n):
        lo, hi = int(pos[r]), int(pos[r + 1])
        k = int(keep_counts[r])
        new_crd[new_pos[r]: new_pos[r] + k] = crd[lo: lo + k]
        new_vals[new_pos[r]: new_pos[r] + k] = vals[lo: lo + k]
        if hi - lo > k:
            t_rows.append(np.full(hi - lo - k, r, np.int32))
            t_cols.append(crd[lo + k: hi])
            t_vals.append(vals[lo + k: hi])
    if t_rows:
        tail = (np.concatenate(t_rows), np.concatenate(t_cols),
                np.concatenate(t_vals))
    else:
        tail = (np.zeros(0, np.int32), np.zeros(0, crd.dtype),
                np.zeros(0, vals.dtype))
    return (new_pos.astype(np.int32), new_crd, new_vals), tail
