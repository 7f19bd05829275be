"""Dependent partitioning for sparse coordinate trees (paper §III-A, §IV).

The reference's partitioner, ported as it is (host-side numpy): per-color ``(lo, hi)`` interval bounds for every level of
every tensor's coordinate tree, computed at plan time, then *materialized*
into statically-shaped, padded per-shard arrays that the lowered leaves
consume batched over pieces.

The level functions mirror paper Table I exactly:

- ``partition_by_bounds``        — Dense init (universe or nnz split)
- ``partition_by_value_ranges``  — Compressed universe init (bucket crd)
- ``image(pos, P_pos)``          — Compressed ``partitionFromParent``
- ``preimage(pos, P_crd)``       — Compressed ``partitionFromChild``

Blocked (BCSR/BCSC) tensors partition at block-row granularity (rows) or
over their stored blocks (nnz); the SpAdd nnz strategy splits the
concatenated entry stream of its addends (``materialize_add_stream``).
Machine grids (``core/grid.py``) take cross-product tiles, order-3 bricks
and dense row, column or tile windows (``partition_tensor_grid``,
``partition_tensor_grid3``, ``partition_tensor_cols`` and the
``materialize_*_grid`` / ``materialize_dense_cols`` materializers). The
elastic path (``materialize_pieces``, ``materialize_dense_rows_pieces``,
``materialize_replicated_elastic``) caches one shard entry per color, so a
re-plan onto a resized machine (``elastic_row_bounds``) re-packs only the
windows the resize changed.
"""

import contextlib
import dataclasses
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import formats as fmt
from ..runtime import telemetry
from .cache import LRUCache
from .tensor import Tensor, INT

Bounds = np.ndarray  # (P, 2) int64, [lo, hi) per color


# ---------------------------------------------------------------------------
# Initial level partitions (paper: init/create/finalize *Partition entries)
# ---------------------------------------------------------------------------

def partition_by_bounds(n: int, pieces: int) -> Bounds:
    """Equal split of ``[0, n)`` into ``pieces`` colors (universe partition).

    Matches the paper's generated code: ``iLo = io * (dim / pieces)`` with
    ceil-div chunks so all elements are covered.
    """
    chunk = -(-n // pieces) if pieces else n
    lo = np.minimum(np.arange(pieces, dtype=np.int64) * chunk, n)
    hi = np.minimum(lo + chunk, n)
    return np.stack([lo, hi], axis=1)


def partition_nonzeros(nnz: int, pieces: int,
                       weights: Optional[np.ndarray] = None) -> Bounds:
    """Split of the position space ``[0, nnz)`` — the tilde operator.

    ``weights`` (pieces,) generalizes the equal split to heterogeneous
    shard speeds: shard p receives ~weights[p]/Σw of the non-zeros. This is
    the straggler-mitigation path (runtime/fault.StragglerMitigator emits
    the weights; re-lowering with them is the re-plan)."""
    if weights is None:
        return partition_by_bounds(nnz, pieces)
    w = np.asarray(weights, dtype=np.float64)
    assert w.shape == (pieces,) and (w > 0).all()
    ends = np.floor(np.cumsum(w / w.sum()) * nnz).astype(np.int64)
    ends[-1] = nnz
    starts = np.concatenate([[0], ends[:-1]])
    return np.stack([starts, ends], axis=1)


def partition_by_value_ranges(crd: np.ndarray, value_bounds: Bounds) -> Bounds:
    """Universe partition of a Compressed level: bucket sorted ``crd`` values
    into coordinate ranges (paper Table I, Compressed/universe).

    Requires globally sorted ``crd`` (true for root compressed levels such as
    a sparse vector or the fused level of COO).
    """
    lo = np.searchsorted(crd, value_bounds[:, 0], side="left")
    hi = np.searchsorted(crd, value_bounds[:, 1], side="left")
    return np.stack([lo, hi], axis=1).astype(np.int64)


# ---------------------------------------------------------------------------
# Dependent partitioning (paper §III-A; Table I derived partitions)
# ---------------------------------------------------------------------------

def image(pos: np.ndarray, parent_bounds: Bounds) -> Bounds:
    """``image(S, P_S, D)``: color crd positions pointed to by parent entries.

    For an interval partition of parent entries ``[lo, hi)``, the pointed-to
    crd positions are exactly ``[pos[lo], pos[hi])`` because ``pos`` is
    monotone — the contiguity that makes static materialization possible.
    """
    pos = np.asarray(pos, dtype=np.int64)
    return np.stack(
        [pos[parent_bounds[:, 0]], pos[parent_bounds[:, 1]]], axis=1
    )


def preimage(pos: np.ndarray, child_bounds: Bounds) -> Bounds:
    """``preimage(S, P_D, D)``: color parent entries whose pos-range
    intersects each child (position-space) interval ``[plo, phi)``.

    Returns possibly *overlapping* intervals — a parent entry straddling a
    boundary belongs to both colors (paper Fig. 6b). Empty child intervals
    produce empty parent intervals.
    """
    pos = np.asarray(pos, dtype=np.int64)
    plo, phi = child_bounds[:, 0], child_bounds[:, 1]
    # first parent whose end > plo ; first parent whose start >= phi
    lo = np.searchsorted(pos[1:], plo, side="right")
    hi = np.searchsorted(pos[:-1], phi, side="left")
    hi = np.maximum(hi, lo)  # empty intervals stay empty
    empty = plo >= phi
    lo = np.where(empty, 0, lo)
    hi = np.where(empty, 0, hi)
    return np.stack([lo, hi], axis=1)


# ---------------------------------------------------------------------------
# Full coordinate-tree partitions (paper §IV-A intuition + Fig. 9a)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LevelPartition:
    """Interval bounds for one level.

    ``coord_bounds``: bounds in the level's *coordinate* space (only
    meaningful for Dense levels / the root); ``pos_bounds``: bounds in the
    level's *position* space (crd/vals indices) for compressed levels.
    """

    coord_bounds: Optional[Bounds] = None
    pos_bounds: Optional[Bounds] = None
    replicated: bool = False


@dataclasses.dataclass
class TensorPartition:
    """A full coordinate-tree partition of one tensor (or replication)."""

    tensor: Tensor
    pieces: int
    levels: List[LevelPartition]
    replicated: bool = False
    # For nnz-partitions: bounds of the values/position space at the leaf.
    vals_bounds: Optional[Bounds] = None
    # Bounds over the *root coordinate space* (output-row ownership etc.).
    root_coord_bounds: Optional[Bounds] = None
    overlapping_root: bool = False  # preimage-derived roots may overlap
    # Grid shape when this is a multi-axis tile partition: (P, Q) colors
    # are row-major over the P×Q cross product of levels[0] row windows ×
    # levels[1] column windows; (P, Q, R) bricks extend the cross product
    # to levels[2] windows (core/grid.py). None for all 1-D partitions.
    grid: Optional[Tuple[int, ...]] = None
    # Transpose-walked universe partitions (column-major roots — CSC):
    # the row walk's permutation, walk position → storage position.
    # ``vals_bounds`` then index the WALK space; materializers permute the
    # value region through this and carry ``val_idx`` scatter maps so
    # pattern-preserving outputs land back in storage order. None for
    # ordered (storage-order) walks.
    walk_perm: Optional[np.ndarray] = None

    def max_counts(self) -> Dict[str, int]:
        out = {}
        if self.vals_bounds is not None:
            out["vals"] = int((self.vals_bounds[:, 1] - self.vals_bounds[:, 0]).max())
        if self.root_coord_bounds is not None:
            out["rows"] = int(
                (self.root_coord_bounds[:, 1] - self.root_coord_bounds[:, 0]).max()
            )
        return out

    def imbalance(self) -> float:
        """max/mean − 1 of per-color vals counts — the paper's load-balance
        story (§II-D): universe partitions of skewed tensors → large value;
        non-zero partitions → ~0."""
        if self.vals_bounds is None:
            return 0.0
        counts = (self.vals_bounds[:, 1] - self.vals_bounds[:, 0]).astype(np.float64)
        if counts.mean() == 0:
            return 0.0
        return float(counts.max() / counts.mean() - 1.0)


def _dense_prefix(tensor: Tensor) -> int:
    return sum(1 for lf in tensor.format.levels if not lf.compressed)


def block_aligned_row_bounds(n: int, pieces: int, block_rows: int) -> Bounds:
    """Equal universe split of ``[0, n)`` whose cut points land on block-row
    boundaries: split the block-row grid evenly, then scale back to rows
    (clipped to ``n`` for the boundary block). Row-partitioning a blocked
    tensor and its unblocked co-operands with these bounds keeps every
    color's row window identical across formats."""
    grid_rows = -(-n // block_rows)
    bb = partition_by_bounds(grid_rows, pieces)
    return np.minimum(bb * block_rows, n)


def partition_tensor_rows(tensor: Tensor, row_bounds: Bounds) -> TensorPartition:
    """Universe partition of the ROOT level by coordinate intervals, derived
    downward through the whole tree (paper: ``partitionFromParent`` chain).

    Works for any supported format. Rows = coordinates of storage level 0.
    A Dense root keys the chain directly (CSR/CSF); a Compressed root
    (DCSR/DCSF/COO) is bucketed with ``partition_by_value_ranges`` over its
    sorted ``crd`` first — paper Table I's Compressed/universe entry — and
    the image chain continues from the resulting position interval.
    Column-major roots (CSC) —
    where dimension 0 is NOT stored at the root — bucket the level tree's
    TRANSPOSE walk instead (core/levels.py): per-color contiguous
    intervals of the row-sorted enumeration, carried with the permutation
    back to storage positions. Blocked tensors partition at block-row
    granularity (see ``partition_tensor_block_rows``).
    """
    if tensor.format.is_blocked:
        if tensor.format.dim_of_level(0) != 0:
            return _partition_tensor_block_rows_walk(tensor, row_bounds)
        return partition_tensor_block_rows(tensor, row_bounds)
    if tensor.format.dim_of_level(0) != 0:
        return _partition_tensor_rows_walk(tensor, row_bounds)
    pieces = row_bounds.shape[0]
    levels: List[LevelPartition] = []
    order = tensor.order
    n_dense = _dense_prefix(tensor)

    if n_dense == 0:
        # Compressed (or COO fused) root: bucket stored row coords.
        root = tensor.levels[0]
        pos_bounds = partition_by_value_ranges(root.crd, row_bounds)
        levels.append(LevelPartition(coord_bounds=row_bounds.copy(),
                                     pos_bounds=pos_bounds.copy()))
        start_lvl = 1
    else:
        # Dense prefix: coordinate bounds multiply down (row-major position
        # math).
        levels.append(LevelPartition(coord_bounds=row_bounds.copy()))
        pos_bounds = row_bounds.astype(np.int64)
        for l in range(1, n_dense):
            size = tensor.levels[l].size
            pos_bounds = pos_bounds * size
            levels.append(
                LevelPartition(coord_bounds=None, pos_bounds=pos_bounds.copy()))
        start_lvl = n_dense
    # Compressed suffix: image through each pos array.
    for l in range(start_lvl, order):
        ld = tensor.levels[l]
        if ld.kind.singleton:
            levels.append(LevelPartition(pos_bounds=pos_bounds.copy()))
            continue
        pos_bounds = image(ld.pos, pos_bounds)
        levels.append(LevelPartition(pos_bounds=pos_bounds.copy()))
    if tensor.format.is_all_dense:
        # leaf position space = linearized dense positions
        for l in range(n_dense, order):  # pragma: no cover (n_dense == order)
            pass
        vb = row_bounds.astype(np.int64)
        for l in range(1, order):
            vb = vb * tensor.levels[l].size
        vals_bounds = vb
    else:
        vals_bounds = pos_bounds
    return TensorPartition(
        tensor=tensor,
        pieces=pieces,
        levels=levels,
        vals_bounds=vals_bounds,
        root_coord_bounds=row_bounds.copy(),
        overlapping_root=False,
    )


def partition_tensor_block_rows(tensor: Tensor, row_bounds: Bounds,
                                ) -> TensorPartition:
    """Universe partition of a blocked tensor at BLOCK-ROW granularity.

    The coordinate tree indexes the block grid, so a row interval realizes
    as a contiguous block-row interval: the given row bounds are snapped to
    block boundaries (identity when the caller used
    ``block_aligned_row_bounds``; unaligned cuts give the straddling block
    to the earlier color so windows stay disjoint), then the image chain
    derives the stored-block position interval exactly as for CSR.
    ``vals_bounds`` index the (n_blocks, br, bc) tile axis;
    ``root_coord_bounds`` stay in ROW space (clipped to the tensor edge) so
    output scatters are format-agnostic."""
    assert tensor.format.is_blocked and tensor.order == 2
    if _dense_prefix(tensor) != 1:
        raise ValueError(
            f"direct block partition needs a dense root: {tensor.format}")
    br = tensor.format.block_shape[0]
    n = tensor.shape[0]
    pieces = row_bounds.shape[0]
    blo = row_bounds[:, 0].astype(np.int64) // br
    bhi = -(-row_bounds[:, 1].astype(np.int64) // br)
    for p in range(1, pieces):          # disjoint block windows
        blo[p] = max(blo[p], bhi[p - 1])
        bhi[p] = max(bhi[p], blo[p])
    bb = np.stack([blo, bhi], axis=1)
    pos_bounds = image(tensor.levels[1].pos, bb)
    levels = [LevelPartition(coord_bounds=bb.copy()),
              LevelPartition(pos_bounds=pos_bounds.copy())]
    rows = np.minimum(bb * br, n)
    return TensorPartition(
        tensor=tensor, pieces=pieces, levels=levels,
        vals_bounds=pos_bounds, root_coord_bounds=rows,
        overlapping_root=False,
    )


def _partition_tensor_rows_walk(tensor: Tensor, row_bounds: Bounds,
                                ) -> TensorPartition:
    """Universe row partition of a COLUMN-MAJOR root (CSC) via the level
    tree's transpose walk: the stored entries are enumerated in
    dimension-lexicographic order (an argsort), so each row window maps to
    a contiguous interval of the WALK — bucketed with searchsorted exactly
    like a compressed root's sorted ``crd``. The walk permutation rides on
    the partition; materialization permutes values through it and keeps a
    ``val_idx`` map for pattern-preserving outputs."""
    pieces = row_bounds.shape[0]
    w = tensor.level_tree().row_walk()
    rows = w.coords[:, 0] if w.n else np.zeros((0,), np.int64)
    lo = np.searchsorted(rows, row_bounds[:, 0], side="left")
    hi = np.searchsorted(rows, row_bounds[:, 1], side="left")
    wb = np.stack([lo, hi], axis=1).astype(np.int64)
    levels = [LevelPartition(coord_bounds=row_bounds.astype(np.int64).copy(),
                             pos_bounds=wb.copy()),
              LevelPartition(pos_bounds=wb.copy())]
    return TensorPartition(
        tensor=tensor, pieces=pieces, levels=levels,
        vals_bounds=wb, root_coord_bounds=row_bounds.astype(np.int64).copy(),
        overlapping_root=False, walk_perm=w.perm,
    )


def _partition_tensor_block_rows_walk(tensor: Tensor, row_bounds: Bounds,
                                      ) -> TensorPartition:
    """Blocked transpose-walk universe partition (BCSC): the block-grid
    transpose walk sorted by (block-row, block-col) is bucketed into
    block-row windows; ``root_coord_bounds`` stay in ROW space (clipped to
    the tensor edge) so output scatters are format-agnostic, exactly as in
    ``partition_tensor_block_rows``."""
    assert tensor.format.is_blocked and tensor.order == 2
    if _dense_prefix(tensor) != 1:
        raise ValueError(
            f"direct block partition needs a dense root: {tensor.format}")
    br = tensor.format.block_shape[0]
    n = tensor.shape[0]
    pieces = row_bounds.shape[0]
    blo = row_bounds[:, 0].astype(np.int64) // br
    bhi = -(-row_bounds[:, 1].astype(np.int64) // br)
    for p in range(1, pieces):          # disjoint block windows
        blo[p] = max(blo[p], bhi[p - 1])
        bhi[p] = max(bhi[p], blo[p])
    bb = np.stack([blo, bhi], axis=1)
    w = tensor.level_tree().row_walk()
    brows = w.coords[:, 0] if w.n else np.zeros((0,), np.int64)
    lo = np.searchsorted(brows, bb[:, 0], side="left")
    hi = np.searchsorted(brows, bb[:, 1], side="left")
    wb = np.stack([lo, hi], axis=1).astype(np.int64)
    levels = [LevelPartition(coord_bounds=bb.copy(), pos_bounds=wb.copy()),
              LevelPartition(pos_bounds=wb.copy())]
    rows = np.minimum(bb * br, n)
    return TensorPartition(
        tensor=tensor, pieces=pieces, levels=levels,
        vals_bounds=wb, root_coord_bounds=rows,
        overlapping_root=False, walk_perm=w.perm,
    )


def partition_tensor_block_nonzeros(tensor: Tensor, pieces: int,
                                    weights: Optional[np.ndarray] = None,
                                    init_bounds: Optional[Bounds] = None,
                                    ) -> TensorPartition:
    """Non-zero partition of a blocked tensor: equal (or weighted) split of
    the STORED-BLOCK position space, root block-row ownership derived with
    preimage. The per-color payload is block-granular — each position moves
    a whole (br, bc) tile. Column-major grids (BCSC) derive the root
    windows in the root's OWN dimension (block-columns); leaves then
    reduce over the full output extent, the CSC story at block
    granularity."""
    assert tensor.format.is_blocked and tensor.order == 2
    if _dense_prefix(tensor) != 1:
        raise ValueError(
            f"direct block partition needs a dense root: {tensor.format}")
    root_dim = tensor.format.dim_of_level(0)
    b_root = tensor.format.block_shape[root_dim]
    n = tensor.shape[root_dim]
    n_blocks = tensor.levels[1].nnz or 0
    init = (partition_nonzeros(n_blocks, pieces, weights)
            if init_bounds is None
            else np.asarray(init_bounds, dtype=np.int64))
    up = preimage(tensor.levels[1].pos, init)       # root-level entry bounds
    levels = [LevelPartition(coord_bounds=up.copy()),
              LevelPartition(pos_bounds=init.copy())]
    rows = np.minimum(up * b_root, n)
    return TensorPartition(
        tensor=tensor, pieces=pieces, levels=levels,
        vals_bounds=init.astype(np.int64),
        root_coord_bounds=rows.astype(np.int64),
        overlapping_root=True,
    )


def partition_tensor_nonzeros(tensor: Tensor, pieces: int,
                              weights: Optional[np.ndarray] = None,
                              fused_levels: Optional[int] = None,
                              init_bounds: Optional[Bounds] = None,
                              ) -> TensorPartition:
    """Non-zero partition of the (fully or partially) fused coordinate tree.

    Default: split the leaf position space (vals) evenly, then derive
    upward with preimage (paper: coordinate fusion `xy→f` + tilde split,
    Fig. 5c / Fig. 8b). ``weights`` gives a heterogeneous split (straggler
    re-plan). ``fused_levels`` < order realizes PARTIAL fusion (paper
    Fig. 5's "non-zero tubes": T_xyz with xy→f splits the level-2 position
    space evenly, then derives the leaf via image and the root via
    preimage). Blocked tensors split their stored-block position space
    (``partition_tensor_block_nonzeros``). ``init_bounds`` overrides the
    equal/weighted split of the split-level position space with
    caller-supplied windows — the elastic resize path feeds merged
    survivor windows here so unaffected colors keep identical bounds."""
    if tensor.format.is_all_dense:
        raise ValueError("non-zero partition of a dense tensor — use rows")
    if tensor.format.is_blocked:
        return partition_tensor_block_nonzeros(tensor, pieces, weights,
                                               init_bounds=init_bounds)
    order = tensor.order
    n_dense = _dense_prefix(tensor)
    split_level = order - 1 if fused_levels is None else fused_levels - 1
    if not tensor.levels[split_level].kind.compressed:
        raise ValueError("partial fusion must end at a compressed level")
    n_at = (tensor.levels[split_level].nnz
            if tensor.levels[split_level].crd is not None else tensor.nnz)
    init_bounds = (partition_nonzeros(n_at, pieces, weights)
                   if init_bounds is None
                   else np.asarray(init_bounds, dtype=np.int64))
    levels: List[LevelPartition] = [LevelPartition() for _ in range(order)]
    # derive DOWNWARD from the split level to the leaf (image chain)
    down = init_bounds.astype(np.int64)
    levels[split_level] = LevelPartition(pos_bounds=down.copy())
    for l in range(split_level + 1, order):
        ld = tensor.levels[l]
        if ld.kind.singleton:
            levels[l] = LevelPartition(pos_bounds=down.copy())
            continue
        down = image(ld.pos, down)
        levels[l] = LevelPartition(pos_bounds=down.copy())
    vals_bounds = down
    # walk upward through compressed levels (preimage chain)
    pos_bounds = init_bounds.astype(np.int64)
    for l in range(split_level, n_dense - 1, -1):
        ld = tensor.levels[l]
        if levels[l].pos_bounds is None:
            levels[l] = LevelPartition(pos_bounds=pos_bounds.copy())
        if ld.kind.singleton:
            continue  # position space shared with parent
        pos_bounds = preimage(ld.pos, pos_bounds)
    # dense prefix: divide position bounds back into coordinates
    root_bounds = pos_bounds
    for l in range(n_dense - 1, 0, -1):
        size = tensor.levels[l].size
        lo = root_bounds[:, 0] // size
        hi = -(-root_bounds[:, 1] // size)
        root_bounds = np.stack([lo, hi], axis=1)
        levels[l] = LevelPartition(pos_bounds=root_bounds.copy())
    if n_dense:
        levels[0] = LevelPartition(coord_bounds=root_bounds.copy())
    else:
        # root is compressed; coordinates owned = crd[slice] range
        levels[0].pos_bounds = (
            levels[0].pos_bounds if levels[0].pos_bounds is not None else pos_bounds
        )
        crd0 = tensor.levels[0].crd
        pb = levels[0].pos_bounds
        if crd0 is None or crd0.size == 0:   # empty tensor: no coords owned
            root_bounds = np.zeros_like(pb)
        else:
            lo = np.where(pb[:, 0] < pb[:, 1],
                          crd0[np.minimum(pb[:, 0], len(crd0) - 1)], 0)
            hi = np.where(pb[:, 0] < pb[:, 1],
                          crd0[np.maximum(pb[:, 1] - 1, 0)] + 1, 0)
            root_bounds = np.stack([lo, hi], axis=1).astype(np.int64)
    return TensorPartition(
        tensor=tensor,
        pieces=pieces,
        levels=levels,
        vals_bounds=vals_bounds,
        root_coord_bounds=root_bounds.astype(np.int64),
        overlapping_root=True,
    )


def partition_tensor_grid(tensor: Tensor, row_bounds: Bounds,
                          col_bounds: Bounds) -> TensorPartition:
    """2-D cross-product tile partition: color ``(p, q)`` (row-major flat
    color ``p*Q + q``) owns the row window ``row_bounds[p]`` × column
    window ``col_bounds[q]`` of the tensor — the machine-grid tiling of
    paper Fig. 4c lifted to sparse coordinate trees (core/grid.py plans
    the per-axis communication these tiles imply).

    Unlike the 1-D partitions, a tile is NOT a contiguous interval of the
    value space, so ``vals_bounds`` stays None; the grid materializers
    (``materialize_csr_grid`` / ``materialize_bcsr_grid``) carry per-tile
    global position indices instead. Blocked tensors interpret the (row,
    col) windows at block granularity — the caller must pass block-aligned
    bounds (``block_aligned_row_bounds``) so windows realize as whole
    blocks."""
    P, Q = row_bounds.shape[0], col_bounds.shape[0]
    levels = [LevelPartition(coord_bounds=row_bounds.copy()),
              LevelPartition(coord_bounds=col_bounds.copy())]
    return TensorPartition(
        tensor=tensor, pieces=P * Q, levels=levels,
        vals_bounds=None, root_coord_bounds=row_bounds.copy(),
        overlapping_root=False, grid=(P, Q),
    )


def partition_tensor_grid3(tensor: Tensor, b0: Bounds, b1: Bounds,
                           b2: Bounds) -> TensorPartition:
    """Order-3 cross-product brick partition: color ``(p, q, r)`` (row-major
    flat color ``(p*Q + q)*R + r``) owns the dimension-0 window ``b0[p]`` ×
    dimension-1 window ``b1[q]`` × dimension-2 window ``b2[r]`` — the 2-D
    grid tiling lifted to P×Q×R machine grids for order-3 operands
    (spmttkrp bricks)."""
    P, Q, R = b0.shape[0], b1.shape[0], b2.shape[0]
    levels = [LevelPartition(coord_bounds=b0.copy()),
              LevelPartition(coord_bounds=b1.copy()),
              LevelPartition(coord_bounds=b2.copy())]
    return TensorPartition(
        tensor=tensor, pieces=P * Q * R, levels=levels,
        vals_bounds=None, root_coord_bounds=b0.copy(),
        overlapping_root=False, grid=(P, Q, R),
    )


def partition_tensor_cols(tensor: Tensor, col_bounds: Bounds,
                          ) -> TensorPartition:
    """Column partition of a DENSE tensor (dim 1 sliced into windows) —
    the co-operand plan for grid-distributed computations whose second
    loop variable indexes the operand's trailing dimension (e.g. D(k, j)
    under an (i, j) grid)."""
    if not tensor.format.is_all_dense:
        raise ValueError("column partition is dense-only; sparse operands "
                         "take grid tiles or replication")
    levels = [LevelPartition(),
              LevelPartition(coord_bounds=col_bounds.copy())]
    return TensorPartition(
        tensor=tensor, pieces=col_bounds.shape[0], levels=levels,
        vals_bounds=None, root_coord_bounds=None,
    )



def replicate_tensor(tensor: Tensor, pieces: int) -> TensorPartition:
    """Every color sees the whole tensor (TDN replication, paper Fig. 1
    ``ReplDense``)."""
    order = tensor.order
    return TensorPartition(
        tensor=tensor,
        pieces=pieces,
        levels=[LevelPartition(replicated=True) for _ in range(order)],
        replicated=True,
    )


# ---------------------------------------------------------------------------
# Materialization: partitions -> stacked, padded, statically-shaped shards
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedTensor:
    """Statically-shaped stacked shards, ready for the batched leaves.

    ``kind`` selects the leaf-kernel calling convention:
      - ``dense_rows``: dense tensor split by leading-dim intervals.
      - ``csr_rows``  : CSR/CSF-style shard per color (local pos rebased).
      - ``coo_nnz``   : equal-nnz COO shard (rows/cols/vals + row offsets).
      - ``bcsr_rows`` : blocked CSR shard per color ((br, bc) value tiles).
      - ``bcsr_nnz``  : equal-stored-block shard (block coordinates + tiles).
      - ``add_stream`` / ``add_stream_blocked``: equal chunks of the SpAdd
        addends' concatenated entry (or block) stream.
      - ``csr_grid`` / ``bcsr_grid``: (P·Q) row×col tiles, column-local
        coordinates and global value positions (``val_idx``).
      - ``coo3_grid`` : P×Q×R bricks, brick-local coordinates.
      - ``dense_grid`` / ``dense_cols``: dense tile or column windows.
      - ``replicated``: single copy broadcast to every color.
    Arrays all have leading dim = pieces (except replicated and the dense
    window stacks, whose leading dims are the windows).
    """

    kind: str
    pieces: int
    arrays: Dict[str, np.ndarray]
    meta: Dict[str, int]
    partition: TensorPartition
    # Device copies of ``arrays``, keyed (array name, device), filled by
    # core.lower at lower time. The dict is shared by every copy
    # ``_cached_shards`` hands out, so a warm re-lower that hits
    # SHARD_CACHE also finds the arrays already on the device.
    device_arrays: Dict[Tuple[str, str], object] = dataclasses.field(
        default_factory=dict, repr=False)

    def padding_waste(self) -> float:
        """Fraction of materialized value slots that are padding."""
        if self.kind in ("replicated",):
            return 0.0
        vb = self.partition.vals_bounds
        if vb is None or "vals" not in self.arrays:
            return 0.0
        real = float((vb[:, 1] - vb[:, 0]).sum())
        v = self.arrays["vals"]
        if v.ndim > 2:      # blocked shards: bounds count (br, bc) tiles
            real *= float(np.prod(v.shape[2:]))
        alloc = float(np.prod(v.shape))
        return 0.0 if alloc == 0 else 1.0 - real / alloc


def _pad_to(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    pad = n - arr.shape[0]
    if pad <= 0:
        return arr[:n]
    return np.concatenate([arr, np.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype)])


# ---------------------------------------------------------------------------
# Shard-materialization cache: every materializer below consults one bounded
# LRU keyed by (materializer kind, tensor content fingerprint, partition
# interval fingerprint). A re-plan over unchanged operands (same schedule,
# or new straggler weights that happen to reproduce the same bounds) returns
# the packed arrays without touching numpy; any content change — including
# in-place mutation of vals/pos/crd — changes the CRC and re-packs.
# ---------------------------------------------------------------------------

SHARD_CACHE = LRUCache(capacity=64)
SHARD_CACHE_STATS = SHARD_CACHE.stats   # {"hits", "misses", "evictions"}


def set_shard_cache_capacity(capacity: int) -> None:
    """Re-bound the shard cache (entry cap, LRU eviction)."""
    SHARD_CACHE.set_capacity(capacity)


def clear_shard_cache() -> None:
    SHARD_CACHE.clear()


# Per-lower fingerprint memo: core.lower activates it for the duration of
# one lower() call, so the O(nnz) CRC over a tensor's storage is computed
# once even though the plan key and one or more materializers all need it.
# Keyed by object identity — valid only within a single lower, where
# in-place mutation mid-lower is already undefined; outside a memo scope
# every call recomputes (that recompute IS the invalidation mechanism).
_FP_MEMO: Optional[Dict[int, Tuple]] = None


def tensor_fingerprint(t: Tensor) -> Tuple:
    if _FP_MEMO is None:
        return t.fingerprint()
    fp = _FP_MEMO.get(id(t))
    if fp is None:
        fp = _FP_MEMO[id(t)] = t.fingerprint()
    return fp


@contextlib.contextmanager
def fingerprint_memo():
    global _FP_MEMO
    prev = _FP_MEMO
    _FP_MEMO = {}
    try:
        yield
    finally:
        _FP_MEMO = prev


# Whole-tensor coordinate walks (``Tensor.coords``, ``Tensor.block_coords``)
# memoized for the duration of one ``materialize_pieces`` call: it packs
# every color with the whole-set impls, each of which would otherwise walk
# the whole tensor again (P walks for P pieces). Keyed by object identity,
# valid only inside the call.
_WALK_MEMO: Optional[Dict[Tuple[int, str], np.ndarray]] = None


def _walk(tensor: Tensor, name: str) -> np.ndarray:
    """``getattr(tensor, name)()``, made once per tensor inside a
    ``walk_memo`` scope."""
    if _WALK_MEMO is None:
        return getattr(tensor, name)()
    key = (id(tensor), name)
    hit = _WALK_MEMO.get(key)
    if hit is None:
        hit = _WALK_MEMO[key] = getattr(tensor, name)()
    return hit


@contextlib.contextmanager
def walk_memo():
    global _WALK_MEMO
    prev = _WALK_MEMO
    _WALK_MEMO = {}
    try:
        yield
    finally:
        _WALK_MEMO = prev


def _crc_arrays(h: int, *arrays: Optional[np.ndarray]) -> int:
    for a in arrays:
        if a is None:
            h = zlib.crc32(b"-", h)
        else:
            h = zlib.crc32(
                np.ascontiguousarray(np.asarray(a, dtype=np.int64)), h)
    return h


def partition_fingerprint(part: TensorPartition) -> Tuple:
    """Hashable summary of a partition's interval structure; together with
    ``Tensor.fingerprint()`` it keys a shard materialization — weighted
    (straggler) re-plans change the bounds and therefore the key. Grid
    partitions fold in their (P, Q) shape so a 2×4 and a 4×2 tiling of the
    same windows key distinct shard sets."""
    h = 0
    for lp in part.levels:
        h = zlib.crc32(b"R" if lp.replicated else b"L", h)
        h = _crc_arrays(h, lp.coord_bounds, lp.pos_bounds)
    h = _crc_arrays(h, part.vals_bounds, part.root_coord_bounds)
    return (part.pieces, part.replicated, part.overlapping_root, part.grid, h)


def _cached_shards(key: Tuple, build: Callable[[], ShardedTensor],
                   partition: Optional[TensorPartition] = None,
                   ) -> ShardedTensor:
    """Cache front-end shared by the materializers: on a hit the packed
    arrays are reused but the ``partition`` field is refreshed to the
    caller's plan object (the bounds are equal by key construction; the
    tensor reference inside may be an older content-identical object)."""
    def _traced_build() -> ShardedTensor:
        with telemetry.span("partition.materialize", kind=str(key[0]),
                            fingerprint=str(key[1])[:64]) as sp:
            sh = build()
            sp.set(bytes=int(sum(np.asarray(a).nbytes
                                 for a in sh.arrays.values())),
                   pieces=sh.partition.pieces if sh.partition else None)
            return sh

    sh = SHARD_CACHE.get_or_build(key, _traced_build)
    if partition is not None:
        return dataclasses.replace(sh, partition=partition)
    return sh


def materialize_dense_rows(tensor: Tensor, bounds: Bounds,
                           cache: bool = True) -> ShardedTensor:
    tp = TensorPartition(tensor, bounds.shape[0],
                         [LevelPartition(coord_bounds=bounds)],
                         root_coord_bounds=bounds, vals_bounds=None)
    if not cache:
        # per-call dense contents (run_overlapped's chunks): re-pack
        # directly instead of churning SHARD_CACHE with one-shot content
        # fingerprints
        return _materialize_dense_rows_impl(tensor, bounds, tp)
    key = ("dense_rows", tensor_fingerprint(tensor), _crc_arrays(0, bounds))
    return _cached_shards(
        key, lambda: _materialize_dense_rows_impl(tensor, bounds, tp),
        partition=tp)


def _materialize_dense_rows_impl(tensor: Tensor, bounds: Bounds,
                                 tp: TensorPartition) -> ShardedTensor:
    dense = tensor.to_dense()
    pieces = bounds.shape[0]
    counts = bounds[:, 1] - bounds[:, 0]
    max_rows = int(counts.max())
    shards = np.zeros((pieces, max_rows) + dense.shape[1:], dtype=dense.dtype)
    for p in range(pieces):
        lo, hi = int(bounds[p, 0]), int(bounds[p, 1])
        shards[p, : hi - lo] = dense[lo:hi]
    return ShardedTensor(
        kind="dense_rows",
        pieces=pieces,
        arrays={
            "vals": shards,
            "row_start": bounds[:, 0].astype(INT),
            "row_count": counts.astype(INT),
        },
        meta={"max_rows": max_rows, "n_rows": dense.shape[0]},
        partition=tp,
    )


def materialize_csr_rows(tensor: Tensor, part: TensorPartition) -> ShardedTensor:
    if part.walk_perm is not None:
        key = ("csr_rows_walk", tensor_fingerprint(tensor),
               partition_fingerprint(part))
        return _cached_shards(
            key, lambda: _materialize_csr_rows_walk_impl(tensor, part),
            partition=part)
    key = ("csr_rows", tensor_fingerprint(tensor),
           partition_fingerprint(part))
    return _cached_shards(
        key, lambda: _materialize_csr_rows_impl(tensor, part), partition=part)


def _materialize_csr_rows_walk_impl(tensor: Tensor, part: TensorPartition,
                                    ) -> ShardedTensor:
    """CSR-convention shard per color from a TRANSPOSE-WALKED row partition
    (column-major roots — CSC). Each color owns a contiguous interval of
    the row-sorted walk; the shard-local ``pos1`` is densified over the row
    window exactly like a compressed root's, ``crd1`` holds the column
    coordinates, ``vals`` is the value region PERMUTED into walk order and
    ``val_idx`` maps each slot back to its storage position (the scatter
    map pattern-preserving outputs use). Leaves written against the CSR
    calling convention consume these shards unchanged — the walk differs,
    the kernel contract does not."""
    pieces = part.pieces
    rb = part.root_coord_bounds
    row_counts = rb[:, 1] - rb[:, 0]
    max_rows = int(row_counts.max()) if pieces else 0
    perm = part.walk_perm
    coords = _walk(tensor, "coords").astype(np.int64)   # storage order
    wrows = coords[perm, 0] if perm.size else np.zeros((0,), np.int64)
    wcols = coords[perm, 1] if perm.size else np.zeros((0,), np.int64)
    vb = part.vals_bounds                          # walk-space intervals
    counts = vb[:, 1] - vb[:, 0]
    max_nnz = int(counts.max()) if pieces else 0
    pos_shards = np.zeros((pieces, max_rows + 1), dtype=INT)
    crd_shards = np.zeros((pieces, max_nnz), dtype=INT)
    val_idx = np.zeros((pieces, max_nnz), dtype=INT)
    vals_shards = np.zeros((pieces, max_nnz), dtype=tensor.vals.dtype)
    for p in range(pieces):
        lo, hi = int(vb[p, 0]), int(vb[p, 1])
        rlo = int(rb[p, 0])
        wrows_win = max(int(rb[p, 1]) - rlo, 0)
        cnts = np.zeros(max_rows, dtype=np.int64)
        if hi > lo:
            np.add.at(cnts, wrows[lo:hi] - rlo, 1)
        pos = np.zeros(max_rows + 1, dtype=np.int64)
        np.cumsum(cnts, out=pos[1:])
        pos[wrows_win + 1:] = pos[wrows_win]       # padded rows stay empty
        pos_shards[p] = pos.astype(INT)
        crd_shards[p, : hi - lo] = wcols[lo:hi]
        val_idx[p, : hi - lo] = perm[lo:hi]
        vals_shards[p, : hi - lo] = tensor.vals[perm[lo:hi]]
    arrays = {
        "pos1": pos_shards,
        "crd1": crd_shards,
        "vals": vals_shards,
        "val_idx": val_idx,
        "nnz_count": counts.astype(INT),
        "row_start": rb[:, 0].astype(INT),
        "row_count": row_counts.astype(INT),
    }
    return ShardedTensor(
        kind="csr_rows", pieces=pieces, arrays=arrays,
        meta={"max_rows": max_rows, "max_nnz": max_nnz,
              "n_rows": tensor.shape[0], "permuted": 1},
        partition=part,
    )


def _materialize_csr_rows_impl(tensor: Tensor, part: TensorPartition,
                               ) -> ShardedTensor:
    """CSR / CSF-convention shard per color from a row-interval partition.

    Local ``pos`` arrays are rebased to the shard's crd window and padded so
    out-of-range rows are empty. Multi-level (CSF) shards keep one pos/crd
    pair per compressed level.

    Compressed-root formats (DCSR, DCSF, 2-D COO) are *densified to the row
    window*: the shard-local ``pos1`` is expanded to one entry per window
    row (absent rows get empty ranges), so every leaf kernel written against
    the CSR/CSF calling convention consumes these shards unchanged. This is
    the level-iterator view of the format abstraction — the iteration
    capability differs, the kernel contract does not.
    """
    pieces = part.pieces
    rb = part.root_coord_bounds
    row_counts = rb[:, 1] - rb[:, 0]
    max_rows = int(row_counts.max())
    n_dense = _dense_prefix(tensor)
    order = tensor.order

    arrays: Dict[str, np.ndarray] = {
        "row_start": rb[:, 0].astype(INT),
        "row_count": row_counts.astype(INT),
    }
    # inner dense sizes multiply row interval into position interval
    inner_dense = 1
    for l in range(1, n_dense):
        inner_dense *= tensor.levels[l].size

    start_lvl = n_dense
    if n_dense == 0:
        # ---- densify the compressed root over each shard's row window ----
        root = tensor.levels[0]
        p0b = part.levels[0].pos_bounds
        child = tensor.levels[1] if order > 1 else None
        if child is None:
            raise NotImplementedError(
                "row materialization of a 1-D compressed vector")
        c1b = part.levels[1].pos_bounds
        max_c1 = int((c1b[:, 1] - c1b[:, 0]).max())
        pos_shards = np.zeros((pieces, max_rows + 1), dtype=INT)
        crd_shards = np.zeros((pieces, max_c1), dtype=INT)
        for p in range(pieces):
            rlo = int(rb[p, 0])
            plo, phi = int(p0b[p, 0]), int(p0b[p, 1])
            wrows = max(int(rb[p, 1]) - rlo, 0)
            counts = np.zeros(max_rows, dtype=np.int64)
            stored_rows = root.crd[plo:phi].astype(np.int64) - rlo
            if child.kind.singleton:
                # COO: one root coord per position — histogram the window
                if stored_rows.size:
                    np.add.at(counts, stored_rows, 1)
            else:
                # DCSR/DCSF: scatter each stored row's child-range length
                per_row = (child.pos[plo + 1: phi + 1].astype(np.int64)
                           - child.pos[plo: phi])
                if stored_rows.size:
                    np.add.at(counts, stored_rows, per_row)
            pos = np.zeros(max_rows + 1, dtype=np.int64)
            np.cumsum(counts, out=pos[1:])
            pos[wrows + 1:] = pos[wrows]     # padded rows stay empty
            pos_shards[p] = pos.astype(INT)
            clo, chi = int(c1b[p, 0]), int(c1b[p, 1])
            crd_shards[p, : chi - clo] = child.crd[clo:chi]
        arrays["pos1"] = pos_shards
        arrays["crd1"] = crd_shards
        start_lvl = 2

    # per compressed level: slice pos (rebased), crd
    for l in range(start_lvl, order):
        ld = tensor.levels[l]
        lp = part.levels[l]
        if ld.kind.singleton:
            continue  # handled with the vals/pos space of parent
        parent_bounds = (
            rb.astype(np.int64) * inner_dense if l == n_dense
            else part.levels[l - 1].pos_bounds
        )
        pb = lp.pos_bounds
        max_parent = int((parent_bounds[:, 1] - parent_bounds[:, 0]).max())
        max_nnz_l = int((pb[:, 1] - pb[:, 0]).max())
        pos_shards = np.zeros((pieces, max_parent + 1), dtype=INT)
        crd_shards = np.zeros((pieces, max_nnz_l), dtype=INT)
        for p in range(pieces):
            plo, phi = int(parent_bounds[p, 0]), int(parent_bounds[p, 1])
            clo, chi = int(pb[p, 0]), int(pb[p, 1])
            local_pos = ld.pos[plo: phi + 1].astype(np.int64) - clo
            local_pos = _pad_to(local_pos.astype(INT), max_parent + 1,
                                fill=int(local_pos[-1]) if local_pos.size else 0)
            pos_shards[p] = local_pos
            crd_shards[p, : chi - clo] = ld.crd[clo:chi]
        arrays[f"pos{l}"] = pos_shards
        arrays[f"crd{l}"] = crd_shards
        # singleton children share this position space; emit their crd too
        for ls in range(l + 1, order):
            if not tensor.levels[ls].kind.singleton:
                break
            s_crd = np.zeros((pieces, max_nnz_l), dtype=INT)
            for p in range(pieces):
                clo, chi = int(pb[p, 0]), int(pb[p, 1])
                s_crd[p, : chi - clo] = tensor.levels[ls].crd[clo:chi]
            arrays[f"crd{ls}"] = s_crd

    vb = part.vals_bounds
    max_nnz = int((vb[:, 1] - vb[:, 0]).max())
    vals_shards = np.zeros((pieces, max_nnz), dtype=tensor.vals.dtype)
    nnz_counts = (vb[:, 1] - vb[:, 0]).astype(INT)
    for p in range(pieces):
        lo, hi = int(vb[p, 0]), int(vb[p, 1])
        vals_shards[p, : hi - lo] = tensor.vals[lo:hi]
    arrays["vals"] = vals_shards
    arrays["nnz_count"] = nnz_counts
    return ShardedTensor(
        kind="csr_rows",
        pieces=pieces,
        arrays=arrays,
        meta={"max_rows": max_rows, "max_nnz": max_nnz,
              "n_rows": tensor.shape[tensor.format.dim_of_level(0)]},
        partition=part,
    )


def materialize_coo_nnz(tensor: Tensor, part: TensorPartition) -> ShardedTensor:
    key = ("coo_nnz", tensor_fingerprint(tensor),
           partition_fingerprint(part))
    return _cached_shards(
        key, lambda: _materialize_coo_nnz_impl(tensor, part), partition=part)


def _materialize_coo_nnz_impl(tensor: Tensor, part: TensorPartition,
                              ) -> ShardedTensor:
    """Equal-nnz COO shards from a non-zero (fused) partition.

    Emits per-color coordinate columns (dimension order) + vals, padded to
    the uniform chunk size, plus the preimage-derived root row interval so
    leaves can compute into a local output slice that is later reduced
    (paper §II-D: "perfect load balance at the cost of communication to
    reduce into the output").
    """
    pieces = part.pieces
    # (nnz, order), dimension order, storage-sorted
    coords = _walk(tensor, "coords")
    vb = part.vals_bounds
    counts = vb[:, 1] - vb[:, 0]
    max_nnz = int(counts.max())
    arrays: Dict[str, np.ndarray] = {}
    for d in range(tensor.order):
        col = np.zeros((pieces, max_nnz), dtype=INT)
        for p in range(pieces):
            lo, hi = int(vb[p, 0]), int(vb[p, 1])
            col[p, : hi - lo] = coords[lo:hi, d]
        arrays[f"dim{d}"] = col
    vals = np.zeros((pieces, max_nnz), dtype=tensor.vals.dtype)
    for p in range(pieces):
        lo, hi = int(vb[p, 0]), int(vb[p, 1])
        vals[p, : hi - lo] = tensor.vals[lo:hi]
    arrays["vals"] = vals
    arrays["nnz_count"] = counts.astype(INT)
    rb = part.root_coord_bounds
    arrays["row_start"] = rb[:, 0].astype(INT)
    arrays["row_count"] = (rb[:, 1] - rb[:, 0]).astype(INT)
    return ShardedTensor(
        kind="coo_nnz",
        pieces=pieces,
        arrays=arrays,
        meta={"max_nnz": max_nnz,
              "max_rows": int((rb[:, 1] - rb[:, 0]).max()),
              "n_rows": tensor.shape[tensor.format.dim_of_level(0)],
              # Dimension tracked by the storage root: leaves may compute
              # into a local root-window output slice only when this is the
              # output-row dimension (0); otherwise (CSC) emitters reduce
              # over the full output extent.
              "root_dim": tensor.format.dim_of_level(0)},
        partition=part,
    )



def _blocked_meta(tensor: Tensor) -> Dict[str, int]:
    # grid extents are per DIMENSION (row grid / col grid) regardless of
    # which level stores which dimension — BCSC stores columns at the root
    br, bc = tensor.format.block_shape
    return {
        "br": br, "bc": bc,
        "n_rows": tensor.shape[0], "n_cols": tensor.shape[1],
        "grid_rows": tensor.levels[tensor.format.level_of_dim(0)].size,
        "grid_cols": tensor.levels[tensor.format.level_of_dim(1)].size,
    }


def materialize_bcsr_rows(tensor: Tensor, part: TensorPartition,
                          ) -> ShardedTensor:
    if part.walk_perm is not None:
        key = ("bcsr_rows_walk", tensor_fingerprint(tensor),
               partition_fingerprint(part))
        return _cached_shards(
            key, lambda: _materialize_bcsr_rows_walk_impl(tensor, part),
            partition=part)
    key = ("bcsr_rows", tensor_fingerprint(tensor),
           partition_fingerprint(part))
    return _cached_shards(
        key, lambda: _materialize_bcsr_rows_impl(tensor, part),
        partition=part)


def _materialize_bcsr_rows_walk_impl(tensor: Tensor, part: TensorPartition,
                                     ) -> ShardedTensor:
    """Blocked-CSR-convention shards from a TRANSPOSE-WALKED block-row
    partition (BCSC): the block-grid transpose walk gives each color a
    contiguous (block-row-sorted) interval; ``pos1``/``crd1`` walk the
    block-row window / global block-columns, ``vals`` carries the (br, bc)
    tiles permuted into walk order and ``val_idx`` the stored-block
    positions — the blocked analog of the scalar transpose-walk shards."""
    pieces = part.pieces
    br, bc = tensor.format.block_shape
    bb = part.levels[0].coord_bounds               # block-row windows
    vb = part.vals_bounds                          # walk-space intervals
    perm = part.walk_perm
    bcoords = _walk(tensor, "block_coords").astype(np.int64)
    wbrow = bcoords[perm, 0] if perm.size else np.zeros((0,), np.int64)
    wbcol = bcoords[perm, 1] if perm.size else np.zeros((0,), np.int64)
    brow_counts = bb[:, 1] - bb[:, 0]
    max_brows = int(brow_counts.max()) if pieces else 0
    counts = vb[:, 1] - vb[:, 0]
    max_bnnz = int(counts.max()) if pieces else 0
    pos_shards = np.zeros((pieces, max_brows + 1), dtype=INT)
    crd_shards = np.zeros((pieces, max_bnnz), dtype=INT)
    val_idx = np.zeros((pieces, max_bnnz), dtype=INT)
    vals_shards = np.zeros((pieces, max_bnnz, br, bc),
                           dtype=tensor.vals.dtype)
    for p in range(pieces):
        lo, hi = int(vb[p, 0]), int(vb[p, 1])
        blo = int(bb[p, 0])
        wb_win = max(int(bb[p, 1]) - blo, 0)
        cnts = np.zeros(max_brows, dtype=np.int64)
        if hi > lo:
            np.add.at(cnts, wbrow[lo:hi] - blo, 1)
        pos = np.zeros(max_brows + 1, dtype=np.int64)
        np.cumsum(cnts, out=pos[1:])
        pos[wb_win + 1:] = pos[wb_win]
        pos_shards[p] = pos.astype(INT)
        crd_shards[p, : hi - lo] = wbcol[lo:hi]
        val_idx[p, : hi - lo] = perm[lo:hi]
        vals_shards[p, : hi - lo] = tensor.vals[perm[lo:hi]]
    rb = part.root_coord_bounds
    arrays = {
        "pos1": pos_shards,
        "crd1": crd_shards,
        "vals": vals_shards,
        "val_idx": val_idx,
        "row_start": rb[:, 0].astype(INT),
        "row_count": (rb[:, 1] - rb[:, 0]).astype(INT),
        "brow_start": bb[:, 0].astype(INT),
        "brow_count": brow_counts.astype(INT),
        "nnz_count": counts.astype(INT),
    }
    meta = dict(_blocked_meta(tensor), max_rows=max_brows * br,
                max_brows=max_brows, max_bnnz=max_bnnz, permuted=1)
    return ShardedTensor(kind="bcsr_rows", pieces=pieces, arrays=arrays,
                         meta=meta, partition=part)


def _materialize_bcsr_rows_impl(tensor: Tensor, part: TensorPartition,
                                ) -> ShardedTensor:
    """Blocked-CSR shard per color from a block-row interval partition.

    The per-shard layout is the CSR convention lifted to the block grid:
    ``pos1``/``crd1`` walk block-rows/block-columns, ``vals`` keeps each
    stored position's dense (br, bc) tile — the shard ships MXU-ready
    tiles, never scalarized entries. Boundary blocks retain their
    zero-padding cells; ``row_count`` (row space, clipped to the tensor
    edge) is what keeps that padding out of assembled results."""
    pieces = part.pieces
    br, bc = tensor.format.block_shape
    bb = part.levels[0].coord_bounds                 # block-row windows
    pb = part.levels[1].pos_bounds                   # stored-block windows
    brow_counts = bb[:, 1] - bb[:, 0]
    max_brows = int(brow_counts.max()) if pieces else 0
    max_bnnz = int((pb[:, 1] - pb[:, 0]).max()) if pieces else 0
    ld = tensor.levels[1]
    pos_shards = np.zeros((pieces, max_brows + 1), dtype=INT)
    crd_shards = np.zeros((pieces, max_bnnz), dtype=INT)
    vals_shards = np.zeros((pieces, max_bnnz, br, bc), dtype=tensor.vals.dtype)
    for p in range(pieces):
        blo, bhi = int(bb[p, 0]), int(bb[p, 1])
        clo, chi = int(pb[p, 0]), int(pb[p, 1])
        local_pos = ld.pos[blo: bhi + 1].astype(np.int64) - clo
        local_pos = _pad_to(local_pos.astype(INT), max_brows + 1,
                            fill=int(local_pos[-1]) if local_pos.size else 0)
        pos_shards[p] = local_pos
        crd_shards[p, : chi - clo] = ld.crd[clo:chi]
        vals_shards[p, : chi - clo] = tensor.vals[clo:chi]
    rb = part.root_coord_bounds
    arrays = {
        "pos1": pos_shards,
        "crd1": crd_shards,
        "vals": vals_shards,
        "row_start": rb[:, 0].astype(INT),
        "row_count": (rb[:, 1] - rb[:, 0]).astype(INT),
        "brow_start": bb[:, 0].astype(INT),
        "brow_count": brow_counts.astype(INT),
        "nnz_count": (pb[:, 1] - pb[:, 0]).astype(INT),
    }
    meta = dict(_blocked_meta(tensor), max_rows=max_brows * br,
                max_brows=max_brows, max_bnnz=max_bnnz)
    return ShardedTensor(kind="bcsr_rows", pieces=pieces, arrays=arrays,
                         meta=meta, partition=part)


def materialize_bcsr_nnz(tensor: Tensor, part: TensorPartition,
                         ) -> ShardedTensor:
    key = ("bcsr_nnz", tensor_fingerprint(tensor),
           partition_fingerprint(part))
    return _cached_shards(
        key, lambda: _materialize_bcsr_nnz_impl(tensor, part), partition=part)


def _materialize_bcsr_nnz_impl(tensor: Tensor, part: TensorPartition,
                               ) -> ShardedTensor:
    """Equal-stored-block shards from a block non-zero partition: per-color
    global (block-row, block-col) columns + (br, bc) value tiles, plus the
    preimage-derived block-row ownership window (overlapping — boundary
    block-rows reduce across colors, the paper's §II-D trade made at block
    granularity)."""
    pieces = part.pieces
    br, bc = tensor.format.block_shape
    vb = part.vals_bounds
    bcoords = _walk(tensor, "block_coords").astype(np.int64)     # (nb, 2) dim order
    counts = vb[:, 1] - vb[:, 0]
    max_bnnz = int(counts.max()) if pieces else 0
    bdim0 = np.zeros((pieces, max_bnnz), dtype=INT)
    bdim1 = np.zeros((pieces, max_bnnz), dtype=INT)
    vals_shards = np.zeros((pieces, max_bnnz, br, bc), dtype=tensor.vals.dtype)
    for p in range(pieces):
        lo, hi = int(vb[p, 0]), int(vb[p, 1])
        bdim0[p, : hi - lo] = bcoords[lo:hi, 0]
        bdim1[p, : hi - lo] = bcoords[lo:hi, 1]
        vals_shards[p, : hi - lo] = tensor.vals[lo:hi]
    rb = part.root_coord_bounds
    bb = part.levels[0].coord_bounds
    arrays = {
        "bdim0": bdim0,
        "bdim1": bdim1,
        "vals": vals_shards,
        "nnz_count": counts.astype(INT),
        "row_start": rb[:, 0].astype(INT),
        "row_count": (rb[:, 1] - rb[:, 0]).astype(INT),
        "brow_start": bb[:, 0].astype(INT),
        "brow_count": (bb[:, 1] - bb[:, 0]).astype(INT),
    }
    meta = dict(_blocked_meta(tensor),
                max_rows=int((rb[:, 1] - rb[:, 0]).max()) if pieces else 0,
                max_brows=int((bb[:, 1] - bb[:, 0]).max()) if pieces else 0,
                max_bnnz=max_bnnz,
                # dimension tracked by the storage root: leaves may compute
                # into a block-row window only when this is 0 (BCSR);
                # otherwise (BCSC) they reduce over the full block grid.
                root_dim=tensor.format.dim_of_level(0))
    return ShardedTensor(kind="bcsr_nnz", pieces=pieces, arrays=arrays,
                         meta=meta, partition=part)


# ---------------------------------------------------------------------------
# 2-D grid materializers: cross-product row×col tiles for the grid
# distribution subsystem (core/grid.py). Each tile is a CSR-convention
# shard over its row window with COLUMN-LOCAL coordinates (rebased to the
# tile's column window) plus the global value positions of its entries —
# tiles are non-contiguous in the value space, so assembly scatters by
# index instead of by interval.
# ---------------------------------------------------------------------------

def materialize_csr_grid(tensor: Tensor, part: TensorPartition,
                         ) -> ShardedTensor:
    key = ("csr_grid", tensor_fingerprint(tensor),
           partition_fingerprint(part))
    return _cached_shards(
        key, lambda: _materialize_csr_grid_impl(tensor, part), partition=part)


def _materialize_csr_grid_impl(tensor: Tensor, part: TensorPartition,
                               ) -> ShardedTensor:
    """Row×col tile shards of any 2-D sparse matrix.

    Built from the level tree's ROW WALK (core/levels.py): the identity
    storage enumeration for row-major formats — per-tile entry order is
    CSR order for free — and the transpose walk for column-major roots
    (CSC), whose permutation re-sorts each tile's entries row-major and
    maps them back to storage positions. Per tile: ``pos1`` walks the
    tile's row window, ``crd1`` holds column-LOCAL coordinates,
    ``val_idx`` the global (storage) value positions — the scatter map
    for pattern-preserving outputs. Colors are row-major: flat color =
    p*Q + q."""
    P, Q = part.grid
    rb = part.levels[0].coord_bounds            # (P, 2) row windows
    cb = part.levels[1].coord_bounds            # (Q, 2) col windows
    walk = tensor.level_tree().row_walk()       # row-sorted, perm → storage
    coords = walk.coords.astype(np.int64)
    r, c = coords[:, 0], coords[:, 1]
    cmasks = [(c >= int(cb[q, 0])) & (c < int(cb[q, 1])) for q in range(Q)]
    tiles = []
    for p in range(P):
        rlo, rhi = int(rb[p, 0]), int(rb[p, 1])
        rmask = (r >= rlo) & (r < rhi)
        for q in range(Q):
            tiles.append(np.nonzero(rmask & cmasks[q])[0])
    max_rows = int((rb[:, 1] - rb[:, 0]).max())
    max_tnnz = max((int(t.shape[0]) for t in tiles), default=0)
    pos_shards = np.zeros((P * Q, max_rows + 1), dtype=INT)
    crd_shards = np.zeros((P * Q, max_tnnz), dtype=INT)
    val_idx = np.zeros((P * Q, max_tnnz), dtype=INT)
    vals_shards = np.zeros((P * Q, max_tnnz), dtype=tensor.vals.dtype)
    nnz_count = np.zeros((P * Q,), dtype=INT)
    for color, idx in enumerate(tiles):
        p, q = divmod(color, Q)
        rlo, rhi = int(rb[p, 0]), int(rb[p, 1])
        clo = int(cb[q, 0])
        k = idx.shape[0]
        counts = np.bincount(r[idx] - rlo, minlength=max_rows)
        pos = np.zeros(max_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=pos[1:])
        pos[rhi - rlo + 1:] = pos[rhi - rlo]    # padded rows stay empty
        pos_shards[color] = pos.astype(INT)
        crd_shards[color, :k] = c[idx] - clo
        val_idx[color, :k] = walk.perm[idx]
        vals_shards[color, :k] = tensor.vals[walk.perm[idx]]
        nnz_count[color] = k
    arrays = {
        "pos1": pos_shards, "crd1": crd_shards, "vals": vals_shards,
        "val_idx": val_idx, "nnz_count": nnz_count,
        "row_start": rb[:, 0].astype(INT),
        "row_count": (rb[:, 1] - rb[:, 0]).astype(INT),
        "col_start": cb[:, 0].astype(INT),
        "col_count": (cb[:, 1] - cb[:, 0]).astype(INT),
    }
    meta = {"P": P, "Q": Q, "max_rows": max_rows, "max_tnnz": max_tnnz,
            "n_rows": tensor.shape[0], "n_cols": tensor.shape[1]}
    return ShardedTensor(kind="csr_grid", pieces=P * Q, arrays=arrays,
                         meta=meta, partition=part)


def materialize_bcsr_grid(tensor: Tensor, part: TensorPartition,
                          ) -> ShardedTensor:
    key = ("bcsr_grid", tensor_fingerprint(tensor),
           partition_fingerprint(part))
    return _cached_shards(
        key, lambda: _materialize_bcsr_grid_impl(tensor, part),
        partition=part)


def _materialize_bcsr_grid_impl(tensor: Tensor, part: TensorPartition,
                                ) -> ShardedTensor:
    """Blocked row×col tile shards: the CSR grid convention lifted to the
    block grid — windows are block-aligned (the planner guarantees it), so
    each tile owns whole (br, bc) value tiles; ``crd1`` holds block-col
    coordinates LOCAL to the tile's block-column window and ``val_idx``
    the global stored-block positions. Column-major block grids (BCSC)
    arrive through the blocked transpose walk, whose permutation re-sorts
    each tile's blocks block-row-major."""
    P, Q = part.grid
    br, bc = tensor.format.block_shape
    rb = part.levels[0].coord_bounds            # (P, 2) ROW windows
    cb = part.levels[1].coord_bounds            # (Q, 2) COL windows
    brb = np.stack([rb[:, 0] // br, -(-rb[:, 1] // br)], axis=1)
    bcb = np.stack([cb[:, 0] // bc, -(-cb[:, 1] // bc)], axis=1)
    walk = tensor.level_tree().row_walk()       # block-row-sorted
    bcoords = walk.coords.astype(np.int64)      # (nb, 2), dim order
    rblk, cblk = bcoords[:, 0], bcoords[:, 1]
    cmasks = [(cblk >= bcb[q, 0]) & (cblk < bcb[q, 1]) for q in range(Q)]
    tiles = []
    for p in range(P):
        rmask = (rblk >= brb[p, 0]) & (rblk < brb[p, 1])
        for q in range(Q):
            tiles.append(np.nonzero(rmask & cmasks[q])[0])
    max_brows = int((brb[:, 1] - brb[:, 0]).max())
    max_tbnnz = max((int(t.shape[0]) for t in tiles), default=0)
    pos_shards = np.zeros((P * Q, max_brows + 1), dtype=INT)
    crd_shards = np.zeros((P * Q, max_tbnnz), dtype=INT)
    val_idx = np.zeros((P * Q, max_tbnnz), dtype=INT)
    vals_shards = np.zeros((P * Q, max_tbnnz, br, bc),
                           dtype=tensor.vals.dtype)
    nnz_count = np.zeros((P * Q,), dtype=INT)
    for color, idx in enumerate(tiles):
        p, q = divmod(color, Q)
        blo, bhi = int(brb[p, 0]), int(brb[p, 1])
        k = idx.shape[0]
        counts = np.bincount(rblk[idx] - blo, minlength=max_brows)
        pos = np.zeros(max_brows + 1, dtype=np.int64)
        np.cumsum(counts, out=pos[1:])
        pos[bhi - blo + 1:] = pos[bhi - blo]
        pos_shards[color] = pos.astype(INT)
        crd_shards[color, :k] = cblk[idx] - int(bcb[q, 0])
        val_idx[color, :k] = walk.perm[idx]
        vals_shards[color, :k] = tensor.vals[walk.perm[idx]]
        nnz_count[color] = k
    arrays = {
        "pos1": pos_shards, "crd1": crd_shards, "vals": vals_shards,
        "val_idx": val_idx, "nnz_count": nnz_count,
        "row_start": rb[:, 0].astype(INT),
        "row_count": (rb[:, 1] - rb[:, 0]).astype(INT),
        "col_start": cb[:, 0].astype(INT),
        "col_count": (cb[:, 1] - cb[:, 0]).astype(INT),
        "brow_start": brb[:, 0].astype(INT),
        "bcol_start": bcb[:, 0].astype(INT),
        "bcol_count": (bcb[:, 1] - bcb[:, 0]).astype(INT),
    }
    meta = dict(_blocked_meta(tensor), P=P, Q=Q, max_brows=max_brows,
                max_tbnnz=max_tbnnz,
                max_rows=int((rb[:, 1] - rb[:, 0]).max()))
    return ShardedTensor(kind="bcsr_grid", pieces=P * Q, arrays=arrays,
                         meta=meta, partition=part)


def materialize_coo3_grid(tensor: Tensor, part: TensorPartition,
                          ) -> ShardedTensor:
    key = ("coo3_grid", tensor_fingerprint(tensor),
           partition_fingerprint(part))
    return _cached_shards(
        key, lambda: _materialize_coo3_grid_impl(tensor, part),
        partition=part)


def _materialize_coo3_grid_impl(tensor: Tensor, part: TensorPartition,
                                ) -> ShardedTensor:
    """P×Q×R brick shards of an order-3 sparse tensor in COO convention.

    Each brick (flat color ``(p*Q + q)*R + r``) holds its entries'
    coordinates LOCAL to the brick's three windows (``dim0``/``dim1``/
    ``dim2``) plus vals, padded to the widest brick. Padding slots keep
    vals = 0 so segment-sum leaves can consume the full padded width
    without masking. Entry order within a brick is storage order — the
    segment-reduction leaves are order-independent, so no walk permutation
    is needed regardless of the root's major dimension."""
    P, Q, R = part.grid
    b0 = part.levels[0].coord_bounds            # (P, 2) dim-0 windows
    b1 = part.levels[1].coord_bounds            # (Q, 2) dim-1 windows
    b2 = part.levels[2].coord_bounds            # (R, 2) dim-2 windows
    coords = tensor.coords().astype(np.int64)   # (nnz, 3), dimension order
    d0, d1, d2 = coords[:, 0], coords[:, 1], coords[:, 2]
    masks1 = [(d1 >= int(b1[q, 0])) & (d1 < int(b1[q, 1])) for q in range(Q)]
    masks2 = [(d2 >= int(b2[r, 0])) & (d2 < int(b2[r, 1])) for r in range(R)]
    bricks = []
    for p in range(P):
        m0 = (d0 >= int(b0[p, 0])) & (d0 < int(b0[p, 1]))
        for q in range(Q):
            for r in range(R):
                bricks.append(np.nonzero(m0 & masks1[q] & masks2[r])[0])
    max_bnnz = max((int(b.shape[0]) for b in bricks), default=0)
    n_colors = P * Q * R
    dim_shards = [np.zeros((n_colors, max_bnnz), dtype=INT) for _ in range(3)]
    vals_shards = np.zeros((n_colors, max_bnnz), dtype=tensor.vals.dtype)
    nnz_count = np.zeros((n_colors,), dtype=INT)
    starts = (b0[:, 0], b1[:, 0], b2[:, 0])
    for color, idx in enumerate(bricks):
        p, qr = divmod(color, Q * R)
        q, r = divmod(qr, R)
        k = idx.shape[0]
        for d, (dcol, win) in enumerate(zip((d0, d1, d2), (p, q, r))):
            dim_shards[d][color, :k] = dcol[idx] - int(starts[d][win])
        vals_shards[color, :k] = tensor.vals[idx]
        nnz_count[color] = k
    arrays = {
        "dim0": dim_shards[0], "dim1": dim_shards[1], "dim2": dim_shards[2],
        "vals": vals_shards, "nnz_count": nnz_count,
        "row_start": b0[:, 0].astype(INT),
        "row_count": (b0[:, 1] - b0[:, 0]).astype(INT),
    }
    meta = {"P": P, "Q": Q, "R": R, "max_bnnz": max_bnnz,
            "max_rows": int((b0[:, 1] - b0[:, 0]).max()),
            "n_rows": tensor.shape[0]}
    return ShardedTensor(kind="coo3_grid", pieces=n_colors, arrays=arrays,
                         meta=meta, partition=part)


def materialize_dense_grid(tensor: Tensor, row_bounds: Bounds,
                           col_bounds: Bounds,
                           cache: bool = True) -> ShardedTensor:
    """Dense matrix tiled by row windows × column windows — the co-operand
    plan when BOTH its indexing variables ride machine axes (e.g. C(k, j)
    under a replicated 2.5-D SpMM, sliced k-rows by the y axis and j-cols
    by the z axis). Shards stack tile-major: ``vals[g0, g1]`` is the
    (max_rw, max_cw)-padded tile for row window g0 × col window g1."""
    tp = partition_tensor_grid(tensor, row_bounds, col_bounds)
    if not cache:
        return _materialize_dense_grid_impl(tensor, row_bounds, col_bounds,
                                            tp)
    key = ("dense_grid", tensor_fingerprint(tensor),
           _crc_arrays(0, row_bounds, col_bounds))
    return _cached_shards(
        key, lambda: _materialize_dense_grid_impl(
            tensor, row_bounds, col_bounds, tp), partition=tp)


def _materialize_dense_grid_impl(tensor: Tensor, row_bounds: Bounds,
                                 col_bounds: Bounds,
                                 tp: TensorPartition) -> ShardedTensor:
    dense = tensor.to_dense()
    G0, G1 = row_bounds.shape[0], col_bounds.shape[0]
    rcounts = row_bounds[:, 1] - row_bounds[:, 0]
    ccounts = col_bounds[:, 1] - col_bounds[:, 0]
    max_rw, max_cw = int(rcounts.max()), int(ccounts.max())
    shards = np.zeros((G0, G1, max_rw, max_cw) + dense.shape[2:],
                      dtype=dense.dtype)
    for g0 in range(G0):
        rlo, rhi = int(row_bounds[g0, 0]), int(row_bounds[g0, 1])
        for g1 in range(G1):
            clo, chi = int(col_bounds[g1, 0]), int(col_bounds[g1, 1])
            shards[g0, g1, : rhi - rlo, : chi - clo] = dense[rlo:rhi, clo:chi]
    return ShardedTensor(
        kind="dense_grid", pieces=G0 * G1,
        arrays={"vals": shards,
                "row_start": row_bounds[:, 0].astype(INT),
                "row_count": rcounts.astype(INT),
                "col_start": col_bounds[:, 0].astype(INT),
                "col_count": ccounts.astype(INT)},
        meta={"max_rows": max_rw, "max_cols": max_cw,
              "n_rows": dense.shape[0], "n_cols": dense.shape[1]},
        partition=tp,
    )


def materialize_dense_cols(tensor: Tensor, bounds: Bounds,
                           cache: bool = True) -> ShardedTensor:
    """Dense tensor sliced into column windows along dim 1 (the grid
    co-operand whose indexing variable rides the second machine axis)."""
    tp = partition_tensor_cols(tensor, bounds)
    if not cache:
        return _materialize_dense_cols_impl(tensor, bounds, tp)
    key = ("dense_cols", tensor_fingerprint(tensor), _crc_arrays(0, bounds))
    return _cached_shards(
        key, lambda: _materialize_dense_cols_impl(tensor, bounds, tp),
        partition=tp)


def _materialize_dense_cols_impl(tensor: Tensor, bounds: Bounds,
                                 tp: TensorPartition) -> ShardedTensor:
    dense = tensor.to_dense()
    pieces = bounds.shape[0]
    counts = bounds[:, 1] - bounds[:, 0]
    max_cols = int(counts.max())
    shards = np.zeros((pieces, dense.shape[0], max_cols) + dense.shape[2:],
                      dtype=dense.dtype)
    for p in range(pieces):
        lo, hi = int(bounds[p, 0]), int(bounds[p, 1])
        shards[p, :, : hi - lo] = dense[:, lo:hi]
    return ShardedTensor(
        kind="dense_cols", pieces=pieces,
        arrays={"vals": shards,
                "col_start": bounds[:, 0].astype(INT),
                "col_count": counts.astype(INT)},
        meta={"max_cols": max_cols, "n_cols": dense.shape[1]},
        partition=tp,
    )


# ---------------------------------------------------------------------------
# Converted-tensor cache: `Tensor.to_format` results keyed by (content
# fingerprint, target format key) in a bounded LRU alongside SHARD_CACHE.
# Fallback conformance cells (csc/coo3 → CSR/CSF) pay the O(nnz) conversion
# walk once; warm re-lowers reuse the converted tensor outright (the
# converted tensor's own fingerprint then keys the shard/plan caches as
# usual). Hits/misses surface per-lower in CacheStats.
# ---------------------------------------------------------------------------

CONVERT_CACHE = LRUCache(capacity=32)
CONVERT_CACHE_STATS = CONVERT_CACHE.stats


def set_convert_cache_capacity(capacity: int) -> None:
    CONVERT_CACHE.set_capacity(capacity)


def clear_convert_cache() -> None:
    CONVERT_CACHE.clear()


def convert_tensor_cached(tensor: Tensor, target: "fmt.Format") -> Tensor:
    """``tensor.to_format(target)`` through the bounded conversion cache."""
    key = ("convert", tensor_fingerprint(tensor), fmt.format_key(target),
           getattr(target, "block_shape", None))
    hit = CONVERT_CACHE.get(key)
    if hit is not None:
        return hit
    out = tensor.to_format(target)
    CONVERT_CACHE.put(key, out)
    return out


def weights_fingerprint(weights: Optional[np.ndarray]) -> Optional[int]:
    """CRC key component for a straggler-weight vector (None = equal)."""
    if weights is None:
        return None
    return zlib.crc32(np.ascontiguousarray(
        np.asarray(weights, dtype=np.float64)))


# ---------------------------------------------------------------------------
# SpAdd non-zero strategy: the position space is the CONCATENATED
# stored-entry stream of all addends. Packing that stream is a
# materialization (not a plan) step — both the concatenated stream and the
# sliced chunk shards live in SHARD_CACHE, so a re-plan over the same
# operands reuses the shards outright and a re-plan with NEW straggler
# weights only re-slices the cached stream.
# ---------------------------------------------------------------------------

# Add-stream view of the shard cache (kept for observability: the original
# one-off stream cache exposed these and tests pin the re-plan semantics).
ADD_STREAM_STATS = {"hits": 0, "misses": 0}


def concat_entry_stream(tensors: Sequence[Tensor]) -> Dict[str, np.ndarray]:
    """Concatenated coordinate/value stream of the addends, in operand
    order. Blocked operands concatenate their BLOCK streams ((n_blocks, 2)
    grid coords + (n_blocks, br, bc) tiles); unblocked ones their scalar
    coordinate streams. Cached by content fingerprint so a weighted
    re-plan (new chunk bounds over the SAME operands) re-slices instead of
    re-walking the coordinate trees."""
    key = ("add_stream_src",
           tuple(tensor_fingerprint(t) for t in tensors))
    cached = SHARD_CACHE.get(key)
    if cached is not None:
        return cached
    if tensors[0].format.is_blocked:
        bs = tensors[0].format.block_shape
        coords = np.concatenate(
            [t.block_coords().astype(np.int64) for t in tensors], axis=0)
        vals = np.concatenate(
            [t.vals.reshape((-1,) + tuple(bs)) for t in tensors], axis=0)
    else:
        coords = np.concatenate([t.coords().astype(np.int64)
                                 for t in tensors], axis=0)
        vals = np.concatenate([np.asarray(t.vals).reshape(-1)
                               for t in tensors], axis=0)
    stream = {"coords": coords, "vals": vals}
    SHARD_CACHE.put(key, stream)
    return stream


def materialize_add_stream(tensors: Sequence[Tensor], pieces: int,
                           weights: Optional[np.ndarray] = None,
                           ) -> ShardedTensor:
    key = ("add_stream", tuple(tensor_fingerprint(t) for t in tensors),
           int(pieces), weights_fingerprint(weights))
    hit = SHARD_CACHE.get(key)
    if hit is not None:
        ADD_STREAM_STATS["hits"] += 1
        return hit
    ADD_STREAM_STATS["misses"] += 1
    with telemetry.span("partition.materialize", kind="add_stream") as sp:
        sh = _materialize_add_stream_impl(tensors, pieces, weights)
        sp.set(bytes=int(sum(np.asarray(a).nbytes
                             for a in sh.arrays.values())))
    SHARD_CACHE.put(key, sh)
    return sh


def _materialize_add_stream_impl(tensors: Sequence[Tensor], pieces: int,
                                 weights: Optional[np.ndarray] = None,
                                 ) -> ShardedTensor:
    """Equal (or straggler-weighted) chunks of the concatenated addend
    stream, padded to the uniform chunk size — the shard set consumed by
    the nnz SpAdd emitters (scalar or blocked)."""
    stream = concat_entry_stream(tensors)
    coords, vals = stream["coords"], stream["vals"]
    blocked = tensors[0].format.is_blocked
    bounds = partition_nonzeros(coords.shape[0], pieces, weights)
    counts = (bounds[:, 1] - bounds[:, 0]).astype(INT)
    max_c = int(counts.max()) if pieces else 0
    d0 = np.zeros((pieces, max_c), dtype=INT)
    d1 = np.zeros((pieces, max_c), dtype=INT)
    vshape = (pieces, max_c) + tuple(vals.shape[1:])
    vs = np.zeros(vshape, dtype=vals.dtype)
    for p in range(pieces):
        lo, hi = int(bounds[p, 0]), int(bounds[p, 1])
        d0[p, : hi - lo] = coords[lo:hi, 0]
        d1[p, : hi - lo] = coords[lo:hi, 1]
        vs[p, : hi - lo] = vals[lo:hi]
    t0 = tensors[0]
    part = TensorPartition(tensor=t0, pieces=pieces, levels=[],
                           vals_bounds=bounds.astype(np.int64))
    arrays = {"dim0": d0, "dim1": d1, "vals": vs, "nnz_count": counts}
    meta: Dict[str, int] = {"max_nnz": max_c,
                            "n_entries": int(coords.shape[0])}
    kind = "add_stream"
    if blocked:
        meta.update(_blocked_meta(t0))
        kind = "add_stream_blocked"
    return ShardedTensor(kind=kind, pieces=pieces, arrays=arrays, meta=meta,
                         partition=part)


def materialize_replicated(tensor: Tensor, pieces: int,
                           cache: bool = True) -> ShardedTensor:
    if not cache:
        return _materialize_replicated_impl(tensor, pieces)
    key = ("replicated", tensor_fingerprint(tensor), int(pieces))
    return _cached_shards(
        key, lambda: _materialize_replicated_impl(tensor, pieces),
        partition=replicate_tensor(tensor, pieces))


def _materialize_replicated_impl(tensor: Tensor, pieces: int) -> ShardedTensor:
    if tensor.format.is_all_dense:
        arrays = {"vals": tensor.to_dense()}
    else:
        arrays = {"vals": tensor.vals}
        for l, ld in enumerate(tensor.levels):
            if ld.pos is not None:
                arrays[f"pos{l}"] = ld.pos
            if ld.crd is not None:
                arrays[f"crd{l}"] = ld.crd
    return ShardedTensor(
        kind="replicated",
        pieces=pieces,
        arrays=arrays,
        meta={},
        partition=replicate_tensor(tensor, pieces),
    )



# ---------------------------------------------------------------------------
# Elastic materialization: per-PIECE shard caching + migration bounds
#
# The whole-set materializers above key one SHARD_CACHE entry per
# (tensor, full partition); any resize changes the partition fingerprint
# and re-packs everything. The elastic path (lower(..., elastic=True),
# used by core.lower.relower) instead caches one entry PER COLOR, keyed
# by the color's own window. Every per-color derivation in the
# partitioners is row-independent (searchsorted / image / preimage are
# elementwise per color), so slicing a partition to one color yields
# bounds identical to that color's rows of the full partition: after a
# migration-style resize (a dead piece's window merged into a neighbor,
# ``elastic_row_bounds``) every surviving window is a cache hit and only
# the merged window re-packs. Stacking the per-piece shards with the
# padding rules of the whole-set impls reproduces their output bit for
# bit (arrays and meta), so the emitters derive the same leaf inputs
# from either, the kernels see the same padded widths, and the runners
# (keyed on shapes + meta) are shared between the two paths.
# ---------------------------------------------------------------------------


def elastic_row_bounds(bounds: Bounds, dead: int) -> Bounds:
    """Migration bounds for losing piece ``dead`` of a 1-D split: the dead
    window is merged into its left neighbor (or the right one when piece 0
    dies), every other window is untouched. P−2 of the P−1 surviving
    windows are bitwise unchanged — the shard-reuse guarantee."""
    b = np.asarray(bounds, dtype=np.int64)
    pieces = b.shape[0]
    if not 0 <= dead < pieces:
        raise ValueError(f"dead piece {dead} out of range for {pieces} pieces")
    if pieces < 2:
        raise ValueError("cannot shrink a 1-piece partition")
    keep = np.delete(b, dead, axis=0)
    if dead == 0:
        keep[0, 0] = b[0, 0]
    else:
        keep[dead - 1, 1] = b[dead, 1]
    return keep


def _slice_bounds(b: Optional[Bounds], p: int) -> Optional[Bounds]:
    return None if b is None else b[p:p + 1]


def _slice_partition(part: TensorPartition, p: int) -> TensorPartition:
    """View of color ``p`` as a 1-piece partition (bounds rows sliced;
    ``walk_perm`` carried whole — it indexes storage, not colors)."""
    levels = [LevelPartition(coord_bounds=_slice_bounds(lv.coord_bounds, p),
                             pos_bounds=_slice_bounds(lv.pos_bounds, p),
                             replicated=lv.replicated)
              for lv in part.levels]
    return dataclasses.replace(
        part, pieces=1, levels=levels,
        vals_bounds=_slice_bounds(part.vals_bounds, p),
        root_coord_bounds=_slice_bounds(part.root_coord_bounds, p),
        grid=None)


def _stack_piece_shards(kind: str, piece_shards: List[ShardedTensor],
                        part: TensorPartition) -> ShardedTensor:
    """Stack per-color 1-piece shards into one whole-set ShardedTensor,
    reproducing the whole-set impls' padding bit for bit: ``pos*`` arrays
    edge-pad (out-of-range rows stay empty), other stacked arrays zero-pad,
    1-D per-color scalars concatenate; ``max_*`` meta takes the max."""
    first = piece_shards[0]
    arrays: Dict[str, np.ndarray] = {}
    for name in first.arrays:
        cols = [sh.arrays[name] for sh in piece_shards]
        if cols[0].ndim == 1:
            arrays[name] = np.concatenate(cols, axis=0)
            continue
        width = max(c.shape[1] for c in cols)
        padded = []
        for c in cols:
            pad = width - c.shape[1]
            if pad:
                spec = [(0, 0), (0, pad)] + [(0, 0)] * (c.ndim - 2)
                c = (np.pad(c, spec, mode="edge")
                     if name.startswith("pos") else np.pad(c, spec))
            padded.append(c)
        arrays[name] = np.concatenate(padded, axis=0)
    meta = {k: (max(sh.meta[k] for sh in piece_shards)
                if k.startswith("max_") else first.meta[k])
            for k in first.meta}
    return ShardedTensor(kind=kind, pieces=part.pieces, arrays=arrays,
                         meta=meta, partition=part)


def materialize_pieces(kind: str, tensor: Tensor,
                       part: TensorPartition) -> ShardedTensor:
    """Elastic counterpart of materialize_{csr,bcsr}_rows / *_nnz: one
    SHARD_CACHE entry per color, stacked. ``kind`` ∈ {csr_rows, bcsr_rows,
    coo_nnz, bcsr_nnz}; transpose walks dispatch automatically."""
    impls = {"csr_rows": _materialize_csr_rows_impl,
             "csr_rows_walk": _materialize_csr_rows_walk_impl,
             "bcsr_rows": _materialize_bcsr_rows_impl,
             "bcsr_rows_walk": _materialize_bcsr_rows_walk_impl,
             "coo_nnz": _materialize_coo_nnz_impl,
             "bcsr_nnz": _materialize_bcsr_nnz_impl}
    impl_key = kind
    if part.walk_perm is not None and kind in ("csr_rows", "bcsr_rows"):
        impl_key = kind + "_walk"
    impl = impls[impl_key]
    fp = tensor_fingerprint(tensor)
    piece_shards = []
    with walk_memo():
        for p in range(part.pieces):
            sp = _slice_partition(part, p)
            key = (impl_key + "_piece", fp, partition_fingerprint(sp))
            piece_shards.append(SHARD_CACHE.get_or_build(
                key, lambda sp=sp: impl(tensor, sp)))
    return _stack_piece_shards(piece_shards[0].kind, piece_shards, part)


def materialize_dense_rows_pieces(tensor: Tensor,
                                  bounds: Bounds) -> ShardedTensor:
    """Elastic counterpart of materialize_dense_rows."""
    fp = tensor_fingerprint(tensor)
    bounds = np.asarray(bounds, dtype=np.int64)
    piece_shards = []
    for p in range(bounds.shape[0]):
        b = bounds[p:p + 1]
        tp = TensorPartition(tensor, 1, [LevelPartition(coord_bounds=b)],
                             root_coord_bounds=b, vals_bounds=None)
        key = ("dense_rows_piece", fp, _crc_arrays(0, b))
        piece_shards.append(SHARD_CACHE.get_or_build(
            key, lambda b=b, tp=tp: _materialize_dense_rows_impl(tensor, b,
                                                                 tp)))
    full = TensorPartition(tensor, bounds.shape[0],
                           [LevelPartition(coord_bounds=bounds)],
                           root_coord_bounds=bounds, vals_bounds=None)
    return _stack_piece_shards("dense_rows", piece_shards, full)


def materialize_replicated_elastic(tensor: Tensor,
                                   pieces: int) -> ShardedTensor:
    """Replicated shards hold ONE copy regardless of piece count, so the
    elastic variant keys on content alone — every resize is a pure hit
    (and the copy's device arrays, cached with it, are reused too)."""
    key = ("replicated_src", tensor_fingerprint(tensor))
    src = SHARD_CACHE.get_or_build(
        key, lambda: _materialize_replicated_impl(tensor, 1))
    return dataclasses.replace(src, pieces=pieces,
                               partition=replicate_tensor(tensor, pieces))
