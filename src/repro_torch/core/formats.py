"""Format language — per-dimension level formats (paper §II-B, §III-B).

A tensor's *coordinate tree* has one level per dimension (in storage order).
Each level is stored with a *level format*:

- ``Dense``      — all coordinates of the level exist; stored implicitly as an
                   index range ``dom = [0, size)``.
- ``Compressed`` — only non-zero coordinates stored, with TACO's ``pos``/
                   ``crd`` arrays. Following the paper (§III-B, Fig. 7) the
                   ``pos`` region conceptually stores *(lo, hi)* range tuples
                   so dependent-partitioning ``image``/``preimage`` apply; we
                   keep the standard length-(parent+1) monotone ``pos`` array
                   and expose the (lo, hi) view as ``pos[i], pos[i+1]-1``.

A :class:`Format` is an ordered list of level formats plus a dimension
ordering (``mode_ordering``), so CSR/CSC/DCSR/CSF/COO are all spellable —
Figure 3 of the paper.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


class LevelFormat:
    """Base class for level formats. Subclasses are stateless singletons."""

    name: str = "?"
    compressed: bool = False
    # COO-style levels that share the position space with their parent
    # (LevelFormat Singleton from Chou et al. [27]); used for fused levels.
    singleton: bool = False

    def __repr__(self) -> str:
        return self.name


class _Dense(LevelFormat):
    name = "Dense"
    compressed = False


class _Compressed(LevelFormat):
    name = "Compressed"
    compressed = True


class _Singleton(LevelFormat):
    """COO trailing level: one coordinate per parent position."""

    name = "Singleton"
    compressed = True
    singleton = True


Dense = _Dense()
Compressed = _Compressed()
Singleton = _Singleton()

_BY_NAME = {"Dense": Dense, "Compressed": Compressed, "Singleton": Singleton}


def level_format(x) -> LevelFormat:
    if isinstance(x, LevelFormat):
        return x
    if isinstance(x, str) and x in _BY_NAME:
        return _BY_NAME[x]
    raise ValueError(f"unknown level format {x!r}")


@dataclasses.dataclass(frozen=True)
class Format:
    """An ordered tuple of level formats + optional mode ordering.

    ``mode_ordering[lvl]`` gives the tensor dimension stored at coordinate
    tree level ``lvl``; identity if omitted (row-major-like). CSC is
    ``Format((Dense, Compressed), mode_ordering=(1, 0))``.

    ``block_shape`` spells *blocked* formats (BCSR): the levels then
    describe the coordinate tree of the **block grid** (dimension ``d`` has
    ``ceil(shape[d] / block_shape[d])`` block coordinates) and each stored
    leaf position carries a dense value block of that shape instead of a
    scalar. ``BCSR((2, 2))`` = ``Format((Dense, Compressed),
    block_shape=(2, 2))``.
    """

    levels: Tuple[LevelFormat, ...]
    mode_ordering: Optional[Tuple[int, ...]] = None
    block_shape: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        object.__setattr__(
            self, "levels", tuple(level_format(l) for l in self.levels)
        )
        if self.mode_ordering is None:
            object.__setattr__(
                self, "mode_ordering", tuple(range(len(self.levels)))
            )
        if sorted(self.mode_ordering) != list(range(len(self.levels))):
            raise ValueError(f"bad mode ordering {self.mode_ordering}")
        if self.block_shape is not None:
            object.__setattr__(
                self, "block_shape", tuple(int(b) for b in self.block_shape)
            )
            if len(self.block_shape) != len(self.levels):
                raise ValueError(
                    f"block_shape {self.block_shape} must have one entry per "
                    f"level ({len(self.levels)})")
            if any(b < 1 for b in self.block_shape):
                raise ValueError(f"bad block_shape {self.block_shape}")

    @property
    def order(self) -> int:
        return len(self.levels)

    @property
    def is_sparse(self) -> bool:
        return any(l.compressed for l in self.levels)

    @property
    def is_all_dense(self) -> bool:
        return not self.is_sparse

    @property
    def is_blocked(self) -> bool:
        return self.block_shape is not None

    def level_of_dim(self, dim: int) -> int:
        return self.mode_ordering.index(dim)

    def dim_of_level(self, lvl: int) -> int:
        return self.mode_ordering[lvl]

    def __repr__(self) -> str:
        lv = ",".join(l.name for l in self.levels)
        extra = ""
        if self.mode_ordering != tuple(range(len(self.levels))):
            extra += f", order={self.mode_ordering}"
        if self.block_shape is not None:
            extra += f", block={self.block_shape}"
        return f"Format([{lv}]{extra})"


# -- Common named formats (paper Fig. 3 and §VI) ----------------------------

def DenseVec() -> Format:
    return Format((Dense,))


def SparseVec() -> Format:
    return Format((Compressed,))


def DenseMat() -> Format:
    return Format((Dense, Dense))


def CSR() -> Format:
    return Format((Dense, Compressed))


def CSC() -> Format:
    return Format((Dense, Compressed), mode_ordering=(1, 0))


def DCSR() -> Format:
    return Format((Compressed, Compressed))


def COO(order: int = 2) -> Format:
    """COO: compressed outer level, singleton trailing levels."""
    return Format((Compressed,) + (Singleton,) * (order - 1))


def CSF(order: int = 3) -> Format:
    """Compressed sparse fiber — all levels compressed (FROSTT tensors)."""
    return Format((Dense,) + (Compressed,) * (order - 1))


def DDC() -> Format:
    """Two dense outer levels + compressed inner ("patents" in the paper)."""
    return Format((Dense, Dense, Compressed))


def DenseND(order: int) -> Format:
    return Format((Dense,) * order)


def BCSR(block: Tuple[int, int] = (2, 2)) -> Format:
    """Blocked CSR: a CSR coordinate tree over the block grid, with a dense
    ``block`` value tile per stored block position."""
    return Format((Dense, Compressed), block_shape=tuple(block))


def BCSC(block: Tuple[int, int] = (2, 2)) -> Format:
    """Blocked CSC: the column-major block grid — a CSC coordinate tree
    over the block grid with a dense value tile per stored block. Lowers
    directly through the blocked transpose walk (core/levels.py); no
    dedicated emitters exist for it."""
    return Format((Dense, Compressed), mode_ordering=(1, 0),
                  block_shape=tuple(block))


def DCSF(order: int = 3) -> Format:
    """Doubly-compressed sparse fiber — every level compressed (hyper-sparse
    FROSTT tensors with empty slices)."""
    return Format((Compressed,) * order)


# ---------------------------------------------------------------------------
# Capability queries — the format-dispatch layer (Chou et al.'s level-format
# abstraction made queryable). `core.lower` and the kernel emitters consult
# these instead of hard-coding per-kernel format assumptions; when a
# capability is missing the lowering engine inserts a logged format
# conversion (see lower._normalize_operands).
# ---------------------------------------------------------------------------

_KEY_TABLE = {
    ("Dense",): "vec",
    ("Compressed",): "spvec",
    ("Dense", "Dense"): "dense",
    ("Dense", "Compressed"): "csr",
    ("Compressed", "Compressed"): "dcsr",
    ("Compressed", "Singleton"): "coo",
    ("Dense", "Dense", "Dense"): "dense3",
    ("Dense", "Compressed", "Compressed"): "csf",
    ("Compressed", "Compressed", "Compressed"): "dcsf",
    ("Compressed", "Singleton", "Singleton"): "coo3",
    ("Dense", "Dense", "Compressed"): "ddc",
}


def format_key(f: Format) -> str:
    """Canonical short name for a spellable format — the format component of
    a conformance-matrix cell ID (e.g. ``spmm/dcsr/nnz/4x1``)."""
    names = tuple(l.name for l in f.levels)
    base = _KEY_TABLE.get(names)
    if base is None:
        base = "".join(n[0].lower() for n in names)
    if f.mode_ordering != tuple(range(len(f.levels))):
        if base == "csr" and f.mode_ordering == (1, 0):
            base = "csc"
        else:
            base += "@" + "".join(str(d) for d in f.mode_ordering)
    if f.is_blocked:
        base = f"b{base}" if base in ("csr", "csc") else f"b[{base}]"
    return base


def format_from_key(key: str,
                    block_shape: Optional[Tuple[int, int]] = None) -> Format:
    """Inverse of :func:`format_key` for the unblocked table formats, ``csc``
    and the blocked ``bcsr`` / ``bcsc`` — how storage handed over as plain
    arrays names its format. A key does not spell a block shape, so the
    blocked keys take it as ``block_shape``."""
    if key in ("bcsr", "bcsc"):
        if block_shape is None:
            raise ValueError(f"format key {key!r} needs a block_shape")
        return (BCSR if key == "bcsr" else BCSC)(tuple(block_shape))
    if key == "csc":
        return CSC()
    for names, k in _KEY_TABLE.items():
        if k == key:
            return Format(tuple(level_format(n) for n in names))
    raise NotImplementedError(
        f"format key {key!r}: only the table formats, csc, bcsr and bcsc "
        "can be rebuilt from a key")


@dataclasses.dataclass(frozen=True)
class FormatCaps:
    """What a format can do directly, as queried by the lowering engine.

    ``row_partitionable``: a universe (coordinate-value) partition of the
    tensor's dimension 0 maps onto contiguous storage — true when dimension
    0 is stored at the root level and values are scalars. Root may be Dense
    (CSR/CSF) or Compressed (DCSR/DCSF/COO: handled by bucketing the sorted
    root ``crd``, then densifying the window at materialization).

    ``nnz_partitionable``: an equal split of the leaf position space plus an
    image/preimage walk is well-defined — true for every unblocked sparse
    format.

    ``root_tracks_dim0``: the root level stores dimension 0, so non-zero
    partitions own contiguous *row* windows and leaves may compute into a
    local output slice; false (e.g. CSC) means nnz leaves must reduce over
    the full output extent instead.

    ``transpose_walkable``: dimension 0 is NOT at the storage root (CSC,
    BCSC) but the level tree's transpose walk (core/levels.py — an argsort
    of the stored coordinates into dimension-lexicographic order) realizes
    universe row windows directly, with a ``val_idx`` permutation back to
    storage positions for pattern-preserving outputs.

    ``block_row_partitionable`` / ``block_nnz_partitionable``: the blocked
    analogs — a universe partition of dimension 0 can be realized as a
    contiguous (or transpose-walked) *block-row* interval, and the stored
    block position space can be split evenly. True for every dense-root
    block grid (BCSR directly, BCSC via the blocked transpose walk);
    compressed-root block grids still go through a conversion.
    """

    key: str
    order: int
    row_major: bool
    root_compressed: bool
    blocked: bool
    row_partitionable: bool
    nnz_partitionable: bool
    root_tracks_dim0: bool
    transpose_walkable: bool = False
    block_row_partitionable: bool = False
    block_nnz_partitionable: bool = False


def capabilities(f: Format) -> FormatCaps:
    row_major = f.mode_ordering == tuple(range(len(f.levels)))
    root_compressed = f.levels[0].compressed
    dim0_at_root = f.dim_of_level(0) == 0
    blocked_direct = f.is_blocked and not root_compressed and f.is_sparse
    return FormatCaps(
        key=format_key(f),
        order=len(f.levels),
        row_major=row_major,
        root_compressed=root_compressed,
        blocked=f.is_blocked,
        row_partitionable=dim0_at_root and not f.is_blocked,
        nnz_partitionable=f.is_sparse and not f.is_blocked,
        root_tracks_dim0=dim0_at_root,
        transpose_walkable=f.is_sparse and not dim0_at_root,
        block_row_partitionable=blocked_direct,
        block_nnz_partitionable=blocked_direct,
    )


def supports_2d_default(f: Format, space: str) -> bool:
    """Default capability contract shared by the 2-D kernel families
    (spmv/spmm/sddmm/spadd3): universe needs a row walk of the operand —
    CSR directly, DCSR/COO via the densified row-window view, CSC via the
    transpose walk — and nnz needs an nnz-splittable position space (any
    unblocked sparse format). Blocked dense-root grids (BCSR, BCSC) lower
    directly under BOTH strategies at block granularity — block-row
    windows (transpose-walked for BCSC) for universe, equal stored-block
    splits for nnz — through the blocked leaves. Kernel modules wrap this
    in their own ``supports()`` so a family that needs a different walk
    (the spmttkrp override pattern) can diverge."""
    caps = capabilities(f)
    if caps.order != 2:
        return False
    if caps.blocked:
        return (caps.block_row_partitionable if space == "universe"
                else caps.block_nnz_partitionable)
    if space == "universe":
        return caps.row_partitionable or caps.transpose_walkable
    return caps.nnz_partitionable


def conversion_target(f: Format) -> Format:
    """The canonical format a tensor is converted to when no direct kernel
    exists for ``f`` (lower.py logs the fallback; conformance cells that hit
    this path are recorded in the ROADMAP open-items list)."""
    order = len(f.levels)
    if order == 1:
        return SparseVec()
    if order == 2:
        return CSR()
    return CSF(order)
