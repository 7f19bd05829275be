"""Level-iterator abstraction — one format-generic walk over coordinate
hierarchies (Chou et al., *Format Abstraction for Sparse Tensor Algebra
Compilers*, composed with distribution as in SpDISTAL §III-B).

The lowering engine does NOT iterate formats; it iterates *level trees*.
A :class:`LevelTree` is instantiated from a tensor's format descriptor and
exposes, per level, the iteration capabilities the compiler needs:

- :class:`DenseIter`      — every coordinate of ``[0, size)`` exists;
  positions are implicit (``parent_pos * size + coord``).
- :class:`CompressedIter` — TACO ``pos``/``crd`` regions; children of
  parent position ``p`` live at positions ``[pos[p], pos[p+1])``.
- :class:`SingletonIter`  — COO trailing level: shares the parent's
  position space, one coordinate per position.
- **Block levels** — when ``block_shape`` is set, every iterator of the
  tree walks the *block grid* (level ``l`` has
  ``ceil(shape[d] / block[d])`` coordinates) and each leaf position
  carries a dense value tile instead of a scalar.

Two walks derive from a tree:

- :meth:`LevelTree.walk` — the **ordered** (storage-order) enumeration of
  all stored coordinates, aligned with the value region. This is what the
  nnz (coordinate-position) strategies split.
- :meth:`LevelTree.row_walk` — the dimension-lexicographic enumeration
  (sorted by dim 0, then dim 1, …). For row-major trees it IS the storage
  walk (``ordered=True``, identity permutation); for column-major roots
  (CSC, BCSC) it is the **transpose walk**: an ``argsort`` of the stored
  coordinates plus the permutation back to storage positions. Universe
  (coordinate-value) partitions of dimension 0 bucket this walk — which is
  what lets every column-major format lower DIRECTLY instead of paying a
  logged conversion to its row-major sibling.

Emitters consume *packed level arrays* — the per-color shard arrays
``core.partition`` materializes from a walk (``pos<l>``/``crd<l>``/
``vals`` for grouped trees, ``dim<d>`` coordinate columns for flat walks,
``val_idx`` scatter maps for permuted walks) — so one emitter per
(expression × strategy) serves every spellable format.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from . import formats as fmt


@dataclasses.dataclass(frozen=True)
class Walk:
    """An enumeration of a tree's stored coordinates.

    ``coords``: (N, order) coordinates in *dimension* order (block-grid
    coordinates for blocked trees). ``perm``: (N,) maps walk position →
    storage position (the index into the value region; identity when
    ``ordered``). ``ordered`` is True when the walk visits entries in
    storage order — the cheap case where no permutation is materialized."""

    coords: np.ndarray
    perm: np.ndarray
    ordered: bool

    @property
    def n(self) -> int:
        return int(self.coords.shape[0])


class LevelIter:
    """One level of a coordinate tree, as the lowering engine iterates it.

    ``size`` is the level's coordinate extent (block-grid extent for
    blocked trees); ``block`` the dense tile extent attached to each
    coordinate (1 for scalar trees); ``pos``/``crd`` the physical regions
    (None where implicit)."""

    kind: str = "?"
    compressed: bool = False
    singleton: bool = False

    def __init__(self, size: int, dim: int, block: int = 1,
                 pos: Optional[np.ndarray] = None,
                 crd: Optional[np.ndarray] = None):
        self.size = int(size)
        self.dim = int(dim)          # tensor dimension stored at this level
        self.block = int(block)
        self.pos = pos
        self.crd = crd

    def coord_range(self) -> Tuple[int, int]:
        """Universe iteration bounds of this level's coordinate space."""
        return (0, self.size)

    def children(self, parent_pos: int) -> Tuple[int, int]:
        """Position range of ``parent_pos``'s children at this level."""
        raise NotImplementedError

    def positions(self, parent_count: int) -> int:
        """Total positions at this level given the parent position count."""
        raise NotImplementedError

    def __repr__(self) -> str:
        b = f", block={self.block}" if self.block != 1 else ""
        return f"{self.kind}(size={self.size}, dim={self.dim}{b})"


class DenseIter(LevelIter):
    kind = "dense"

    def children(self, parent_pos: int) -> Tuple[int, int]:
        return (parent_pos * self.size, (parent_pos + 1) * self.size)

    def positions(self, parent_count: int) -> int:
        return parent_count * self.size


class CompressedIter(LevelIter):
    kind = "compressed"
    compressed = True

    def children(self, parent_pos: int) -> Tuple[int, int]:
        return (int(self.pos[parent_pos]), int(self.pos[parent_pos + 1]))

    def positions(self, parent_count: int) -> int:
        return int(self.pos[parent_count])


class SingletonIter(LevelIter):
    kind = "singleton"
    compressed = True
    singleton = True

    def children(self, parent_pos: int) -> Tuple[int, int]:
        return (parent_pos, parent_pos + 1)   # shared position space

    def positions(self, parent_count: int) -> int:
        return parent_count


@dataclasses.dataclass
class LevelTree:
    """A tensor's coordinate hierarchy as level iterators (storage order).

    Built by :func:`tree_of` / ``Tensor.level_tree()`` from the format
    descriptor. The predicates below are the ONLY format questions the
    generic emitters ask — adding a format means teaching the tree to
    answer them, not adding an emitter."""

    levels: Tuple[LevelIter, ...]
    shape: Tuple[int, ...]
    mode_ordering: Tuple[int, ...]
    block_shape: Optional[Tuple[int, ...]]
    _coords_fn: object = dataclasses.field(repr=False, default=None)

    @property
    def order(self) -> int:
        return len(self.levels)

    @property
    def blocked(self) -> bool:
        return self.block_shape is not None

    @property
    def root_dim(self) -> int:
        """Tensor dimension tracked by the storage root level."""
        return self.mode_ordering[0]

    @property
    def root_tracks_dim0(self) -> bool:
        return self.root_dim == 0

    @property
    def transposed(self) -> bool:
        """True for column-major roots (CSC, BCSC): a universe partition
        of dimension 0 needs the transpose walk."""
        return not self.root_tracks_dim0

    @property
    def grouped_middle(self) -> bool:
        """Order-3 trees with a grouped (non-singleton) middle level —
        what the two-level pos/crd leaf walk (CSF/DCSF) consumes."""
        return self.order >= 3 and not self.levels[1].singleton

    @property
    def trailing_singletons(self) -> bool:
        """COO-style trees: every level past the root is a singleton, so
        the only walk is the flat per-position coordinate enumeration."""
        return self.order >= 2 and all(l.singleton for l in self.levels[1:])

    # -- walks --------------------------------------------------------------

    def walk(self) -> Walk:
        """Storage-order enumeration of all stored coordinates (block-grid
        coordinates for blocked trees), aligned with the value region."""
        coords = np.asarray(self._coords_fn(), dtype=np.int64)
        n = coords.shape[0]
        ordered = self.mode_ordering == tuple(range(self.order))
        return Walk(coords=coords, perm=np.arange(n, dtype=np.int64),
                    ordered=ordered)

    def row_walk(self) -> Walk:
        """Dimension-lexicographic enumeration — the transpose walk for
        column-major roots, the plain walk otherwise. ``perm`` maps each
        walk position back to its storage position, so materializers can
        permute values and record ``val_idx`` scatter maps for
        pattern-preserving outputs."""
        w = self.walk()
        if w.ordered:
            return w
        # lexsort keys: last key is primary → feed dims in reverse
        perm = np.lexsort(tuple(w.coords[:, d]
                                for d in reversed(range(self.order))))
        return Walk(coords=w.coords[perm], perm=perm.astype(np.int64),
                    ordered=False)


def tree_of(tensor) -> LevelTree:
    """Instantiate the level tree of a Tensor (or TensorVar — walks then
    unavailable) from its format descriptor."""
    f: fmt.Format = tensor.format
    bs = f.block_shape
    its = []
    for l, lf in enumerate(f.levels):
        dim = f.dim_of_level(l)
        ld = getattr(tensor, "levels", None)
        size = (ld[l].size if ld else
                -(-tensor.shape[dim] // (bs[dim] if bs else 1)))
        block = bs[dim] if bs else 1
        pos = ld[l].pos if ld else None
        crd = ld[l].crd if ld else None
        if lf.singleton:
            its.append(SingletonIter(size, dim, block, pos, crd))
        elif lf.compressed:
            its.append(CompressedIter(size, dim, block, pos, crd))
        else:
            its.append(DenseIter(size, dim, block, pos, crd))
    coords_fn = None
    if hasattr(tensor, "coords"):
        coords_fn = tensor.block_coords if f.is_blocked else tensor.coords
    return LevelTree(levels=tuple(its), shape=tuple(tensor.shape),
                     mode_ordering=tuple(f.mode_ordering),
                     block_shape=bs, _coords_fn=coords_fn)
