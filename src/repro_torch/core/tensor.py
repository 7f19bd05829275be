"""Sparse/dense tensor data structure — pos/crd/vals regions (paper §III).

A :class:`Tensor` stores one coordinate-tree level per dimension, in
``format.mode_ordering`` order. Supported level layouts (covers every format
used in the paper's evaluation — CSR, CSC, DCSR, CSF, DDC, COO, dense):

- a (possibly empty) *leading prefix of Dense levels*, stored implicitly;
- followed by Compressed / Singleton levels with explicit ``pos``/``crd``.

Regions (paper Fig. 7):
  ``pos[lvl]``  int32, length = parent position count + 1, monotone. The
                paper's (lo, hi) tuple view of entry ``i`` is
                ``(pos[i], pos[i+1]-1)``.
  ``crd[lvl]``  int32, length = number of stored coordinates at the level.
  ``vals``      values at the last level's positions; for trailing dense
                levels after the last compressed level vals is a block.

Assembly is host-side numpy (this is the paper's "format conversion" /
assembly phase); compute kernels consume the arrays as torch tensors.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import formats as fmt
from .formats import Format
from .tin import Access, IndexVar

INT = np.int32


@dataclasses.dataclass
class LevelData:
    """Physical storage for one coordinate-tree level."""

    kind: fmt.LevelFormat
    size: int  # dimension extent (universe size of this level)
    pos: Optional[np.ndarray] = None  # int32 (parent_count + 1,)
    crd: Optional[np.ndarray] = None  # int32 (stored_coords,)

    @property
    def nnz(self) -> Optional[int]:
        return None if self.crd is None else int(self.crd.shape[0])


class Tensor:
    """A tensor with a TACO-style per-level sparse encoding."""

    def __init__(
        self,
        name: str,
        shape: Sequence[int],
        format: Format,
        levels: List[LevelData],
        vals: np.ndarray,
        dtype=np.float32,
    ):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.format = format
        self.levels = levels
        self.vals = vals
        self.dtype = dtype

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------
    @staticmethod
    def from_dense(name: str, arr: np.ndarray, format: Optional[Format] = None,
                   ) -> "Tensor":
        arr = np.asarray(arr)
        if format is None:
            format = fmt.DenseND(arr.ndim)
        if format.is_blocked:
            return Tensor._from_dense_blocked(name, arr, format)
        if format.is_all_dense:
            levels = [
                LevelData(format.levels[l], arr.shape[format.dim_of_level(l)])
                for l in range(arr.ndim)
            ]
            # store vals in storage (level) order
            vals = np.transpose(arr, format.mode_ordering).astype(arr.dtype)
            return Tensor(name, arr.shape, format, levels, vals, arr.dtype)
        coords = np.argwhere(arr != 0).astype(INT)
        vals = arr[tuple(coords.T)]
        return Tensor.from_coo(name, arr.shape, coords, vals, format)

    @staticmethod
    def _from_dense_blocked(name: str, arr: np.ndarray, format: Format,
                            ) -> "Tensor":
        """Assemble a blocked (BCSR-style) tensor: the level tree indexes the
        block grid; ``vals`` is (n_stored_blocks, *block_shape)."""
        bs = format.block_shape
        if arr.ndim != len(bs):
            raise ValueError(f"blocked format {format} on order-{arr.ndim}")
        grid = tuple(-(-s // b) for s, b in zip(arr.shape, bs))
        padded = np.zeros(tuple(g * b for g, b in zip(grid, bs)), arr.dtype)
        padded[tuple(slice(0, s) for s in arr.shape)] = arr
        # view as (g0, b0, g1, b1, ...) then move block dims last
        view = padded.reshape(
            tuple(x for g, b in zip(grid, bs) for x in (g, b)))
        perm = tuple(range(0, 2 * len(bs), 2)) + \
            tuple(range(1, 2 * len(bs), 2))
        blocks = np.transpose(view, perm)          # (g0, g1, ..., b0, b1, ..)
        grid_fmt = fmt.Format(format.levels, format.mode_ordering)
        if grid_fmt.is_all_dense:
            # dense block grid: every block is stored, in storage (level)
            # order — permute grid dims by the mode ordering and flatten.
            perm = tuple(grid_fmt.mode_ordering) + tuple(
                range(len(bs), 2 * len(bs)))
            block_vals = np.ascontiguousarray(
                np.transpose(blocks, perm)).reshape((-1,) + tuple(bs))
            levels = [
                LevelData(grid_fmt.levels[l], grid[grid_fmt.dim_of_level(l)])
                for l in range(len(bs))
            ]
            return Tensor(name, arr.shape, format, levels,
                          block_vals.astype(arr.dtype), arr.dtype)
        nz = np.argwhere(
            blocks.reshape(grid + (-1,)).any(axis=-1)).astype(np.int64)
        block_vals = blocks[tuple(nz.T)].astype(arr.dtype)  # (nb, *bs)
        # build the block-grid coordinate tree with a scalar-level from_coo,
        # then swap in the block values (same stored order: from_coo keeps
        # lexicographic storage order and the block coords are unique).
        skeleton = Tensor.from_coo(
            name, grid, nz, np.arange(nz.shape[0], dtype=np.float64),
            grid_fmt, dedupe=False)
        order_idx = skeleton.vals.astype(np.int64)
        return Tensor(name, arr.shape, format, skeleton.levels,
                      block_vals[order_idx], arr.dtype)

    @staticmethod
    def from_blocks(
        name: str,
        shape: Sequence[int],
        format: Format,
        block_coords: np.ndarray,
        block_vals: np.ndarray,
        dedupe: bool = True,
    ) -> "Tensor":
        """Assemble a blocked tensor directly from ``(n_blocks, order)``
        block-grid coordinates (dimension order) + ``(n_blocks, *block)``
        value tiles — the blocked analog of :meth:`from_coo`, used by the
        direct BCSR execution path to rebuild outputs without densifying.
        ``dedupe=True`` merges duplicate block coordinates by summing their
        tiles (chunk-boundary duplicates of the nnz strategy)."""
        assert format.is_blocked
        shape = tuple(int(s) for s in shape)
        bs = format.block_shape
        grid = tuple(-(-s // b) for s, b in zip(shape, bs))
        bc = np.asarray(block_coords, dtype=np.int64).reshape(-1, len(shape))
        bv = np.asarray(block_vals).reshape((-1,) + tuple(bs))
        if bc.shape[0] == 0:
            skeleton = Tensor.from_coo(
                name, grid, bc, np.zeros((0,), np.float64),
                fmt.Format(format.levels, format.mode_ordering), dedupe=False)
            return Tensor(name, shape, format, skeleton.levels,
                          bv.astype(bv.dtype), bv.dtype)
        if dedupe:
            lin = np.zeros(bc.shape[0], dtype=np.int64)
            for d in range(len(shape)):
                lin = lin * grid[d] + bc[:, d]
            order = np.argsort(lin, kind="stable")
            lin, bc, bv = lin[order], bc[order], bv[order]
            uniq, inv = np.unique(lin, return_inverse=True)
            merged = np.zeros((uniq.shape[0],) + tuple(bs), dtype=bv.dtype)
            np.add.at(merged, inv, bv)
            keep = np.searchsorted(lin, uniq)
            bc, bv = bc[keep], merged
        # grid-tree skeleton carries the stored order back to the tiles
        skeleton = Tensor.from_coo(
            name, grid, bc, np.arange(bc.shape[0], dtype=np.float64),
            fmt.Format(format.levels, format.mode_ordering), dedupe=False)
        order_idx = skeleton.vals.astype(np.int64)
        return Tensor(name, shape, format, skeleton.levels, bv[order_idx],
                      bv.dtype)

    @staticmethod
    def from_coo(
        name: str,
        shape: Sequence[int],
        coords: np.ndarray,
        vals: np.ndarray,
        format: Format,
        dedupe: bool = True,
    ) -> "Tensor":
        """Assemble from (nnz, order) coordinates in *dimension* order."""
        shape = tuple(int(s) for s in shape)
        order = len(shape)
        coords = np.asarray(coords, dtype=np.int64).reshape(-1, order)
        vals = np.asarray(vals)
        if format.is_blocked:
            dense = np.zeros(shape, dtype=vals.dtype)
            if coords.size:
                np.add.at(dense, tuple(coords.T), vals)
            return Tensor._from_dense_blocked(name, dense, format)
        if format.is_all_dense:
            dense = np.zeros(shape, dtype=vals.dtype)
            if coords.size:
                np.add.at(dense, tuple(coords.T), vals)
            return Tensor.from_dense(name, dense, format)

        # Reorder columns into storage order and sort lexicographically.
        perm = np.array(format.mode_ordering)
        sc = coords[:, perm]
        sizes = [shape[format.dim_of_level(l)] for l in range(order)]
        # linearize for sort / dedupe
        lin = np.zeros(sc.shape[0], dtype=np.int64)
        for l in range(order):
            lin = lin * sizes[l] + sc[:, l]
        sort_idx = np.argsort(lin, kind="stable")
        lin, sc, v = lin[sort_idx], sc[sort_idx], vals[sort_idx]
        if dedupe and lin.size:
            uniq, inv = np.unique(lin, return_inverse=True)
            vsum = np.zeros(uniq.shape[0], dtype=v.dtype)
            np.add.at(vsum, inv, v)
            keep = np.searchsorted(lin, uniq)
            sc, v = sc[keep], vsum

        # Split leading dense prefix from compressed suffix.
        n_dense = 0
        for l, lf in enumerate(format.levels):
            if lf.compressed:
                break
            n_dense += 1
        if any(not lf.compressed for lf in format.levels[n_dense:]):
            raise NotImplementedError(
                f"format {format}: Dense level after a Compressed level is "
                "not supported (not needed for any paper format)"
            )

        levels: List[LevelData] = [
            LevelData(format.levels[l], sizes[l]) for l in range(n_dense)
        ]
        dense_count = int(np.prod([sizes[l] for l in range(n_dense)], dtype=np.int64)) \
            if n_dense else 1

        # linear parent key over the dense prefix for each nnz
        parent_key = np.zeros(sc.shape[0], dtype=np.int64)
        for l in range(n_dense):
            parent_key = parent_key * sizes[l] + sc[:, l]
        parent_count = dense_count

        for l in range(n_dense, order):
            lf = format.levels[l]
            c = sc[:, l]
            if lf.singleton:
                levels.append(LevelData(lf, sizes[l], pos=None,
                                        crd=c.astype(INT)))
                # position space unchanged; parent_key extends per-coordinate
                parent_key = parent_key * sizes[l] + c
                parent_count = sc.shape[0]
                continue
            # Compressed: distinct (parent_key, c) pairs are exactly the rows
            # (input already deduped + sorted), unless deeper levels follow.
            # A Compressed level followed by Singleton levels (COO) is
            # non-unique: it stores one coordinate per nnz position.
            next_singleton = l + 1 < order and format.levels[l + 1].singleton
            if l == order - 1 or next_singleton:
                seg_key = parent_key
                child_key = c
                keep = np.ones(sc.shape[0], dtype=bool)
            else:
                full = parent_key * sizes[l] + c
                keep = np.ones(full.shape[0], dtype=bool)
                if full.size:
                    keep[1:] = full[1:] != full[:-1]
                seg_key = parent_key[keep]
                child_key = c[keep]
            counts = np.zeros(parent_count, dtype=np.int64)
            if seg_key.size:
                np.add.at(counts, seg_key, 1)
            pos = np.zeros(parent_count + 1, dtype=INT)
            np.cumsum(counts, out=pos[1:])
            levels.append(LevelData(lf, sizes[l], pos=pos,
                                    crd=child_key.astype(INT)))
            # next level's parent positions = stored coords of this level
            new_parent_key = np.cumsum(keep) - 1  # position index per nnz row
            parent_key = new_parent_key
            parent_count = int(child_key.shape[0])

        return Tensor(name, shape, format, levels, v, v.dtype)

    @staticmethod
    def from_storage(name: str, shape: Sequence[int], format_key: str,
                     levels: Sequence[Tuple[Optional[np.ndarray],
                                            Optional[np.ndarray]]],
                     vals: np.ndarray) -> "Tensor":
        """Rebuild a Tensor from its storage regions given as plain numpy:
        one ``(pos, crd)`` pair per storage level (None where the level
        has no such region) plus ``vals``. The arrays are taken as they
        are, so a tensor assembled elsewhere from the same regions has the
        same ``fingerprint()`` and lowers to the same shards. Blocked
        formats (``bcsr``, ``bcsc``) take their block shape from ``vals``
        (n_blocks, br, bc); their levels index the block grid."""
        vals = np.asarray(vals)
        blocked = format_key in ("bcsr", "bcsc")
        format = fmt.format_from_key(
            format_key, tuple(vals.shape[1:]) if blocked else None)
        shape = tuple(int(s) for s in shape)
        if len(levels) != format.order or len(shape) != format.order:
            raise ValueError(
                f"{format_key}: need {format.order} levels and dims, got "
                f"{len(levels)} levels for shape {shape}")
        bs = format.block_shape or (1,) * format.order
        lds = []
        for l, (pos, crd) in enumerate(levels):
            d = format.dim_of_level(l)
            lds.append(LevelData(
                format.levels[l], -(-shape[d] // bs[d]),
                pos=None if pos is None else np.asarray(pos, dtype=INT),
                crd=None if crd is None else np.asarray(crd, dtype=INT)))
        return Tensor(name, shape, format, lds, vals, vals.dtype)

    @staticmethod
    def zeros_dense(name: str, shape: Sequence[int], dtype=np.float32,
                    format: Optional[Format] = None) -> "Tensor":
        return Tensor.from_dense(name, np.zeros(shape, dtype=dtype), format)

    # ------------------------------------------------------------------
    # Introspection / conversion
    # ------------------------------------------------------------------
    @property
    def order(self) -> int:
        return len(self.shape)

    @property
    def nnz(self) -> int:
        if self.format.is_all_dense:
            return int(np.prod(self.shape))
        if self.format.is_blocked:
            return int(self.vals.size)  # stored values incl. in-block zeros
        return int(self.vals.shape[0])

    def level(self, lvl: int) -> LevelData:
        return self.levels[lvl]

    def level_tree(self):
        """The level-iterator view of this tensor (core/levels.py): the
        format-generic walk interface the lowering engine consumes instead
        of the format descriptor itself."""
        from .levels import tree_of
        return tree_of(self)

    def fingerprint(self) -> Tuple:
        """Content fingerprint: structural identity (format key, shape,
        dtype) + a CRC over every storage region (pos/crd/vals). This is
        the cache key unit of the re-plan fast path (partition.SHARD_CACHE,
        lower's plan/runner caches): two Tensors with equal fingerprints
        materialize identical shards, and an in-place mutation between
        lowers changes the CRC — recomputed on every call, O(nnz) streaming
        reads, far cheaper than re-packing."""
        h = zlib.crc32(np.ascontiguousarray(self.vals))
        for ld in self.levels:
            if ld.pos is not None:
                h = zlib.crc32(np.ascontiguousarray(ld.pos), h)
            if ld.crd is not None:
                h = zlib.crc32(np.ascontiguousarray(ld.crd), h)
        return (fmt.format_key(self.format), self.shape,
                str(np.dtype(self.dtype)), h)

    def block_coords(self) -> np.ndarray:
        """Blocked formats: (n_blocks, order) block-grid coordinates in
        dimension order (the scalar-level walk over the grid tree)."""
        assert self.format.is_blocked
        grid_fmt = fmt.Format(self.format.levels, self.format.mode_ordering)
        grid = tuple(self.levels[self.format.level_of_dim(d)].size
                     for d in range(self.order))
        proxy = Tensor(self.name, grid, grid_fmt, self.levels,
                       np.zeros(self.vals.shape[0], self.dtype), self.dtype)
        return proxy.coords()

    def _blocked_entries(self):
        """All stored cells of a blocked tensor: ((N, order) coords aligned
        with ``vals.reshape(-1)``, plus an in-bounds mask — boundary blocks
        of a block-unaligned shape carry padding cells past the tensor
        edge, which every external consumer must drop."""
        bc = self.block_coords().astype(np.int64)         # (nb, order)
        bs = self.format.block_shape
        inner = np.indices(bs).reshape(len(bs), -1).T      # (prod(bs), order)
        out = (bc[:, None, :] * np.asarray(bs)[None, None, :]
               + inner[None, :, :]).reshape(-1, self.order)
        mask = np.all(out < np.asarray(self.shape)[None, :], axis=1)
        return out, mask

    def coords(self) -> np.ndarray:
        """(nnz, order) coordinates in *dimension* order, aligned with
        ``vals``. Blocked formats are the exception: block-padding cells
        beyond the tensor boundary are dropped, so the row count may be
        smaller than ``vals.size`` — pair with ``_blocked_entries`` when
        value alignment matters."""
        if self.format.is_blocked:
            out, mask = self._blocked_entries()
            return out[mask]
        if self.format.is_all_dense:
            # enumerate in STORAGE order (vals is stored level-major), then
            # place each level's coordinate in its dimension column
            sizes = [self.levels[l].size for l in range(self.order)]
            idx = np.indices(sizes).reshape(self.order, -1).T
            out = np.zeros_like(idx)
            for l in range(self.order):
                out[:, self.format.dim_of_level(l)] = idx[:, l]
            return out.astype(INT)
        # Walk levels, expanding positions to coordinates (storage order).
        n_dense = sum(1 for lf in self.format.levels if not lf.compressed)
        cols: List[np.ndarray] = []
        # positions at current level
        if n_dense:
            sizes = [self.levels[l].size for l in range(n_dense)]
            dense_count = int(np.prod(sizes))
        else:
            dense_count = 1
        parent_ids = np.arange(dense_count, dtype=np.int64)
        # expand through compressed levels
        level_coord: List[np.ndarray] = []
        for l in range(n_dense, self.order):
            ld = self.levels[l]
            if ld.kind.singleton:
                level_coord.append(ld.crd.astype(np.int64))
                continue
            counts = np.diff(ld.pos.astype(np.int64))
            parent_ids = np.repeat(parent_ids, counts)
            # previously recorded coords share the parent position space and
            # must be expanded to the new position space too
            level_coord = [np.repeat(c, counts) for c in level_coord]
            level_coord.append(ld.crd.astype(np.int64))
        # decode dense prefix from parent_ids
        out = np.zeros((self.nnz, self.order), dtype=np.int64)
        rem = parent_ids
        for l in reversed(range(n_dense)):
            out[:, l] = rem % self.levels[l].size
            rem = rem // self.levels[l].size
        for j, c in enumerate(level_coord):
            out[:, n_dense + j] = c
        # storage order -> dimension order
        dimcols = np.zeros_like(out)
        for l in range(self.order):
            dimcols[:, self.format.dim_of_level(l)] = out[:, l]
        return dimcols.astype(INT)

    def to_dense(self) -> np.ndarray:
        if self.format.is_blocked:
            dense = np.zeros(self.shape, dtype=self.vals.dtype)
            c, mask = self._blocked_entries()
            if c.size:
                np.add.at(dense, tuple(c[mask].T),
                          self.vals.reshape(-1)[mask])
            return dense
        if self.format.is_all_dense:
            inv = np.argsort(self.format.mode_ordering)
            return np.transpose(
                self.vals.reshape([self.levels[l].size for l in range(self.order)]),
                inv,
            )
        dense = np.zeros(self.shape, dtype=self.vals.dtype)
        c = self.coords()
        if c.size:
            np.add.at(dense, tuple(c.T), self.vals)
        return dense

    def to_format(self, new_format: Format) -> "Tensor":
        """Convert to another spellable format (the paper's assembly /
        format-conversion phase; host-side numpy).

        Non-blocked sparse → sparse goes through the coordinate stream
        (explicitly stored zeros are preserved; duplicate COO entries merge
        by summation); anything involving a blocked or all-dense endpoint
        has the dense image's result. Blocked → unblocked sparse takes it
        from the stored cells without building the image (the nonzero
        cells inside the tensor, each stored once), so a matrix whose dense
        image would not fit in memory converts too."""
        if new_format == self.format:
            return self
        if new_format.order != self.order:
            raise ValueError(
                f"cannot convert order-{self.order} tensor {self.name} to "
                f"order-{new_format.order} format {new_format}")
        if (self.format.is_blocked and not new_format.is_blocked
                and not new_format.is_all_dense):
            coords, inside = self._blocked_entries()
            vals = self.vals.reshape(-1)[inside]
            keep = vals != 0
            return Tensor.from_coo(self.name, self.shape, coords[inside][keep],
                                   vals[keep], new_format)
        if (self.format.is_blocked or new_format.is_blocked
                or self.format.is_all_dense or new_format.is_all_dense):
            return Tensor.from_dense(self.name, self.to_dense(), new_format)
        return Tensor.from_coo(self.name, self.shape, self.coords(),
                               self.vals, new_format, dedupe=True)

    # TIN access sugar: B(i, j)
    def __call__(self, *idx: IndexVar) -> Access:
        return Access(self, idx)

    def __repr__(self) -> str:
        return (f"Tensor({self.name}, shape={self.shape}, {self.format}, "
                f"nnz={self.nnz})")


class TensorVar:
    """Shape/format-only stand-in used by the dry-run (no data allocated)."""

    def __init__(self, name: str, shape: Sequence[int], format: Format,
                 dtype=np.float32, nnz: Optional[int] = None):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.format = format
        self.dtype = dtype
        self.nnz = nnz

    def __call__(self, *idx: IndexVar) -> Access:
        return Access(self, idx)

    def __repr__(self) -> str:
        return f"TensorVar({self.name}, shape={self.shape}, {self.format})"
