"""SPMD executor for lowered sparse kernels, one process per piece.

``core.lower`` runs every piece of a kernel in one launch on one device.
This module runs the SAME Hopper kernels (their plain versions on the CPU)
in separate processes over a :class:`~.mesh.Mesh`: each rank slices its own
pieces out of the host shard arrays, moves only those to its device, and
calls the kernel wrapper the emitter calls on a leading piece axis of its
local extent (one). The paper's ``communicate`` and the reductions after
the loop become explicit collectives over the axes' process groups
(:mod:`.collectives`), which gather the partials and add them in piece
order. Every rank of the mesh gets the global output, on its device, with
the bits of the single-process ``LoweredKernel.run()``: it computes each
piece the same way and reduces in the same order.

Each builder returns ``call()``; ``call.leaf()`` launches the rank's kernel
alone (for timing), ``call.kernel`` names it and ``call.launches`` says how
often one ``call()`` launches it. A grid rank ``(p, q[, r])`` runs the 1-D
kernel on its own tile and its own window of each dense operand, so the id
offsets ``core.grid`` adds to run all tiles in one launch are not needed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict

import numpy as np
import torch

from ..core import lower as L
from ..core.cache import LRUCache, avals_key
from ..core.lower import LoweredKernel
from ..core.tdn import Machine
from ..kernels import bcsr as bcsr_kernels
from ..kernels import ref as K
from ..kernels import sddmm as sddmm_kernels
from ..kernels import spmm as spmm_kernels
from ..kernels import spmttkrp as spmttkrp_kernels
from ..kernels import spmv as spmv_kernels
from ..kernels.layout import (pack_mat_row_blocks, pack_rowwindow_blocks,
                              pack_vec_blocks)
from ..runtime import telemetry
from . import collectives as col
from .mesh import Mesh, machine_to_mesh
from .planner import sparse_pspecs

# Rank-local callables, keyed like core.lower's runner cache (builder name,
# mesh, axis, static constants, shard avals). Data flows through the
# callable's arguments; the rank's device slices ride with the shards
# (``_device_cached``), so a warm re-lower that hits SHARD_CACHE finds
# both.
_SPMD_RUN_CACHE = LRUCache(capacity=64)
SPMD_RUN_STATS = _SPMD_RUN_CACHE.stats


def set_spmd_cache_capacity(capacity: int) -> None:
    _SPMD_RUN_CACHE.set_capacity(capacity)


def clear_spmd_cache() -> None:
    _SPMD_RUN_CACHE.clear()


def _mesh_key(mesh: Mesh):
    return (tuple(mesh.axis_names), tuple(mesh.shape), mesh.backend,
            str(mesh.device), mesh.rank)


def _spmd_runner(name, mesh, axis, static, arrays, build):
    """The rank-local callable of a builder, reusing a cached one when
    (builder, mesh, axis, statics, shard avals) match."""
    key = (name, _mesh_key(mesh), axis, tuple(static), avals_key(arrays))

    def _build():
        with telemetry.span("lower.jit", leaf=name, spmd=True):
            return build()

    return _SPMD_RUN_CACHE.get_or_build(key, _build)


def _spmd_call(name, kernel_name, mesh, axis, static, proto, leaf, finish,
               local, meta=(), launches=1):
    """``call()`` of a builder: the cached ``fn(mesh, local, meta)`` that
    runs ``leaf(*local)`` (the rank's kernel) and ``finish(mesh, partial,
    *meta)`` (the collective and the assembly)."""
    def build():
        def fn(mesh, local, meta):
            return finish(mesh, leaf(*local), *meta)
        return fn

    run = _spmd_runner(name, mesh, axis, static, proto, build)

    def call():
        return run(mesh, local, meta)

    call.leaf = lambda: leaf(*local)
    call.kernel = kernel_name
    call.launches = launches
    return call


# ---------------------------------------------------------------------------
# This rank's inputs: host slices moved to the rank's device, cached with
# the shard. Replicated operands are whole on every rank and share the
# emitters' device copy.
# ---------------------------------------------------------------------------

def _piece(kernel: LoweredKernel, mesh: Mesh, axis) -> int:
    """This rank's piece along ``axis``, checking that the axis has one
    rank per piece."""
    w = mesh.axis_extent(axis)
    if w != kernel.strategy.pieces:
        raise ValueError(f"{kernel.leaf_name}: {kernel.strategy.pieces} "
                         f"pieces on a mesh axis {axis} of {w} ranks")
    return mesh.index(axis)


def _piece_of(sh, name: str, p: int, device):
    """Piece ``p`` of array ``name`` of shard ``sh`` (a leading axis of
    one) on ``device``, cached with the shard."""
    return L._device_cached(sh, ("spmd", name, p), device,
                            lambda: sh.arrays[name][p:p + 1])


def _take(sh, name: str, spec, p: int, device):
    """Array ``name`` of shard ``sh`` on ``device``: this rank's piece
    ``p`` where ``spec`` shards it, the whole array where it is
    replicated."""
    if not spec:
        return L._on_device(sh, name, device)
    return _piece_of(sh, name, p, device)


def _local(sh, key, p: int, device, build):
    """What ``build()`` derives for piece ``p`` (host arrays), on
    ``device``, cached with the shard."""
    return L._device_cached(sh, ("spmd",) + tuple(key) + (p,), device, build)


def _rows_finish(out_shape, axis):
    """Gather the pieces' row blocks over ``axis`` and scatter them into
    the output, overlapping rows added in piece order (``_scatter_rows``)."""
    def finish(mesh, blocks, row_start, row_count):
        stack = torch.cat(col.gather_parts(blocks, mesh, axis), 0)
        return L._scatter_rows(out_shape, stack, row_start, row_count)
    return finish


def _vals_finish(total, axis, by_val_idx: bool):
    """Gather the pieces' value blocks over ``axis`` and place them in the
    flat value region: by value-space interval or by ``val_idx``."""
    def finish(mesh, blocks, where, count):
        stack = torch.cat(col.gather_parts(blocks, mesh, axis), 0)
        if by_val_idx:
            return L._scatter_by_val_idx(total, stack, where, count)
        return L._scatter_vals(total, stack, where, count)
    return finish


def _summa_finish(out_shape, ax, ay):
    """Grid rows: sum the tiles of a grid row over y in window order (the
    SUMMA reduction), gather the grid rows over x, scatter them."""
    def finish(mesh, blocks, row_start, row_count):
        partial = col.sum_parts(col.gather_parts(blocks[0], mesh, ay))
        stack = torch.stack(col.gather_parts(partial, mesh, ax))
        return L._scatter_rows(out_shape, stack, row_start, row_count)
    return finish


# ---------------------------------------------------------------------------
# 1-D builders
# ---------------------------------------------------------------------------

def _operands(kernel):
    return [kernel.shards[acc.tensor.name]
            for acc in kernel.stmt.rhs.accesses()]


def _csr_leaf_inputs(kernel, p: int, device):
    """(pos, crd, vals) of piece ``p`` of a row shard set on ``device``."""
    B = _operands(kernel)[0]
    sp = sparse_pspecs({"B": B})["B"]
    return tuple(_take(B, x, sp[x], p, device)
                 for x in ("pos1", "crd1", "vals"))


def _nnz_leaf_local(kernel, p: int, device):
    """(rows_local, cols, vals) of piece ``p`` of a COO shard set on
    ``device`` (the emitter's host arrays, sliced) and the windows
    (row_start, row_count, max_rows) the leaf and the assembly read."""
    B = _operands(kernel)[0]
    row_start, row_count, max_rows = L._nnz_row_windows(
        B, kernel.stmt.lhs.tensor.shape[0])
    host = L._nnz_leaf_host(B, row_start, max_rows)
    local = _local(B, ("nnz_leaf", max_rows, "dim0", "dim1"), p, device,
                   lambda: tuple(x[p:p + 1] for x in host))
    return local, row_start, row_count, max_rows


def _product_spmd(name, kernel_fn, kernel, mesh, axis, nnz):
    """SpMV / SpMM: the rank's rows (a CSR row block) or entries (a COO
    chunk, rows rebased to its window) against the replicated dense
    operand; the row blocks are gathered over ``axis`` and placed, the
    overlapping windows of nnz added in piece order."""
    B, dense = _operands(kernel)
    out_shape = tuple(kernel.stmt.lhs.tensor.shape)
    a = B.arrays
    dev = mesh.device
    p = _piece(kernel, mesh, axis)
    dv = L._on_device(dense, "vals", dev)
    if nnz:
        local, row_start, row_count, max_rows = _nnz_leaf_local(kernel, p,
                                                                dev)
        return _spmd_call(
            name, kernel_fn.__name__, mesh, axis, out_shape + (max_rows,),
            (a["dim0"], a["dim1"], a["vals"], dense.arrays["vals"]),
            lambda r, c, v, d: kernel_fn(r, c, v, d, max_rows),
            _rows_finish(out_shape, axis), local + (dv,),
            (row_start, row_count))
    return _spmd_call(
        name, kernel_fn.__name__, mesh, axis, out_shape,
        (a["pos1"], a["crd1"], a["vals"], dense.arrays["vals"],
         a["row_count"]),
        kernel_fn, _rows_finish(out_shape, axis),
        _csr_leaf_inputs(kernel, p, dev) + (dv,),
        (a["row_start"], a["row_count"]))


def spmv_rows_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """Rows SpMV: each rank computes its row block against the replicated
    vector; the blocks are gathered over ``axis`` and placed (disjoint
    rows). Returns a callable () -> y on every rank."""
    return _product_spmd("spmv_rows", spmv_kernels.spmv_csr_rows, kernel,
                         mesh, axis, False)


def spmv_nnz_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """Non-zero SpMV: every rank computes a partial over its row window;
    the partials are gathered and added in piece order — the explicit form
    of the paper's "communication to reduce into the output" (§II-D)."""
    return _product_spmd("spmv_nnz", spmv_kernels.spmv_coo_nnz, kernel,
                         mesh, axis, True)


def spmm_rows_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """Row-based SpMM: each rank computes its row block against the
    replicated dense matrix (paper's SpMM algorithm, §VI-A)."""
    return _product_spmd("spmm_rows", spmm_kernels.spmm_csr_rows, kernel,
                         mesh, axis, False)


def spmm_nnz_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """Non-zero SpMM: row-window partials gathered and added in piece
    order. Uses the shard's row windows, or full-extent partials where the
    storage root does not track rows (CSC), so it is format-general."""
    return _product_spmd("spmm_nnz", spmm_kernels.spmm_coo_nnz, kernel,
                         mesh, axis, True)


def _rows_vals_where(kernel, device):
    """Where a rows SDDMM's piece values go home, as its emitter places
    them: (True, (val_idx, nnz_count)) for transpose-walked shards, else
    (False, (start, count)) of the value-space intervals. The position
    map is whole on every rank: each assembles the global output."""
    B = _operands(kernel)[0]
    a = B.arrays
    if "val_idx" in a:
        return True, (L._on_device(B, "val_idx", device), a["nnz_count"])
    vb = kernel.plans[kernel.stmt.rhs.accesses()[0].tensor.name].vals_bounds
    return False, (vb[:, 0].astype(np.int32),
                   (vb[:, 1] - vb[:, 0]).astype(np.int32))


def sddmm_rows_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """Row-based SDDMM: B's row shard and C's matching row block local, D
    replicated; the pieces' values are gathered and placed by value-space
    bounds (or ``val_idx`` for transpose-walked shards)."""
    accs = kernel.stmt.rhs.accesses()
    B, C, D = _operands(kernel)
    Bt = accs[0].tensor
    a = B.arrays
    dev = mesh.device
    p = _piece(kernel, mesh, axis)
    sp = sparse_pspecs({"B": B, "C": C}, axis)
    n_pos = a["crd1"].shape[1]
    rows = _local(B, ("sddmm_rows",), p, dev, lambda: K.rows_from_pos(
        torch.from_numpy(a["pos1"][p]), n_pos)[None].int())
    local = (rows, _take(B, "crd1", sp["B"]["crd1"], p, dev),
             _take(B, "vals", sp["B"]["vals"], p, dev),
             _take(C, "vals", sp["C"]["vals"], p, dev),
             L._transposed(D, dev))
    by_idx, meta = _rows_vals_where(kernel, dev)
    return _spmd_call(
        "sddmm_rows", "sddmm_coo", mesh, axis, (Bt.nnz, by_idx),
        (a["pos1"], a["crd1"], a["vals"], C.arrays["vals"],
         D.arrays["vals"]),
        sddmm_kernels.sddmm_coo, _vals_finish(Bt.nnz, axis, by_idx), local,
        meta)


def sddmm_nnz_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """Non-zero SDDMM: equal-nnz COO shards, dense factors replicated;
    outputs stay position-aligned (no reduction — the output pattern
    equals the input pattern, paper §V-B)."""
    accs = kernel.stmt.rhs.accesses()
    B, C, D = _operands(kernel)
    Bt = accs[0].tensor
    a = B.arrays
    dev = mesh.device
    p = _piece(kernel, mesh, axis)
    sp = sparse_pspecs({"B": B}, axis)["B"]
    local = tuple(_take(B, x, sp[x], p, dev) for x in ("dim0", "dim1",
                                                        "vals")) \
        + (L._on_device(C, "vals", dev), L._transposed(D, dev))
    start = kernel.plans[Bt.name].vals_bounds[:, 0].astype(np.int32)
    return _spmd_call(
        "sddmm_nnz", "sddmm_coo", mesh, axis, (Bt.nnz,),
        (a["dim0"], a["dim1"], a["vals"], C.arrays["vals"],
         D.arrays["vals"]),
        sddmm_kernels.sddmm_coo, _vals_finish(Bt.nnz, axis, False), local,
        (start, a["nnz_count"]))


def _bcsr_product_spmd(name, kernel_fn, pack, kernel, mesh, axis, nnz):
    """Blocked SpMV / SpMM: the rank's stored-block stream (block-row ids
    expanded from pos1 under rows, rebased and clipped under nnz) against
    the replicated, block-packed dense operand; block-row windows gathered
    over ``axis`` and scattered (overlapping windows added in piece
    order)."""
    B, dense = _operands(kernel)
    out_shape = tuple(kernel.stmt.lhs.tensor.shape)
    a = B.arrays
    dev = mesh.device
    p = _piece(kernel, mesh, axis)
    if nnz:
        brow_start, row_start, row_count, max_brows = L._bcsr_nnz_windows(B)
        host = L._nnz_leaf_host(B, brow_start, max_brows, ("bdim1",),
                                "bdim0")
        stream = _local(B, ("nnz_leaf", max_brows, "bdim0", "bdim1"), p,
                        dev, lambda: tuple(x[p:p + 1] for x in host))
        proto = (a["bdim0"], a["bdim1"], a["vals"], dense.arrays["vals"])
        static = out_shape + (max_brows,)
    else:
        row_start, row_count = a["row_start"], a["row_count"]
        max_brows = a["pos1"].shape[1] - 1
        sp = sparse_pspecs({"B": B}, axis)["B"]
        stream = (_local(B, ("bcsr_row_ids",), p, dev,
                         lambda: L.bcsr_row_ids_host(a, slice(p, p + 1))),
                  _take(B, "crd1", sp["crd1"], p, dev),
                  _take(B, "vals", sp["vals"], p, dev))
        proto = (a["pos1"], a["crd1"], a["vals"], dense.arrays["vals"])
        static = out_shape
    packed = L._packed(dense, pack, int(B.meta["grid_cols"]),
                       int(B.meta["bc"]), dev)
    return _spmd_call(
        name, kernel_fn.__name__, mesh, axis, static, proto,
        lambda br_, bc_, t, d: kernel_fn(br_, bc_, t, d, int(max_brows)),
        _rows_finish(out_shape, axis), stream + (packed,),
        (row_start, row_count))


def bcsr_spmv_rows_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """Direct blocked SpMV: each rank's (br, bc) value tiles over its
    block-row window against the broadcast column-blocked vector."""
    return _bcsr_product_spmd("bcsr_spmv_rows", bcsr_kernels.bcsr_spmv,
                              pack_vec_blocks, kernel, mesh, axis, False)


def bcsr_spmv_nnz_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """Blocked non-zero SpMV: block-row window partials added in piece
    order."""
    return _bcsr_product_spmd("bcsr_spmv_nnz", bcsr_kernels.bcsr_spmv,
                              pack_vec_blocks, kernel, mesh, axis, True)


def bcsr_spmm_rows_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """Blocked row-based SpMM: each rank's tiles contract against the
    broadcast row-blocked dense operand."""
    return _bcsr_product_spmd("bcsr_spmm_rows", bcsr_kernels.bcsr_spmm,
                              pack_mat_row_blocks, kernel, mesh, axis, False)


def bcsr_spmm_nnz_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """Blocked non-zero SpMM: the blocked analog of spmm_nnz."""
    return _bcsr_product_spmd("bcsr_spmm_nnz", bcsr_kernels.bcsr_spmm,
                              pack_mat_row_blocks, kernel, mesh, axis, True)


def bcsr_sddmm_rows_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """Blocked row-based SDDMM: the rank's block-row shard sampled against
    its local C row blocks and the broadcast column-blocked D; tiles
    reassemble by value-space bounds (or ``val_idx``)."""
    accs = kernel.stmt.rhs.accesses()
    B, C, D = _operands(kernel)
    Bt = accs[0].tensor
    a, meta = B.arrays, B.meta
    dev = mesh.device
    p = _piece(kernel, mesh, axis)
    br = int(meta["br"])
    max_brows = int(meta["max_brows"])
    total = int(Bt.levels[1].nnz or 0)
    Cv = C.arrays["vals"]
    sp = sparse_pspecs({"B": B}, axis)["B"]
    local = (_local(B, ("bcsr_row_ids",), p, dev,
                    lambda: L.bcsr_row_ids_host(a, slice(p, p + 1))),
             _take(B, "crd1", sp["crd1"], p, dev),
             _take(B, "vals", sp["vals"], p, dev),
             _local(C, ("rowwindow_blocks", max_brows, br), p, dev,
                    lambda: pack_rowwindow_blocks(
                        Cv[p:p + 1], max_brows, br).reshape(
                            1, max_brows * br, Cv.shape[2])),
             L._bcsr_dt(B, D, dev))
    by_idx, where = _rows_vals_where(kernel, dev)
    return _spmd_call(
        "bcsr_sddmm_rows", "bcsr_sddmm", mesh, axis, (total, by_idx),
        (a["pos1"], a["crd1"], a["vals"], Cv, D.arrays["vals"]),
        bcsr_kernels.bcsr_sddmm, _vals_finish(total, axis, by_idx), local,
        where)


def bcsr_sddmm_nnz_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """Blocked non-zero SDDMM: equal stored-block shards sample the
    broadcast block-packed factors; output tiles stay aligned with the
    stored block positions (no reduction — pattern-preserving)."""
    accs = kernel.stmt.rhs.accesses()
    B, C, D = _operands(kernel)
    Bt = accs[0].tensor
    a = B.arrays
    dev = mesh.device
    p = _piece(kernel, mesh, axis)
    br, grid_rows = int(B.meta["br"]), int(B.meta["grid_rows"])
    total = int(Bt.levels[1].nnz or 0)
    sp = sparse_pspecs({"B": B}, axis)["B"]
    local = tuple(_take(B, x, sp[x], p, dev)
                  for x in ("bdim0", "bdim1", "vals")) + (
        L._packed(C, pack_mat_row_blocks, grid_rows, br, dev,
                  (grid_rows * br, C.arrays["vals"].shape[1])),
        L._bcsr_dt(B, D, dev))
    start = kernel.plans[Bt.name].vals_bounds[:, 0].astype(np.int32)
    return _spmd_call(
        "bcsr_sddmm_nnz", "bcsr_sddmm", mesh, axis, (total,),
        (a["bdim0"], a["bdim1"], a["vals"], C.arrays["vals"],
         D.arrays["vals"]),
        bcsr_kernels.bcsr_sddmm, _vals_finish(total, axis, False), local,
        (start, a["nnz_count"]))


# ---------------------------------------------------------------------------
# Grid builders — the SUMMA-style executors over a (P, Q[, R]) mesh. Rank
# (p, q) holds tile p·Q + q and window q of the dense co-operand; the
# contraction reduction is a gather-and-add over the y axis only.
# ---------------------------------------------------------------------------

def _grid_axes(mesh: Mesh) -> tuple:
    if len(mesh.axis_names) != 2:
        raise ValueError(f"grid executor needs a 2-D mesh, got "
                         f"{mesh.axis_names}")
    return mesh.axis_names[0], mesh.axis_names[1]


def _grid_axes3(mesh: Mesh) -> tuple:
    if len(mesh.axis_names) != 3:
        raise ValueError(f"3-D grid executor needs a 3-D mesh, got "
                         f"{mesh.axis_names}")
    return mesh.axis_names[0], mesh.axis_names[1], mesh.axis_names[2]


def _grid_reshape(a: np.ndarray, P: int, Q: int) -> np.ndarray:
    return np.asarray(a).reshape((P, Q) + a.shape[1:])


def _grid_tiles(kernel):
    """B's (pos1, crd1, vals) as (P, Q, ...) tile stacks: the shard avals
    of a grid builder's run-cache key, as the reference's."""
    B = _operands(kernel)[0]
    P, Q = int(B.meta["P"]), int(B.meta["Q"])
    return tuple(_grid_reshape(B.arrays[x], P, Q)
                 for x in ("pos1", "crd1", "vals"))


def _tile(kernel, mesh: Mesh, axes):
    """This rank's grid coordinate along ``axes`` and its flat color,
    checking the mesh against the kernel's grid."""
    B = _operands(kernel)[0]
    dims = tuple(int(B.meta[k]) for k in "PQR"[:len(axes)])
    got = tuple(mesh.axis_extent(a) for a in axes)
    if got != dims:
        raise ValueError(f"{kernel.leaf_name}: a {dims} grid on a mesh of "
                         f"{got} ranks")
    coord = tuple(mesh.index(a) for a in axes)
    return coord, int(np.ravel_multi_index(coord, dims))


def _grid_rows_inputs(kernel, g: int, device):
    """(pos, crd, vals) of tile ``g`` (column-local crd) on ``device``."""
    B = _operands(kernel)[0]
    return tuple(_piece_of(B, x, g, device)
                 for x in ("pos1", "crd1", "vals"))


def spmm_grid_rows_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """2-D SpMM: tile (p, q) multiplies its B tile against C's q-th
    k-window and the grid row sums its partials along y ONLY — the SUMMA
    reduction."""
    ax, ay = _grid_axes(mesh)
    B, C = _operands(kernel)
    out_shape = tuple(kernel.stmt.lhs.tensor.shape)
    a = B.arrays
    dev = mesh.device
    (p, q), g = _tile(kernel, mesh, (ax, ay))
    local = _grid_rows_inputs(kernel, g, dev) + (
        _piece_of(C, "vals", q, dev)[0],)
    return _spmd_call(
        "spmm_grid_rows", "spmm_csr_rows", mesh, (ax, ay), out_shape,
        (*_grid_tiles(kernel), C.arrays["vals"]),
        spmm_kernels.spmm_csr_rows, _summa_finish(out_shape, ax, ay), local,
        (a["row_start"], a["row_count"]))


def spmv_grid_rows_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """2-D SpMV: the SUMMA of :func:`spmm_grid_rows_spmd` over a vector."""
    ax, ay = _grid_axes(mesh)
    B, c = _operands(kernel)
    n = kernel.stmt.lhs.tensor.shape[0]
    a = B.arrays
    dev = mesh.device
    (p, q), g = _tile(kernel, mesh, (ax, ay))
    local = _grid_rows_inputs(kernel, g, dev) + (
        _piece_of(c, "vals", q, dev)[0],)
    return _spmd_call(
        "spmv_grid_rows", "spmv_csr_rows", mesh, (ax, ay), (n,),
        (*_grid_tiles(kernel), c.arrays["vals"]),
        spmv_kernels.spmv_csr_rows, _summa_finish((n,), ax, ay), local,
        (a["row_start"], a["row_count"]))


def _tile_vals_finish(total, axes):
    """Owner-computes tiles: gather every tile's values over ``axes`` and
    scatter them home by ``val_idx``."""
    def finish(mesh, out, val_idx, count):
        stack = torch.cat(col.gather_parts(out, mesh, axes), 0)
        return L._scatter_by_val_idx(total, stack, val_idx, count)
    return finish


def sddmm_grid_rows_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """2-D SDDMM: owner-computes tiles — C row windows along x, D column
    windows along y, outputs stay tile-aligned (NO reduction on either
    axis); the tiles' values are gathered and scattered home by their
    global value positions."""
    ax, ay = _grid_axes(mesh)
    accs = kernel.stmt.rhs.accesses()
    B, C, D = _operands(kernel)
    Bt = accs[0].tensor
    a = B.arrays
    dev = mesh.device
    (p, q), g = _tile(kernel, mesh, (ax, ay))
    n_pos = a["crd1"].shape[1]
    local = (
        _local(B, ("tile_rows",), g, dev, lambda: K.rows_from_pos(
            torch.from_numpy(a["pos1"][g]), n_pos)[None].int()),
        _piece_of(B, "crd1", g, dev), _piece_of(B, "vals", g, dev),
        _piece_of(C, "vals", p, dev)[0],
        _local(D, ("window_t",), q, dev, lambda: np.ascontiguousarray(
            D.arrays["vals"][q].T)))
    return _spmd_call(
        "sddmm_grid_rows", "sddmm_coo", mesh, (ax, ay), (Bt.nnz,),
        (*_grid_tiles(kernel), C.arrays["vals"], D.arrays["vals"]),
        sddmm_kernels.sddmm_coo, _tile_vals_finish(Bt.nnz, (ax, ay)), local,
        (L._on_device(B, "val_idx", dev), a["nnz_count"]))


def bcsr_spmm_grid_rows_spmd(kernel: LoweredKernel, mesh: Mesh,
                             axis: str = "x"):
    """Blocked 2-D SpMM: (br, bc) tile matmuls against the q-th window of
    the block-packed dense operand, summed along y."""
    from ..core.grid import pack_window_mat_row_blocks
    ax, ay = _grid_axes(mesh)
    B, C = _operands(kernel)
    out_shape = tuple(kernel.stmt.lhs.tensor.shape)
    a = B.arrays
    dev = mesh.device
    (p, q), g = _tile(kernel, mesh, (ax, ay))
    bc, max_brows = int(B.meta["bc"]), int(B.meta["max_brows"])
    max_gcw = int(a["bcol_count"].max())
    local = (_local(B, ("bcsr_row_ids",), g, dev,
                    lambda: L.bcsr_row_ids_host(a, slice(g, g + 1))),
             _piece_of(B, "crd1", g, dev),
             _piece_of(B, "vals", g, dev),
             _local(C, ("window_row_blocks", max_gcw, bc), q, dev,
                    lambda: pack_window_mat_row_blocks(
                        C.arrays["vals"][q:q + 1], max_gcw, bc)[0]))
    return _spmd_call(
        "bcsr_spmm_grid_rows", "bcsr_spmm", mesh, (ax, ay),
        (max_brows,) + out_shape, (*_grid_tiles(kernel), C.arrays["vals"]),
        lambda br_, bc_, t, Cw: bcsr_kernels.bcsr_spmm(br_, bc_, t, Cw,
                                                       max_brows),
        _summa_finish(out_shape, ax, ay), local,
        (a["row_start"], a["row_count"]))


def spmm_grid_rep_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """2.5-D replicated SpMM over a (P, Q, R) mesh: B's (P, Q) tiles are
    shared by the z-layers; C's (Q, R) dense grid gives rank (p, q, r) its
    window (q, r). Each z-layer runs the SUMMA for its own output-column
    slab, so the sum runs over y ONLY — the (QR−1)-hop reduction of an
    unreplicated 3-D spread shrinks to Q−1 hops."""
    ax, ay, az = _grid_axes3(mesh)
    B, C = _operands(kernel)
    out_shape = tuple(kernel.stmt.lhs.tensor.shape)
    a = B.arrays
    dev = mesh.device
    (p, q), g = _tile(kernel, mesh, (ax, ay))
    r = mesh.index(az)
    R = mesh.axis_extent(az)
    max_jw = int(C.meta["max_cols"])
    widths = tuple(int(w) for w in C.arrays["col_count"])
    local = _grid_rows_inputs(kernel, g, dev) + (
        _local(C, ("window",), q * R + r, dev,
               lambda: C.arrays["vals"][q, r]),)

    def finish(mesh, blocks, row_start, row_count):
        partial = col.sum_parts(col.gather_parts(blocks[0], mesh, ay))
        parts = col.gather_parts(partial, mesh, (ax, az))   # (p, r) order
        P_ = len(parts) // R
        outs = [L._scatter_rows(
            (out_shape[0], max_jw),
            torch.stack([parts[pp * R + rr] for pp in range(P_)]),
            row_start, row_count)[:, :widths[rr]] for rr in range(R)]
        return torch.cat(outs, 1)

    return _spmd_call(
        "spmm_grid_rep_rows", "spmm_csr_rows", mesh, (ax, ay, az),
        (max_jw, widths) + out_shape, (*_grid_tiles(kernel), C.arrays["vals"]),
        spmm_kernels.spmm_csr_rows, finish, local,
        (a["row_start"], a["row_count"]))


def sddmm_grid_rep_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """2.5-D replicated SDDMM: B's sampling tiles shared across z; the
    contraction variable k splits over z — rank (p, q, r) takes C's window
    (p, r) and D's window (r, q). Each z-layer samples a partial dot
    product, summed over z ONLY in layer order; outputs stay
    tile-aligned."""
    ax, ay, az = _grid_axes3(mesh)
    accs = kernel.stmt.rhs.accesses()
    B, C, D = _operands(kernel)
    Bt = accs[0].tensor
    a = B.arrays
    dev = mesh.device
    (p, q), g = _tile(kernel, mesh, (ax, ay))
    r = mesh.index(az)
    R = mesh.axis_extent(az)
    Q = mesh.axis_extent(ay)
    n_pos = a["crd1"].shape[1]
    local = (
        _local(B, ("tile_rows",), g, dev, lambda: K.rows_from_pos(
            torch.from_numpy(a["pos1"][g]), n_pos)[None].int()),
        _piece_of(B, "crd1", g, dev), _piece_of(B, "vals", g, dev),
        _local(C, ("window",), p * R + r, dev,
               lambda: C.arrays["vals"][p, r]),
        _local(D, ("window_t",), r * Q + q, dev, lambda: np.ascontiguousarray(
            D.arrays["vals"][r, q].T)))

    def finish(mesh, out, val_idx, count):
        total = col.sum_parts(col.gather_parts(out, mesh, az))
        stack = torch.cat(col.gather_parts(total, mesh, (ax, ay)), 0)
        return L._scatter_by_val_idx(Bt.nnz, stack, val_idx, count)

    return _spmd_call(
        "sddmm_grid_rep_rows", "sddmm_coo", mesh, (ax, ay, az), (Bt.nnz,),
        (*_grid_tiles(kernel), C.arrays["vals"], D.arrays["vals"]),
        sddmm_kernels.sddmm_coo, finish, local,
        (L._on_device(B, "val_idx", dev), a["nnz_count"]))


def spmttkrp_grid3_spmd(kernel: LoweredKernel, mesh: Mesh, axis: str = "x"):
    """P×Q×R brick SpMTTKRP: rank (p, q, r) contracts its brick against
    C's q-th and D's r-th row windows; the partials of the Q·R bricks
    sharing a row window are summed over (y, z) in flat-colour order
    ``(p·Q + q)·R + r``, and the row windows gathered over x."""
    from ..core.grid import brick_stream_host
    ax, ay, az = _grid_axes3(mesh)
    B, C, D = _operands(kernel)
    out_shape = tuple(kernel.stmt.lhs.tensor.shape)
    a = B.arrays
    dev = mesh.device
    (p, q, r), g = _tile(kernel, mesh, (ax, ay, az))
    max_rows = int(B.meta["max_rows"])
    local = _local(B, ("brick",), g, dev,
                   lambda: brick_stream_host(B, slice(g, g + 1))) + (
        _piece_of(C, "vals", q, dev)[0],
        _piece_of(D, "vals", r, dev)[0])

    def finish(mesh, blocks, row_start, row_count):
        partial = col.sum_parts(col.gather_parts(blocks[0], mesh, (ay, az)))
        stack = torch.stack(col.gather_parts(partial, mesh, ax))
        return L._scatter_rows(out_shape, stack, row_start, row_count)

    return _spmd_call(
        "spmttkrp_grid3_rows", "spmttkrp_coo", mesh, (ax, ay, az),
        (max_rows,) + out_shape,
        (a["dim0"], a["dim1"], a["dim2"], a["vals"], C.arrays["vals"],
         D.arrays["vals"]),
        lambda rw, j, k, v, Cw, Dw: spmttkrp_kernels.spmttkrp_coo(
            rw, j, k, v, Cw, Dw, max_rows), finish, local,
        (a["row_start"], a["row_count"]))


SPMD_BUILDERS: Dict[str, Callable] = {
    "spmv_rows": spmv_rows_spmd,
    "spmv_nnz": spmv_nnz_spmd,
    "spmm_rows": spmm_rows_spmd,
    "spmm_nnz": spmm_nnz_spmd,
    "sddmm_rows": sddmm_rows_spmd,
    "sddmm_nnz": sddmm_nnz_spmd,
    "bcsr_spmv_rows": bcsr_spmv_rows_spmd,
    "bcsr_spmv_nnz": bcsr_spmv_nnz_spmd,
    "bcsr_spmm_rows": bcsr_spmm_rows_spmd,
    "bcsr_spmm_nnz": bcsr_spmm_nnz_spmd,
    "bcsr_sddmm_rows": bcsr_sddmm_rows_spmd,
    "bcsr_sddmm_nnz": bcsr_sddmm_nnz_spmd,
    "spmv_grid_rows": spmv_grid_rows_spmd,
    "spmm_grid_rows": spmm_grid_rows_spmd,
    "sddmm_grid_rows": sddmm_grid_rows_spmd,
    "bcsr_spmm_grid_rows": bcsr_spmm_grid_rows_spmd,
    "spmm_grid_rep_rows": spmm_grid_rep_spmd,
    "sddmm_grid_rep_rows": sddmm_grid_rep_spmd,
    "spmttkrp_grid3_rows": spmttkrp_grid3_spmd,
}


def to_spmd(kernel: LoweredKernel, mesh=None, axis="x",
            overlap: bool = False, overlap_chunks: int = 2, *,
            backend=None):
    """SPMD executor for a lowered kernel, when a builder exists.

    ``mesh`` is data, not trace state: pass nothing to realize the
    kernel's own Machine, a :class:`~.mesh.Mesh`, or a ``Machine``
    directly (realized here over ``backend``, on the kernel's device). A
    mesh of more than one rank needs the process group started, and every
    rank of it calls this, in the same order.

    Grid (multi-axis) NON-ZERO kernels reuse their 1-D builders with the
    flat color axis split over BOTH mesh axes and the reduction over both
    — the nested pos-split is the flat P*Q split.

    ``overlap=True`` selects the comm/compute-overlapped builder variant
    where one exists (grid SpMM): the dense co-operand is consumed in
    ``overlap_chunks`` column chunks, chunk t's reduction in flight while
    chunk t+1's kernel runs — bit-for-bit the unchunked builder (column
    chunking never reorders any per-element reduction)."""
    table = OVERLAP_SPMD_BUILDERS if overlap else SPMD_BUILDERS
    builder = table.get(kernel.leaf_name)
    if builder is None:
        if overlap:
            raise NotImplementedError(
                f"no overlapped shard_map builder for leaf "
                f"{kernel.leaf_name}; supported: "
                f"{sorted(OVERLAP_SPMD_BUILDERS)}")
        raise NotImplementedError(
            f"no shard_map builder for leaf {kernel.leaf_name}; "
            "the vmap simulation backend covers it")
    if mesh is None:
        mesh = kernel.machine
    if isinstance(mesh, Machine):
        mesh = machine_to_mesh(mesh, backend=backend, device=kernel.device)
    strat = kernel.strategy
    if getattr(strat, "is_grid", False) and strat.space == "nnz" \
            and len(mesh.axis_names) >= 2:
        axis = tuple(mesh.axis_names)
    if overlap:
        with telemetry.span("execute.spmd.build", leaf=kernel.leaf_name,
                            overlap=True, chunks=overlap_chunks):
            return builder(kernel, mesh, axis=axis, chunks=overlap_chunks)
    with telemetry.span("execute.spmd.build", leaf=kernel.leaf_name):
        return builder(kernel, mesh, axis=axis)


# ---------------------------------------------------------------------------
# Per-piece leaf profiling: run each piece's kernel ALONE and time it. The
# emitters run all pieces in one launch, so a straggler piece is invisible
# in aggregate time; the per-piece profile is the skew histogram whose
# flags feed the lower(weights=) straggler re-plan path.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PieceProfile:
    """Per-piece leaf times for one lowered kernel."""

    leaf_name: str
    seconds: np.ndarray               # (pieces,) best-of-iters per piece

    def skew(self) -> float:
        """max/mean piece time — 1.0 is perfectly balanced."""
        m = float(self.seconds.mean())
        return float(self.seconds.max()) / m if m > 0 else 1.0

    def stragglers(self, threshold: float = 1.5):
        """Piece ids slower than ``threshold``× the mean."""
        m = float(self.seconds.mean())
        if m <= 0:
            return []
        return [int(p) for p in np.nonzero(self.seconds > threshold * m)[0]]

    def replan_weights(self) -> np.ndarray:
        """Mean-normalized inverse-time weights for ``lower(weights=)``: a
        faster piece gets proportionally more non-zeros, the same
        convention as StragglerMitigator.weights."""
        inv = 1.0 / np.maximum(self.seconds, 1e-12)
        return inv / inv.mean()

    def as_dict(self):
        return {"leaf": self.leaf_name,
                "seconds": [float(s) for s in self.seconds],
                "skew": self.skew()}


def _pieces_rows(kernel_fn):
    def slicer(kernel):
        B, dense = _operands(kernel)
        dev = kernel.device
        dv = L._on_device(dense, "vals", dev)
        return kernel_fn, [_csr_leaf_inputs(kernel, p, dev) + (dv,)
                           for p in range(B.pieces)]
    return slicer


def _pieces_nnz(kernel_fn):
    def slicer(kernel):
        B, dense = _operands(kernel)
        dev = kernel.device
        dv = L._on_device(dense, "vals", dev)
        pieces = [_nnz_leaf_local(kernel, p, dev) for p in range(B.pieces)]
        max_rows = pieces[0][3]

        def leaf(r, c, v, d):
            return kernel_fn(r, c, v, d, max_rows)

        return leaf, [local + (dv,) for local, *_ in pieces]
    return slicer


def _pieces_grid_rows(kernel_fn):
    def slicer(kernel):
        B, dense = _operands(kernel)
        dev = kernel.device
        Q = int(B.meta["Q"])
        return kernel_fn, [_grid_rows_inputs(kernel, g, dev)
                           + (_piece_of(dense, "vals", g % Q, dev)[0],)
                           for g in range(B.pieces)]
    return slicer


#: leaf name -> (kernel) -> (leaf_fn, [per-piece arg tuples]): each piece's
#: kernel call on a leading piece axis of one, on the kernel's device.
PIECE_PROFILERS: Dict[str, Callable] = {
    "spmv_rows": _pieces_rows(spmv_kernels.spmv_csr_rows),
    "spmm_rows": _pieces_rows(spmm_kernels.spmm_csr_rows),
    "spmv_nnz": _pieces_nnz(spmv_kernels.spmv_coo_nnz),
    "spmm_nnz": _pieces_nnz(spmm_kernels.spmm_coo_nnz),
    "spmv_grid_rows": _pieces_grid_rows(spmv_kernels.spmv_csr_rows),
    "spmm_grid_rows": _pieces_grid_rows(spmm_kernels.spmm_csr_rows),
}


def _timed(leaf, args, device) -> float:
    """Seconds of one ``leaf(*args)``: CUDA events on a card, the host
    clock after the call on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        leaf(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    leaf(*args)
    return time.perf_counter() - t0


def profile_pieces(kernel: LoweredKernel, iters: int = 3,
                   warmup: int = 1) -> PieceProfile:
    """Time every piece's kernel individually (best of ``iters`` after
    ``warmup``): with CUDA events on a card, the host clock on the CPU.

    Records one ``execute.piece`` span + an ``executor.piece_seconds``
    histogram observation per piece, and the profile's skew as the
    ``executor.piece_skew`` gauge — the telemetry surface straggler
    re-plans read."""
    slicer = PIECE_PROFILERS.get(kernel.leaf_name)
    if slicer is None:
        raise NotImplementedError(
            f"no per-piece profiler for leaf {kernel.leaf_name}; "
            f"supported: {sorted(PIECE_PROFILERS)}")
    leaf, piece_args = slicer(kernel)
    dev = kernel.device
    n = len(piece_args)
    secs = np.full(n, np.inf)
    for args in piece_args:                      # warm every shape
        for _ in range(max(warmup, 1)):
            leaf(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    for _ in range(max(iters, 1)):
        for p, args in enumerate(piece_args):
            with telemetry.span("execute.piece", piece=p,
                                leaf=kernel.leaf_name) as sp:
                dt = _timed(leaf, args, dev)
                sp.set(seconds=dt)
            secs[p] = min(secs[p], dt)
    for s in secs:
        telemetry.METRICS.observe("executor.piece_seconds", float(s))
    prof = PieceProfile(leaf_name=kernel.leaf_name, seconds=secs)
    telemetry.METRICS.gauge("executor.piece_skew", prof.skew())
    return prof


# -- Comm/compute overlap ---------------------------------------------------
#
# Double-buffered shard transfers. The dense co-operand of an SpMM is
# consumed in column chunks; while the kernel contracts chunk t-1 on the
# compute stream, chunk t's host-to-device copy is already in flight on the
# copy stream (collectives.prefetch). Column chunking is bit-for-bit exact —
# every output element's k-reduction runs in the same order as the
# unchunked kernel; chunks are independent output-column lanes
# concatenated at the end.

#: Leaves whose dense operand reaches the kernel as the device copy the
#: emitter caches, under the key (and arranged as) given here. The bcsr
#: paths re-pack on the host, which would force the transferred chunk back
#: through host memory and defeat the double buffering.
_OVERLAP_OPERAND = {
    "spmm_rows": (("vals",), lambda v: v),
    "spmm_nnz": (("vals",), lambda v: v),
    "spmm_grid_rows": (("grid_flat", "mat"),
                       lambda v: v.reshape(-1, v.shape[-1])),
}
_OVERLAP_LEAVES = tuple(_OVERLAP_OPERAND)


def _chunk_bounds(J: int, chunks: int):
    """Equal-width column chunks (last takes the remainder) — at most two
    distinct widths, so the runner caches hold at most two entries per
    leaf regardless of chunk count."""
    chunks = max(1, min(int(chunks), int(J)))
    cw = -(-int(J) // chunks)
    return [(s, min(int(J), s + cw)) for s in range(0, int(J), cw)]


def run_overlapped(kernel: LoweredKernel, chunks: int = 2,
                   overlap: bool = True) -> torch.Tensor:
    """Execute an SpMM kernel with double-buffered dense-operand chunks.

    Pipelined loop: issue chunk t's copy, compute chunk t-1 (the copy
    rides under it), wait for the copy, emit chunk t's runner against the
    landed device arrays. ``overlap=False`` runs the same chunking
    sequentially (issue, wait, compute) — the baseline; both orders return
    bit-for-bit identical results (and identical to ``kernel.run()``), as
    a tensor on the kernel's device.

    Per-chunk attribution lands as ``execute.overlap.chunk`` instants
    (comm_s, hidden_s, bytes) under one ``execute.overlap`` span, rolled
    up by :func:`repro_torch.runtime.telemetry.overlap_report`; byte
    totals are mirrored into ``kernel.comm.overlap_total_bytes`` /
    ``overlap_hidden_bytes`` (attribution only — never added to
    ``total_network_bytes``). ``comm_s`` runs from the issue to the copy
    event's completion; ``hidden_s`` is the part of it spent under the
    previous chunk's compute, clamped to ``comm_s``.
    """
    from ..core import grid as grid_mod
    from ..core.tensor import Tensor
    from .collectives import prefetch, wait

    if kernel.leaf_name not in _OVERLAP_LEAVES:
        raise NotImplementedError(
            f"run_overlapped supports leaves {_OVERLAP_LEAVES}; got "
            f"{kernel.leaf_name} (bcsr paths re-pack on host)")
    stmt = kernel.stmt
    strat = kernel.strategy
    dev = kernel.device
    _, Cacc = stmt.rhs.accesses()
    cname = Cacc.tensor.name
    oname = stmt.lhs.tensor.name
    cplan = kernel.plans[cname]
    if not cplan.replicated and cplan.grid is None \
            and cplan.root_coord_bounds is None:
        raise NotImplementedError(
            "run_overlapped chunks the dense operand by columns; a "
            "column-partitioned operand's bounds would change per chunk")
    key, arrange = _OVERLAP_OPERAND[kernel.leaf_name]
    Cfull = np.asarray(cplan.tensor.to_dense(), np.float32)
    n, J = (int(d) for d in stmt.lhs.tensor.shape)
    bounds = _chunk_bounds(J, chunks)

    def prep(c0, c1):
        """Host-side pack of one chunk's shard (NOT the transfer), pinned
        on a card so the copy can run asynchronously."""
        Ct = Tensor.from_dense(cname, np.ascontiguousarray(Cfull[:, c0:c1]))
        plan_t = dataclasses.replace(cplan, tensor=Ct)
        hs = L._materialize_dense_operand(Ct, plan_t, strat.pieces,
                                          cache=False)
        host = torch.from_numpy(np.ascontiguousarray(
            arrange(hs.arrays["vals"])))
        if dev.type == "cuda":
            host = host.pin_memory()
        return Ct, plan_t, hs, host, host.numel() * host.element_size()

    def build(c0, c1, Ct, plan_t, hs, landed):
        """Emit the chunk runner against the landed device arrays."""
        hs.device_arrays[key + (str(dev),)] = landed[0]
        Ot = Tensor.zeros_dense(oname, (n, c1 - c0))
        cstmt = stmt.with_tensors({cname: Ct, oname: Ot})
        plans = dict(kernel.plans)
        plans[cname] = plan_t
        if oname in plans:
            plans[oname] = dataclasses.replace(plans[oname], tensor=Ot)
        shards = dict(kernel.shards)
        shards[cname] = hs
        if getattr(strat, "is_grid", False) and strat.space == "universe":
            gp = grid_mod.compute_grid_plan(cstmt, strat)
            _, runner, args = grid_mod._emit_grid(cstmt, gp, shards, dev)
        else:
            _, runner, args = L._emit(cstmt, strat, plans, shards, dev)
        return lambda: runner(*args)

    def compute(runner):
        out = runner()
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        return out

    def landed_at(handle):
        if handle.event is not None:
            handle.event.synchronize()
        return time.perf_counter()

    results = [None] * len(bounds)
    total_comm = total_hidden = 0.0
    total_bytes = hidden_bytes = 0
    with telemetry.span("execute.overlap", leaf=kernel.leaf_name,
                        chunks=len(bounds), overlap=bool(overlap)) as osp:
        if not overlap or len(bounds) == 1:
            for t, (c0, c1) in enumerate(bounds):
                Ct, plan_t, hs, host, nb = prep(c0, c1)
                t0 = time.perf_counter()
                with telemetry.span("execute.overlap.xfer", chunk=t,
                                    bytes=nb):
                    handle = prefetch((host,), dev)
                    landed = wait(handle)
                    comm = max(landed_at(handle) - t0, 1e-9)
                runner = build(c0, c1, Ct, plan_t, hs, landed)
                with telemetry.span("execute.overlap.compute", chunk=t):
                    results[t] = compute(runner)
                telemetry.instant("execute.overlap.chunk", chunk=t,
                                  comm_s=comm, hidden_s=0.0, bytes=nb)
                total_comm += comm
                total_bytes += nb
        else:
            preps = [prep(c0, c1) for (c0, c1) in bounds]
            pending = None                # (chunk index, emitted runner)
            for t in range(len(bounds) + 1):
                inflight = None
                if t < len(bounds):
                    Ct, plan_t, hs, host, nb = preps[t]
                    t_issue = time.perf_counter()
                    with telemetry.span("execute.overlap.xfer", chunk=t,
                                        bytes=nb):
                        handle = prefetch((host,), dev)   # async copy
                    inflight = (t, Ct, plan_t, hs, handle, t_issue, nb)
                t_comp_end = None
                if pending is not None:
                    pt, runner = pending
                    with telemetry.span("execute.overlap.compute",
                                        chunk=pt):
                        results[pt] = compute(runner)
                    t_comp_end = time.perf_counter()
                    pending = None
                if inflight is not None:
                    ct, Ct, plan_t, hs, handle, t_issue, nb = inflight
                    landed = wait(handle)
                    comm = max(landed_at(handle) - t_issue, 1e-9)
                    hid = 0.0
                    if t_comp_end is not None:
                        hid = min(max(t_comp_end - t_issue, 0.0), comm)
                    telemetry.instant("execute.overlap.chunk", chunk=ct,
                                      comm_s=comm, hidden_s=hid, bytes=nb)
                    total_comm += comm
                    total_hidden += hid
                    total_bytes += nb
                    hidden_bytes += int(nb * (hid / comm))
                    c0, c1 = bounds[ct]
                    pending = (ct, build(c0, c1, Ct, plan_t, hs, landed))
        eff = (total_hidden / total_comm) if total_comm > 0 else 0.0
        osp.set(comm_s=total_comm, hidden_s=total_hidden, efficiency=eff)
    telemetry.METRICS.counter("executor.overlap.comm_seconds", total_comm)
    telemetry.METRICS.counter("executor.overlap.hidden_seconds",
                              total_hidden)
    telemetry.METRICS.counter("executor.overlap.bytes", float(total_bytes))
    telemetry.METRICS.counter("executor.overlap.hidden_bytes",
                              float(hidden_bytes))
    telemetry.METRICS.gauge("executor.overlap.efficiency", eff)
    kernel.comm.overlap_total_bytes += total_bytes
    kernel.comm.overlap_hidden_bytes += hidden_bytes
    return torch.cat(results, 1)


def spmm_grid_rows_overlap_spmd(kernel: LoweredKernel, mesh: Mesh,
                                axis: str = "x", chunks: int = 2):
    """Overlapped 2-D SpMM: the SUMMA of :func:`spmm_grid_rows_spmd`, but
    the dense k-window is consumed in column chunks: chunk t's y-axis
    gather is issued asynchronously and runs while chunk t+1's kernel
    executes. Bit-for-bit the unchunked builder: column chunks are
    independent output lanes, and each lane's sum over y keeps its
    order."""
    ax, ay = _grid_axes(mesh)
    B, C = _operands(kernel)
    out_shape = tuple(kernel.stmt.lhs.tensor.shape)
    a = B.arrays
    dev = mesh.device
    (p, q), g = _tile(kernel, mesh, (ax, ay))
    bounds = tuple(_chunk_bounds(int(out_shape[1]), chunks))
    Cq = C.arrays["vals"][q]
    local = _grid_rows_inputs(kernel, g, dev) + tuple(
        _local(C, ("chunk", c0, c1), q, dev,
               lambda c0=c0, c1=c1: np.ascontiguousarray(Cq[:, c0:c1]))
        for c0, c1 in bounds)

    def build():
        def fn(mesh, local, meta):
            pos, crd, vals = local[:3]
            pending = []
            for Cc in local[3:]:
                # chunk t's gather runs while chunk t+1's kernel does
                y = spmm_kernels.spmm_csr_rows(pos, crd, vals, Cc)
                pending.append(col.gather_parts(y[0], mesh, ay,
                                                async_op=True))
            outs = []
            for work, parts in pending:
                if work is not None:
                    work.wait()
                outs.append(col.sum_parts(parts))
            stack = torch.stack(col.gather_parts(torch.cat(outs, -1), mesh,
                                                 ax))
            return L._scatter_rows(out_shape, stack, *meta)
        return fn

    run = _spmd_runner("spmm_grid_rows_overlap", mesh, (ax, ay),
                       (bounds,) + out_shape,
                       (*_grid_tiles(kernel), C.arrays["vals"]), build)
    meta = (a["row_start"], a["row_count"])

    def call():
        return run(mesh, local, meta)

    call.leaf = lambda: [spmm_kernels.spmm_csr_rows(*local[:3], Cc)
                         for Cc in local[3:]]
    call.kernel = "spmm_csr_rows"
    call.launches = len(bounds)
    return call


OVERLAP_SPMD_BUILDERS: Dict[str, Callable] = {
    "spmm_grid_rows": spmm_grid_rows_overlap_spmd,
}
