"""SpAdd3 ``A(i,j) = B(i,j) + C(i,j) + D(i,j)``, scalar and blocked, for
both distribution strategies.

Hopper kernels (``csrc/spadd3.cu``), each with its plain PyTorch version
beside it; a wrapper runs the plain version only when its inputs lie on the
CPU, and on a CUDA tensor it launches the kernel or raises:

- :func:`spadd3_dense_rows` / :func:`bcsr_spadd3_dense_rows`: the dense sum
  of three CSR (or BCSR) matrices, reached through ``ops.spadd3_dense`` /
  ``ops.spadd3_bcsr_dense``. They replace the TPU kernels
  ``repro/kernels/spadd3.py::spadd3_dense_tiles`` and
  ``repro/kernels/bcsr.py::bcsr_spadd3``.
- :func:`spadd3_union_rows` / :func:`bcsr_spadd3_union_rows`: the rows
  strategy's leaf, the union of the three operands' row shards written as
  one CSR on the card (task bounds and count, scan, fill; a warp merges
  a unit of up to 32 consecutive tasks of about ``TASK`` entries).
- :func:`spadd3_union_nnz` / :func:`bcsr_spadd3_union_nnz`: the nnz
  strategy's leaf, the runs of equal coordinates of the concatenated add
  stream summed per chunk, then across chunks. :func:`plan_runs` sorts the
  stream's coordinates into those runs once, at lower time.

The union kernels compute in compressed form what the reference's lowered
leaves (``leaf_spadd3_rows``, ``leaf_spadd_union_chunk`` and their blocked
twins) compute; the scalar and blocked wrappers share one kernel each and
differ in the tile size and their launch counts.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core import formats as fmt
from . import ref
from ._build import check_launch, library, on_cpu

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # pos1, crd1, v1, pos2, crd2, v2, pos3, crd3, v3, out, n_brows, n_rows,
    # n_cols, br, bc, stream
    "spadd3_dense": (_P,) * 10 + (_I, _L, _L, _I, _I, _P),
    # (pos, crd, vals, N) x 3, P, R, tile, task, task_off, unit_at, T,
    # n_units, trow, tbeg, tend, tunit, ufirst, cnt, out_off, out_crd,
    # out_vals, fill, stream
    "spadd3_union_rows": (_P, _P, _P, _L) * 3 + (_I, _I, _I, _L, _P, _P, _L,
                                                  _L) + (_P,) * 9 + (_I, _P),
    # vals, perm, seg_ptr, run_ptr, out, U, tile, stream
    "spadd3_union_runs": (_P,) * 5 + (_L, _I, _P),
}
TASK = 256     # input entries per merge task of the rows union kernel
MIN_WEIGHT = TASK // 32   # a row's least weight in the split into units


def supports(format: "fmt.Format", space: str) -> bool:
    """Format-dispatch query of core.lower. The union leaves iterate every
    operand in row order, so universe needs the row-window view of each
    (CSC and BCSC through the transpose walk); the nnz strategy splits the
    concatenated entry stream, which any 2-D sparse format can feed.
    Blocked operands union whole (br, bc) tiles; core.lower refuses addends
    whose formats or block shapes differ."""
    return fmt.supports_2d_default(format, space)


def _operands(name, pos1, crd1, v1, pos2, crd2, v2, pos3, crd3, v3):
    """Check three (pos, crd, vals) triples; True when they lie on the
    CPU."""
    trip = ((pos1, crd1, v1), (pos2, crd2, v2), (pos3, crd3, v3))
    tail = v1.shape[crd1.dim():]
    for pos, crd, v in trip:
        if pos.dim() != crd.dim() or v.shape[:crd.dim()] != crd.shape \
                or v.shape[crd.dim():] != tail \
                or pos.shape[:-1] != pos1.shape[:-1] \
                or crd.shape[:-1] != crd1.shape[:-1]:
            raise ValueError(
                f"{name}: bad shapes " + ", ".join(
                    f"pos {tuple(p.shape)} crd {tuple(c.shape)} "
                    f"vals {tuple(x.shape)}" for p, c, x in trip))
    return on_cpu(name, {f"{k}{i}": t for i, (p, c, _) in enumerate(trip, 1)
                         for k, t in (("pos", p), ("crd", c))},
                  {f"vals{i}": x for i, (_, _, x) in enumerate(trip, 1)})


# ---------------------------------------------------------------------------
# Dense: the TPU kernels' function
# ---------------------------------------------------------------------------

def _dense(name, pos1, crd1, v1, pos2, crd2, v2, pos3, crd3, v3,
           n_rows: int, n_cols: int, plain):
    br, bc = (v1.shape[1], v1.shape[2]) if v1.dim() == 3 else (1, 1)
    n_brows = -(-n_rows // br)
    if pos1.dim() != 1 or pos1.shape[0] != n_brows + 1:
        raise ValueError(f"{name}: pos must be ({n_brows + 1},) for "
                         f"{n_rows} rows in blocks of {br}, got "
                         f"{tuple(pos1.shape)}")
    if _operands(name, pos1, crd1, v1, pos2, crd2, v2, pos3, crd3, v3):
        return plain(pos1, crd1, v1, pos2, crd2, v2, pos3, crd3, v3,
                     n_rows, n_cols)
    out = torch.empty((n_rows, n_cols), dtype=torch.float32,
                      device=v1.device)
    if n_rows * n_cols == 0:
        return out                     # nothing to launch: an empty output
    with torch.cuda.device(v1.device):
        err = library("spadd3", _SIGNATURES).spadd3_dense(
            *(t.data_ptr() for t in (pos1, crd1, v1, pos2, crd2, v2,
                                     pos3, crd3, v3, out)),
            n_brows, n_rows, n_cols, br, bc,
            torch.cuda.current_stream().cuda_stream)
    check_launch(name, err)
    return out


def spadd3_dense_rows_plain(pos1, crd1, v1, pos2, crd2, v2, pos3, crd3, v3,
                            n_rows: int, n_cols: int):
    return ref.leaf_spadd3_dense_rows(pos1, crd1, v1, pos2, crd2, v2,
                                      pos3, crd3, v3, n_cols)[:n_rows]


def spadd3_dense_rows(pos1, crd1, v1, pos2, crd2, v2, pos3, crd3, v3,
                      n_rows: int, n_cols: int) -> torch.Tensor:
    """Dense (n_rows, n_cols) = B + C + D from three CSR triples (pos
    (n_rows + 1,), crd, vals). Contract of the kernel: the columns within
    one row of one operand are distinct (``ops.spadd3_dense`` checks)."""
    return _dense("spadd3_dense_rows", pos1, crd1, v1, pos2, crd2, v2, pos3,
                  crd3, v3, n_rows, n_cols, spadd3_dense_rows_plain)


def bcsr_spadd3_dense_rows_plain(pos1, crd1, t1, pos2, crd2, t2, pos3, crd3,
                                 t3, n_rows: int, n_cols: int):
    grid_cols = -(-n_cols // t1.shape[2])
    return ref.leaf_bcsr_spadd3_dense(pos1, crd1, t1, pos2, crd2, t2, pos3,
                                      crd3, t3, grid_cols)[:n_rows, :n_cols]


def bcsr_spadd3_dense_rows(pos1, crd1, t1, pos2, crd2, t2, pos3, crd3, t3,
                           n_rows: int, n_cols: int) -> torch.Tensor:
    """Dense (n_rows, n_cols) = B + C + D from three BCSR triples of one
    block shape (pos over block-rows, block-column crd, (nb, br, bc)
    tiles); the padding of ragged boundary blocks is dropped. Contract: the
    block columns within one block-row of one operand are distinct."""
    return _dense("bcsr_spadd3_dense_rows", pos1, crd1, t1, pos2, crd2, t2,
                  pos3, crd3, t3, n_rows, n_cols,
                  bcsr_spadd3_dense_rows_plain)


# ---------------------------------------------------------------------------
# Rows strategy: the union of the stacked row shards
# ---------------------------------------------------------------------------

def _union_rows_plain(leaf, pos1, crd1, v1, pos2, crd2, v2, pos3, crd3, v3):
    P, R = pos1.shape[0], pos1.shape[1] - 1
    counts, crds, vals = [], [], []
    for p in range(P):
        rows, cols, v, k = leaf(pos1[p], crd1[p], v1[p], pos2[p], crd2[p],
                                v2[p], pos3[p], crd3[p], v3[p])
        k = int(k)
        counts.append(torch.bincount(rows[:k].long(), minlength=R))
        crds.append(cols[:k])
        vals.append(v[:k])
    row_pos = torch.zeros(P * R + 1, dtype=torch.int64, device=pos1.device)
    if P * R:
        torch.cumsum(torch.cat(counts), 0, out=row_pos[1:])
    return row_pos, torch.cat(crds), torch.cat(vals)


def spadd3_union_rows_plain(*args):
    return _union_rows_plain(
        lambda *a: ref.leaf_spadd3_rows(*a, n_cols=0), *args)


def bcsr_spadd3_union_rows_plain(*args):
    return _union_rows_plain(ref.leaf_bcsr_spadd3_rows, *args)


def _union_rows(name, pos1, crd1, v1, pos2, crd2, v2, pos3, crd3, v3, plain
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if pos1.dim() != 2:
        raise ValueError(f"{name}: pos must be (P, R + 1), got "
                         f"{tuple(pos1.shape)}")
    if _operands(name, pos1, crd1, v1, pos2, crd2, v2, pos3, crd3, v3):
        return plain(pos1, crd1, v1, pos2, crd2, v2, pos3, crd3, v3)
    P, R = pos1.shape[0], pos1.shape[1] - 1
    tile_shape = tuple(v1.shape[2:])
    tile = int(torch.Size(tile_shape).numel())
    dev = v1.device
    lens = sum((p[:, 1:] - p[:, :-1]).long() for p in (pos1, pos2, pos3))
    n_tasks = ((lens + TASK - 1) // TASK).flatten()
    # a warp merges the tasks of one unit, TASK nominal entries: a row's
    # tasks lie TASK apart and rows at least MIN_WEIGHT apart, so no unit
    # holds more than 32 tasks
    weight = torch.where(n_tasks > 0, torch.maximum(
        lens.flatten(), (n_tasks - 1) * TASK + MIN_WEIGHT), 0)
    task_off = torch.zeros(P * R + 1, dtype=torch.int64, device=dev)
    unit_at = torch.zeros(P * R + 1, dtype=torch.int64, device=dev)
    if P * R:
        torch.cumsum(n_tasks, 0, out=task_off[1:])
        torch.cumsum(weight, 0, out=unit_at[1:])
    T, span = torch.stack([task_off[-1], unit_at[-1]]).tolist()
    if T == 0:                         # nothing to launch: no stored entry
        return (task_off, torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros((0,) + tile_shape, dtype=torch.float32,
                            device=dev))
    n_units = -(-span // TASK)
    if P * R >= 2**31 or T >= 2**31 or n_units >= 2**31:
        raise ValueError(f"{name}: {P}x{R} rows and {T} merge tasks "
                         "overflow the kernel's int32 indices")
    trow = torch.empty(T, dtype=torch.int32, device=dev)
    tunit = torch.empty_like(trow)
    tbeg = torch.empty((T, 3), dtype=torch.int32, device=dev)
    tend = torch.empty_like(tbeg)
    ufirst = torch.full((n_units,), -1, dtype=torch.int32, device=dev)
    cnt = torch.empty(T, dtype=torch.int32, device=dev)
    out_off = torch.zeros(T + 1, dtype=torch.int64, device=dev)
    lib = library("spadd3", _SIGNATURES)
    head = [x for trip in ((pos1, crd1, v1), (pos2, crd2, v2),
                           (pos3, crd3, v3))
            for x in (*(t.data_ptr() for t in trip), trip[1].shape[1])]
    head += [P, R, tile, TASK, task_off.data_ptr(), unit_at.data_ptr(), T,
             n_units] + [x.data_ptr() for x in (trow, tbeg, tend, tunit,
                                                ufirst)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.spadd3_union_rows(*head, cnt.data_ptr(), None, None, None,
                                    0, stream)
        if err == 0:
            torch.cumsum(cnt, 0, out=out_off[1:])
            U = int(out_off[-1])
            crd = torch.empty(U, dtype=torch.int32, device=dev)
            vals = torch.empty((U,) + tile_shape, dtype=torch.float32,
                               device=dev)
            err = lib.spadd3_union_rows(*head, None, out_off.data_ptr(),
                                        crd.data_ptr(), vals.data_ptr(), 1,
                                        stream)
    check_launch(name, err)
    return out_off[task_off], crd, vals


def spadd3_union_rows(pos1, crd1, v1, pos2, crd2, v2, pos3, crd3, v3):
    """The union B + C + D of three stacked CSR row shards (pos (P, R + 1)
    piece-local, crd and vals (P, N_t)), as one CSR over the P·R rows:
    (row_pos (P·R + 1,) int64, crd (U,), vals (U,)), each row's columns
    increasing, duplicates summed as (B + C) + D. Contract: columns are
    non-decreasing within each row (the lowered path sorts a shard that is
    not); ``pos`` reads only inside each row's range, so padding slots and
    rows past a piece's window (empty ranges) are never read."""
    return _union_rows("spadd3_union_rows", pos1, crd1, v1, pos2, crd2, v2,
                       pos3, crd3, v3, spadd3_union_rows_plain)


def bcsr_spadd3_union_rows(pos1, crd1, t1, pos2, crd2, t2, pos3, crd3, t3):
    """:func:`spadd3_union_rows` over stacked BCSR block-row shards: block
    columns merge, duplicate blocks sum their (br, bc) tiles; vals is
    (U, br, bc)."""
    return _union_rows("bcsr_spadd3_union_rows", pos1, crd1, t1, pos2, crd2,
                       t2, pos3, crd3, t3, bcsr_spadd3_union_rows_plain)


# ---------------------------------------------------------------------------
# Nnz strategy: runs of the add stream, planned at lower time
# ---------------------------------------------------------------------------

def plan_runs(dim0: torch.Tensor, dim1: torch.Tensor,
              nnz_count: torch.Tensor, shape: Tuple[int, int],
              root_dim: int = 0):
    """The run structure of an add stream (``materialize_add_stream``'s
    (P, C) chunks ``dim0``/``dim1``, ``nnz_count`` real entries each), made
    once at lower time on the stream's device. The entries are sorted
    stably by their (root, other) coordinates with an int64 key over
    ``shape`` (root = dimension ``root_dim``, the output's storage order),
    so each run of equal coordinates lists its entries chunk by chunk in
    stream order. Returns (perm, seg_ptr, run_ptr, pos, crd), int32:
    ``perm`` the stream slots (p·C + e) in that order, ``seg_ptr`` the
    bounds of each run's per-chunk segments, ``run_ptr`` each run's
    segments, and the output's compressed levels ``pos`` (shape[root] + 1)
    and ``crd`` (one per run)."""
    P, C = dim0.shape
    if P * C >= 2**31:
        raise ValueError(f"add stream of {P}x{C} slots: int32 slot ids "
                         "overflow")
    dev = dim0.device
    valid = (torch.arange(C, device=dev)[None, :]
             < nnz_count.to(dev).long()[:, None]).flatten()
    slot = torch.nonzero(valid).squeeze(1)
    dims = (dim0.flatten()[slot].long(), dim1.flatten()[slot].long())
    n_root, n_other = shape[root_dim], shape[1 - root_dim]
    key, order = torch.sort(dims[root_dim] * n_other + dims[1 - root_dim],
                            stable=True)
    perm = slot[order]
    new_run = torch.ones_like(key, dtype=torch.bool)
    new_run[1:] = key[1:] != key[:-1]
    new_seg = new_run.clone()
    chunk = perm // C
    new_seg[1:] |= chunk[1:] != chunk[:-1]
    seg_start = torch.nonzero(new_seg).squeeze(1)
    end = torch.tensor([key.shape[0]], device=dev)
    seg_ptr = torch.cat([seg_start, end])
    run_ptr = torch.cat([torch.nonzero(new_run[seg_start]).squeeze(1),
                         torch.tensor([seg_start.shape[0]], device=dev)])
    ukey = key[new_run]
    pos = torch.zeros(n_root + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(ukey // n_other, minlength=n_root), 0,
                 out=pos[1:])
    return tuple(x.int() for x in (perm, seg_ptr, run_ptr, pos,
                                   ukey % n_other))


def union_runs_plain(vals, perm, seg_ptr, run_ptr):
    """(U, *tile) sums of ``vals`` (P, C, *tile) over the planned runs:
    each chunk segment in stream order, then the segments in order."""
    flat = vals.reshape((-1,) + tuple(vals.shape[2:]))
    v = flat[perm.long()]
    seg = torch.repeat_interleave(
        torch.arange(seg_ptr.shape[0] - 1, device=v.device),
        (seg_ptr[1:] - seg_ptr[:-1]).long())
    parts = ref._segment_sum(v, seg, seg_ptr.shape[0] - 1)
    run = torch.repeat_interleave(
        torch.arange(run_ptr.shape[0] - 1, device=v.device),
        (run_ptr[1:] - run_ptr[:-1]).long())
    return ref._segment_sum(parts, run, run_ptr.shape[0] - 1)


def _union_runs(name, vals, perm, seg_ptr, run_ptr):
    if vals.dim() < 2 or perm.dim() != 1 or seg_ptr.dim() != 1 \
            or run_ptr.dim() != 1:
        raise ValueError(f"{name}: bad shapes vals {tuple(vals.shape)} "
                         f"perm {tuple(perm.shape)} seg_ptr "
                         f"{tuple(seg_ptr.shape)} run_ptr "
                         f"{tuple(run_ptr.shape)}")
    if on_cpu(name, {"perm": perm, "seg_ptr": seg_ptr, "run_ptr": run_ptr},
              {"vals": vals}):
        return union_runs_plain(vals, perm, seg_ptr, run_ptr)
    tile_shape = tuple(vals.shape[2:])
    tile = int(torch.Size(tile_shape).numel())
    U = run_ptr.shape[0] - 1
    out = torch.empty((U,) + tile_shape, dtype=torch.float32,
                      device=vals.device)
    if U * tile == 0:
        return out                     # nothing to launch: an empty union
    with torch.cuda.device(vals.device):
        err = library("spadd3", _SIGNATURES).spadd3_union_runs(
            vals.data_ptr(), perm.data_ptr(), seg_ptr.data_ptr(),
            run_ptr.data_ptr(), out.data_ptr(), U, tile,
            torch.cuda.current_stream().cuda_stream)
    check_launch(name, err)
    return out


def spadd3_union_nnz(vals, perm, seg_ptr, run_ptr):
    """The nnz leaf: (U,) run sums of the add stream's values ``vals``
    (P, C) over the runs :func:`plan_runs` made."""
    return _union_runs("spadd3_union_nnz", vals, perm, seg_ptr, run_ptr)


def bcsr_spadd3_union_nnz(tiles, perm, seg_ptr, run_ptr):
    """The blocked nnz leaf: (U, br, bc) run sums of the block stream's
    tiles (P, C, br, bc)."""
    return _union_runs("bcsr_spadd3_union_nnz", tiles, perm, seg_ptr,
                       run_ptr)
