"""Multi-axis (grid) distribution: 2-D and 3-D processor grids.

SpDISTAL's ``distribute((i, k, …) → (x, y, …))`` maps SEVERAL index
variables onto a multi-dimensional machine grid (the DISTAL machine
abstraction, paper §II-C / Fig. 4c), with communication planned per grid
axis:

- :class:`GridPlan`: the per-axis universe splits and the cross-product
  tile map: color ``(p, q)`` owns row window ``p`` × column window ``q``
  of the distributed sparse operand (block-aligned when it is blocked);
  order-3 grids add a third window axis: bricks ``(p, q, r)`` for order-3
  operands, nested column splits (one loop variable divided onto two
  machine axes), and the REPLICATED 2.5-D schedules where the sparse
  operand keeps its (P, Q) tiles and the third axis splits a loop
  variable that does not index it.
- **Per-axis communication planning** (``grid_axis_bytes``): an operand
  is sliced by the machine axes its distributed index variables ride;
  along every OTHER axis it is broadcast, hierarchically in grid order.
  Output partials all-reduce along exactly the axes whose distributed
  variable is a reduction variable. This is SUMMA specialized to sparse
  operands (a 2-D SpMM at P×Q pieces moves ``|C|·(P−1) + |A|·(Q−1)``
  bytes versus 1-D's ``|C|·(PQ−1)``) and, with replication, the
  communication-avoiding 2.5-D tradeoff.
- **Grid emitters**: SpMV / SpMM / SDDMM tiles (scalar and blocked),
  k-replicated SpMM / SDDMM, brick SpMTTKRP and nested-column SpAdd3, on
  the 1-D path's Hopper kernels (their plain versions on the CPU). A tile
  (p, q) reads window q of a dense co-operand: the window stack is
  flattened once at lower time, ``(Q, max_w, …)`` to ``(Q·max_w, …)``, and
  each tile's window-local coordinates are offset by ``q·max_w`` on the
  device, so every tile of the grid runs in ONE launch of the 1-D kernel.
  The partials of a grid row sum over q in one fixed order with torch ops,
  so a run repeats bit for bit.

Grid NON-ZERO schedules do not pass through here: a nested pos-split
canonicalizes to the flat equal split of the fused position space, so
``core.lower`` runs them through the 1-D nnz machinery at ``P*Q(*R)``
pieces (bit for bit their ``Px1`` counterparts) and only re-attributes
the communication to the axes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from . import formats as F
from . import lower as L
from ..runtime import telemetry
from .partition import (Bounds, ShardedTensor, TensorPartition,
                        block_aligned_row_bounds, materialize_bcsr_grid,
                        materialize_coo3_grid, materialize_csr_grid,
                        materialize_dense_cols, materialize_dense_grid,
                        materialize_dense_rows, materialize_replicated,
                        partition_by_bounds, partition_tensor_cols,
                        partition_tensor_grid, partition_tensor_grid3,
                        partition_tensor_rows, replicate_tensor)
from .schedule import DistStrategy
from .tdn import Machine
from .tensor import Tensor
from .tin import Assignment
from ..kernels import bcsr as bcsr_kernels
from ..kernels import ref as K
from ..kernels import sddmm as sddmm_kernels
from ..kernels import spadd3 as spadd3_kernels
from ..kernels import spmm as spmm_kernels
from ..kernels import spmttkrp as spmttkrp_kernels
from ..kernels import spmv as spmv_kernels
from ..kernels.layout import pack_rowwindow_blocks


@dataclasses.dataclass
class GridPlan:
    """Per-axis splits + the cross-product tile map of a grid distribution.

    ``row_bounds`` (P, 2) splits the first distributed variable's universe,
    ``col_bounds`` (Q, 2) the second's; the flat color of tile ``(p, q)``
    is ``p * Q + q`` (row-major), the convention every grid shard set and
    emitter shares. Order-3 grids add ``dep_bounds`` (R, 2) — the third
    distributed variable's windows — with flat color ``(p*Q + q)*R + r``;
    ``nested`` marks plans whose column windows are the JOINT y×z split of
    one variable divided twice (``col_bounds`` then has Q·R windows);
    ``replicate`` carries the strategy's (tensor, axis) replication pairs
    (the replicated operand keeps 2-D (P, Q) tiles shared across z). Only
    universe strategies flow through a GridPlan — grid nnz schedules
    canonicalize to the flat 1-D split (module docstring)."""

    axis_x: str
    axis_y: str
    row_bounds: Bounds                # (P, 2) over extent(vars[0])
    col_bounds: Bounds                # (Q, 2) over extent(vars[1])
    axis_z: Optional[str] = None
    dep_bounds: Optional[Bounds] = None   # (R, 2) over extent(vars[2])
    replicate: Tuple[Tuple[str, str], ...] = ()
    nested: Optional[Tuple[int, int]] = None  # (Q, R) of a joint col split

    @property
    def P(self) -> int:
        return int(self.row_bounds.shape[0])

    @property
    def Q(self) -> int:
        return int(self.col_bounds.shape[0])

    @property
    def R(self) -> int:
        return 1 if self.dep_bounds is None else int(self.dep_bounds.shape[0])

    @property
    def pieces(self) -> int:
        return self.P * self.Q * self.R

    def tile_windows(self):
        """Yield ``(p, q, (rlo, rhi), (clo, chi))`` in flat-color order."""
        for p in range(self.P):
            for q in range(self.Q):
                yield (p, q,
                       (int(self.row_bounds[p, 0]), int(self.row_bounds[p, 1])),
                       (int(self.col_bounds[q, 0]), int(self.col_bounds[q, 1])))

    def tile_windows3(self):
        """Yield ``(p, q, r, rw, cw, dw)`` in flat-color order (3-D plans)."""
        for p in range(self.P):
            for q in range(self.Q):
                for r in range(self.R):
                    yield (p, q, r,
                           (int(self.row_bounds[p, 0]),
                            int(self.row_bounds[p, 1])),
                           (int(self.col_bounds[q, 0]),
                            int(self.col_bounds[q, 1])),
                           (int(self.dep_bounds[r, 0]),
                            int(self.dep_bounds[r, 1])))

    @staticmethod
    def _check_axis(bounds: Bounds, n: int, label: str) -> None:
        if bounds[0, 0] != 0 or bounds[-1, 1] != n:
            raise AssertionError(f"{label} windows do not span [0, {n})")
        for w in range(bounds.shape[0]):
            if bounds[w, 0] > bounds[w, 1]:
                raise AssertionError(f"negative {label} window {w}")
            if w and bounds[w, 0] != bounds[w - 1, 1]:
                raise AssertionError(
                    f"{label} windows {w - 1}/{w} overlap or gap")

    def validate(self, n_rows: int, n_cols: int,
                 n_dep: Optional[int] = None) -> None:
        """Tiling invariant: the grid tiles cover ``[0, n_rows) × [0,
        n_cols)`` (× ``[0, n_dep)`` for 3-D plans) exactly once — each
        axis's windows are sorted, disjoint, and gap-free."""
        self._check_axis(self.row_bounds, n_rows, "row")
        self._check_axis(self.col_bounds, n_cols, "col")
        if self.dep_bounds is not None:
            if n_dep is None:
                raise AssertionError(
                    "3-D plan validated without the third-axis extent")
            self._check_axis(self.dep_bounds, n_dep, "dep")

    def validate_coverage(self, part: TensorPartition,
                          shape: Tuple[int, ...]) -> None:
        """Per-operand coverage invariant, replication-aware: every
        dimension the partition windows must be tiled exactly once
        (sorted, disjoint, gap-free); a dimension with NO windows is
        replicated — every piece sees its full extent by construction —
        and legal only when the partition's color count divides the
        grid's (replica shards are shared across the leftover machine
        axes, not sliced by them). Applies to the window-structured grid
        partitions (tiles / bricks / dense grids / slices), whose levels
        follow dimension order."""
        for d, lp in enumerate(part.levels):
            if lp.coord_bounds is None:
                continue          # replicated / unsplit: full extent
            self._check_axis(lp.coord_bounds, shape[d], f"dim{d}")
        if part.pieces and self.pieces % part.pieces:
            raise AssertionError(
                f"operand colors ({part.pieces}) do not divide the machine "
                f"grid ({self.pieces}): replicas cannot be evenly shared")


def compute_grid_plan(stmt: Assignment, strat: DistStrategy) -> GridPlan:
    """Derive the per-axis universe splits for a grid universe strategy:
    equal splits of the distributed variables' extents, snapped to block
    boundaries when the distributed sparse operand is blocked (so every
    co-partitioned tensor shares the same per-color windows).

    Three-variable strategies dispatch on shape: three DISTINCT variables
    matching an order-3 sparse operand's leading dimensions → P×Q×R
    bricks; one variable divided onto two machine axes (vars ``(i, j,
    j)``) → nested column split (Q·R joint windows); otherwise the third
    variable does not index the sparse operand — a REPLICATED 2.5-D
    schedule, which must name the operand in ``strat.replicate``."""
    if not strat.is_grid or strat.space != "universe":
        raise ValueError("grid plan requires a multi-var universe strategy")
    if len(strat.vars) not in (2, 3):
        raise NotImplementedError(
            f"grid distribution supports 2 or 3 machine dimensions, got "
            f"{len(strat.vars)} distributed vars {strat.vars}")
    dx, dy = strat.machine_dims[0], strat.machine_dims[1]
    v0, v1 = strat.vars[0], strat.vars[1]
    spa = stmt.sparse_accesses()[0]
    Bt = spa.tensor
    n0, n1 = stmt.var_extent(v0), stmt.var_extent(v1)

    if len(strat.vars) == 3:
        dz, v2 = strat.machine_dims[2], strat.vars[2]
        if v1.name == v2.name:
            # nested column split: one variable rides both y and z — the
            # effective tiling is (P, Q·R), zero communication (spadd3)
            if tuple(spa.idx[:2]) != (v0, v1):
                raise NotImplementedError(
                    f"nested grid split must divide the sparse operand's "
                    f"leading variables, got ({v0}, {v1}) for {spa}")
            return GridPlan(
                axis_x=dx.name, axis_y=dy.name, axis_z=dz.name,
                row_bounds=partition_by_bounds(n0, dx.size),
                col_bounds=partition_by_bounds(n1, dy.size * dz.size),
                nested=(dy.size, dz.size))
        if len(spa.idx) >= 3 and tuple(spa.idx[:3]) == (v0, v1, v2):
            # order-3 bricks (spmttkrp)
            return GridPlan(
                axis_x=dx.name, axis_y=dy.name, axis_z=dz.name,
                row_bounds=partition_by_bounds(n0, dx.size),
                col_bounds=partition_by_bounds(n1, dy.size),
                dep_bounds=partition_by_bounds(stmt.var_extent(v2), dz.size))
        # replicated 2.5-D: v2 does not index the sparse operand — B keeps
        # its (P, Q) tiles, shared by every z-slice; replication must be
        # DECLARED, it is a schedule decision, not an inference
        if tuple(spa.idx[:2]) != (v0, v1):
            raise NotImplementedError(
                f"grid distribution must distribute the sparse operand's "
                f"first two index variables, got ({v0}, {v1}) for {spa}")
        rep = dict(strat.replicate)
        if rep.get(Bt.name) != dz.name:
            raise ValueError(
                f"3-var grid schedule: {v2} does not index the sparse "
                f"operand {Bt.name} — declare the replication explicitly "
                f"with .replicate([{Bt.name}], {dz.name})")
        if getattr(Bt.format, "is_blocked", False):
            raise NotImplementedError(
                "replicated 2.5-D schedules support scalar sparse formats")
        return GridPlan(
            axis_x=dx.name, axis_y=dy.name, axis_z=dz.name,
            row_bounds=partition_by_bounds(n0, dx.size),
            col_bounds=partition_by_bounds(n1, dy.size),
            dep_bounds=partition_by_bounds(stmt.var_extent(v2), dz.size),
            replicate=strat.replicate)

    if tuple(spa.idx[:2]) != (v0, v1):
        raise NotImplementedError(
            f"2-D grid distribution must distribute the sparse operand's "
            f"first two index variables, got ({v0}, {v1}) for {spa}")
    if getattr(Bt.format, "is_blocked", False):
        br, bc = Bt.format.block_shape
        row_bounds = block_aligned_row_bounds(n0, dx.size, br)
        col_bounds = block_aligned_row_bounds(n1, dy.size, bc)
    else:
        row_bounds = partition_by_bounds(n0, dx.size)
        col_bounds = partition_by_bounds(n1, dy.size)
    return GridPlan(axis_x=dx.name, axis_y=dy.name,
                    row_bounds=row_bounds, col_bounds=col_bounds)


def _var_dim_map(strat: DistStrategy) -> Dict[str, List[str]]:
    """Distributed variable name → the machine axes it rides (two axes for
    a nested divide)."""
    m: Dict[str, List[str]] = {}
    for v, d in zip(strat.vars, strat.machine_dims):
        m.setdefault(v.name, []).append(d.name)
    return m


def _sliced_dims(acc, strat: DistStrategy,
                 vdm: Dict[str, List[str]]) -> Set[str]:
    """Machine axes that SLICE this access — the communication key: along
    every other axis the operand is broadcast (shared by all colors of
    that axis). The distributed sparse operand is sliced by the axes of
    its matching leading variables; a dense operand by the axis of a
    distributed variable at position 0 (row windows, when dim 0 is the
    storage root) or position 1 (column windows, all-dense only)."""
    t = acc.tensor
    names = [v.name for v in acc.idx]
    vs = [v.name for v in strat.vars]
    if t.format.is_sparse and len(names) >= 2 and names[:2] == vs[:2]:
        sliced = set(vdm[names[0]]) | set(vdm[names[1]])
        if len(names) >= 3 and len(vs) >= 3 and names[2] == vs[2]:
            sliced |= set(vdm[names[2]])
        return sliced
    sliced: Set[str] = set()
    if names and names[0] in vdm and t.format.level_of_dim(0) == 0:
        sliced.add(vdm[names[0]][0])
    if len(names) > 1 and names[1] in vdm and t.format.is_all_dense:
        sliced.add(vdm[names[1]][-1])
    return sliced


def _axis_bounds(gp: GridPlan) -> Dict[str, Bounds]:
    b = {gp.axis_x: gp.row_bounds, gp.axis_y: gp.col_bounds}
    if gp.dep_bounds is not None:
        b[gp.axis_z] = gp.dep_bounds
    return b


def _grid_plans(stmt: Assignment, strat: DistStrategy, gp: GridPlan,
                ) -> Dict[str, TensorPartition]:
    """Fig. 9a steps 1 & 2 on a grid: the distributed sparse operand (and a
    sparse output sharing its index pattern) takes cross-product tiles /
    bricks; every other operand is sliced by whichever distributed
    variables index it — row windows, column windows, both (a dense
    grid), or neither (replication)."""
    vdm = _var_dim_map(strat)
    ab = _axis_bounds(gp)
    vs = [v.name for v in strat.vars]
    plans: Dict[str, TensorPartition] = {}
    for acc in stmt.accesses():
        t = acc.tensor
        if t.name in plans:
            continue
        names = [v.name for v in acc.idx]
        if t.format.is_sparse and len(names) >= 2 and names[:2] == vs[:2]:
            if (gp.dep_bounds is not None and not gp.replicate
                    and len(names) >= 3 and names[2] == vs[2]):
                plans[t.name] = partition_tensor_grid3(
                    t, gp.row_bounds, gp.col_bounds, gp.dep_bounds)
            else:
                # 2-D tiles: also the nested joint split (col_bounds is
                # the Q·R product) and the replicated operand's SHARED
                # (P, Q) tiling — the same partition, and therefore the
                # same SHARD_CACHE key, as the unreplicated 2-D plan
                plans[t.name] = partition_tensor_grid(
                    t, gp.row_bounds, gp.col_bounds)
            continue
        row_axis = col_axis = None
        if names and names[0] in vdm and t.format.level_of_dim(0) == 0:
            row_axis = vdm[names[0]][0]
        if len(names) > 1 and names[1] in vdm and t.format.is_all_dense:
            col_axis = vdm[names[1]][-1]
        if row_axis is not None and col_axis is not None:
            plans[t.name] = partition_tensor_grid(
                t, ab[row_axis], ab[col_axis])
        elif row_axis is not None:
            plans[t.name] = partition_tensor_rows(t, ab[row_axis])
        elif col_axis is not None:
            plans[t.name] = partition_tensor_cols(t, ab[col_axis])
        else:
            plans[t.name] = replicate_tensor(t, gp.pieces)
    return plans


def grid_axis_bytes(stmt: Assignment, strat: DistStrategy,
                    ) -> Dict[str, "L.AxisComm"]:
    """Per-axis byte formulas of a grid schedule, computed from the
    statement + strategy alone (no GridPlan / partitioning needed).

    Broadcast: walking the machine axes in grid order, an operand NOT
    sliced by an axis is broadcast along it; each such broadcast
    multiplies the copies every later broadcast axis must move (a fully
    replicated operand on a 2-D grid moves ``|t|`` along x, then ``P·|t|``
    along y — one copy per grid row). A replicated 2.5-D operand is
    sliced by x and y but not z, so it lands exactly ``|t|`` on z:
    network bytes ``|t|·(R−1)`` = payload × (replicas − 1).

    Reduce: output partials all-reduce along exactly the axes whose
    distributed variable is a reduction variable, hierarchically in grid
    order (spmttkrp bricks: ``|A|`` along y then ``Q·|A|`` along z).
    Replication REMOVES an axis from this set by splitting a
    non-reduction variable over it — the 2.5-D saving.

    This is both the ledger `lower_grid` records on the kernel and the
    estimator `core.plan_search` scores grid candidates with before
    committing to a plan."""
    dims = strat.machine_dims
    vdm = _var_dim_map(strat)
    out_name = stmt.lhs.tensor.name
    axes = {d.name: L.AxisComm(size=d.size) for d in dims}
    seen = set()
    for acc in stmt.accesses():
        t = acc.tensor
        if t.name in seen or t.name == out_name:
            continue
        seen.add(t.name)
        sliced = _sliced_dims(acc, strat, vdm)
        m = 1
        for d in dims:
            if d.name in sliced:
                continue
            axes[d.name].broadcast_bytes += m * L._nbytes(t)
            m *= d.size
    m = 1
    for d, v in zip(dims, strat.vars):
        if v in stmt.reduction_vars:
            axes[d.name].reduce_bytes += m * L._nbytes(stmt.lhs.tensor)
            m *= d.size
    return axes


def _grid_comm(stmt: Assignment, strat: DistStrategy,
               gp: GridPlan) -> L.CommStats:
    """Per-axis communication plan recorded on the kernel — the shared
    ``grid_axis_bytes`` formulas over the normalized statement (whose
    access tensors are exactly the planned tensors)."""
    comm = L.CommStats(pieces=gp.pieces)
    comm.axes = grid_axis_bytes(stmt, strat)
    return comm


# ---------------------------------------------------------------------------
# The grid lowering entry point (called from core.lower._lower_impl)
# ---------------------------------------------------------------------------

def lower_grid(stmt: Assignment, machine: Machine, strat: DistStrategy,
               device: torch.device, fallbacks, declared_formats, snap,
               distributions=None) -> "L.LoweredKernel":
    """Lower a grid universe schedule of the (already normalized)
    statement: the grid plan and its memoized operand partitions, the
    per-axis ledger, the tile / brick / window shards, and the grid
    emitter's runner on ``device``."""
    out_t: Tensor = stmt.lhs.tensor
    with telemetry.span("lower.plan", sig=stmt.signature(),
                        space=strat.space, pieces=strat.pieces,
                        grid=list(strat.grid_shape)):
        gp = compute_grid_plan(stmt, strat)

        plan_key = L._plan_cache_key(stmt, strat, None)
        plans = L._PLAN_CACHE.get(plan_key)
        telemetry.instant("lower.plan.cache", hit=plans is not None,
                          memoizable=True)
        if plans is not None:
            current: Dict[str, Tensor] = {}
            for acc in stmt.accesses():
                current.setdefault(acc.tensor.name, acc.tensor)
            plans = {name: dataclasses.replace(p, tensor=current[name])
                     for name, p in plans.items()}
        else:
            plans = _grid_plans(stmt, strat, gp)
            L._PLAN_CACHE.put(plan_key, {
                name: dataclasses.replace(p, tensor=None)
                for name, p in plans.items()})

    comm = _grid_comm(stmt, strat, gp)

    # ---- materialize ------------------------------------------------------
    shards: Dict[str, ShardedTensor] = {}
    with telemetry.span("lower.materialize", sig=stmt.signature(),
                        pieces=gp.pieces):
        for name, plan in plans.items():
            if name == out_t.name:
                continue                  # grid outputs assemble from leaves
            t = plan.tensor
            if plan.replicated:
                shards[name] = materialize_replicated(t, gp.pieces)
            elif plan.grid is not None and len(plan.grid) == 3:
                shards[name] = materialize_coo3_grid(t, plan)
            elif plan.grid is not None and t.format.is_sparse:
                shards[name] = (materialize_bcsr_grid(t, plan)
                                if t.format.is_blocked
                                else materialize_csr_grid(t, plan))
            elif plan.grid is not None:
                shards[name] = materialize_dense_grid(
                    t, plan.levels[0].coord_bounds,
                    plan.levels[1].coord_bounds)
            elif plan.root_coord_bounds is None:
                shards[name] = materialize_dense_cols(
                    t, plan.levels[1].coord_bounds)
            else:
                shards[name] = materialize_dense_rows(
                    t, plan.root_coord_bounds)

    # data-vs-computation distribution mismatch cost, as in the 1-D path: a
    # declared data distribution that does not match the grid plan charges
    # the operand's reshuffle.
    for name, d in (distributions or {}).items():
        want = plans.get(name)
        if want is None or want.replicated:
            continue
        if not L._plans_equal(want, d.plan(want.tensor)):
            comm.redistribute_bytes += L._nbytes(want.tensor)

    with telemetry.span("lower.emit", sig=stmt.signature(),
                        space=strat.space) as esp:
        leaf_name, runner, args = _emit_grid(stmt, gp, shards, device)
        esp.set(leaf=leaf_name)
    return L.LoweredKernel(
        stmt=stmt, strategy=strat, machine=machine, plans=plans,
        shards=shards, runner=runner, args=args, comm=comm,
        leaf_name=leaf_name, device=device, fallbacks=fallbacks,
        declared_formats=declared_formats, cache=L._cache_delta(snap))


# ---------------------------------------------------------------------------
# Grid emitters: ONE format-generic emitter per expression (the level tree
# selects scalar vs blocked tiles). Each returns ``(leaf_name, runner,
# args)`` as the 1-D emitters do. A (p, q) tile is a CSR-convention shard
# whose column-local crd indexes the q-th window of the dense co-operand;
# the windows are flattened and the crd offset once at lower time, so ONE
# launch of the 1-D kernel covers every tile. SUMMA's reduction is the sum
# over the q axis of each grid row's partials, in window order.
# ---------------------------------------------------------------------------

def _emit_grid(stmt, gp, shards, device):
    sig = stmt.signature()
    if gp.replicate:
        table = {
            "d2(i,j)=s2(i,k)*d2(k,j)": _emit_spmm_grid_rep,
            "s2(i,j)=s2(i,j)*d2(i,k)*d2(k,j)": _emit_sddmm_grid_rep,
        }
        kind = "replicated 2.5-D"
    elif gp.dep_bounds is not None:
        table = {
            "d2(i,l)=s3(i,j,k)*d2(j,l)*d2(k,l)": _emit_spmttkrp_grid3,
        }
        kind = "3-D brick"
    else:
        table = {
            "d1(i)=s2(i,j)*d1(j)": _emit_spmv_grid,
            "d2(i,j)=s2(i,k)*d2(k,j)": _emit_spmm_grid,
            "s2(i,j)=s2(i,j)*d2(i,k)*d2(k,j)": _emit_sddmm_grid,
            "s2(i,j)=s2(i,j)+s2(i,j)+s2(i,j)": _emit_spadd3_grid,
        }
        kind = "nested-column grid" if gp.nested else "2-D grid"
    emitter = table.get(sig)
    if emitter is None:
        raise NotImplementedError(
            f"no {kind} emitter for {sig}; schedule a 1-D distribution")
    return emitter(stmt, gp, shards, device)


def _grid_blocked(stmt) -> bool:
    for acc in stmt.rhs.accesses():
        if acc.tensor.format.is_sparse:
            return acc.tensor.level_tree().blocked
    return False


def _sum_windows(x: torch.Tensor) -> torch.Tensor:
    """(G, W, ...) partials summed over axis 1 in window order: one fixed
    order of adds, so a run repeats bit for bit."""
    return functools.reduce(torch.add, x.unbind(1))


def _window_of(colors: int, Q: int, R: int = 1) -> np.ndarray:
    """The window index, ``(color // R) % Q``, of each flat color."""
    return (np.arange(colors, dtype=np.int64) // R) % Q


def _shifted_ids(S: ShardedTensor, key: Tuple, device: torch.device,
                 build_ids, offsets: np.ndarray) -> torch.Tensor:
    """Window-local ids (colors, N) that ``build_ids()`` gives, each color's
    row offset by ``offsets[color]`` into a flattened window stack: int32 on
    ``device``, made once and cached with the shard."""
    def build():
        ids = build_ids().astype(np.int64) + offsets[:, None]
        if ids.size and int(ids.max()) >= 2**31:
            raise ValueError(f"{key}: a flattened window offset reaches "
                             "2^31, past the kernels' int32 indices")
        return ids.astype(np.int32)

    return L._device_cached(S, ("grid_ids",) + key, device, build)


def _tile_rows(pos: np.ndarray, n: int) -> np.ndarray:
    """Per-slot local row ids (G, n) of stacked pos arrays (G, R + 1), each
    tile's expanded by ``rows_from_pos`` as the 1-D SDDMM path does: slots
    past a tile's entries clip to its own last row (their values are 0 and
    the assembly masks them)."""
    return torch.stack([K.rows_from_pos(torch.from_numpy(p), n)
                        for p in pos]).numpy()


def _flat_windows(S: ShardedTensor, key: str, device: torch.device,
                  arrange) -> torch.Tensor:
    """A dense window stack ``arrange``d (transposed, packed) into the flat
    operand the kernel gathers from, on ``device``, cached with the
    shard."""
    return L._device_cached(S, ("grid_flat", key), device,
                            lambda: np.ascontiguousarray(
                                arrange(S.arrays["vals"])))


def _emit_spmv_grid(stmt, gp, shards, device):
    B = shards[stmt.rhs.accesses()[0].tensor.name]
    c = shards[stmt.rhs.accesses()[1].tensor.name]
    n = stmt.lhs.tensor.shape[0]
    a = B.arrays
    P, Q = int(B.meta["P"]), int(B.meta["Q"])
    q_of = _window_of(P * Q, Q)
    if _grid_blocked(stmt):
        bc, max_brows = int(B.meta["bc"]), int(B.meta["max_brows"])
        max_gcw = int(a["bcol_count"].max())
        cw = _flat_windows(c, f"vec_blocks{max_gcw}x{bc}", device,
                           lambda v: pack_window_vec_blocks(
                               v, max_gcw, bc).reshape(-1, bc))

        def fn(brow, bcol, tiles, cw, row_start, row_count):
            blocks = bcsr_kernels.bcsr_spmv(brow, bcol, tiles, cw,
                                            max_brows)   # (P*Q, mbr*br)
            partial = _sum_windows(blocks.reshape(P, Q, -1))
            return L._scatter_rows((n,), partial, row_start, row_count)

        args = (L._bcsr_row_ids(B, device),
                _shifted_ids(B, ("crd1", max_gcw), device,
                             lambda: a["crd1"], q_of * max_gcw),
                L._on_device(B, "vals", device), cw,
                a["row_start"], a["row_count"])
        f = L._runner("bcsr_spmv_grid_rows", (n, P, Q, max_brows), args,
                      lambda: fn, device)
        return "bcsr_spmv_grid_rows", f, args

    mr = int(B.meta["max_rows"])
    max_kw = c.arrays["vals"].shape[1]                   # (Q, max_kw)

    def fn(pos, crd, vals, cw, row_start, row_count):
        blocks = spmv_kernels.spmv_csr_rows(pos, crd, vals, cw)  # (P*Q, mr)
        partial = _sum_windows(blocks.reshape(P, Q, mr))
        return L._scatter_rows((n,), partial, row_start, row_count)

    args = (L._on_device(B, "pos1", device),
            _shifted_ids(B, ("crd1", max_kw), device, lambda: a["crd1"],
                         q_of * max_kw),
            L._on_device(B, "vals", device),
            _flat_windows(c, "vec", device, lambda v: v.reshape(-1)),
            a["row_start"], a["row_count"])
    f = L._runner("spmv_grid_rows", (n, P, Q, mr), args, lambda: fn, device)
    return "spmv_grid_rows", f, args


def _emit_spmm_grid(stmt, gp, shards, device):
    Bacc, Cacc = stmt.rhs.accesses()
    B, C = shards[Bacc.tensor.name], shards[Cacc.tensor.name]
    out_shape = stmt.lhs.tensor.shape
    a = B.arrays
    P, Q = int(B.meta["P"]), int(B.meta["Q"])
    J = out_shape[1]
    q_of = _window_of(P * Q, Q)
    if _grid_blocked(stmt):
        bc, max_brows = int(B.meta["bc"]), int(B.meta["max_brows"])
        max_gcw = int(a["bcol_count"].max())
        Cw = _flat_windows(C, f"mat_row_blocks{max_gcw}x{bc}", device,
                           lambda v: pack_window_mat_row_blocks(
                               v, max_gcw, bc).reshape(-1, bc, J))

        def fn(brow, bcol, tiles, Cw, row_start, row_count):
            blocks = bcsr_kernels.bcsr_spmm(brow, bcol, tiles, Cw,
                                            max_brows)   # (P*Q, mbr*br, J)
            partial = _sum_windows(blocks.reshape(P, Q, -1, J))
            return L._scatter_rows(out_shape, partial, row_start, row_count)

        args = (L._bcsr_row_ids(B, device),
                _shifted_ids(B, ("crd1", max_gcw), device,
                             lambda: a["crd1"], q_of * max_gcw),
                L._on_device(B, "vals", device), Cw,
                a["row_start"], a["row_count"])
        f = L._runner("bcsr_spmm_grid_rows", (P, Q, max_brows) + out_shape,
                      args, lambda: fn, device)
        return "bcsr_spmm_grid_rows", f, args

    mr = int(B.meta["max_rows"])
    max_kw = C.arrays["vals"].shape[1]                   # (Q, max_kw, J)

    def fn(pos, crd, vals, Cw, row_start, row_count):
        blocks = spmm_kernels.spmm_csr_rows(pos, crd, vals, Cw)
        partial = _sum_windows(blocks.reshape(P, Q, mr, J))
        return L._scatter_rows(out_shape, partial, row_start, row_count)

    args = (L._on_device(B, "pos1", device),
            _shifted_ids(B, ("crd1", max_kw), device, lambda: a["crd1"],
                         q_of * max_kw),
            L._on_device(B, "vals", device),
            _flat_windows(C, "mat", device, lambda v: v.reshape(-1, J)),
            a["row_start"], a["row_count"])
    f = L._runner("spmm_grid_rows", (P, Q, mr) + out_shape, args,
                  lambda: fn, device)
    return "spmm_grid_rows", f, args


def _emit_sddmm_grid(stmt, gp, shards, device):
    """Grid SDDMM is pure owner-computes: tile (p, q) samples its B tile
    against C's p-th row window and D's q-th column window; outputs stay
    aligned with B's stored positions (scattered home by ``val_idx``), no
    reduction on either axis. Blocked trees sample whole (br, bc) tiles;
    the walk and scatter logic is identical."""
    accs = stmt.rhs.accesses()
    B = shards[accs[0].tensor.name]
    C = shards[accs[1].tensor.name]                # (P, max_rw, K)
    D = shards[accs[2].tensor.name]                # (Q, K, max_mw)
    Bt = accs[0].tensor
    a = B.arrays
    P, Q = int(B.meta["P"]), int(B.meta["Q"])
    Kd = C.arrays["vals"].shape[2]
    p_of, q_of = _window_of(P * Q, P, Q), _window_of(P * Q, Q)
    if _grid_blocked(stmt):
        br, bc = int(B.meta["br"]), int(B.meta["bc"])
        max_brows = int(B.meta["max_brows"])
        max_gcw = int(a["bcol_count"].max())
        total = int(Bt.levels[1].nnz or 0)
        head = (
            _shifted_ids(B, ("brow", max_brows), device,
                         lambda: _tile_rows(a["pos1"], a["crd1"].shape[1]),
                         p_of * max_brows),
            _shifted_ids(B, ("crd1", max_gcw), device, lambda: a["crd1"],
                         q_of * max_gcw),
            L._on_device(B, "vals", device),
            _flat_windows(C, f"rowwindow_blocks{max_brows}x{br}", device,
                          lambda v: pack_rowwindow_blocks(
                              v, max_brows, br).reshape(-1, Kd)),
            _flat_windows(D, f"inner_blocks_t{max_gcw}x{bc}", device,
                          lambda v: pack_window_mat_inner_blocks(
                              v, max_gcw, bc).transpose(0, 1, 3, 2)
                          .reshape(-1, Kd)))
        kernel, name = bcsr_kernels.bcsr_sddmm, "bcsr_sddmm_grid_rows"
        static = (total, P, Q, br, bc)
    else:
        max_rw = C.arrays["vals"].shape[1]
        max_mw = D.arrays["vals"].shape[2]
        total = Bt.nnz
        head = (
            _shifted_ids(B, ("rows", max_rw), device,
                         lambda: _tile_rows(a["pos1"], a["crd1"].shape[1]),
                         p_of * max_rw),
            _shifted_ids(B, ("crd1", max_mw), device, lambda: a["crd1"],
                         q_of * max_mw),
            L._on_device(B, "vals", device),
            _flat_windows(C, "mat", device, lambda v: v.reshape(-1, Kd)),
            _flat_windows(D, "mat_t", device,
                          lambda v: v.transpose(0, 2, 1).reshape(-1, Kd)))
        kernel, name = sddmm_kernels.sddmm_coo, "sddmm_grid_rows"
        static = (total, Q)

    def fn(rows, cols, vals, Cw, Dt, val_idx, nnz_count):
        out = kernel(rows, cols, vals, Cw, Dt)           # (P*Q, max_tnnz...)
        return L._scatter_by_val_idx(total, out, val_idx, nnz_count)

    args = head + (L._on_device(B, "val_idx", device), a["nnz_count"])
    f = L._runner(name, static, args, lambda: fn, device)
    return name, L._pattern_output(stmt.lhs.tensor.name, Bt.shape, Bt.format,
                                  Bt.levels, f), args


# ---------------------------------------------------------------------------
# Communication-avoiding emitters: 2.5-D replicated SpMM / SDDMM (the sparse
# operand keeps its (P, Q) tiles, fingerprint-shared across the z axis,
# while the third machine axis splits a non-reduction loop variable), the
# P×Q×R brick SpMTTKRP, and the nested-column SpAdd3.
# ---------------------------------------------------------------------------

def _emit_spmm_grid_rep(stmt, gp, shards, device):
    """2.5-D SpMM: B(i, k) tiled (P, Q) and replicated along z; C(k, j)
    dense-grid sliced (k by y, j by z); each z-slice r computes the SAME
    (P, Q) SUMMA as the unreplicated 2-D plan restricted to its column
    window (one launch of the rows kernel per slice, R in all): partials
    sum along y only, and the z-slices concatenate disjoint output
    columns. Bit for bit the (P, Q) 2-D plan: output columns are
    independent lanes of the same contraction."""
    Bacc, Cacc = stmt.rhs.accesses()
    B, C = shards[Bacc.tensor.name], shards[Cacc.tensor.name]
    out_shape = stmt.lhs.tensor.shape
    a = B.arrays
    P, Q = int(B.meta["P"]), int(B.meta["Q"])
    R = int(gp.R)
    mr = int(B.meta["max_rows"])
    max_jw = int(C.meta["max_cols"])
    max_kw = C.arrays["vals"].shape[2]            # (Q, R, max_kw, max_jw)
    widths = tuple(int(w) for w in C.arrays["col_count"])   # (R,)

    def fn(pos, crd, vals, Cw, row_start, row_count):
        outs = []
        for r in range(R):
            blocks = spmm_kernels.spmm_csr_rows(pos, crd, vals, Cw[r])
            partial = _sum_windows(blocks.reshape(P, Q, mr, max_jw))
            outs.append(L._scatter_rows((out_shape[0], max_jw), partial,
                                        row_start, row_count)[:, :widths[r]])
        return torch.cat(outs, 1)

    args = (L._on_device(B, "pos1", device),
            _shifted_ids(B, ("crd1", max_kw), device, lambda: a["crd1"],
                         _window_of(P * Q, Q) * max_kw),
            L._on_device(B, "vals", device),
            _flat_windows(C, "rep", device, lambda v: v.transpose(
                1, 0, 2, 3).reshape(R, Q * max_kw, max_jw)),
            a["row_start"], a["row_count"])
    f = L._runner("spmm_grid_rep_rows",
                  (P, Q, R, mr, max_jw, widths) + out_shape, args,
                  lambda: fn, device)
    return "spmm_grid_rep_rows", f, args


def _emit_sddmm_grid_rep(stmt, gp, shards, device):
    """2.5-D SDDMM: B's sampling tiles stay (P, Q), shared across z; the
    contraction variable k splits over z: C(i, k) dense-grid (x rows ×
    z cols), D(k, j) dense-grid (z rows × y cols). Each z-slice samples a
    partial dot product (one launch of the SDDMM kernel per slice, R in
    all); the partials sum along z in slice order and scatter home by B's
    stored positions."""
    accs = stmt.rhs.accesses()
    B = shards[accs[0].tensor.name]
    C = shards[accs[1].tensor.name]               # (P, R, max_rw, max_kw)
    D = shards[accs[2].tensor.name]               # (R, Q, max_kw, max_mw)
    Bt = accs[0].tensor
    a = B.arrays
    P, Q = int(B.meta["P"]), int(B.meta["Q"])
    R = int(gp.R)
    _, _, max_rw, max_kw = C.arrays["vals"].shape
    max_mw = D.arrays["vals"].shape[3]
    total = Bt.nnz

    def fn(rows, cols, vals, Cw, Dt, val_idx, nnz_count):
        out = functools.reduce(torch.add, [
            sddmm_kernels.sddmm_coo(rows, cols, vals, Cw[r], Dt[r])
            for r in range(R)])                   # (P*Q, max_tnnz)
        return L._scatter_by_val_idx(total, out, val_idx, nnz_count)

    args = (_shifted_ids(B, ("rows", max_rw), device,
                         lambda: _tile_rows(a["pos1"], a["crd1"].shape[1]),
                         _window_of(P * Q, P, Q) * max_rw),
            _shifted_ids(B, ("crd1", max_mw), device, lambda: a["crd1"],
                         _window_of(P * Q, Q) * max_mw),
            L._on_device(B, "vals", device),
            _flat_windows(C, "rep", device, lambda v: v.transpose(
                1, 0, 2, 3).reshape(R, P * max_rw, max_kw)),
            _flat_windows(D, "rep_t", device, lambda v: v.transpose(
                0, 1, 3, 2).reshape(R, Q * max_mw, max_kw)),
            L._on_device(B, "val_idx", device), a["nnz_count"])
    f = L._runner("sddmm_grid_rep_rows", (total, Q, R), args, lambda: fn,
                  device)
    return "sddmm_grid_rep_rows", L._pattern_output(
        stmt.lhs.tensor.name, Bt.shape, Bt.format, Bt.levels, f), args


def _brick_stream(B: ShardedTensor, max_jw: int, max_kw: int,
                  device: torch.device):
    """(rows, j, k, vals) of the brick shards on ``device``, the SpMTTKRP
    kernel's stream, made once and cached with the shard: the bricks of
    :func:`brick_stream_host` with j and k offset into the flattened C and
    D windows (q·max_jw, r·max_kw)."""
    a = B.arrays
    Q, R = int(B.meta["Q"]), int(B.meta["R"])

    def build():
        ids, j, k, vals = brick_stream_host(B, slice(None))
        colors = ids.shape[0]
        j = j + (_window_of(colors, Q, R) * max_jw)[:, None]
        k = k + (_window_of(colors, R) * max_kw)[:, None]
        if max(int(j.max(initial=0)), int(k.max(initial=0))) >= 2**31:
            raise ValueError("spmttkrp_grid3: a flattened window offset "
                             "reaches 2^31, past the kernel's int32 indices")
        return ids, j.astype(np.int32), k.astype(np.int32), vals

    return L._device_cached(B, ("brick_stream", max_jw, max_kw), device,
                            build)


def brick_stream_host(B: ShardedTensor, bricks: slice):
    """(rows, j, k, vals) host arrays of the ``bricks`` of a brick shard
    set, brick-local: padding slots get the dropped row id ``max_rows``; a
    brick whose rows are not sorted (storage order of an unsorted COO tree)
    is stable-sorted by row, the kernel's contract."""
    a = B.arrays
    max_rows = int(B.meta["max_rows"])
    ids = a["dim0"][bricks].astype(np.int64)
    ids[np.arange(ids.shape[1])[None, :]
        >= a["nnz_count"][bricks][:, None]] = max_rows
    rest = [a["dim1"][bricks], a["dim2"][bricks], a["vals"][bricks]]
    if ids.size and (np.diff(ids, axis=1) < 0).any():
        order = np.argsort(ids, axis=1, kind="stable")
        ids = np.take_along_axis(ids, order, axis=1)
        rest = [np.take_along_axis(x, order, axis=1) for x in rest]
    return (ids.astype(np.int32), rest[0].astype(np.int32),
            rest[1].astype(np.int32), rest[2])


def _emit_spmttkrp_grid3(stmt, gp, shards, device):
    """P×Q×R brick SpMTTKRP: brick (p, q, r) contracts its COO entries
    (brick-local coordinates) against C's q-th and D's r-th row windows,
    all bricks in one launch; partials sum over the Q·R bricks sharing a
    row window (the y and z all-reduce) in brick order and scatter into
    the output rows."""
    accs = stmt.rhs.accesses()
    B = shards[accs[0].tensor.name]
    C = shards[accs[1].tensor.name]               # (Q, max_jw, L)
    D = shards[accs[2].tensor.name]               # (R, max_kw, L)
    out_shape = stmt.lhs.tensor.shape
    a = B.arrays
    P, Q, R = int(B.meta["P"]), int(B.meta["Q"]), int(B.meta["R"])
    max_rows = int(B.meta["max_rows"])
    Lw = out_shape[1]
    max_jw, max_kw = C.arrays["vals"].shape[1], D.arrays["vals"].shape[1]

    def fn(rows, j, k, vals, Cw, Dw, row_start, row_count):
        blocks = spmttkrp_kernels.spmttkrp_coo(rows, j, k, vals, Cw, Dw,
                                               max_rows)
        partial = _sum_windows(blocks.reshape(P, Q * R, max_rows, Lw))
        return L._scatter_rows(out_shape, partial, row_start, row_count)

    args = (*_brick_stream(B, max_jw, max_kw, device),
            _flat_windows(C, "mat", device, lambda v: v.reshape(-1, Lw)),
            _flat_windows(D, "mat", device, lambda v: v.reshape(-1, Lw)),
            a["row_start"], a["row_count"])
    f = L._runner("spmttkrp_grid3_rows", (P, Q, R, max_rows) + out_shape,
                  args, lambda: fn, device)
    return "spmttkrp_grid3_rows", f, args


def _emit_spadd3_grid(stmt, gp, shards, device):
    """Grid SpAdd3: all three addends share the same (P, Qr) tile windows
    (Qr = Q·R for a nested 3-D split), so one launch of the rows union
    kernel unions every tile's three local coordinate sets, with zero
    communication; the host offsets rows AND columns back to global
    coordinates and assembles the CSR with ``Tensor.from_coo``, as the
    reference does."""
    accs = stmt.rhs.accesses()
    Bs = [shards[acc.tensor.name] for acc in accs]
    if any(S.kind != "csr_grid" for S in Bs):
        raise NotImplementedError(
            "grid SpAdd3 over blocked addends: the reference's grid union "
            "is scalar; schedule a 1-D distribution")
    n_rows, n_cols = stmt.lhs.tensor.shape
    Qr = int(Bs[0].meta["Q"])
    R = max(int(Bs[0].meta["max_rows"]), 1)
    max_cw = int(np.asarray(Bs[0].arrays["col_count"]).max())
    rs = Bs[0].arrays["row_start"].astype(np.int64)
    cs = Bs[0].arrays["col_start"].astype(np.int64)
    flat = tuple(x for S in Bs for x in L._sorted_row_shard(S, device))
    f = L._runner("spadd3_grid_rows", (n_rows, n_cols, Qr, max_cw), flat,
                  lambda: spadd3_kernels.spadd3_union_rows, device)
    name = stmt.lhs.tensor.name

    def run(*args):
        row_pos, crd, vals = (x.cpu().numpy() for x in f(*args))
        row = np.repeat(np.arange(row_pos.shape[0] - 1), np.diff(row_pos))
        color, r = np.divmod(row, R)
        p, q = np.divmod(color, Qr)
        coords = np.stack([r + rs[p], crd.astype(np.int64) + cs[q]], 1)
        return Tensor.from_coo(name, (n_rows, n_cols), coords, vals,
                               F.CSR(), dedupe=True)

    return "spadd3_grid_rows", run, flat


# -- per-window block packing for the blocked grid leaves -------------------
# The grid column windows are block-aligned (the planner snaps them), so a
# window's slice of the dense co-operand reshapes straight into (bc-sized)
# blocks. These pack from the MATERIALIZED window shards (the cached
# (Q, max_w, ...) arrays), so a warm re-lower never re-densifies the
# operand.

def pack_window_vec_blocks(vals: np.ndarray, max_gcw: int, bc: int,
                           ) -> np.ndarray:
    """Dense-vector window shards (Q, max_kw) → column blocks
    (Q, max_gcw, bc); padding past each window is already zero."""
    Q, kw = vals.shape
    out = np.zeros((Q, max_gcw * bc), vals.dtype)
    out[:, :kw] = vals
    return out.reshape(Q, max_gcw, bc)


def pack_window_mat_row_blocks(vals: np.ndarray, max_gcw: int, bc: int,
                               ) -> np.ndarray:
    """Dense-matrix row-window shards (Q, max_kw, J) → leading-dim blocks
    (Q, max_gcw, bc, J)."""
    Q, kw, J = vals.shape
    out = np.zeros((Q, max_gcw * bc, J), vals.dtype)
    out[:, :kw] = vals
    return out.reshape(Q, max_gcw, bc, J)


def pack_window_mat_inner_blocks(vals: np.ndarray, max_gcw: int, bc: int,
                                 ) -> np.ndarray:
    """Dense-matrix column-window shards (Q, K, max_mw) → trailing-dim
    blocks (Q, max_gcw, K, bc) — the per-window analog of
    ``layout.pack_mat_inner_blocks``."""
    Q, K, mw = vals.shape
    out = np.zeros((Q, K, max_gcw * bc), vals.dtype)
    out[:, :, :mw] = vals
    return np.ascontiguousarray(
        out.reshape(Q, K, max_gcw, bc).transpose(0, 2, 1, 3))
