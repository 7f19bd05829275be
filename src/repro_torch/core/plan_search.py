"""Cost-model-driven autoscheduler: ``lower(stmt, machine, schedule="auto")``.

Given an Assignment with its operand Tensors and a machine, the planner

1. enumerates candidate :class:`SchedulePoint`s: the 1-D rows and nnz
   strategies, every 2-D grid factorization P×Q of ``pieces`` the grid
   subsystem supports and the 2.5-D replicated P×Q×R ones, each carrying
   the ``(block_R, block_nb)`` tile of
   :func:`repro_torch.kernels.autotune.tune_block_ell` when the sparse
   operand is blocked (infeasible tunes are skipped). The tile is plan
   provenance and part of the plan key: no Hopper kernel takes it;
2. scores each point with a roofline model
   (:class:`repro_torch.launch.roofline.HardwareModel`, the H100's
   datasheet figures by default) fed by the sparse operand's structural
   stats (the row-degree distribution from its level-tree walk, nnz,
   shape) and the byte formulas the lowering charges: 1-D replication
   and reduction from ``core.lower``'s conventions, per-axis grid bytes
   from :func:`repro_torch.core.grid.grid_axis_bytes`;
3. on the card, refines the model's top K by lowering each point and
   timing its ``run()`` (host clock, each call ending in a synchronize);
4. memoizes the winner in ``_TUNED_PLAN_CACHE``, an LRU keyed like the
   plan cache (signature + operand content fingerprints + machine), so a
   warm re-lower skips the search (``cache.tuned_hits``) and any in-place
   mutation misses. The key holds no device: the cached value is a
   schedule, valid on any device.

Given the reference's constants, the host products (stats, candidates,
their order and costs, tiles, keys, the winner) equal the JAX package's.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import formats as fmt
from . import levels
from . import lower as lower_mod
from ..runtime import telemetry
from .cache import LRUCache, _MISSING
from .device import resolve_device
from .partition import (partition_by_bounds, tensor_fingerprint,
                        weights_fingerprint)
from .schedule import Schedule
from .tdn import Machine
from .tensor import Tensor
from .tin import Assignment
from ..kernels.autotune import TuneResult, tune_block_ell
from ..launch.roofline import DEFAULT_HW, HardwareModel

log = logging.getLogger(__name__)

# Winner memoization: (signature, machine dim sizes, weights fingerprint,
# per-operand (name, content fingerprint, index vars)) -> SchedulePoint
# (or None when no candidate could be scored). Content keys mean in-place
# mutation re-searches while an unchanged re-lower skips straight to the
# cached winner.
_TUNED_PLAN_CACHE = LRUCache(capacity=64)
TUNED_PLAN_CACHE_STATS = _TUNED_PLAN_CACHE.stats


def clear_tuned_plan_cache() -> None:
    _TUNED_PLAN_CACHE.clear()


def set_tuned_plan_cache_capacity(capacity: int) -> None:
    _TUNED_PLAN_CACHE.set_capacity(capacity)


def export_tuned_entries() -> list:
    """Snapshot of the tuned-plan cache as (key, SchedulePoint-or-None)
    pairs, oldest → newest. Checkpoints persist this (picklable: keys are
    tuples of str/int, points are plain dataclasses) so a recovered run
    skips the candidate search for operands whose fingerprints survived."""
    return _TUNED_PLAN_CACHE.items()


def import_tuned_entries(entries) -> int:
    """Merge checkpointed tuned entries back in; existing keys win (the
    live entry is at least as fresh). Returns the number imported."""
    n = 0
    for key, point in entries:
        if key not in _TUNED_PLAN_CACHE:
            _TUNED_PLAN_CACHE.put(key, point)
            n += 1
    return n


# Signatures/format families the grid subsystem lowers directly (mirrors
# the conformance matrix's grid cells); other cells only get 1-D points.
_GRID_EXPRS = {"spmv", "spmm", "sddmm"}
_GRID_FORMAT_ROOTS = {"csr", "csc", "bcsr", "bcsc"}


@dataclasses.dataclass
class SearchConfig:
    """Search knobs. ``refine_top_k <= 0`` disables measurement: the
    model's ranking decides alone. The default measures the model's top 3
    and the measured minimum picks."""

    refine_top_k: int = 3
    measure_warmup: int = 1
    measure_iters: int = 3


DEFAULT_CONFIG = SearchConfig()


@dataclasses.dataclass
class SchedulePoint:
    """One candidate schedule: strategy space × processor-grid
    factorization × tile. Self-contained: ``build`` reconstructs the
    Schedule + Machine from it, which is what makes the point cacheable."""

    space: str                       # 'universe' | 'nnz'
    grid: Tuple[int, ...]            # (P,), (P, Q), or (P, Q, R)
    tile: Optional[Tuple[int, int]] = None   # (block_R, block_nb)
    replicated: bool = False         # 2.5-D: sparse operand replicated on z
    est_cost_s: float = float("inf")
    measured_s: Optional[float] = None
    # Set on the WINNER only: every point the search scored, as plain
    # dicts (label / est_cost_s / measured_s) in model-cost order — the
    # provenance LoweredKernel.explain() renders, kept picklable so
    # checkpointed tuned entries carry it.
    candidates: Optional[List[Dict[str, Any]]] = None

    @property
    def label(self) -> str:
        kind = "rows" if self.space == "universe" else "nnz"
        mesh = "x".join(str(s) for s in self.grid)
        return f"{kind}/{mesh}" + ("r" if self.replicated else "")

    @property
    def canonical_grid(self) -> Tuple[int, ...]:
        """Grid with trailing singleton axes stripped: a P×1 (or 1-deep
        z) factorization IS the lower-order plan, and dedupe keys on this
        so refine never times the same kernel twice."""
        g = list(self.grid)
        while len(g) > 1 and g[-1] == 1:
            g.pop()
        return tuple(g)

    @property
    def plan_key(self) -> Tuple:
        g = self.canonical_grid
        return (self.space, g, self.replicated and len(g) >= 3, self.tile)

    def machine_for(self, base: Machine) -> Machine:
        names = [d.name for d in base.dims]
        defaults = ["x", "y", "z", "w"]
        g = self.canonical_grid
        return Machine(*[(names[i] if i < len(names) else defaults[i], s)
                         for i, s in enumerate(g)])

    def build(self, stmt: Assignment,
              base: Machine) -> Tuple[Schedule, Machine]:
        m = self.machine_for(base)
        if self.replicated:
            s = lower_mod.default_replicated_schedule(stmt, m)
        elif len(m.dims) >= 3:
            s = lower_mod.default_grid3_schedule(stmt, m)
        elif len(m.dims) == 2:
            s = lower_mod.default_grid_schedule(stmt, m)
        elif self.space == "universe":
            s = lower_mod.default_row_schedule(stmt, m)
        else:
            s = lower_mod.default_nnz_schedule(stmt, m)
        if self.tile is not None:
            s.tile_hint(*self.tile)
        return s, m


# ---------------------------------------------------------------------------
# Structural stats: what the fingerprinted storage tells us at plan time
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StructStats:
    """Row-degree distribution + sizes of the distributed sparse operand,
    in walk coordinates (block-granular for blocked formats)."""

    entries: int                 # stored entries (blocks for blocked)
    n0: int                      # dim-0 extent of the walk coordinates
    deg: np.ndarray              # (n0,) stored entries per dim-0 coord
    entry_elems: int             # scalar elements per stored entry
    root_tracks_dim0: bool       # storage root iterates output rows
    tile: Optional[TuneResult] = None   # blocked formats: tuned group shape

    @property
    def imbalance(self) -> float:
        mean = self.deg.mean() if self.deg.size else 0.0
        return float(self.deg.max() / mean) if mean else 0.0


def structural_stats(stmt: Assignment) -> Optional[StructStats]:
    """Stats of the first sparse rhs operand (the distributed tensor by
    the default-schedule conventions); None when the statement has no
    sparse operand with storage."""
    spas = stmt.sparse_accesses()
    if not spas:
        return None
    t = spas[0].tensor
    if not isinstance(t, Tensor) or getattr(t, "vals", None) is None:
        return None
    tree = levels.tree_of(t)
    w = tree.walk()
    bs = t.format.block_shape if t.format.is_blocked else None
    b0 = bs[0] if bs else 1
    n0 = max(-(-t.shape[0] // b0), 1)
    deg = np.bincount(w.coords[:, 0], minlength=n0) if w.coords.size \
        else np.zeros(n0, dtype=np.int64)
    tile = None
    if bs is not None:
        # tune the group shape over the row-major block-grid pos
        # (recovered from the degree histogram: valid for BCSC too)
        row_pos = np.zeros(n0 + 1, np.int64)
        np.cumsum(deg, out=row_pos[1:])
        tile = tune_block_ell(row_pos, (bs[0], bs[1]))
        if tile.fallback:
            log.warning("plan_search: tuned tile infeasible for %s; "
                        "candidates carry no tile", t.name)
    return StructStats(
        entries=int(w.coords.shape[0]), n0=n0, deg=deg,
        entry_elems=int(np.prod(bs)) if bs else 1,
        root_tracks_dim0=t.format.dim_of_level(0) == 0,
        tile=tile,
    )


# ---------------------------------------------------------------------------
# Candidate enumeration
# ---------------------------------------------------------------------------

def _grid_eligible(stmt: Assignment) -> bool:
    sig = stmt.signature()
    if lower_mod.expression_key(sig) not in _GRID_EXPRS:
        return False
    spas = stmt.sparse_accesses()
    if not spas or len(spas[0].idx) < 2:
        return False
    root = fmt.format_key(spas[0].tensor.format).split("(")[0]
    return root in _GRID_FORMAT_ROOTS


def _replicated_eligible(stmt: Assignment) -> bool:
    """2.5-D replicated candidates: scalar-format sparse operand (the
    replicated grid emitters don't walk blocked trees) and a loop
    variable outside the sparse index set to split over z (SpMM's output
    columns, SDDMM's contraction) — SpMV has no such variable."""
    if not _grid_eligible(stmt):
        return False
    spa = stmt.sparse_accesses()[0]
    if spa.tensor.format.is_blocked:
        return False
    return any(v not in spa.idx for v in stmt.all_vars)


def enumerate_points(stmt: Assignment, machine: Machine,
                     stats: Optional[StructStats] = None,
                     ) -> List[SchedulePoint]:
    """The search space: 1-D rows + 1-D nnz, and each 2-D factorization
    P×Q (P, Q > 1) of ``pieces`` for grid-distributable cells. 2-D nnz is
    NOT enumerated: a nested pos-split canonicalizes to the flat P·Q
    split, so it is never a distinct execution. Blocked operands carry
    the tuned tile on every point (None when the tune was infeasible)."""
    pieces = machine.n_procs
    tile = None
    if stats is not None and stats.tile is not None \
            and not stats.tile.fallback:
        tile = (stats.tile.block_r, stats.tile.block_n)
    pts = [SchedulePoint("universe", (pieces, 1), tile)]
    if stmt.sparse_accesses():
        pts.append(SchedulePoint("nnz", (pieces, 1), tile))
    if _grid_eligible(stmt):
        for P in range(2, pieces):
            if pieces % P == 0 and pieces // P > 1:
                pts.append(SchedulePoint("universe", (P, pieces // P), tile))
    if _replicated_eligible(stmt):
        # every P×Q×R factorization with a genuine replication depth
        # (R >= 2; R == 1 would just be the 2-D plan again)
        for P in range(2, pieces + 1):
            if pieces % P:
                continue
            rest = pieces // P
            for Q in range(1, rest):
                if rest % Q:
                    continue
                R = rest // Q
                if R >= 2:
                    pts.append(SchedulePoint("universe", (P, Q, R), tile,
                                             replicated=True))
    # dedupe by canonical plan key so degenerate factorizations that
    # coincide with a lower-order plan are scored (and refined) once
    uniq: Dict[Tuple, SchedulePoint] = {}
    for p in pts:
        uniq.setdefault(p.plan_key, p)
    return list(uniq.values())


# ---------------------------------------------------------------------------
# The cost model
# ---------------------------------------------------------------------------

def _entry_flops(stmt: Assignment) -> float:
    """FLOPs per stored SCALAR entry: 2 (multiply-add) times the extent
    of every loop that does not index the sparse operand (the dense
    fan-out — J for SpMM's output columns, K for SDDMM's contraction)."""
    spas = stmt.sparse_accesses()
    if not spas:
        return 2.0
    sparse_vars = set(spas[0].idx)
    seen: List = []
    for v in list(stmt.lhs.idx) + list(stmt.rhs.index_vars()):
        if v not in seen:
            seen.append(v)
    fan = 1.0
    for v in seen:
        if v not in sparse_vars:
            fan *= stmt.var_extent(v)
    return 2.0 * max(fan, 1.0)


def _replicated_universe(stmt: Assignment) -> List[Tensor]:
    """Operands a 1-D rows schedule replicates — mirrors
    ``_compute_plans``: everything not indexed by the distributed
    variable at (or through) its storage root."""
    dist_var = stmt.result_vars[0]
    out_name = stmt.lhs.tensor.name
    rep: List[Tensor] = []
    seen = set()
    for acc in stmt.accesses():
        t = acc.tensor
        if t.name in seen or t.name == out_name:
            continue
        seen.add(t.name)
        if dist_var in acc.idx:
            lvl_dim = acc.idx.index(dist_var)
            if t.format.level_of_dim(lvl_dim) == 0:
                continue
            if lvl_dim == 0 and t.format.is_sparse:
                continue   # transpose walk realizes the row windows
        rep.append(t)
    return rep


def _replicated_nnz(stmt: Assignment) -> Tuple[List[Tensor], bool]:
    """(replicated operands, output_partitioned) under the 1-D nnz
    schedule: everything but the position-space tensor replicates; a
    dense output whose leading variable is the position tensor's root
    variable is row-partitioned (small boundary-overlap reduce), any
    other output reduces at full extent."""
    pos_t = None
    for acc in stmt.rhs.accesses():
        if acc.tensor.format.is_sparse:
            pos_t = acc.tensor
            break
    out = stmt.lhs.tensor
    rep: List[Tensor] = []
    seen = set()
    for acc in stmt.rhs.accesses():
        t = acc.tensor
        if t.name in seen or (pos_t is not None and t.name == pos_t.name) \
                or t.name == out.name:
            continue
        seen.add(t.name)
        rep.append(t)
    out_partitioned = (
        pos_t is not None and not out.format.is_sparse and bool(stmt.lhs.idx)
        and stmt.lhs.idx[0] == lower_mod.pos_tensor_root_var(stmt, pos_t))
    return rep, out_partitioned


def estimate(stmt: Assignment, point: SchedulePoint, stats: StructStats,
             hw: HardwareModel = DEFAULT_HW) -> float:
    """Roofline-style score in seconds: max(compute, memory) + network.

    Per-device work is the padded maximum over pieces — universe splits
    carry the row-degree imbalance (windows pad to the heaviest window),
    nnz splits are balanced by construction but pay the cross-piece
    output merge (the full output touched once more) plus the
    overlapping-row (or full-extent, for column-major roots) reduction
    the lowering charges."""
    grid = tuple(point.grid)
    P = grid[0]
    pieces = 1
    for s in grid:
        pieces *= s
    par = max(pieces // max(P, 1), 1)   # column-axis (y·z) work division
    flops_per_entry = _entry_flops(stmt) * stats.entry_elems
    bytes_per_entry = 8 + 4 * stats.entry_elems
    out_t = stmt.lhs.tensor
    out_bytes = lower_mod._nbytes(out_t)

    sig = stmt.signature()
    if point.space == "universe":
        bounds = partition_by_bounds(stats.n0, P)
        cum = np.zeros(stats.n0 + 1, np.int64)
        np.cumsum(stats.deg, out=cum[1:])
        win = cum[bounds[:, 1]] - cum[bounds[:, 0]]
        work = float(win.max()) / par         # leaves pad to the max window
        mem = work * bytes_per_entry
        if len(point.canonical_grid) > 1:
            from . import grid as grid_mod
            sched, _ = point.build(stmt, Machine.grid(*grid))
            axes = grid_mod.grid_axis_bytes(stmt, sched.strategy())
            comm = float(sum(a.network_bytes() for a in axes.values()))
        else:
            comm = float((pieces - 1) *
                         sum(lower_mod._nbytes(t)
                             for t in _replicated_universe(stmt)))
    else:
        work = float(-(-stats.entries // max(pieces, 1)))
        # scatter-assembly merge: the global output is touched once more
        mem = work * bytes_per_entry + out_bytes
        if (sig, "nnz") in lower_mod._SELF_MATERIALIZING:
            # spadd3/nnz ships every chunk's entry union to the merge
            tile_b = 8 + 4 * stats.entry_elems
            comm = float(stats.entries * tile_b)
        else:
            rep, out_partitioned = _replicated_nnz(stmt)
            comm = float((pieces - 1) *
                         sum(lower_mod._nbytes(t) for t in rep))
            if not stats.root_tracks_dim0 or not out_partitioned:
                comm += (pieces - 1) * out_bytes   # full-extent reduce
            else:
                # boundary rows overlap between adjacent nnz windows
                row_b = out_bytes / max(out_t.shape[0], 1)
                comm += (pieces - 1) * row_b
    return hw.bound_s(work * flops_per_entry, mem, comm)


# ---------------------------------------------------------------------------
# Measurement refinement + the search
# ---------------------------------------------------------------------------

def _measure(stmt: Assignment, point: SchedulePoint, base: Machine,
             weights, device: torch.device, cfg: SearchConfig) -> float:
    """The point's best ``run()`` time in seconds: lowered on ``device``,
    ``measure_warmup`` calls, then the minimum of ``measure_iters`` calls
    by the host clock, each ending in a synchronize on the card."""
    sched, m = point.build(stmt, base)
    k = lower_mod.lower(stmt, m, schedule=sched, weights=weights,
                        device=device)

    def call():
        k.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(cfg.measure_warmup):
        call()
    best = float("inf")
    for _ in range(cfg.measure_iters):
        t0 = time.perf_counter()
        call()
        best = min(best, time.perf_counter() - t0)
    return best


def search(stmt: Assignment, machine: Machine, *,
           weights=None, device=None,
           config: Optional[SearchConfig] = None,
           hw: HardwareModel = DEFAULT_HW) -> Optional[SchedulePoint]:
    """Enumerate, score, measure the model's top K on ``device`` (the
    card when None), and return the winning point (None when nothing
    could be scored)."""
    cfg = config or DEFAULT_CONFIG
    device = resolve_device(device)
    with telemetry.span("plan_search.search",
                        sig=stmt.signature()) as search_sp:
        stats = structural_stats(stmt)
        points = enumerate_points(stmt, machine, stats)
        if not points:
            return None
        if stats is None:
            # dense-only statement: nothing structural to rank — keep rows
            return points[0]
        for p in points:
            try:
                p.est_cost_s = estimate(stmt, p, stats, hw)
            except Exception:                    # estimator gap: deprioritize
                log.exception("plan_search: estimate failed for %s", p.label)
                p.est_cost_s = float("inf")
        points.sort(key=lambda p: p.est_cost_s)
        if cfg.refine_top_k > 0 and len(points) > 1:
            for p in points[:cfg.refine_top_k]:
                try:
                    with telemetry.span("plan_search.measure",
                                        candidate=p.label) as msp:
                        p.measured_s = _measure(stmt, p, machine, weights,
                                                device, cfg)
                        msp.set(measured_s=p.measured_s)
                except Exception:
                    log.exception("plan_search: measurement failed for %s",
                                  p.label)
                    p.measured_s = float("inf")
            measured = [p for p in points if p.measured_s is not None]
            measured.sort(key=lambda p: p.measured_s)
            winner = measured[0]
        else:
            winner = points[0]
        # Provenance: every scored candidate, model-cost order, on the
        # winner (what LoweredKernel.explain() renders).
        winner.candidates = [
            {"label": p.label, "est_cost_s": p.est_cost_s,
             "measured_s": (None if p.measured_s is None
                            else float(p.measured_s))}
            for p in points]
        search_sp.set(winner=winner.label, n_candidates=len(points))
    log.info("plan_search: %s -> %s (est %.3es, measured %s)",
             lower_mod.expression_key(stmt.signature()), winner.label,
             winner.est_cost_s,
             f"{winner.measured_s:.3e}s" if winner.measured_s is not None
             else "-")
    return winner


def _tuned_key(stmt: Assignment, machine: Machine, weights) -> Optional[Tuple]:
    """Like ``lower._plan_cache_key`` minus the strategy (the strategy is
    the cached VALUE here): signature + machine + operand content
    fingerprints. None disables caching (operands without storage)."""
    ops = []
    for acc in stmt.accesses():
        t = acc.tensor
        if not isinstance(t, Tensor) or getattr(t, "vals", None) is None:
            return None
        ops.append((t.name, tensor_fingerprint(t),
                    tuple(v.name for v in acc.idx)))
    return (stmt.signature(), tuple(d.size for d in machine.dims),
            weights_fingerprint(weights), tuple(ops))


def resolve_auto(stmt: Assignment, machine: Machine, *, weights=None,
                 device=None, config: Optional[SearchConfig] = None,
                 ) -> Tuple[Schedule, Machine, Optional[SchedulePoint]]:
    """``lower(schedule="auto")`` entry: cached winner or fresh search.

    Returns (schedule, machine, point): the machine is re-factorized to
    the winning grid shape (the planner owns the factorization; the
    total piece count is always the caller's)."""
    device = resolve_device(device)
    key = _tuned_key(stmt, machine, weights)
    if key is None:
        # no storage to score: default rows, uncached
        return lower_mod.default_row_schedule(stmt, machine), machine, None
    point = _TUNED_PLAN_CACHE.get(key, _MISSING)
    telemetry.instant("plan_search.tuned_cache", hit=point is not _MISSING)
    if point is _MISSING:
        point = search(stmt, machine, weights=weights, device=device,
                       config=config)
        _TUNED_PLAN_CACHE.put(key, point)
    if point is None:
        return lower_mod.default_row_schedule(stmt, machine), machine, None
    sched, m = point.build(stmt, machine)
    return sched, m, point
