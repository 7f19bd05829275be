"""Scheduling language (paper §II-C).

Transformations: ``divide``/``split`` (universe or non-zero strip-mining),
``fuse`` (coordinate/loop fusion), ``distribute`` (map a loop onto machine
dimensions), ``communicate`` (placement of data movement), ``parallelize``
(leaf parallelism), ``reorder``, ``precompute``.

A `Schedule` records the transformation list applied to a TIN statement and
canonicalizes it into a `DistStrategy` that the lowering engine (lower.py)
consumes — mirroring how SpDISTAL's scheduling commands drive the Fig. 9a
code-generation algorithm.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .tdn import Machine, MachineDim
from .tin import Assignment, IndexVar


class ParallelUnit:
    """Leaf-level parallel hardware (paper: CPUThread, GPUBlock, ...).

    The names are the reference's, kept so schedules read the same in
    both packages; the port's leaves on the card are its CUDA kernels.
    """

    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:
        return self.name


CPUThread = ParallelUnit("CPUThread")
TPUGrid = ParallelUnit("TPUGrid")
VectorLanes = ParallelUnit("VectorLanes")


@dataclasses.dataclass
class ScheduleOp:
    kind: str
    args: tuple


@dataclasses.dataclass
class DistStrategy:
    """Canonical distribution strategy extracted from a schedule.

    ``space`` is 'universe' (coordinate-value distributed loop → universe
    partitions) or 'nnz' (coordinate-position loop → non-zero partitions),
    paper §IV-C. ``vars`` are the pre-divide loop variables being
    distributed, one per machine dimension — a single entry is the classic
    1-D distribution; two entries map onto a 2-D processor grid (paper
    `distribute((i, k) → (x, y))`, the SUMMA-style tilings of §VI). For
    nnz strategies the first entry is the fused variable and later entries
    are the successive inner split variables of the nested pos-split."""

    space: str                      # 'universe' | 'nnz'
    vars: Tuple[IndexVar, ...]      # distributed index variables (outer)
    machine_dims: Tuple[MachineDim, ...]
    fused_vars: Optional[Tuple[IndexVar, ...]] = None   # for nnz via fusion
    communicate_at: Dict[str, str] = dataclasses.field(default_factory=dict)
    leaf_unit: Optional[ParallelUnit] = None
    # Leaf tile hint for blocked formats: (block_R, block_nb) group
    # shape chosen by the autoscheduler's tune_ell pass (None → the
    # kernels' built-in fallback defaults).
    tile: Optional[Tuple[int, int]] = None
    # Per-operand replication: (tensor_name, machine_dim_name) pairs. A
    # replicated operand is NOT partitioned along the named machine axis —
    # every processor along it holds the full slice (the DISTAL
    # "1.5-D/2.5-D" communication-avoiding schedules): broadcast bytes are
    # paid once along that axis to save reduction hops elsewhere.
    replicate: Tuple[Tuple[str, str], ...] = ()

    @property
    def var(self) -> IndexVar:
        """First (row-axis) distributed variable — the whole strategy for
        1-D schedules; kept for the single-axis call sites."""
        return self.vars[0]

    @property
    def pieces(self) -> int:
        p = 1
        for d in self.machine_dims:
            p *= d.size
        return p

    @property
    def is_grid(self) -> bool:
        """True when the schedule distributes over a multi-dim machine
        grid (len(vars) > 1) — lowering routes to the grid subsystem."""
        return len(self.vars) > 1

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        """Processor-grid shape: (P, Q) for 1-D/2-D strategies (Q = 1 when
        1-D), the full (P, Q, R, ...) tuple for higher-order grids."""
        sizes = [d.size for d in self.machine_dims]
        while len(sizes) < 2:
            sizes.append(1)
        return tuple(sizes)

    @property
    def space_label(self) -> str:
        """Strategy component of a conformance cell ID: ``rows`` for
        coordinate-value (universe) loops, ``nnz`` for coordinate-position
        loops."""
        return "rows" if self.space == "universe" else "nnz"

    @property
    def mesh_label(self) -> str:
        """Mesh-shape component of a conformance cell ID (``4x1``, ``2x2``,
        ``2x2x2``; a trailing ``r`` marks a replicated schedule)."""
        sizes = [d.size for d in self.machine_dims]
        while len(sizes) < 2:
            sizes.append(1)
        label = "x".join(str(s) for s in sizes)
        return label + ("r" if self.replicate else "")


class Schedule:
    """Fluent scheduling API bound to a TIN statement (paper Fig. 1)."""

    def __init__(self, stmt: Assignment, machine: Machine):
        self.stmt = stmt
        self.machine = machine
        self.ops: List[ScheduleOp] = []
        # derived state
        self._divided: Dict[str, Tuple[IndexVar, IndexVar, MachineDim, str]] = {}
        self._fused: Dict[str, Tuple[IndexVar, ...]] = {}
        self._distributed: List[IndexVar] = []
        self._communicate: Dict[str, str] = {}
        self._leaf_unit: Optional[ParallelUnit] = None
        self._reorder: Optional[Tuple[IndexVar, ...]] = None
        self._tile: Optional[Tuple[int, int]] = None
        self._replicate: List[Tuple[str, str]] = []
        # inner-split var -> the ORIGINAL loop variable it descends from,
        # so nested divides (divide j, then divide its inner half again)
        # canonicalize to the same origin var on both machine axes.
        self._inner_origin: Dict[str, IndexVar] = {}

    # -- transformations ----------------------------------------------------
    def fuse(self, i: IndexVar, j: IndexVar, f: IndexVar) -> "Schedule":
        """Collapse loops i, j into f (coordinate fusion when i, j index a
        sparse tensor's levels — enables non-zero divides)."""
        prior = self._fused.get(i.name)
        base = prior if prior is not None else (i,)
        self._fused[f.name] = tuple(base) + (j,)
        self.ops.append(ScheduleOp("fuse", (i, j, f)))
        return self

    def divide(self, i: IndexVar, io: IndexVar, ii: IndexVar,
               mdim: MachineDim, space: str = "universe") -> "Schedule":
        """Split loop ``i`` into ``pieces`` chunks (outer ``io``).

        ``space='universe'`` splits the coordinate range (paper divide);
        ``space='nnz'`` strip-mines non-zero positions (Senanayake et al.'s
        pos-split variant), used after ``fuse`` for non-zero distribution."""
        if space not in ("universe", "nnz"):
            raise ValueError(space)
        self._divided[io.name] = (i, ii, mdim, space)
        self._inner_origin[ii.name] = self._inner_origin.get(i.name, i)
        self.ops.append(ScheduleOp("divide", (i, io, ii, mdim, space)))
        return self

    # paper spells the nnz variant `split`/`pos`; alias for readability
    def pos_split(self, i: IndexVar, io: IndexVar, ii: IndexVar,
                  mdim: MachineDim) -> "Schedule":
        return self.divide(i, io, ii, mdim, space="nnz")

    def distribute(self, *vars: IndexVar) -> "Schedule":
        for v in vars:
            if v.name not in self._divided:
                raise ValueError(
                    f"distribute({v}): variable must be the outer result of "
                    "a divide/pos_split")
            self._distributed.append(v)
        self.ops.append(ScheduleOp("distribute", vars))
        return self

    def replicate(self, tensors: Sequence, mdim: MachineDim) -> "Schedule":
        """Replicate ``tensors`` along machine dimension ``mdim`` instead of
        partitioning them — the communication-avoiding knob (DISTAL's
        1.5-D/2.5-D schedules): every processor along ``mdim`` holds the
        operand's full slice, eliminating the reduction hops along the
        other axes at the cost of one broadcast along ``mdim``."""
        for t in tensors:
            self._replicate.append((t.name, mdim.name))
        self.ops.append(ScheduleOp("replicate", (tuple(tensors), mdim)))
        return self

    def communicate(self, tensors: Sequence, at: IndexVar) -> "Schedule":
        for t in tensors:
            self._communicate[t.name] = at.name
        self.ops.append(ScheduleOp("communicate", (tuple(tensors), at)))
        return self

    def parallelize(self, v: IndexVar, unit: ParallelUnit) -> "Schedule":
        self._leaf_unit = unit
        self.ops.append(ScheduleOp("parallelize", (v, unit)))
        return self

    def reorder(self, *vars: IndexVar) -> "Schedule":
        self._reorder = tuple(vars)
        self.ops.append(ScheduleOp("reorder", vars))
        return self

    def precompute(self, expr, i: IndexVar, iw: IndexVar) -> "Schedule":
        self.ops.append(ScheduleOp("precompute", (expr, i, iw)))
        return self

    def tile_hint(self, block_r: int, block_n: int) -> "Schedule":
        """Pin the leaf tile (block_R, block_nb) for blocked
        formats — set by the autoscheduler from ``tune_ell``; the kernels
        fall back to their built-in defaults when unset."""
        self._tile = (int(block_r), int(block_n))
        self.ops.append(ScheduleOp("tile_hint", self._tile))
        return self

    # -- canonicalization ---------------------------------------------------
    def strategy(self) -> DistStrategy:
        if not self._distributed:
            raise ValueError("schedule has no distribute() — nothing to lower")
        mdims: List[MachineDim] = []
        spaces = set()
        outer_vars = []
        for io in self._distributed:
            i, ii, mdim, space = self._divided[io.name]
            mdims.append(mdim)
            spaces.add(space)
            # resolve inner-split vars back to their original loop var so a
            # nested divide (j -> y, then its inner half -> z) reads as the
            # SAME origin var distributed over two machine axes
            outer_vars.append(self._inner_origin.get(i.name, i))
        if len(spaces) != 1:
            raise NotImplementedError("mixed universe/nnz distribution")
        space = spaces.pop()
        var = outer_vars[0]
        fused = self._fused.get(var.name)
        if space == "nnz" and fused is None and len(self._fused) == 0:
            # nnz split directly on a single sparse loop variable
            fused = (var,)
        return DistStrategy(
            space=space,
            vars=tuple(outer_vars),
            machine_dims=tuple(mdims),
            fused_vars=fused,
            communicate_at=dict(self._communicate),
            leaf_unit=self._leaf_unit,
            tile=self._tile,
            replicate=tuple(self._replicate),
        )

    def __repr__(self) -> str:
        return "Schedule[" + "; ".join(
            f"{op.kind}{op.args}" for op in self.ops) + "]"
