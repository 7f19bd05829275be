"""Lowering scheduled TIN statements to runnable PyTorch (paper §IV).

The 1-D half of the JAX package's lowering engine for SpMV, SpMM, SpAdd3,
SDDMM, SpTTV and SpMTTKRP (Fig. 9a, adapted):

1. **Plan**: the initial level partition of the distributed index variable
   (universe partitions for coordinate-value loops, non-zero partitions for
   coordinate-position loops), then the derived partitions of every
   accessed tensor through image / preimage, and replication of tensors
   the distributed variable does not index.
2. **Materialize**: pack per-color sub-tensors into stacked, padded
   arrays on the host (numpy, as in the reference), then move them to the
   device once, where they stay cached with the shard. Sparse outputs
   (SpAdd3, SDDMM, SpTTV) are not materialized: they are assembled from the
   leaf results. The SpAdd3 nnz strategy packs its own shards, equal chunks
   of the addends' concatenated entry stream.
3. **Emit**: select the leaf for (expression signature × strategy), batched
   over the piece axis. On the card the leaves are the Hopper kernels of
   :mod:`repro_torch.kernels`; on the CPU their plain versions. The
   overlapping output rows of the nnz strategy reduce in piece order;
   pattern-preserving outputs scatter their values home by position.

Host-side products (partitions, shards, ``CommStats``, ``cell_id``, cache
counters) equal the reference's exactly. Blocked (BCSR, BCSC) operands lower
for SpMV, SpMM, SDDMM and SpAdd3. An operand no leaf iterates directly (a
blocked grid with a compressed root, or blocked addends whose block shapes
differ) is converted first, logged on this module's logger and recorded in
``LoweredKernel.fallbacks``; a statement outside the emitter table runs the
interpreter on the kernel's device (``generic[<sig>|<space>]``, a
correctness path, not a performance one). Grid universe schedules lower
through :mod:`.grid`; grid non-zero schedules through the 1-D nnz machinery
at P·Q(·R) pieces, with the communication attributed to the axes.

``lower(..., elastic=True)`` caches the 1-D shards per color, and
:func:`relower` re-plans a lowered kernel onto a resized machine (a dead
piece's window merged into a neighbor), re-packing only what the resize
changed. The serving fast path batches requests over one frozen sparse
operand (:class:`BatchedKernel`, :func:`lower_batched`): a batch of
vectors (or fixed-width panels) is one SpMM, and :func:`rebind_dense`
swaps the dense right-hand side without re-planning. ``schedule="auto"``
hands the choice of schedule to the autoscheduler (:mod:`.plan_search`).
"""
from __future__ import annotations

import dataclasses
import logging
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .cache import BATCH_BUCKETS, LRUCache, avals_key, batch_bucket
from . import formats as fmt
from .device import resolve_device
from .levels import tree_of
from .partition import (CONVERT_CACHE_STATS, SHARD_CACHE_STATS,
                        ShardedTensor, TensorPartition, _crc_arrays,
                        block_aligned_row_bounds, clear_convert_cache,
                        clear_shard_cache, convert_tensor_cached,
                        elastic_row_bounds, fingerprint_memo,
                        materialize_add_stream, materialize_bcsr_nnz,
                        materialize_bcsr_rows, materialize_coo_nnz,
                        materialize_csr_rows, materialize_dense_cols,
                        materialize_dense_grid, materialize_dense_rows,
                        materialize_dense_rows_pieces, materialize_pieces,
                        materialize_replicated,
                        materialize_replicated_elastic,
                        partition_by_bounds, partition_tensor_nonzeros,
                        partition_tensor_rows, replicate_tensor,
                        tensor_fingerprint, weights_fingerprint)
from .schedule import DistStrategy, Schedule
from .tdn import Distribution, Machine
from .tensor import INT, LevelData, Tensor
from .tin import Access, Assignment, IndexVar, Mul
from ..runtime import telemetry
from ..kernels import bcsr as bcsr_kernels
from ..kernels import ref as K
from ..kernels import sddmm as sddmm_kernels
from ..kernels import spadd3 as spadd3_kernels
from ..kernels import spmm as spmm_kernels
from ..kernels import spmttkrp as spmttkrp_kernels
from ..kernels import spmv as spmv_kernels
from ..kernels.layout import (pack_mat_inner_blocks, pack_mat_row_blocks,
                              pack_rowwindow_blocks, pack_vec_blocks)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class AxisComm:
    """Per-machine-axis communication ledger of a grid schedule. Each
    payload byte reaches or leaves ``size - 1`` peers."""

    size: int = 1
    broadcast_bytes: int = 0
    reduce_bytes: int = 0

    def network_bytes(self) -> int:
        return (self.broadcast_bytes + self.reduce_bytes) * \
            max(self.size - 1, 0)

    def as_dict(self) -> Dict[str, int]:
        return {"size": self.size, "broadcast_bytes": self.broadcast_bytes,
                "reduce_bytes": self.reduce_bytes,
                "network_bytes": self.network_bytes()}


@dataclasses.dataclass
class CommStats:
    """Communication model of the lowered kernel.

    ``replicate_bytes``: payload all-gathered to every color before the
    distributed loop (the paper's ``communicate`` at the loop).
    ``reduce_bytes``: overlapping-output payload reduced after the loop
    (non-zero strategies).
    ``redistribute_bytes``: data-vs-computation distribution mismatch cost
    (paper §II-D, final paragraph).
    ``axes``: per-machine-axis breakdown for grid schedules.
    ``overlap_total_bytes`` / ``overlap_hidden_bytes``: set by the
    double-buffered executor (``distributed.executor.run_overlapped``): how
    much of the shard-transfer traffic was in flight while a leaf kernel
    ran. Attribution only: these re-describe bytes already counted above,
    so they never enter ``total_network_bytes``."""

    pieces: int = 1
    replicate_bytes: int = 0
    reduce_bytes: int = 0
    redistribute_bytes: int = 0
    axes: Dict[str, AxisComm] = dataclasses.field(default_factory=dict)
    overlap_total_bytes: int = 0
    overlap_hidden_bytes: int = 0

    def total_network_bytes(self) -> int:
        # all-gather of b bytes to P nodes moves b*(P-1); reductions likewise
        p = max(self.pieces - 1, 0)
        return (self.replicate_bytes + self.reduce_bytes) * p + \
            self.redistribute_bytes + \
            sum(a.network_bytes() for a in self.axes.values())

    def as_dict(self) -> Dict[str, int]:
        out = {
            "pieces": self.pieces,
            "replicate_bytes": self.replicate_bytes,
            "reduce_bytes": self.reduce_bytes,
            "redistribute_bytes": self.redistribute_bytes,
            "total_network_bytes": self.total_network_bytes(),
        }
        if self.axes:
            out["axes"] = {n: a.as_dict() for n, a in self.axes.items()}
        if self.overlap_total_bytes:
            out["overlap_total_bytes"] = self.overlap_total_bytes
            out["overlap_hidden_bytes"] = self.overlap_hidden_bytes
        return out


# ---------------------------------------------------------------------------
# Re-plan fast path: plan memoization + runner reuse. Together with
# partition.SHARD_CACHE (whose shards also keep their device copies) these
# make re-lowering over unchanged inputs near-free.
# ---------------------------------------------------------------------------

# (signature, strategy, pieces, weights, operand fingerprints) ->
# {name: TensorPartition}
_PLAN_CACHE = LRUCache(capacity=64)
PLAN_CACHE_STATS = _PLAN_CACHE.stats

# (emitter name, static constants, shard shapes/dtypes, device) -> the
# compute fn. Data flows through the fn's arguments, never its closure, so
# one cached fn serves every lower with the same key.
_RUNNER_CACHE = LRUCache(capacity=128)
RUNNER_CACHE_STATS = _RUNNER_CACHE.stats


def set_plan_cache_capacity(capacity: int) -> None:
    _PLAN_CACHE.set_capacity(capacity)


def set_runner_cache_capacity(capacity: int) -> None:
    _RUNNER_CACHE.set_capacity(capacity)


def clear_lowering_caches() -> None:
    """Drop the plan, runner, shard, conversion and tuned-plan caches (the
    cold path)."""
    _PLAN_CACHE.clear()
    _RUNNER_CACHE.clear()
    clear_shard_cache()
    clear_convert_cache()
    plan_search = sys.modules.get("repro_torch.core.plan_search")
    if plan_search is not None:  # deferred: the planner imports this module
        plan_search.clear_tuned_plan_cache()


@dataclasses.dataclass
class CacheStats:
    """Per-lower cache effectiveness, snapshotted onto LoweredKernel.cache:
    how much of this lower's plan / shard-packing / runner-building work
    was reused from previous lowers. ``tuned_*`` count the
    autoscheduler's tuned-plan cache (:mod:`.plan_search`): a hit means the
    lower skipped the candidate search entirely."""

    plan_hits: int = 0
    plan_misses: int = 0
    shard_hits: int = 0
    shard_misses: int = 0
    runner_hits: int = 0
    runner_misses: int = 0
    convert_hits: int = 0
    convert_misses: int = 0
    tuned_hits: int = 0
    tuned_misses: int = 0

    @property
    def shard_reuse(self) -> float:
        """Fraction of shard-cache lookups this lower served from cache —
        the elastic-resize metric (a migration-style P→P−1 ``relower``
        reuses ≥ 0.5). 0.0 when the lower did no shard lookups at all."""
        total = self.shard_hits + self.shard_misses
        return self.shard_hits / total if total else 0.0

    @property
    def warm(self) -> bool:
        """True when the lower re-assembled nothing (full fast path)."""
        return (self.plan_misses == 0 and self.shard_misses == 0
                and self.runner_misses == 0 and self.convert_misses == 0
                and self.tuned_misses == 0)

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


def _tuned_cache_stats() -> Dict[str, int]:
    """Tuned-plan cache counters, read lazily: plan_search imports this
    module, so lower only sees its stats once the planner is in use."""
    plan_search = sys.modules.get("repro_torch.core.plan_search")
    if plan_search is None:
        return {"hits": 0, "misses": 0}
    return plan_search.TUNED_PLAN_CACHE_STATS


def _cache_snapshot() -> Tuple[int, ...]:
    tuned = _tuned_cache_stats()
    return (PLAN_CACHE_STATS["hits"], PLAN_CACHE_STATS["misses"],
            SHARD_CACHE_STATS["hits"], SHARD_CACHE_STATS["misses"],
            RUNNER_CACHE_STATS["hits"], RUNNER_CACHE_STATS["misses"],
            CONVERT_CACHE_STATS["hits"], CONVERT_CACHE_STATS["misses"],
            tuned["hits"], tuned["misses"])


def _cache_delta(snap: Tuple[int, ...]) -> CacheStats:
    d = [b - a for a, b in zip(snap, _cache_snapshot())]
    return CacheStats(plan_hits=d[0], plan_misses=d[1], shard_hits=d[2],
                      shard_misses=d[3], runner_hits=d[4], runner_misses=d[5],
                      convert_hits=d[6], convert_misses=d[7],
                      tuned_hits=d[8], tuned_misses=d[9])


@dataclasses.dataclass
class LoweredKernel:
    """A distributed sparse kernel, ready to run on ``device``, with its
    plan artifacts. ``runner(*args)`` computes the result; ``args`` are the
    leaf's inputs, already on the device (with the host-side window
    bounds the assembly reads).

    ``fallbacks`` records every operand the lowering had to convert because
    no leaf iterates its declared format (each entry is
    ``"name: <from> -> <to>"``); an empty list means the cell lowered
    directly. ``declared_formats`` keeps the structured form (operand name
    → declared format key): the plans hold the CONVERTED tensors, so the
    declared key is only recoverable from here."""

    stmt: Assignment
    strategy: DistStrategy
    machine: Machine
    plans: Dict[str, TensorPartition]
    shards: Dict[str, ShardedTensor]
    runner: Callable[..., Union[torch.Tensor, Tensor]]
    args: Tuple
    comm: CommStats
    leaf_name: str
    device: torch.device
    fallbacks: List[str] = dataclasses.field(default_factory=list)
    declared_formats: Dict[str, str] = dataclasses.field(default_factory=dict)
    cache: CacheStats = dataclasses.field(default_factory=CacheStats)
    # schedule="auto" provenance: the winning plan_search.SchedulePoint
    # (estimated/measured costs, tile choice), None for hand schedules.
    tuned: Optional[Any] = None

    def run(self) -> Union[torch.Tensor, Tensor]:
        """The result. A dense output (SpMV, SpMM, SpMTTKRP) is a tensor on
        the kernel's device. A sparse output (SpAdd3, SDDMM, SpTTV) is a
        :class:`Tensor`, as in the reference: SDDMM and SpTTV keep the
        sparse operand's (i, j) pattern with the values brought back from
        the device (the flat SpTTV paths assemble it on the host with
        ``Tensor.from_coo``); SpAdd3's union is built on the device and its
        levels and values are copied back once (the grid union's tiles are
        assembled on the host, as the reference does). The generic path
        returns the interpreter's dense numpy result."""
        return self.runner(*self.args)

    def cell_id(self) -> str:
        """Conformance-matrix cell ID: ``<expr>/<format>/<strategy>/<mesh>``
        (e.g. ``spmm/dcsr/nnz/4x1``). The format component is the sparse
        operand's DECLARED format: a fallback cell keeps its declared key
        and is told apart by a non-empty ``fallbacks`` list."""
        name = self._dist_sparse_name()
        key = "dense"
        if name is not None:
            key = self.declared_formats.get(
                name, fmt.format_key(self.plans[name].tensor.format))
        return (f"{expression_key(self.stmt.signature())}/{key}/"
                f"{self.strategy.space_label}/{self.strategy.mesh_label}")

    def imbalance(self) -> float:
        name = self._dist_sparse_name()
        return self.plans[name].imbalance() if name in self.plans else 0.0

    def _dist_sparse_name(self) -> Optional[str]:
        for acc in self.stmt.rhs.accesses():
            if acc.tensor.format.is_sparse:
                return acc.tensor.name
        return None

    def explain(self) -> str:
        """Human-readable plan provenance: what was chosen, what it costs,
        and, for ``schedule="auto"`` lowers, every candidate the
        autoscheduler scored and which one won."""
        comm, cs = self.comm, self.cache
        lines = [f"kernel {self.cell_id()}  leaf={self.leaf_name}  "
                 f"device={self.device}",
                 f"  schedule: space={self.strategy.space} "
                 f"mesh={self.strategy.mesh_label} "
                 f"pieces={self.strategy.pieces}"]
        if self.fallbacks:
            lines.append("  fallbacks: " + "; ".join(self.fallbacks))
        t = self.tuned
        if t is not None:
            cands = t.candidates or []
            lines.append(
                f"  autoscheduler winner: {t.label} "
                f"est={t.est_cost_s:.3e}s"
                + (f" measured={t.measured_s:.3e}s"
                   if t.measured_s is not None else " (not measured)"))
            if cands:
                lines.append(f"  candidates scored: {len(cands)} "
                             "(model cost order; top-K measured)")
                for i, c in enumerate(cands):
                    meas = (f" measured={c['measured_s']:.3e}s"
                            if c["measured_s"] is not None else "")
                    mark = " <- winner" if c["label"] == t.label else ""
                    lines.append(f"    {i + 1:2d}. {c['label']:<28s} "
                                 f"est={c['est_cost_s']:.3e}s{meas}{mark}")
        else:
            lines.append("  hand-picked schedule (no candidate search ran)")
        if comm.axes:
            lines.append("  comm: " + ", ".join(
                f"{n}: bcast={a.broadcast_bytes} reduce={a.reduce_bytes}"
                for n, a in comm.axes.items())
                + f" (net={comm.total_network_bytes()})")
        else:
            lines.append(f"  comm: replicate={comm.replicate_bytes} "
                         f"reduce={comm.reduce_bytes} "
                         f"redistribute={comm.redistribute_bytes} "
                         f"(net={comm.total_network_bytes()})")
        lines.append(f"  cache: plan {cs.plan_hits}h/{cs.plan_misses}m, "
                     f"shard {cs.shard_hits}h/{cs.shard_misses}m, "
                     f"runner {cs.runner_hits}h/{cs.runner_misses}m, "
                     f"convert {cs.convert_hits}h/{cs.convert_misses}m, "
                     f"tuned {cs.tuned_hits}h/{cs.tuned_misses}m"
                     + (" [warm]" if cs.warm else ""))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _scatter_rows(global_shape, blocks: torch.Tensor, row_start: np.ndarray,
                  row_count: np.ndarray) -> torch.Tensor:
    """Assemble per-color padded row blocks into the global output (the
    inverse of the row partition). Disjoint rows: add == set. Overlapping
    rows (nnz strategy): the pieces are added in piece order, so the
    reduction repeats bit for bit."""
    n = global_shape[0]
    out = torch.zeros(global_shape, dtype=blocks.dtype, device=blocks.device)
    for p, (s, c) in enumerate(zip(row_start.tolist(), row_count.tolist())):
        c = min(c, n - s, blocks.shape[1])
        if c > 0:
            out[s:s + c] += blocks[p, :c]
    return out


def _scatter_vals(total: int, blocks: torch.Tensor, start: np.ndarray,
                  count: np.ndarray) -> torch.Tensor:
    """Assemble per-color value blocks (P, N), or (P, N, br, bc) tiles of a
    blocked operand, into the global value region: the first ``count[p]``
    slots of piece p land at ``start[p]`` onward. The windows are disjoint,
    so an indexed assignment gives the reference's scatter-add result, the
    same bits on every run."""
    out = torch.zeros((total,) + tuple(blocks.shape[2:]), dtype=blocks.dtype,
                      device=blocks.device)
    for p, (s, c) in enumerate(zip(start.tolist(), count.tolist())):
        c = min(c, total - s, blocks.shape[1])
        if c > 0:
            out[s:s + c] = blocks[p, :c]
    return out


def _scatter_by_val_idx(total: int, blocks: torch.Tensor,
                        val_idx: torch.Tensor,
                        count: np.ndarray) -> torch.Tensor:
    """Permuted value-region assembly: slot e < ``count[p]`` of piece p (a
    value or a (br, bc) tile) goes home to storage position
    ``val_idx[p, e]`` (the map a transpose walk records); padding slots are
    dropped. The positions are disjoint, so this is an indexed assignment
    too."""
    out = torch.zeros((total,) + tuple(blocks.shape[2:]), dtype=blocks.dtype,
                      device=blocks.device)
    for p, c in enumerate(count.tolist()):
        c = min(c, blocks.shape[1])
        if c > 0:
            out[val_idx[p, :c].long()] = blocks[p, :c]
    return out


def _pattern_output(name: str, shape, format: "fmt.Format", levels,
                    f: Callable[..., torch.Tensor]
                    ) -> Callable[..., Tensor]:
    """A runner returning a pattern-preserving output: ``levels`` with the
    values ``f`` computes, brought back from the device."""
    def run(*args):
        vals = f(*args).cpu().numpy()
        return Tensor(name, shape, format, levels, vals, vals.dtype)
    return run


def _nbytes(t: Tensor) -> int:
    if t.format.is_all_dense:
        return int(np.prod(t.shape)) * t.vals.dtype.itemsize
    if t.format.is_blocked:
        # block-granular payload: one (br, bc) tile + one block coord per
        # stored block position, plus the block-grid pos arrays
        tile = int(np.prod(t.format.block_shape)) * t.vals.dtype.itemsize
        n_blocks = int(t.vals.shape[0]) if t.vals.ndim else 0
        n = n_blocks * (tile + 4)
        for ld in t.levels:
            if ld.pos is not None:
                n += ld.pos.nbytes
        return n
    n = t.nnz * (t.vals.dtype.itemsize + 4)  # vals + one crd per level approx
    for ld in t.levels:
        if ld.pos is not None:
            n += ld.pos.nbytes
    return n


def _on_device(sh: ShardedTensor, name: str, device: torch.device,
               ) -> torch.Tensor:
    """``sh.arrays[name]`` on ``device``, copied once and cached with the
    shard (the cache entry is shared by every copy SHARD_CACHE hands out)."""
    return _device_cached(sh, (name,), device, lambda: sh.arrays[name])


def _shard_cached(sh: ShardedTensor, key: Tuple, build: Callable[[], object]):
    """``build()``, made once and cached with the shard under ``key``."""
    hit = sh.device_arrays.get(key)
    if hit is None:
        hit = sh.device_arrays[key] = build()
    return hit


def _device_cached(sh: ShardedTensor, key: Tuple, device: torch.device,
                   build: Callable[[], object]):
    """What ``build()`` derives from the shard (an array or a tuple of
    arrays, numpy or CPU tensors), moved to ``device`` once and cached with
    the shard under ``key``."""
    def move(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.contiguous().to(device)

    def moved():
        built = build()
        return (tuple(map(move, built)) if isinstance(built, tuple)
                else move(built))

    return _shard_cached(sh, key + (str(device),), moved)


# ---------------------------------------------------------------------------
# Format dispatch: which kernel family handles a signature and whether it
# iterates a sparse operand's format directly.
# ---------------------------------------------------------------------------

_SIG_KERNEL = {
    "d1(i)=s2(i,j)*d1(j)": ("spmv", "spmv"),
    "d2(i,j)=s2(i,k)*d2(k,j)": ("spmm", "spmm"),
    "s2(i,j)=s2(i,j)+s2(i,j)+s2(i,j)": ("spadd3", "spadd3"),
    "s2(i,j)=s2(i,j)*d2(i,k)*d2(k,j)": ("sddmm", "sddmm"),
    "s2(i,j)=s3(i,j,k)*d1(k)": ("spttv", "spmttkrp"),
    "d2(i,l)=s3(i,j,k)*d2(j,l)*d2(k,l)": ("spmttkrp", "spmttkrp"),
}


def _kernel_supports(module: str):
    # resolved when called: the kernel modules import core, so importing
    # them at module scope here would be circular
    import importlib
    return importlib.import_module(f"..kernels.{module}",
                                   package=__package__).supports


def expression_key(sig: str) -> str:
    """Short expression name for cell IDs (``spmm`` in ``spmm/dcsr/nnz/4x1``);
    falls back to the raw signature."""
    entry = _SIG_KERNEL.get(sig)
    return entry[0] if entry else sig


def _normalize_operands(
    stmt: Assignment, space: str,
) -> Tuple[Assignment, List[str], Dict[str, str]]:
    """Format-conversion fallback (logged): every sparse rhs operand whose
    format the selected kernel family cannot iterate directly is converted
    to the canonical target (CSR / CSF). The returned statement is what the
    planner and emitters see; the fallback census (display strings + the
    structured name → declared-key map) is recorded on the LoweredKernel.
    A statement outside the table passes through unchanged (the generic
    path takes it)."""
    sig = stmt.signature()
    entry = _SIG_KERNEL.get(sig)
    if entry is None:
        return stmt, [], {}
    kernel_name, module = entry
    supports = _kernel_supports(module)
    mapping: Dict[str, Tensor] = {}
    fallbacks: List[str] = []
    declared: Dict[str, str] = {}
    # Blocked operands of a multi-operand family (spadd3) must share ONE
    # block layout: the tile-union leaves merge tiles positionally. Mixed
    # layouts force the blocked operands through the conversion fallback.
    sparse_ops = {acc.tensor.name: acc.tensor for acc in stmt.rhs.accesses()
                  if acc.tensor.format.is_sparse}
    force_convert: set = set()
    if (len(sparse_ops) > 1
            and any(t.format.is_blocked for t in sparse_ops.values())
            and len({t.format for t in sparse_ops.values()}) > 1):
        force_convert = {name for name, t in sparse_ops.items()
                         if t.format.is_blocked}
    for acc in stmt.rhs.accesses():
        t = acc.tensor
        if not t.format.is_sparse or t.name in mapping:
            continue
        if supports(t.format, space) and t.name not in force_convert:
            continue
        target = fmt.conversion_target(t.format)
        declared[t.name] = fmt.format_key(t.format)
        fallbacks.append(
            f"{t.name}: {fmt.format_key(t.format)} -> {fmt.format_key(target)}")
        log.warning(
            "no direct %s/%s kernel for %s stored as %s; converting to %s "
            "(conformance cell falls back)",
            kernel_name, space, t.name, t.format, target)
        mapping[t.name] = convert_tensor_cached(t, target)
    return stmt.with_tensors(mapping), fallbacks, declared


# ---------------------------------------------------------------------------
# The lowering entry point
# ---------------------------------------------------------------------------

def lower(
    stmt: Assignment,
    machine: Machine,
    schedule: Union[Schedule, str, None] = None,
    distributions: Optional[Dict[str, Distribution]] = None,
    weights: Optional[np.ndarray] = None,
    *,
    elastic: bool = False,
    init_bounds: Optional[np.ndarray] = None,
    device=None,
) -> LoweredKernel:
    """Compile a scheduled TIN statement into a distributed kernel that runs
    on ``device``: the card when None (raising when there is none), the
    CPU only when asked (``device="cpu"``).

    ``schedule`` is a hand-built :class:`Schedule`, None (the default 1-D
    row schedule) or ``"auto"``: the autoscheduler (:mod:`.plan_search`)
    enumerates strategy × grid-factorization × tile candidates, scores
    them with a roofline model of the card, times the model's top K on
    ``device``, and memoizes the winner in a tuned-plan cache keyed by
    operand content (``kernel.cache.tuned_hits``; the winner is
    ``kernel.tuned``). ``distributions`` declares the data distribution per
    tensor; where it disagrees with the schedule, ``comm.redistribute_bytes``
    charges the reshuffle (paper §II-D). ``weights`` (pieces,) skews the
    non-zero splits toward faster shards (the straggler re-plan).

    ``elastic=True`` routes 1-D materialization through PER-PIECE shard
    caching (``partition.materialize_pieces``): each color is its own
    SHARD_CACHE entry, so a later :func:`relower` onto a resized machine
    reuses every color whose window the resize left alone. The stacked
    arrays are bit for bit the whole-set materializers' output (runners
    are shared). ``init_bounds`` (pieces, 2) overrides the initial equal
    split: :func:`relower` feeds the merged survivor windows here."""
    device = resolve_device(device)
    with fingerprint_memo(), telemetry.span(
            "lower", sig=stmt.signature()) as sp:
        k = _lower_impl(stmt, machine, schedule, distributions, weights,
                        device, elastic=elastic, init_bounds=init_bounds)
        sp.set(cell=k.cell_id(), leaf=k.leaf_name,
               pieces=k.strategy.pieces, warm=k.cache.warm)
        _record_lower_metrics(k)
        return k


def _record_lower_metrics(k: LoweredKernel) -> None:
    """Fold one lower's cache delta and communication ledger into the
    process metrics registry (+ a trace instant with the cache delta)."""
    cs = k.cache
    for field, v in (("plan", cs.plan_hits), ("shard", cs.shard_hits),
                     ("runner", cs.runner_hits), ("convert", cs.convert_hits),
                     ("tuned", cs.tuned_hits)):
        if v:
            telemetry.METRICS.counter(f"lower.cache.{field}.hits", v)
    for field, v in (("plan", cs.plan_misses), ("shard", cs.shard_misses),
                     ("runner", cs.runner_misses),
                     ("convert", cs.convert_misses),
                     ("tuned", cs.tuned_misses)):
        if v:
            telemetry.METRICS.counter(f"lower.cache.{field}.misses", v)
    telemetry.METRICS.counter("lower.count")
    if cs.warm:
        telemetry.METRICS.counter("lower.warm_count")
    comm = k.comm
    if comm.axes:
        for name, ax in comm.axes.items():
            telemetry.METRICS.counter(f"comm.axis.{name}.broadcast_bytes",
                                      ax.broadcast_bytes)
            telemetry.METRICS.counter(f"comm.axis.{name}.reduce_bytes",
                                      ax.reduce_bytes)
    else:
        telemetry.METRICS.counter("comm.replicate_bytes",
                                  comm.replicate_bytes)
        telemetry.METRICS.counter("comm.reduce_bytes", comm.reduce_bytes)
    telemetry.METRICS.counter("comm.network_bytes",
                              comm.total_network_bytes())
    telemetry.instant("lower.cache", **cs.as_dict())


def _lower_impl(stmt, machine, schedule, distributions, weights, device,
                elastic=False, init_bounds=None):
    snap = _cache_snapshot()
    tuned_point = None
    if isinstance(schedule, str):
        if schedule != "auto":
            raise ValueError(
                f"unknown schedule string {schedule!r}; pass a Schedule, "
                "None, or 'auto'")
        from . import plan_search
        schedule, machine, tuned_point = plan_search.resolve_auto(
            stmt, machine, weights=weights, device=device)
    if schedule is None:
        schedule = default_row_schedule(stmt, machine)
    strat = schedule.strategy()
    pieces = strat.pieces
    sig = stmt.signature()

    # Format dispatch: convert operands with no direct leaf (logged).
    stmt, fallbacks, declared_formats = _normalize_operands(stmt, strat.space)

    # Grid universe schedules route to the grid subsystem: cross-product
    # tile plans, per-axis communication, SUMMA-style emitters. Grid
    # NON-ZERO schedules fall through: a nested pos-split canonicalizes to
    # the flat equal split of the fused position space (pieces = P·Q), so
    # the 1-D nnz machinery lowers them bit for bit as their Px1 twins;
    # only the communication attribution (below) differs.
    if strat.is_grid and strat.space == "universe":
        from . import grid as grid_mod
        k = grid_mod.lower_grid(stmt, machine, strat, device, fallbacks,
                                declared_formats, snap, distributions)
        k.tuned = tuned_point
        return k

    out_t: Tensor = stmt.lhs.tensor
    shards: Dict[str, ShardedTensor] = {}
    comm = CommStats(pieces=pieces)

    # ---- Steps 1 & 2 of Fig. 9a: initial + derived partitions, memoized --
    with telemetry.span("lower.plan", sig=sig, space=strat.space,
                        pieces=pieces):
        plan_key = _plan_cache_key(stmt, strat, weights, init_bounds)
        plans = _PLAN_CACHE.get(plan_key)
        telemetry.instant("lower.plan.cache", hit=plans is not None,
                          memoizable=True)
        if plans is not None:
            # Rebind the memoized plans to the CURRENT statement's tensors:
            # the key proves their content, not the identity of the objects
            # the plans were computed from.
            current: Dict[str, Tensor] = {}
            for acc in stmt.accesses():
                current.setdefault(acc.tensor.name, acc.tensor)
            plans = {name: dataclasses.replace(p, tensor=current[name])
                     for name, p in plans.items()}
        else:
            plans = _compute_plans(stmt, strat, out_t, weights, init_bounds)
            _PLAN_CACHE.put(plan_key, {
                name: dataclasses.replace(p, tensor=None)
                for name, p in plans.items()})

    # ---- materialize ------------------------------------------------------
    self_materializing = (sig, strat.space) in _SELF_MATERIALIZING
    with telemetry.span("lower.materialize", sig=sig, pieces=pieces):
        if self_materializing:
            # spadd3/nnz: equal (or weighted) chunks of the addends'
            # concatenated entry stream, packed by the materialization
            # layer. Comm = every chunk's union ships to the root for the
            # cross-chunk merge: coords + vals per entry, a whole (br, bc)
            # tile per entry for blocked operands.
            add_tensors, seen = [], set()
            for acc in stmt.rhs.accesses():
                t = acc.tensor
                if t.format.is_sparse and t.name not in seen:
                    seen.add(t.name)
                    add_tensors.append(t)
            shards["_addstream"] = materialize_add_stream(add_tensors,
                                                          pieces, weights)
            n_entries = shards["_addstream"].meta["n_entries"]
            if add_tensors and add_tensors[0].format.is_blocked:
                tile = int(np.prod(add_tensors[0].format.block_shape))
                comm.reduce_bytes += n_entries * (8 + tile * 4)
            else:
                comm.reduce_bytes += n_entries * 12
        for name, plan in plans.items():
            t = plan.tensor
            if self_materializing:
                continue  # the add stream above is the whole shard set
            if name == out_t.name and _output_is_assembled(sig):
                continue  # assembled from the leaf results, not materialized
            if plan.replicated:
                shards[name] = (materialize_replicated_elastic(t, pieces)
                                if elastic
                                else materialize_replicated(t, pieces))
                comm.replicate_bytes += _nbytes(t)
            elif strat.space == "nnz" and t.format.is_sparse:
                kind = "bcsr_nnz" if t.format.is_blocked else "coo_nnz"
                shards[name] = (materialize_pieces(kind, t, plan) if elastic
                                else materialize_bcsr_nnz(t, plan)
                                if t.format.is_blocked
                                else materialize_coo_nnz(t, plan))
            elif (t.format.is_sparse and t.order >= 3
                    and t.format.levels[1].singleton):
                # trailing-singleton trees (COO3) have no grouped middle
                # level: the universe row plan materializes the flat walk
                # (coordinate columns bucketed by row window)
                shards[name] = (materialize_pieces("coo_nnz", t, plan)
                                if elastic else materialize_coo_nnz(t, plan))
            elif t.format.is_all_dense:
                shards[name] = (
                    materialize_dense_rows_pieces(t, plan.root_coord_bounds)
                    if elastic
                    else materialize_dense_rows(t, plan.root_coord_bounds))
            elif t.format.is_blocked:
                shards[name] = (materialize_pieces("bcsr_rows", t, plan)
                                if elastic else materialize_bcsr_rows(t, plan))
            else:
                shards[name] = (materialize_pieces("csr_rows", t, plan)
                                if elastic else materialize_csr_rows(t, plan))

        # data-vs-computation distribution mismatch cost
        for name, d in (distributions or {}).items():
            want = plans.get(name)
            if want is None or want.replicated:
                continue
            if not _plans_equal(want, d.plan(want.tensor)):
                comm.redistribute_bytes += _nbytes(want.tensor)

        if strat.space == "nnz" and not self_materializing:
            ov = plans[next(iter(plans))]  # position tensor plan
            if ov.tensor.format.dim_of_level(0) != 0:
                # storage root doesn't track output rows (CSC, BCSC): every
                # color reduces a FULL-extent output partial
                # (_nnz_row_windows, _bcsr_nnz_windows)
                comm.reduce_bytes += _nbytes(out_t)
            elif ov.tensor.format.is_blocked:
                # overlapping BLOCK-rows reduce across colors; the payload
                # per overlapped block-row is its br-row output stripe
                bb = ov.levels[0].coord_bounds
                comm.reduce_bytes += int(
                    (bb[:, 1] - bb[:, 0]).sum()
                    - (bb[:, 1].max() - bb[:, 0].min())
                ) * ov.tensor.format.block_shape[0] * 4
            else:
                # overlapping output rows reduced across colors
                rb = ov.root_coord_bounds
                comm.reduce_bytes += int(
                    (rb[:, 1] - rb[:, 0]).sum()
                    - (rb[:, 1].max() - rb[:, 0].min())) * 4

        # Grid nnz schedules: re-attribute the flat replicate/reduce payload
        # to the machine axes under the hierarchical collective model
        # (broadcast along x once, then along y within each of the P grid
        # rows; reduce in reverse). Totals are unchanged (b·(PQ−1)).
        if strat.is_grid:
            m = 1
            axes = {}
            for d in strat.machine_dims:
                axes[d.name] = AxisComm(size=d.size,
                                        broadcast_bytes=m * comm.replicate_bytes,
                                        reduce_bytes=m * comm.reduce_bytes)
                m *= d.size
            comm.axes = axes
            comm.replicate_bytes = 0
            comm.reduce_bytes = 0

    # ---- emit: pick leaf + build runner ------------------------------------
    with telemetry.span("lower.emit", sig=sig, space=strat.space) as esp:
        leaf_name, runner, args = _emit(stmt, strat, plans, shards, device)
        esp.set(leaf=leaf_name)
    return LoweredKernel(
        stmt=stmt, strategy=strat, machine=machine, plans=plans,
        shards=shards, runner=runner, args=args, comm=comm,
        leaf_name=leaf_name, device=device, fallbacks=fallbacks,
        declared_formats=declared_formats, cache=_cache_delta(snap),
        tuned=tuned_point)


def _plan_cache_key(stmt: Assignment, strat: DistStrategy,
                    weights: Optional[np.ndarray],
                    init_bounds: Optional[np.ndarray] = None) -> Tuple:
    """Memoization key for the partitioning step: signature + strategy +
    per-operand content fingerprints + straggler weights + the elastic
    init-bounds override."""
    ops = tuple((acc.tensor.name, tensor_fingerprint(acc.tensor),
                 tuple(v.name for v in acc.idx)) for acc in stmt.accesses())
    init_crc = (None if init_bounds is None
                else _crc_arrays(0, np.asarray(init_bounds, dtype=np.int64)))
    return (stmt.signature(), strat.space,
            tuple(v.name for v in strat.vars),
            tuple(d.size for d in strat.machine_dims),
            tuple(strat.replicate), weights_fingerprint(weights), init_crc,
            ops)


def _compute_plans(stmt: Assignment, strat: DistStrategy, out_t: Tensor,
                   weights: Optional[np.ndarray],
                   init_bounds: Optional[np.ndarray] = None,
                   ) -> Dict[str, TensorPartition]:
    """Fig. 9a steps 1 & 2: initial + derived coordinate-tree partitions.

    ``init_bounds`` replaces the equal initial split (universe: root
    coordinate windows; nnz: split-level position windows) with
    caller-supplied windows — relower's migration bounds, already
    block-aligned because they come from a previous plan of the same
    operands."""
    plans: Dict[str, TensorPartition] = {}
    pieces = strat.pieces
    dist_var = strat.var
    if strat.space == "universe":
        # coordinate-value loop -> createInitialUniversePartitions
        n = stmt.var_extent(dist_var)
        if init_bounds is not None:
            bounds = np.asarray(init_bounds, dtype=np.int64)
        else:
            bounds = partition_by_bounds(n, pieces)
            # A blocked operand distributed on its row dimension snaps the
            # split to block-row boundaries, so every co-partitioned tensor
            # (the other addends, the output) shares the same per-color row
            # windows.
            for acc in stmt.rhs.accesses():
                t = acc.tensor
                if (t.format.is_sparse and t.format.is_blocked
                        and dist_var in acc.idx
                        and acc.idx.index(dist_var) == 0):
                    bounds = block_aligned_row_bounds(
                        n, pieces, t.format.block_shape[0])
                    break
        for acc in stmt.accesses():
            t = acc.tensor
            if t.name in plans:
                continue
            if dist_var in acc.idx:
                lvl_dim = acc.idx.index(dist_var)
                if t.format.level_of_dim(lvl_dim) == 0 or (
                        lvl_dim == 0 and t.format.is_sparse):
                    # distributed dim at the storage root: the image chain;
                    # column-major roots (CSC): the transpose walk realizes
                    # the same row windows (partition routes it)
                    plans[t.name] = partition_tensor_rows(t, bounds)
                    continue
            # not indexed by the distributed var at the root -> communicate
            # fetches the whole tensor per color (replication)
            plans[t.name] = replicate_tensor(t, pieces)
        return plans
    if (stmt.signature(), strat.space) in _SELF_MATERIALIZING:
        # spadd3/nnz: each addend's equal nnz split (imbalance ~0 by
        # construction); the chunk shards come from the add stream at
        # materialize time.
        for acc in stmt.rhs.accesses():
            t = acc.tensor
            if t.name not in plans:
                plans[t.name] = (partition_tensor_nonzeros(t, pieces)
                                 if t.format.is_sparse
                                 else replicate_tensor(t, pieces))
        return plans
    # coordinate-position loop -> createInitialNonZeroPartition of the
    # position-space (sparse) tensor, then partition the remaining
    # coordinate trees from its derived root partition.
    pos_tensor = next((acc.tensor for acc in stmt.rhs.accesses()
                       if acc.tensor.format.is_sparse), None)
    if pos_tensor is None:
        raise ValueError("nnz schedule requires a sparse rhs tensor")
    p = partition_tensor_nonzeros(pos_tensor, pieces, weights,
                                  init_bounds=init_bounds)
    plans[pos_tensor.name] = p
    for acc in stmt.accesses():
        t = acc.tensor
        if t.name in plans:
            continue
        if (t is out_t and not t.format.is_sparse and stmt.lhs.idx
                and stmt.lhs.idx[0] == pos_tensor_root_var(stmt, pos_tensor)):
            plans[t.name] = partition_tensor_rows(t, p.root_coord_bounds)
        else:
            plans[t.name] = replicate_tensor(t, pieces)
    return plans


def pos_tensor_root_var(stmt: Assignment, pos_tensor: Tensor) -> IndexVar:
    """The index variable iterated at the tensor's STORAGE root level (for
    CSC that is the column variable — non-zero partitions then own column
    windows, and output-row locality is gone)."""
    for acc in stmt.rhs.accesses():
        if acc.tensor is pos_tensor:
            return acc.idx[pos_tensor.format.dim_of_level(0)]
    raise KeyError(pos_tensor.name)


def _output_is_assembled(sig: str) -> bool:
    # sparse outputs (sddmm, spttv, spadd3) are assembled from leaf results
    return sig.startswith("s")


# (sig, space) pairs whose lower packs its own shard set (the add stream)
# instead of materializing each tensor's plan
_SELF_MATERIALIZING = {
    ("s2(i,j)=s2(i,j)+s2(i,j)+s2(i,j)", "nnz"),
}


def _plans_equal(a: TensorPartition, b: TensorPartition) -> bool:
    if a.replicated != b.replicated:
        return False
    for x, y in ((a.vals_bounds, b.vals_bounds),
                 (a.root_coord_bounds, b.root_coord_bounds)):
        if (x is None) != (y is None):
            return False
        if x is not None and not np.array_equal(x, y):
            return False
    return True


def default_row_schedule(stmt: Assignment, machine: Machine) -> Schedule:
    """The paper's Fig. 1 schedule generalized: divide the first result
    variable over the machine's first dimension, distribute, communicate."""
    i = stmt.result_vars[0]
    io, ii = IndexVar(f"{i.name}o"), IndexVar(f"{i.name}i")
    s = Schedule(stmt, machine)
    s.divide(i, io, ii, machine.dims[0]).distribute(io)
    s.communicate(stmt.tensors(), io)
    return s


def default_nnz_schedule(stmt: Assignment, machine: Machine) -> Schedule:
    """Fuse all sparse loops and split non-zeros evenly (paper §II-D)."""
    spa = stmt.sparse_accesses()[0]
    s = Schedule(stmt, machine)
    vs = list(spa.idx)
    f = vs[0]
    for v in vs[1:]:
        nf = IndexVar(f"{f.name}{v.name}")
        s.fuse(f, v, nf)
        f = nf
    fo, fi = IndexVar(f"{f.name}o"), IndexVar(f"{f.name}i")
    s.pos_split(f, fo, fi, machine.dims[0]).distribute(fo)
    s.communicate(stmt.tensors(), fo)
    return s


def default_grid_schedule(stmt: Assignment, machine: Machine) -> Schedule:
    """2-D universe schedule — the paper's ``distribute((i, k) → (x, y))``:
    divide the sparse operand's two index variables over the machine's two
    dimensions and distribute both, tiling the operand onto the processor
    grid (SUMMA-style for SpMM/SpMV, owner-computes tiles for SDDMM)."""
    spa = stmt.sparse_accesses()[0]
    if len(spa.idx) < 2 or len(machine.dims) < 2:
        raise ValueError("grid schedule needs a 2-D sparse operand and a "
                         "2-D machine")
    i, k2 = spa.idx[0], spa.idx[1]
    io, ii = IndexVar(f"{i.name}o"), IndexVar(f"{i.name}i")
    ko, ki = IndexVar(f"{k2.name}o"), IndexVar(f"{k2.name}i")
    s = Schedule(stmt, machine)
    s.divide(i, io, ii, machine.dims[0])
    s.divide(k2, ko, ki, machine.dims[1])
    s.distribute(io, ko)
    s.communicate(stmt.tensors(), io)
    return s


def default_grid_nnz_schedule(stmt: Assignment, machine: Machine) -> Schedule:
    """2-D non-zero schedule: fuse the sparse loops, then NEST the position
    split over both machine dimensions — color (p, q) owns block p*Q+q of
    the fused non-zero stream (canonically equal to the flat P*Q split, so
    2-D nnz cells are bit-for-bit their Px1 counterparts)."""
    if len(machine.dims) < 2:
        raise ValueError("grid nnz schedule needs a 2-D machine")
    spa = stmt.sparse_accesses()[0]
    s = Schedule(stmt, machine)
    vs = list(spa.idx)
    f = vs[0]
    for v in vs[1:]:
        nf = IndexVar(f"{f.name}{v.name}")
        s.fuse(f, v, nf)
        f = nf
    outers = []
    cur = f
    for d in machine.dims:
        co, ci = IndexVar(f"{cur.name}o"), IndexVar(f"{cur.name}i")
        s.pos_split(cur, co, ci, d)
        outers.append(co)
        cur = ci
    s.distribute(*outers)
    s.communicate(stmt.tensors(), outers[0])
    return s


def default_grid3_schedule(stmt: Assignment, machine: Machine) -> Schedule:
    """3-D universe schedule over an order-3 machine grid. An order-3
    sparse operand maps its three index variables onto the three machine
    dimensions (P×Q×R COO bricks); an order-2 operand nests a second
    divide of its column variable so the grid reads ``i → x, j → (y, z)``
    (the joint Q·R column split used by spadd3)."""
    if len(machine.dims) < 3:
        raise ValueError("grid3 schedule needs a 3-D machine")
    spa = stmt.sparse_accesses()[0]
    s = Schedule(stmt, machine)
    if len(spa.idx) >= 3:
        outers = []
        for v, d in zip(spa.idx[:3], machine.dims[:3]):
            vo, vi = IndexVar(f"{v.name}o"), IndexVar(f"{v.name}i")
            s.divide(v, vo, vi, d)
            outers.append(vo)
        s.distribute(*outers)
        s.communicate(stmt.tensors(), outers[0])
        return s
    i, j = spa.idx[0], spa.idx[1]
    io, ii = IndexVar(f"{i.name}o"), IndexVar(f"{i.name}i")
    jo, ji = IndexVar(f"{j.name}o"), IndexVar(f"{j.name}i")
    jio, jii = IndexVar(f"{ji.name}o"), IndexVar(f"{ji.name}i")
    s.divide(i, io, ii, machine.dims[0])
    s.divide(j, jo, ji, machine.dims[1])
    s.divide(ji, jio, jii, machine.dims[2])
    s.distribute(io, jo, jio)
    s.communicate(stmt.tensors(), io)
    return s


def default_replicated_schedule(stmt: Assignment, machine: Machine) -> Schedule:
    """2.5-D communication-avoiding schedule: tile the sparse operand over
    the first two machine dimensions (as the 2-D grid schedule does) and
    split the remaining dense loop variable over the third, replicating
    the sparse operand along it — each z-layer computes a disjoint slab of
    the dense contraction, so the cross-grid reduction shrinks from a
    (Q·R−1)-hop all-reduce to (Q−1) hops at the cost of broadcasting the
    sparse operand R−1 extra times."""
    if len(machine.dims) < 3:
        raise ValueError("replicated schedule needs a 3-D machine")
    spa = stmt.sparse_accesses()[0]
    v0, v1 = spa.idx[0], spa.idx[1]
    rest = [v for v in stmt.all_vars if v not in spa.idx]
    if not rest:
        raise ValueError("replicated schedule needs a loop variable outside "
                         "the sparse operand's index set")
    v2 = rest[0]
    s = Schedule(stmt, machine)
    outers = []
    for v, d in zip((v0, v1, v2), machine.dims[:3]):
        vo, vi = IndexVar(f"{v.name}o"), IndexVar(f"{v.name}i")
        s.divide(v, vo, vi, d)
        outers.append(vo)
    s.distribute(*outers)
    s.replicate([spa.tensor], machine.dims[2])
    s.communicate(stmt.tensors(), outers[0])
    return s


# ---------------------------------------------------------------------------
# Elastic re-plan: mesh-as-data. A Schedule traces against ONE machine, but
# the STRATEGY it canonicalizes to is plain data (space, grid rank,
# replication, tile), so moving a lowered kernel to a different machine is
# a pure function of (strategy, new machine), not a re-trace of user
# schedule code. relower() is the elastic entry point: rebuild the
# schedule family on the new machine, derive migration-friendly initial
# bounds, and re-lower with per-piece shard caching so everything the
# resize did not touch is a cache hit.
# ---------------------------------------------------------------------------


def rebuild_schedule(stmt: Assignment, machine: Machine,
                     strat: DistStrategy) -> Schedule:
    """Re-instantiate ``strat``'s schedule family against a NEW machine:
    one of the default 1-D, grid, grid-nnz, 3-D and replicated schedules,
    with the strategy's tile hint carried over."""
    nd = len(machine.dims)
    if strat.replicate and nd >= 3:
        s = default_replicated_schedule(stmt, machine)
    elif nd >= 3:
        s = default_grid3_schedule(stmt, machine)
    elif nd == 2:
        s = (default_grid_schedule(stmt, machine)
             if strat.space == "universe"
             else default_grid_nnz_schedule(stmt, machine))
    elif strat.space == "universe":
        s = default_row_schedule(stmt, machine)
    else:
        s = default_nnz_schedule(stmt, machine)
    if strat.tile is not None:
        s.tile_hint(*strat.tile)
    return s


def _elastic_init_bounds(kernel: LoweredKernel) -> Optional[np.ndarray]:
    """The initial split the kernel's plans were derived from: universe →
    the (block-aligned) root row windows; nnz → the position tensor's
    split-level windows (== vals_bounds under full fusion / block split).
    None when no migration-style reuse applies (grids, spadd3/nnz whose
    per-operand splits are independent)."""
    strat = kernel.strategy
    if strat.is_grid:
        return None
    if (kernel.stmt.signature(), strat.space) in _SELF_MATERIALIZING:
        return None
    if strat.space == "universe":
        for p in kernel.plans.values():
            if not p.replicated and p.root_coord_bounds is not None:
                return np.asarray(p.root_coord_bounds, dtype=np.int64)
        return None
    for acc in kernel.stmt.rhs.accesses():
        if acc.tensor.format.is_sparse:
            p = kernel.plans.get(acc.tensor.name)
            if p is not None and p.vals_bounds is not None:
                return np.asarray(p.vals_bounds, dtype=np.int64)
            return None
    return None


def relower(kernel: LoweredKernel, new_machine: Machine, *,
            dead: Optional[int] = None,
            weights: Optional[np.ndarray] = None,
            device=None) -> LoweredKernel:
    """Re-plan a lowered kernel for a DIFFERENT machine — shrunk, grown,
    or re-factorized — reusing every cache entry the resize leaves valid.

    ``dead`` names the lost piece for a P→P−1 shrink: its window is merged
    into a neighbor (``partition.elastic_row_bounds``) instead of
    re-splitting equally, so P−2 of the surviving windows — and their
    per-piece shard cache entries, seeded by a previous
    ``lower(..., elastic=True)`` — are bitwise unchanged. Reuse is
    observable as ``kernel.cache.shard_reuse``. Without ``dead`` (or for
    grids / weighted re-plans) the new machine gets a fresh equal split;
    replicated operands still hit regardless.

    ``weights`` forwards to the straggler re-plan path:
    ``relower(kernel, kernel.machine, weights=w)`` re-balances in place on
    the SAME machine. The new kernel runs on ``device``, by default the
    old kernel's."""
    stmt = kernel.stmt
    old = kernel.strategy
    schedule = rebuild_schedule(stmt, new_machine, old)
    new_strat = schedule.strategy()
    init = None
    if (dead is not None and weights is None
            and not old.is_grid and not new_strat.is_grid
            and new_strat.space == old.space
            and new_strat.pieces == old.pieces - 1):
        ob = _elastic_init_bounds(kernel)
        if ob is not None and ob.shape[0] == old.pieces:
            init = elastic_row_bounds(ob, dead)
    return lower(stmt, new_machine, schedule=schedule, weights=weights,
                 elastic=True, init_bounds=init,
                 device=kernel.device if device is None else device)


def _materialize_dense_operand(t: Tensor, plan: TensorPartition, pieces: int,
                               cache: bool = False) -> ShardedTensor:
    """Re-pack ONE all-dense operand under its existing partition geometry
    — the same branch structure the 1-D and grid lowering paths use, minus
    every sparse case (rebinds and ``run_overlapped``'s chunks only ever
    swap dense data)."""
    if plan.replicated:
        return materialize_replicated(t, pieces, cache=cache)
    if plan.grid is not None:
        return materialize_dense_grid(t, plan.levels[0].coord_bounds,
                                      plan.levels[1].coord_bounds,
                                      cache=cache)
    if plan.root_coord_bounds is None:
        return materialize_dense_cols(t, plan.levels[1].coord_bounds,
                                      cache=cache)
    return materialize_dense_rows(t, plan.root_coord_bounds, cache=cache)


# ---------------------------------------------------------------------------
# Leaf emission: one emitter per expression × strategy. Every emitter
# returns ``(leaf_name, runner, args)``; the shards' device copies in
# ``args`` are made here, once, and the runner only launches the leaves and
# assembles the output.
# ---------------------------------------------------------------------------

def _runner(name: str, static: Tuple, arrays: Tuple, build, device):
    """Runner-cache front-end used by every emitter. ``build()`` returns
    the compute fn; all per-lower DATA must flow through its arguments
    (``arrays`` is the argument prototype for the shapes/dtypes key
    component) and every Python constant it closes over must be listed in
    ``static``."""
    key = (name, tuple(static), avals_key(arrays), str(device))

    def _build():
        with telemetry.span("lower.jit", leaf=name):
            return build()

    return _RUNNER_CACHE.get_or_build(key, _build)


def _nnz_row_windows(B: ShardedTensor, n: int):
    """Row-window parameters for a coordinate-column shard set. When the
    storage root tracks output rows, leaves compute into the shard's root
    window; otherwise (CSC) every shard computes a full-extent partial and
    the scatter reduces the overlap."""
    a = B.arrays
    if B.meta.get("root_dim", 0) == 0 and B.meta["max_rows"] > 0:
        return a["row_start"], a["row_count"], int(B.meta["max_rows"])
    pieces = B.pieces
    return (np.zeros((pieces,), dtype=np.int32),
            np.full((pieces,), n, dtype=np.int32), int(n))


def _bcsr_nnz_windows(B: ShardedTensor):
    """Block-row window parameters (brow_start, row_start, row_count,
    max_brows) of a blocked nnz shard set. Column-major roots (BCSC: the
    root tracks block-columns) and empty shard sets fall back to full-grid
    windows, so leaves reduce over the whole block grid."""
    a = B.arrays
    max_brows = int(B.meta["max_brows"])
    if B.meta.get("root_dim", 0) == 0 and max_brows > 0:
        return a["brow_start"], a["row_start"], a["row_count"], max_brows
    pieces = B.pieces
    return (np.zeros((pieces,), dtype=np.int32),
            np.zeros((pieces,), dtype=np.int32),
            np.full((pieces,), int(B.meta["n_rows"]), dtype=np.int32),
            max(int(B.meta["grid_rows"]), 1))


def _nnz_leaf_inputs(B: ShardedTensor, row_start: np.ndarray, max_rows: int,
                     device: torch.device, cols: Tuple[str, ...] = ("dim1",),
                     rows: str = "dim0"):
    """(rows_local, *cols, vals) of a coordinate-column shard set on
    ``device``, the flat leaves' inputs, prepared once and cached with the
    shard (:func:`_nnz_leaf_host` on the device)."""
    return _device_cached(
        B, ("nnz_leaf_inputs", max_rows, rows) + cols, device,
        lambda: _nnz_leaf_host(B, row_start, max_rows, cols, rows))


def _nnz_leaf_host(B: ShardedTensor, row_start: np.ndarray, max_rows: int,
                   cols: Tuple[str, ...] = ("dim1",), rows: str = "dim0"):
    """The host arrays of :func:`_nnz_leaf_inputs`, made once and cached
    with the shard. Rows (block-rows ``bdim0`` of a blocked shard, whose
    ``vals`` are tiles) are rebased to each piece's window and clipped into
    it, as the reference's emitter does; padding slots get the dropped id
    ``max_rows``, so each piece stays row-sorted. A piece whose rows are not
    sorted (column-major roots: CSC, BCSC) is stable-sorted by row, the
    order the row-run kernels require."""
    def build():
        a = B.arrays
        ids = np.clip(a[rows].astype(np.int64) - row_start[:, None], 0,
                      max(max_rows - 1, 0))
        pad = np.arange(ids.shape[1])[None, :] >= a["nnz_count"][:, None]
        ids[pad] = max_rows
        rest = [a[c] for c in cols] + [a["vals"]]
        if ids.size and (np.diff(ids, axis=1) < 0).any():
            order = np.argsort(ids, axis=1, kind="stable")
            ids = np.take_along_axis(ids, order, axis=1)
            rest = [np.take_along_axis(
                x, order.reshape(order.shape + (1,) * (x.ndim - 2)), axis=1)
                for x in rest]
        return (ids.astype(np.int32), *rest)

    return _shard_cached(B, ("nnz_leaf_host", max_rows, rows) + cols, build)


def _bcsr_row_ids(B: ShardedTensor, device: torch.device) -> torch.Tensor:
    """Per-slot block-row ids (P, N) of a blocked row shard set on
    ``device`` (:func:`bcsr_row_ids_host`), cached with the shard."""
    return _device_cached(B, ("bcsr_row_ids",), device,
                          lambda: bcsr_row_ids_host(B.arrays, slice(None)))


def bcsr_row_ids_host(a: Dict[str, np.ndarray], pieces: slice) -> np.ndarray:
    """Per-slot block-row ids of the ``pieces`` of a blocked row shard set
    (arrays ``a``), expanded from ``pos1``; padding slots get the dropped
    id max_brows, so each piece stays sorted."""
    pos = a["pos1"][pieces].astype(np.int64)
    R = pos.shape[1] - 1
    ids = np.full((pos.shape[0], a["crd1"].shape[1]), R, dtype=np.int32)
    for p in range(pos.shape[0]):
        ids[p, :pos[p, -1]] = np.repeat(np.arange(R, dtype=np.int32),
                                        np.diff(pos[p]))
    return ids


def _packed(S: ShardedTensor, pack: Callable, grid: int, b: int,
            device: torch.device, shape: Optional[Tuple[int, ...]] = None):
    """A dense co-operand shard's values packed into the blocks of a blocked
    operand's grid (``kernels.layout``), reshaped to ``shape`` when given,
    made once and cached with the shard."""
    def build():
        x = pack(S.arrays["vals"], grid, b)
        return x if shape is None else x.reshape(shape)

    return _device_cached(S, (pack.__name__, grid, b, shape), device, build)


def _bcsr_product(name: str, kernel: Callable, pack: Callable, out_shape,
                  B: ShardedTensor, dense: ShardedTensor, nnz: bool,
                  device: torch.device):
    """The blocked SpMV / SpMM leaf, (runner, args): the kernel over the
    shard set's stored-block stream into per-piece block-row windows, then
    ``_scatter_rows`` into the output (overlapping windows under nnz reduce
    in piece order). Rows expands ``pos1`` into block-row ids; nnz rebases
    and clips the block-rows (``_bcsr_nnz_windows``)."""
    a = B.arrays
    if nnz:
        brow_start, row_start, row_count, max_brows = _bcsr_nnz_windows(B)
        stream = _nnz_leaf_inputs(B, brow_start, max_brows, device,
                                  cols=("bdim1",), rows="bdim0")
        static = tuple(out_shape) + (max_brows,)
    else:
        row_start, row_count = a["row_start"], a["row_count"]
        max_brows = a["pos1"].shape[1] - 1
        stream = (_bcsr_row_ids(B, device), _on_device(B, "crd1", device),
                  _on_device(B, "vals", device))
        static = tuple(out_shape)

    def fn(brow, bcol, tiles, packed, max_brows, row_start, row_count):
        blocks = kernel(brow, bcol, tiles, packed, int(max_brows))
        return _scatter_rows(out_shape, blocks, row_start, row_count)

    # max_brows travels as an argument: the reference's static key does
    # not hold it under rows
    args = (*stream, _packed(dense, pack, int(B.meta["grid_cols"]),
                             int(B.meta["bc"]), device),
            np.asarray(max_brows), row_start, row_count)
    return _runner(name, static, args, lambda: fn, device), args


# -- SpMV -------------------------------------------------------------------

def _emit_spmv_rows(stmt, plans, shards, device):
    Bt = stmt.rhs.accesses()[0].tensor
    B = shards[Bt.name]
    c = shards[stmt.rhs.accesses()[1].tensor.name]
    n = stmt.lhs.tensor.shape[0]
    a = B.arrays
    if tree_of(Bt).blocked:
        return ("bcsr_spmv_rows", *_bcsr_product(
            "bcsr_spmv_rows", bcsr_kernels.bcsr_spmv, pack_vec_blocks, (n,),
            B, c, False, device))

    def fn(pos, crd, vals, cvec, row_start, row_count):
        blocks = spmv_kernels.spmv_csr_rows(pos, crd, vals, cvec)  # (P, R)
        return _scatter_rows((n,), blocks, row_start, row_count)

    args = (_on_device(B, "pos1", device), _on_device(B, "crd1", device),
            _on_device(B, "vals", device), _on_device(c, "vals", device),
            a["row_start"], a["row_count"])
    f = _runner("spmv_rows", (n,), args, lambda: fn, device)
    return "spmv_rows", f, args


def _emit_spmv_nnz(stmt, plans, shards, device):
    Bt = stmt.rhs.accesses()[0].tensor
    B = shards[Bt.name]
    c = shards[stmt.rhs.accesses()[1].tensor.name]
    n = stmt.lhs.tensor.shape[0]
    if tree_of(Bt).blocked:
        return ("bcsr_spmv_nnz", *_bcsr_product(
            "bcsr_spmv_nnz", bcsr_kernels.bcsr_spmv, pack_vec_blocks, (n,),
            B, c, True, device))
    row_start, row_count, max_rows = _nnz_row_windows(B, n)

    def fn(rows, cols, vals, cvec, row_start, row_count):
        blocks = spmv_kernels.spmv_coo_nnz(rows, cols, vals, cvec, max_rows)
        return _scatter_rows((n,), blocks, row_start, row_count)

    args = (*_nnz_leaf_inputs(B, row_start, max_rows, device),
            _on_device(c, "vals", device), row_start, row_count)
    f = _runner("spmv_nnz", (n, max_rows), args, lambda: fn, device)
    return "spmv_nnz", f, args


# -- SpMM -------------------------------------------------------------------

def _emit_spmm_rows(stmt, plans, shards, device):
    Bacc, Cacc = stmt.rhs.accesses()
    B, C = shards[Bacc.tensor.name], shards[Cacc.tensor.name]
    out_shape = stmt.lhs.tensor.shape
    a = B.arrays
    if tree_of(Bacc.tensor).blocked:
        return ("bcsr_spmm_rows", *_bcsr_product(
            "bcsr_spmm_rows", bcsr_kernels.bcsr_spmm, pack_mat_row_blocks,
            out_shape, B, C, False, device))

    def fn(pos, crd, vals, Cmat, row_start, row_count):
        blocks = spmm_kernels.spmm_csr_rows(pos, crd, vals, Cmat)  # (P, R, J)
        return _scatter_rows(out_shape, blocks, row_start, row_count)

    args = (_on_device(B, "pos1", device), _on_device(B, "crd1", device),
            _on_device(B, "vals", device), _on_device(C, "vals", device),
            a["row_start"], a["row_count"])
    f = _runner("spmm_rows", out_shape, args, lambda: fn, device)
    return "spmm_rows", f, args


def _emit_spmm_nnz(stmt, plans, shards, device):
    Bacc, Cacc = stmt.rhs.accesses()
    B, C = shards[Bacc.tensor.name], shards[Cacc.tensor.name]
    out_shape = stmt.lhs.tensor.shape
    if tree_of(Bacc.tensor).blocked:
        return ("bcsr_spmm_nnz", *_bcsr_product(
            "bcsr_spmm_nnz", bcsr_kernels.bcsr_spmm, pack_mat_row_blocks,
            out_shape, B, C, True, device))
    row_start, row_count, max_rows = _nnz_row_windows(B, out_shape[0])

    def fn(rows, cols, vals, Cmat, row_start, row_count):
        blocks = spmm_kernels.spmm_coo_nnz(rows, cols, vals, Cmat, max_rows)
        return _scatter_rows(out_shape, blocks, row_start, row_count)

    args = (*_nnz_leaf_inputs(B, row_start, max_rows, device),
            _on_device(C, "vals", device), row_start, row_count)
    f = _runner("spmm_nnz", out_shape + (max_rows,), args, lambda: fn,
                device)
    return "spmm_nnz", f, args


# -- SpAdd3 -----------------------------------------------------------------

def _compressed_tensor(name: str, shape, format: "fmt.Format", pos, crd,
                       vals) -> Tensor:
    """A (Dense, Compressed) result (CSR, BCSR, BCSC) from its storage
    regions, already in storage order; the levels of a blocked format
    index the block grid, as ``Tensor.from_blocks`` builds them."""
    bs = format.block_shape or (1, 1)
    size = [-(-shape[format.dim_of_level(l)] // bs[format.dim_of_level(l)])
            for l in (0, 1)]
    levels = [LevelData(format.levels[0], size[0]),
              LevelData(format.levels[1], size[1],
                        pos=np.asarray(pos, dtype=INT),
                        crd=np.asarray(crd, dtype=INT))]
    return Tensor(name, shape, format, levels, vals, vals.dtype)


def _sorted_row_shard(S: ShardedTensor, device: torch.device):
    """(pos1, crd1, vals) of one addend's row shard on ``device`` with the
    columns non-decreasing within every row, the order the union kernels
    merge. Shards come in storage order (CSR, DCSR, COO, BCSR) or in the
    row-sorted transpose walk (CSC, BCSC), which already is that order; a
    shard built from storage that is not sorted is sorted here, once."""
    def build():
        a = S.arrays
        pos, crd, vals = a["pos1"], a["crd1"], a["vals"]
        fixed = None
        for p in range(S.pieces):
            n = int(pos[p, -1])
            rows = np.repeat(np.arange(pos.shape[1] - 1), np.diff(pos[p]))
            c = crd[p, :n]
            if ((c[1:] < c[:-1]) & (rows[1:] == rows[:-1])).any():
                if fixed is None:
                    fixed = crd.copy(), vals.copy()
                order = np.lexsort((c, rows))
                fixed[0][p, :n] = c[order]
                fixed[1][p, :n] = vals[p, :n][order]
        return (pos, *(fixed or (crd, vals)))

    return _device_cached(S, ("spadd3_sorted",), device, build)


def _window_gather(start: np.ndarray, count: np.ndarray, R: int,
                   n_root: int) -> np.ndarray:
    """Indices that turn the union kernel's CSR over the P·R padded piece
    rows into the global CSR over ``n_root`` rows: row ``start[p] + r`` is
    piece row ``p·R + r``. The universe windows are disjoint, ordered and
    cover [0, n_root), and padded piece rows are empty."""
    ends = start.astype(np.int64) + count
    if (n_root and (start[0] != 0 or ends[-1] != n_root
                    or (start[1:] != ends[:-1]).any())):
        raise AssertionError(f"row windows {start}, {count} do not tile "
                             f"[0, {n_root})")
    return np.concatenate(
        [p * R + np.arange(int(c), dtype=np.int64)
         for p, c in enumerate(count)] + [[len(count) * R]])


def _to_storage_order(format: "fmt.Format", pos, crd, vals, n_minor: int):
    """A row-major union (pos over rows, column crd) in the storage order of
    ``format``: itself for a row-major root; for a column-major root
    (BCSC) a stable sort by column on the device."""
    if format.dim_of_level(0) == 0:
        return pos, crd, vals
    rows = torch.repeat_interleave(
        torch.arange(pos.shape[0] - 1, device=crd.device),
        (pos[1:] - pos[:-1]).long())
    order = torch.sort(crd, stable=True).indices
    cpos = torch.zeros(n_minor + 1, dtype=torch.int64, device=crd.device)
    torch.cumsum(torch.bincount(crd.long(), minlength=n_minor), 0,
                 out=cpos[1:])
    return cpos, rows[order], vals[order]


def _emit_spadd3_rows(stmt, plans, shards, device):
    """Fused three-way add over shared row windows: the union of the three
    row shards on the device, one launch per run, written as the output's
    CSR (scalar addends) or blocked CSR (duplicate blocks sum their tiles;
    the output takes the addends' blocked format). Transpose-walked shards
    (CSC, BCSC) feed the same kernel: the walk already delivered row-window
    locality."""
    accs = stmt.rhs.accesses()
    Bs = [shards[acc.tensor.name] for acc in accs]
    Bt = accs[0].tensor
    out_name = stmt.lhs.tensor.name
    shape = tuple(stmt.lhs.tensor.shape)
    a, meta = Bs[0].arrays, Bs[0].meta
    if tree_of(Bt).blocked:
        br, bc = int(meta["br"]), int(meta["bc"])
        name, static = "bcsr_spadd3_rows", shape + (br, bc)
        kernel = spadd3_kernels.bcsr_spadd3_union_rows
        start, count = a["brow_start"], a["brow_count"]
        n_root, n_minor = int(meta["grid_rows"]), int(meta["grid_cols"])
        out_fmt = Bt.format
    else:
        name, static = "spadd3_rows", shape
        kernel = spadd3_kernels.spadd3_union_rows
        start, count = a["row_start"], a["row_count"]
        n_root, n_minor = shape
        out_fmt = fmt.CSR()
    R = a["pos1"].shape[1] - 1
    flat = tuple(x for S in Bs for x in _sorted_row_shard(S, device))

    def fn(*args):
        row_pos, crd, vals = kernel(*args[:9])
        return row_pos[args[9]], crd, vals

    f = _runner(name, static, flat, lambda: fn, device)
    args = flat + (_device_cached(
        Bs[0], ("spadd3_window_gather",), device,
        lambda: _window_gather(start, count, R, n_root)),)

    def run(*args):
        levels = _to_storage_order(out_fmt, *f(*args), n_minor)
        return _compressed_tensor(out_name, shape, out_fmt,
                                  *(x.cpu().numpy() for x in levels))

    return name, run, args


def _emit_spadd3_nnz(stmt, plans, shards, device):
    """Non-zero SpAdd: the coordinate-position loop of an addition iterates
    the concatenated stored-entry stream of all addends, split evenly
    (paper §II-D applied to additions). Each chunk's union and the merge
    across chunks depend only on the stream's coordinates, so their order
    is planned once at lower time (``spadd3.plan_runs``, cached with the
    add-stream shard together with the output's levels); a run launches one
    kernel that sums the runs of equal coordinates, per chunk in stream
    order and then across chunks, and copies the values back."""
    Bt = stmt.rhs.accesses()[0].tensor
    out_name = stmt.lhs.tensor.name
    shape = tuple(stmt.lhs.tensor.shape)
    S = shards["_addstream"]
    a = S.arrays
    if tree_of(Bt).blocked:
        grid = (int(S.meta["grid_rows"]), int(S.meta["grid_cols"]))
        name = "bcsr_spadd3_nnz"
        static = (grid[0], int(S.meta["br"]), int(S.meta["bc"]))
        kernel = spadd3_kernels.bcsr_spadd3_union_nnz
        out_fmt = Bt.format
    else:
        grid, name, static = shape, "spadd3_nnz", shape[:1]
        kernel = spadd3_kernels.spadd3_union_nnz
        out_fmt = fmt.CSR()
    f = _runner(name, static, (a["dim0"], a["dim1"], a["vals"],
                               a["nnz_count"]), lambda: kernel, device)

    def plan():
        runs = spadd3_kernels.plan_runs(
            _on_device(S, "dim0", device), _on_device(S, "dim1", device),
            torch.from_numpy(a["nnz_count"]), grid, out_fmt.dim_of_level(0))
        return runs[:3], tuple(x.cpu().numpy() for x in runs[3:])

    runs, (pos, crd) = _shard_cached(S, ("spadd3_runs", str(device)), plan)
    args = (_on_device(S, "vals", device), *runs)

    def run(*args):
        return _compressed_tensor(out_name, shape, out_fmt, pos, crd,
                                  f(*args).cpu().numpy())

    return name, run, args


# -- SDDMM ------------------------------------------------------------------

def _transposed(D: ShardedTensor, device: torch.device) -> torch.Tensor:
    """A replicated dense (K, m) operand as Dt (m, K), made once and cached
    with its shard: both SDDMM gathers then read contiguous K-rows."""
    return _device_cached(D, ("Dt",), device,
                          lambda: np.ascontiguousarray(D.arrays["vals"].T))


def _three_operands(stmt, shards):
    """(B's tensor, B, C, D shards) of ``A = B * C * D`` (SDDMM, MTTKRP)."""
    Bacc, Cacc, Dacc = stmt.rhs.accesses()
    return (Bacc.tensor, shards[Bacc.tensor.name], shards[Cacc.tensor.name],
            shards[Dacc.tensor.name])


def _bcsr_dt(B: ShardedTensor, D: ShardedTensor, device: torch.device):
    """A replicated dense (K, m) operand in the column blocks of B's grid,
    transposed to (grid_cols·bc, K) and cached with its shard: the blocked
    SDDMM kernel reads contiguous K-rows of C and of D."""
    grid_cols, bc = int(B.meta["grid_cols"]), int(B.meta["bc"])
    K = D.arrays["vals"].shape[0]
    return _device_cached(D, ("Dt_blocks", grid_cols, bc), device, lambda: (
        pack_mat_inner_blocks(D.arrays["vals"], grid_cols, bc)
        .transpose(0, 2, 1).reshape(grid_cols * bc, K)))


def _emit_bcsr_sddmm_rows(stmt, plans, shards, device):
    """Blocked row-based SDDMM: per piece, the stored tiles against C's row
    window padded to whole block-rows and D in column blocks; the new tiles
    go home by value-space intervals, or through ``val_idx`` for
    transpose-walked (BCSC) shards."""
    Bt, B, C, D = _three_operands(stmt, shards)
    a, meta = B.arrays, B.meta
    br, bc = int(meta["br"]), int(meta["bc"])
    max_brows = int(meta["max_brows"])
    total = int(Bt.levels[1].nnz or 0)
    Cv = C.arrays["vals"]
    head = (_bcsr_row_ids(B, device), _on_device(B, "crd1", device),
            _on_device(B, "vals", device),
            _packed(C, pack_rowwindow_blocks, max_brows, br, device,
                    (Cv.shape[0], max_brows * br, Cv.shape[2])),
            _bcsr_dt(B, D, device))
    if "val_idx" in a:
        def fn(brow, bcol, tiles, Cl, Dt, val_idx, count):
            out = bcsr_kernels.bcsr_sddmm(brow, bcol, tiles, Cl, Dt)
            return _scatter_by_val_idx(total, out, val_idx, count)

        args = head + (_on_device(B, "val_idx", device), a["nnz_count"])
        static = (total, br, bc)
    else:
        vb = plans[Bt.name].vals_bounds

        def fn(brow, bcol, tiles, Cl, Dt, start, count):
            out = bcsr_kernels.bcsr_sddmm(brow, bcol, tiles, Cl, Dt)
            return _scatter_vals(total, out, start, count)

        args = head + (vb[:, 0].astype(np.int32),
                       (vb[:, 1] - vb[:, 0]).astype(np.int32))
        static = (total,)
    f = _runner("bcsr_sddmm_rows", static, args, lambda: fn, device)
    return "bcsr_sddmm_rows", _pattern_output(
        stmt.lhs.tensor.name, Bt.shape, Bt.format, Bt.levels, f), args


def _emit_sddmm_rows(stmt, plans, shards, device):
    """Row-based SDDMM: B and C's matching row block local per color, D
    replicated; output vals stay aligned with B's stored positions. Ordered
    walks scatter back by value-space intervals; transpose-walked shards
    (CSC) scatter home through their ``val_idx`` permutation."""
    Bt, B, C, D = _three_operands(stmt, shards)
    if tree_of(Bt).blocked:
        return _emit_bcsr_sddmm_rows(stmt, plans, shards, device)
    a = B.arrays
    total = Bt.nnz
    n_pos = a["crd1"].shape[1]
    # the leaf's per-position rows, expanded from pos1 once
    rows = _device_cached(B, ("sddmm_rows",), device, lambda: torch.stack([
        K.rows_from_pos(torch.from_numpy(a["pos1"][p]), n_pos)
        for p in range(B.pieces)]).int())
    head = (rows, _on_device(B, "crd1", device), _on_device(B, "vals", device),
            _on_device(C, "vals", device), _transposed(D, device))
    if "val_idx" in a:
        def fn(rows, cols, vals, Cl, Dt, val_idx, count):
            out = sddmm_kernels.sddmm_coo(rows, cols, vals, Cl, Dt)
            return _scatter_by_val_idx(total, out, val_idx, count)

        args = head + (_on_device(B, "val_idx", device), a["nnz_count"])
    else:
        vb = plans[Bt.name].vals_bounds

        def fn(rows, cols, vals, Cl, Dt, start, count):
            out = sddmm_kernels.sddmm_coo(rows, cols, vals, Cl, Dt)
            return _scatter_vals(total, out, start, count)

        args = head + (vb[:, 0].astype(np.int32),
                       (vb[:, 1] - vb[:, 0]).astype(np.int32))
    f = _runner("sddmm_rows", (total,), args, lambda: fn, device)
    return "sddmm_rows", _pattern_output(
        stmt.lhs.tensor.name, Bt.shape, Bt.format, Bt.levels, f), args


def _emit_sddmm_nnz(stmt, plans, shards, device):
    Bt, B, C, D = _three_operands(stmt, shards)
    a = B.arrays
    if tree_of(Bt).blocked:
        # global block coordinates against C in the full block grid
        br, grid_rows = int(B.meta["br"]), int(B.meta["grid_rows"])
        total = int(Bt.levels[1].nnz or 0)
        kernel = bcsr_kernels.bcsr_sddmm
        name = "bcsr_sddmm_nnz"
        head = (_on_device(B, "bdim0", device), _on_device(B, "bdim1", device),
                _on_device(B, "vals", device),
                _packed(C, pack_mat_row_blocks, grid_rows, br, device,
                        (grid_rows * br, C.arrays["vals"].shape[1])),
                _bcsr_dt(B, D, device))
    else:
        total = Bt.nnz
        kernel = sddmm_kernels.sddmm_coo
        name = "sddmm_nnz"
        head = (_on_device(B, "dim0", device), _on_device(B, "dim1", device),
                _on_device(B, "vals", device), _on_device(C, "vals", device),
                _transposed(D, device))

    def fn(rows, cols, vals, Cm, Dt, count, start):
        out = kernel(rows, cols, vals, Cm, Dt)
        return _scatter_vals(total, out, start, count)

    args = head + (a["nnz_count"],
                   plans[Bt.name].vals_bounds[:, 0].astype(np.int32))
    f = _runner(name, (total,), args, lambda: fn, device)
    return name, _pattern_output(
        stmt.lhs.tensor.name, Bt.shape, Bt.format, Bt.levels, f), args


# -- SpTTV ------------------------------------------------------------------

def _spttv_flat_runner(stmt, shards, device, name):
    """Flat-walk SpTTV: per-position products, then the (i, j) assembly on
    the host (the result pattern is the walk's ij columns; duplicates merge
    in ``from_coo``). Serves the nnz strategy and the universe strategy over
    trailing-singleton trees (COO3), whose shard sets are the same
    coordinate columns. No TPU kernel exists for the products (the
    reference computes them in jnp); they stay plain PyTorch."""
    Bacc, cacc = stmt.rhs.accesses()
    Bt, B = Bacc.tensor, shards[Bacc.tensor.name]
    a = B.arrays
    args = (_on_device(B, "dim2", device), _on_device(B, "vals", device),
            _on_device(shards[cacc.tensor.name], "vals", device))
    f = _runner(name, (), args, lambda: K.leaf_spttv_flat, device)
    mask = np.arange(a["vals"].shape[1])[None, :] < a["nnz_count"][:, None]
    coords = np.stack([a["dim0"][mask], a["dim1"][mask]], 1)
    # the assembled output format follows the input's (i, j) levels
    out_fmt = fmt.Format(Bt.format.levels[:2])
    flat_mask = torch.from_numpy(mask.ravel())

    def run(dk, vals, cvec):
        prod = f(dk, vals, cvec).cpu().reshape(-1)[flat_mask].numpy()
        return Tensor.from_coo(stmt.lhs.tensor.name, Bt.shape[:2], coords,
                               prod, out_fmt, dedupe=True)

    return run, args


def _emit_spttv_rows(stmt, plans, shards, device):
    Bacc, cacc = stmt.rhs.accesses()
    Bt = Bacc.tensor
    if tree_of(Bt).trailing_singletons:
        # no grouped middle level: the universe plan materialized the flat
        # walk bucketed by row window; consume it with the flat leaf
        return ("spttv_flat_rows",
                *_spttv_flat_runner(stmt, shards, device, "spttv_flat_rows"))
    B = shards[Bt.name]
    # output pattern = B's (i, j) level; vals live at level-1 positions
    ij = plans[Bt.name].levels[1].pos_bounds
    total_ij = Bt.levels[1].nnz

    def fn(pos2, crd2, vals, cvec, ij_start, ij_count):
        # the SpMV rows kernel over the (i, j) fibres
        out = spmv_kernels.spmv_csr_rows(pos2, crd2, vals, cvec)
        return _scatter_vals(total_ij, out, ij_start, ij_count)

    args = (_on_device(B, "pos2", device), _on_device(B, "crd2", device),
            _on_device(B, "vals", device),
            _on_device(shards[cacc.tensor.name], "vals", device),
            ij[:, 0].astype(np.int32), (ij[:, 1] - ij[:, 0]).astype(np.int32))
    f = _runner("spttv_rows", (total_ij,), args, lambda: fn, device)
    # an (i, j) matrix with B's ij pattern, in the format the input's first
    # two levels spell: CSF yields CSR, DCSF yields DCSR
    levels = [dataclasses.replace(Bt.levels[0]),
              dataclasses.replace(Bt.levels[1])]
    return "spttv_rows", _pattern_output(
        stmt.lhs.tensor.name, Bt.shape[:2], fmt.Format(Bt.format.levels[:2]),
        levels, f), args


def _emit_spttv_nnz(stmt, plans, shards, device):
    return ("spttv_nnz",
            *_spttv_flat_runner(stmt, shards, device, "spttv_nnz"))


# -- SpMTTKRP ---------------------------------------------------------------

def _spmttkrp_leaf(out_shape, max_rows: int):
    def fn(rows, j, k, vals, Cm, Dm, row_start, row_count):
        blocks = spmttkrp_kernels.spmttkrp_coo(rows, j, k, vals, Cm, Dm,
                                               max_rows)
        return _scatter_rows(out_shape, blocks, row_start, row_count)
    return fn


def _spmttkrp_flat_runner(stmt, shards, device, name):
    """Flat-walk MTTKRP: per-position (i, j, k) contributions summed into the
    shard's row window. Serves the nnz strategy (overlapping windows,
    reduced by the scatter) and the universe strategy over
    trailing-singleton trees (COO3: disjoint windows, same leaf)."""
    _, B, C, D = _three_operands(stmt, shards)
    out_shape = stmt.lhs.tensor.shape
    row_start, row_count, max_rows = _nnz_row_windows(B, out_shape[0])
    args = (*_nnz_leaf_inputs(B, row_start, max_rows, device,
                              cols=("dim1", "dim2")),
            _on_device(C, "vals", device), _on_device(D, "vals", device),
            row_start, row_count)
    f = _runner(name, out_shape + (max_rows,), args,
                lambda: _spmttkrp_leaf(out_shape, max_rows), device)
    return f, args


def _emit_spmttkrp_rows(stmt, plans, shards, device):
    Bt, B, C, D = _three_operands(stmt, shards)
    if tree_of(Bt).trailing_singletons:
        return ("spmttkrp_flat_rows", *_spmttkrp_flat_runner(
            stmt, shards, device, "spmttkrp_flat_rows"))
    out_shape = stmt.lhs.tensor.shape
    a = B.arrays
    max_rows = a["pos1"].shape[1] - 1
    n_pos = a["crd2"].shape[1]

    def flatten():
        # the CSF shard as the kernel's (row, j) stream, once per shard
        rj = [spmttkrp_kernels.flatten_csf(
            *(torch.from_numpy(a[x][p]) for x in ("pos1", "crd1", "pos2")),
            n_pos) for p in range(B.pieces)]
        return (torch.stack([r for r, _ in rj]),
                torch.stack([j for _, j in rj]))

    args = (*_device_cached(B, ("csf_stream",), device, flatten),
            _on_device(B, "crd2", device), _on_device(B, "vals", device),
            _on_device(C, "vals", device), _on_device(D, "vals", device),
            a["row_start"], a["row_count"])
    f = _runner("spmttkrp_rows", out_shape + (max_rows,), args,
                lambda: _spmttkrp_leaf(out_shape, max_rows), device)
    return "spmttkrp_rows", f, args


def _emit_spmttkrp_nnz(stmt, plans, shards, device):
    return ("spmttkrp_nnz",
            *_spmttkrp_flat_runner(stmt, shards, device, "spmttkrp_nnz"))


# -- the generic path ----------------------------------------------------

def _emit(stmt, strat, plans, shards, device):
    """The emitter of (signature, space), or the generic path for a pair
    outside the table."""
    sig = stmt.signature()
    emitter = _EMITTERS.get((sig, strat.space))
    if emitter is None:
        return (f"generic[{sig}|{strat.space}]",
                *_emit_generic_fallback(stmt, device))
    return emitter(stmt, plans, shards, device)


def _emit_generic_fallback(stmt, device):
    """Correctness fallback for any TIN statement: densify and contract
    with the interpreter, on the kernel's own device. Kept for generality
    (the paper supports all of tensor algebra); not a performance path,
    and flagged as such by its leaf name."""
    from .interp import interpret

    def run():
        return interpret(stmt, device=device)

    return run, ()


# One emitter per expression × strategy; the format variation lives in the
# shards the emitters read, not in this table.
_EMITTERS = {
    ("d1(i)=s2(i,j)*d1(j)", "universe"): _emit_spmv_rows,
    ("d1(i)=s2(i,j)*d1(j)", "nnz"): _emit_spmv_nnz,
    ("d2(i,j)=s2(i,k)*d2(k,j)", "universe"): _emit_spmm_rows,
    ("d2(i,j)=s2(i,k)*d2(k,j)", "nnz"): _emit_spmm_nnz,
    ("s2(i,j)=s2(i,j)+s2(i,j)+s2(i,j)", "universe"): _emit_spadd3_rows,
    ("s2(i,j)=s2(i,j)+s2(i,j)+s2(i,j)", "nnz"): _emit_spadd3_nnz,
    ("s2(i,j)=s2(i,j)*d2(i,k)*d2(k,j)", "universe"): _emit_sddmm_rows,
    ("s2(i,j)=s2(i,j)*d2(i,k)*d2(k,j)", "nnz"): _emit_sddmm_nnz,
    ("s2(i,j)=s3(i,j,k)*d1(k)", "universe"): _emit_spttv_rows,
    ("s2(i,j)=s3(i,j,k)*d1(k)", "nnz"): _emit_spttv_nnz,
    ("d2(i,l)=s3(i,j,k)*d2(j,l)*d2(k,l)", "universe"): _emit_spmttkrp_rows,
    ("d2(i,l)=s3(i,j,k)*d2(j,l)*d2(k,l)", "nnz"): _emit_spmttkrp_nnz,
}


# ---------------------------------------------------------------------------
# Serving fast path: bucketized request batching. A batch of per-request
# vectors (or fixed-width panels) is stacked into one dense RHS, padded up
# to the smallest registered bucket, and run as ONE SpMM over the frozen
# sparse operand. Per bucket: one plan, one set of sparse shards (on the
# device), one runner; each batch swaps only the dense RHS shard
# (rebind_dense: no plan, no fingerprinting, a runner-cache hit), executes,
# and slices the per-request outputs back out.
# ---------------------------------------------------------------------------

def rebind_dense(kernel: LoweredKernel, mapping: Dict[str, Tensor], *,
                 cache: bool = False) -> LoweredKernel:
    """A copy of ``kernel`` with dense operands swapped by name.

    The partition geometry is kept (bounds depend only on shapes and the
    sparse pattern, both unchanged), so the swap re-packs just the named
    operands' shards and re-emits — a pure runner-cache hit when the new
    values have the old shapes, with the swapped shards copied to the
    kernel's device once. This is the serving hot path: no plan
    recompute, no content fingerprinting of any operand. ``comm`` is
    carried over unchanged (the model depends on shapes, not values).

    Only all-dense operands can rebind; a sparse swap changes the
    partition itself and must go through ``lower()`` / ``relower()``."""
    strat = kernel.strategy
    stmt = kernel.stmt.with_tensors(mapping)
    plans = dict(kernel.plans)
    shards = dict(kernel.shards)
    for name, t in mapping.items():
        old = plans.get(name)
        if old is None:
            raise KeyError(f"operand {name!r} not in kernel plans "
                           f"({sorted(plans)})")
        if (old.tensor is not None and old.tensor.format.is_sparse) \
                or t.format.is_sparse:
            raise ValueError(
                f"rebind_dense only swaps all-dense operands; {name!r} is "
                "sparse — re-plan through lower()/relower() instead")
        plans[name] = dataclasses.replace(old, tensor=t)
        if name in shards:
            shards[name] = _materialize_dense_operand(
                t, plans[name], strat.pieces, cache=cache)
    if strat.is_grid and strat.space == "universe":
        from . import grid as grid_mod
        gp = grid_mod.compute_grid_plan(stmt, strat)
        leaf_name, runner, args = grid_mod._emit_grid(stmt, gp, shards,
                                                      kernel.device)
    else:
        leaf_name, runner, args = _emit(stmt, strat, plans, shards,
                                        kernel.device)
    return dataclasses.replace(kernel, stmt=stmt, plans=plans,
                               shards=shards, runner=runner, args=args,
                               leaf_name=leaf_name)


#: Batchable signatures: per-request RHS shape, promoted signature.
_BATCHABLE = {
    "d1(i)=s2(i,j)*d1(j)": "spmv",        # requests are (m,) vectors
    "d2(i,j)=s2(i,k)*d2(k,j)": "spmm",    # requests are (m, jw) panels
}


@dataclasses.dataclass
class _BucketEntry:
    kernel: LoweredKernel
    rhs_name: str
    out_name: str
    bucket: int
    jw: int                      # per-request column width (1 for spmv)
    m: int                       # RHS rows


class BatchedKernel:
    """Bucketized request batching over one scheduled sparse statement.

    ``run_many([x_0, ..., x_{B-1}])`` stacks the request vectors (or
    fixed-width panels) as columns of one dense RHS on the host, pads the
    batch up to the smallest registered bucket, executes the per-bucket
    lowered SpMM once (one launch of its kernel) and slices the
    per-request outputs back out. Each bucket lowers lazily exactly once —
    one plan, one set of sparse shards, one runner — and later batches of
    any size in that bucket reuse all three via :func:`rebind_dense`; the
    stacked RHS is the batch's one host-to-device copy.

    ``schedule`` may be a Schedule, None, or a callable ``(stmt, machine)
    -> Schedule`` applied to the PROMOTED statement (e.g.
    ``default_nnz_schedule`` / ``default_grid_schedule``). ``mesh`` routes
    execution through the SPMD executor (``distributed.executor.to_spmd``;
    every rank of the mesh calls ``run_many`` with the same batch) instead
    of the single-process run. Every bucket runs on ``device``.
    """

    def __init__(self, stmt: Assignment, machine: Machine,
                 schedule: Any = None, *, buckets=BATCH_BUCKETS,
                 mesh: Any = None, device=None):
        sig = stmt.signature()
        if sig not in _BATCHABLE:
            raise NotImplementedError(
                f"lower_batched supports {sorted(_BATCHABLE)}; got {sig}")
        self.stmt = stmt
        self.machine = machine
        self.schedule = schedule
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.mesh = mesh
        self.device = resolve_device(device)
        self.kind = _BATCHABLE[sig]
        self._entries: Dict[int, _BucketEntry] = {}

    # -- construction ------------------------------------------------------
    def _promoted_stmt(self, bucket: int) -> Tuple[Assignment, str, str, int]:
        stmt = self.stmt
        sparse_acc = stmt.rhs.accesses()[0]
        rhs_acc = stmt.rhs.accesses()[-1]
        rhs_name = rhs_acc.tensor.name
        out_name = stmt.lhs.tensor.name
        n = stmt.lhs.tensor.shape[0]
        m = rhs_acc.tensor.shape[0]
        if self.kind == "spmv":
            # promote a(i) = B(i,j) * c(j)  →  A(i,j) = B(i,k) * C(k,j):
            # each request vector is one column of C. Index vars are
            # rebuilt with the canonical SpMM names (the emitter table and
            # default schedules key on them); a caller-tuned schedule is
            # passed as a callable over the promoted statement.
            i, k, j = IndexVar("i"), IndexVar("k"), IndexVar("j")
            out = Tensor.zeros_dense(out_name, (n, bucket))
            X = Tensor.from_dense(rhs_name,
                                  np.zeros((m, bucket), np.float32))
            bstmt = Assignment(
                Access(out, (i, j)),
                Mul(Access(sparse_acc.tensor, (i, k)),
                    Access(X, (k, j))))
            return bstmt, rhs_name, out_name, 1
        # spmm: widen the dense RHS to bucket panels of the original width
        jw = stmt.lhs.tensor.shape[1]
        out = Tensor.zeros_dense(out_name, (n, bucket * jw))
        X = Tensor.from_dense(rhs_name,
                              np.zeros((m, bucket * jw), np.float32))
        bstmt = stmt.with_tensors({out_name: out, rhs_name: X})
        return bstmt, rhs_name, out_name, jw

    def _entry(self, bucket: int) -> _BucketEntry:
        e = self._entries.get(bucket)
        if e is not None:
            return e
        bstmt, rhs_name, out_name, jw = self._promoted_stmt(bucket)
        sched = self.schedule
        if callable(sched) and not isinstance(sched, Schedule):
            sched = sched(bstmt, self.machine)
        with telemetry.span("serve.batch.lower", bucket=bucket):
            kernel = lower(bstmt, self.machine, schedule=sched,
                           device=self.device)
        telemetry.METRICS.counter("serve.buckets_lowered")
        e = _BucketEntry(kernel=kernel, rhs_name=rhs_name,
                         out_name=out_name, bucket=bucket, jw=jw,
                         m=bstmt.rhs.accesses()[-1].tensor.shape[0])
        self._entries[bucket] = e
        return e

    def warm(self, batch: int) -> "BatchedKernel":
        """Pre-lower the bucket that will serve batches of size ``batch``."""
        self._entry(batch_bucket(batch, self.buckets))
        return self

    # -- execution ---------------------------------------------------------
    def run_many(self, rhs_batch) -> List[torch.Tensor]:
        """Execute one batched step over ``len(rhs_batch)`` requests and
        return the per-request outputs ((n,) each for spmv requests,
        (n, jw) for spmm panels, views of the batch's result on the
        kernel's device), bit for bit equal to running the original
        statement once per request."""
        B = len(rhs_batch)
        bucket = batch_bucket(B, self.buckets)
        with telemetry.span("serve.batch", requests=B, bucket=bucket) as sp:
            e = self._entry(bucket)
            with telemetry.span("serve.batch.fill"):
                buf = np.zeros((e.m, bucket * e.jw), np.float32)
                for r, x in enumerate(rhs_batch):
                    x = np.asarray(x, np.float32)
                    if e.jw == 1:
                        buf[:, r] = x.reshape(e.m)
                    else:
                        buf[:, r * e.jw:(r + 1) * e.jw] = \
                            x.reshape(e.m, e.jw)
            # the rebind copies the stacked RHS to the device
            with telemetry.span("serve.batch.rebind", bytes=buf.nbytes):
                X = Tensor.from_dense(e.rhs_name, buf)
                e.kernel = rebind_dense(e.kernel, {e.rhs_name: X},
                                        cache=False)
            with telemetry.span("serve.batch.run"):
                if self.mesh is not None:
                    from ..distributed.executor import to_spmd
                    y = to_spmd(e.kernel, self.mesh)()
                else:
                    y = e.kernel.run()
            sp.set(leaf=e.kernel.leaf_name, h2d_bytes=buf.nbytes)
        telemetry.METRICS.counter("serve.requests", B)
        telemetry.METRICS.counter("serve.batches")
        telemetry.METRICS.counter("serve.h2d_bytes", buf.nbytes)
        telemetry.METRICS.observe("serve.batch.occupancy", B / bucket)
        telemetry.METRICS.observe("serve.batch.padded_slot_waste",
                                  (bucket - B) / bucket)
        if e.jw == 1:
            return [y[:, r] for r in range(B)]
        return [y[:, r * e.jw:(r + 1) * e.jw] for r in range(B)]

    def explain(self) -> str:
        lines = [f"batched kernel over {self.stmt.signature()} "
                 f"buckets={self.buckets}"]
        for b, e in sorted(self._entries.items()):
            lines.append(f"  bucket {b}: leaf={e.kernel.leaf_name} "
                         f"pieces={e.kernel.strategy.pieces}")
        return "\n".join(lines)


def lower_batched(stmt: Assignment, machine: Machine, batch: int = 8,
                  schedule: Any = None, *, buckets=BATCH_BUCKETS,
                  mesh: Any = None, device=None) -> BatchedKernel:
    """Batched-serving entry point: a :class:`BatchedKernel` for ``stmt``
    on ``device`` with the bucket covering ``batch`` pre-lowered (one plan
    + one runner, shared by every later ``run_many`` call in that
    bucket)."""
    return BatchedKernel(stmt, machine, schedule, buckets=buckets,
                         mesh=mesh, device=device).warm(batch)
