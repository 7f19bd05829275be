"""Tensor Distribution Notation (TDN) — the data-distribution language
(paper §II-B "Data Distribution", Figs. 4 & 5).

A TDN statement names each dimension of a tensor and each dimension of an
abstract machine grid; shared names mean "partitioned by". SpDISTAL's
extensions implemented here:

- **universe partitions** (default): split the coordinate range equally.
- **non-zero partitions** (tilde ``~x``): split the stored non-zeros equally.
- **coordinate fusion** (``xy->f``): flatten dimensions into one logical
  coordinate that can be the target of a non-zero partition.

String syntax (mirrors the paper's math)::

    dist(B, "xy -> x",  M)      # B_xy |->_x M      row-wise (Fig. 4b)
    dist(B, "xy -> xy", M2)     # tiled onto 2-D machine (Fig. 4c)
    dist(c, "x  -> ~x", M)      # non-zero split of sparse vector (Fig. 5b)
    dist(B, "xy ~f> f", M)      # fuse x,y into f; nnz split (Fig. 5c)
    dist(c, "x  -> *",  M)      # replicate onto all of M (Fig. 1 ReplDense)

Machine axes are named positionally after the tensor names used on the RHS.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .partition import (Bounds, TensorPartition, materialize_coo_nnz,
                        materialize_csr_rows, materialize_dense_rows,
                        materialize_replicated, partition_by_bounds,
                        partition_tensor_nonzeros, partition_tensor_rows,
                        replicate_tensor, ShardedTensor)
from .tensor import Tensor


@dataclasses.dataclass(frozen=True)
class MachineDim:
    name: str
    size: int


class Machine:
    """An abstract n-dimensional grid of processors (paper Fig. 1 line 5).

    A 1-D machine's pieces run batched on one device (the lowered
    leaves take the piece axis as a batch dimension).
    """

    def __init__(self, *dims: Tuple[str, int]):
        if len(dims) == 1 and isinstance(dims[0], int):
            dims = (("x", dims[0]),)
        self.dims = tuple(MachineDim(n, int(s)) for n, s in dims)

    @staticmethod
    def grid(*sizes: int, names: Optional[Sequence[str]] = None) -> "Machine":
        names = names or ["x", "y", "z", "w"][: len(sizes)]
        return Machine(*[(n, s) for n, s in zip(names, sizes)])

    @property
    def n_procs(self) -> int:
        return int(np.prod([d.size for d in self.dims])) if self.dims else 1

    def dim(self, name: str) -> MachineDim:
        for d in self.dims:
            if d.name == name:
                return d
        raise KeyError(name)

    def __getattr__(self, name: str) -> MachineDim:
        try:
            return self.dim(name)
        except KeyError as e:
            raise AttributeError(name) from e

    def __repr__(self) -> str:
        return f"Machine({', '.join(f'{d.name}={d.size}' for d in self.dims)})"


@dataclasses.dataclass
class Distribution:
    """Parsed TDN statement for one tensor."""

    tensor_dims: Tuple[str, ...]       # names for the tensor dims, in order
    machine: Machine
    mapping: Tuple[str, ...]           # machine dim -> tensor dim name / "*"
    nonzero: bool = False              # tilde split
    fused: Optional[Tuple[str, ...]] = None  # dims fused into the target
    replicate: bool = False

    @property
    def pieces(self) -> int:
        return self.machine.n_procs

    # -- application ------------------------------------------------------
    def plan(self, tensor: Tensor) -> TensorPartition:
        """Compute the coordinate-tree partition this TDN statement implies
        (paper §V-C: TDN compiles into divide/distribute scheduling)."""
        if self.replicate:
            return replicate_tensor(tensor, self.pieces)
        pieces = self.pieces
        if self.nonzero:
            if self.fused is not None and \
                    set(self.fused) != set(self.tensor_dims):
                # partial fusion (paper Fig. 5: non-zero slices/tubes):
                # split the position space at the level of the LAST fused
                # dim; image/preimage derive the rest of the tree
                if tuple(self.fused) != tuple(
                        self.tensor_dims[: len(self.fused)]):
                    raise NotImplementedError(
                        "fusion of non-prefix dims — reorder the format so "
                        "the fused dims are stored first")
                return partition_tensor_nonzeros(
                    tensor, pieces, fused_levels=len(self.fused))
            return partition_tensor_nonzeros(tensor, pieces)
        # universe partition of the mapped (root) dimension
        target = self.mapping[0]
        dim_index = self.tensor_dims.index(target)
        lvl = tensor.format.level_of_dim(dim_index)
        if lvl != 0:
            raise NotImplementedError(
                f"universe partition of non-root storage level {lvl}; "
                "reorder the format (e.g. use CSC) so the distributed "
                "dimension is stored first")
        n = tensor.shape[dim_index]
        return partition_tensor_rows(tensor, partition_by_bounds(n, pieces))

    def materialize(self, tensor: Tensor) -> ShardedTensor:
        p = self.plan(tensor)
        if p.replicated:
            return materialize_replicated(tensor, self.pieces)
        if self.nonzero:
            return materialize_coo_nnz(tensor, p)
        if tensor.format.is_all_dense:
            return materialize_dense_rows(tensor, p.root_coord_bounds)
        return materialize_csr_rows(tensor, p)


def dist(tensor_or_dims, spec: str, machine: Machine) -> Distribution:
    """Parse ``"xy -> x"`` / ``"xy ~f> f"`` / ``"x -> *"`` TDN strings."""
    if isinstance(tensor_or_dims, Tensor):
        order = tensor_or_dims.order
        names = tuple("xyzw"[:order])
    else:
        names = tuple(tensor_or_dims)
    spec = spec.replace(" ", "")
    fused = None
    nonzero = False
    if "~" in spec and ">" in spec:
        # "xy~f>f" fusion+nnz  or  "x->~x" simple nnz
        if "->" in spec:
            lhs, rhs = spec.split("->")
            nonzero = rhs.startswith("~")
            rhs = rhs.lstrip("~")
        else:
            lhs, rest = spec.split("~", 1)
            fname, rhs = rest.split(">", 1)
            fused = tuple(lhs)
            nonzero = True
    else:
        lhs, rhs = spec.split("->")
    if rhs == "*":
        return Distribution(names, machine, ("*",), replicate=True)
    mapping = tuple(rhs) if fused is None else (rhs,)
    return Distribution(names, machine, mapping, nonzero=nonzero, fused=fused)
