"""Mesh utilities: the bridge between the paper's abstract Machine grids and
``torch.distributed`` process groups.

A :class:`Mesh` lays a Machine's axes over the first ``prod(shape)`` ranks
of the default process group, row-major (rank ``(p·Q + q)·R + r`` holds
coordinate ``(p, q, r)``), and holds one subgroup for every slice of every
non-empty set of its axes: the group a collective over those axes runs in.
Each rank runs on its own device: ``cuda:<local_rank % device_count>``
unless ``device=`` says otherwise, the CPU only when asked. A one-piece
mesh needs no process group and runs in the calling process.

The backend is named by the caller, never picked: ``"nccl"`` when each rank
has its own card, ``"gloo"`` otherwise (ranks that share one card, or run
on the CPU). NCCL asked for two ranks on one device raises and names them.

The caller starts the process group (``init_process_group`` with its
address, world size and rank); every rank of that group must then build
every mesh, in the same order, since each subgroup is created by all of
them. Building a mesh touches no process group until it is called.
"""
from __future__ import annotations

import itertools
import os
import socket
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.tdn import Machine

BACKENDS = ("nccl", "gloo")
_SERIAL = [0]          # meshes built by this process, for the store keys


class Mesh:
    """A Machine realised over ranks: axis names and shape, this rank's
    coordinate (None for a rank past the mesh's ranks), its device, and
    this rank's subgroup for every set of axes (None where the set spans
    one rank)."""

    def __init__(self, axis_names: Tuple[str, ...], shape: Tuple[int, ...],
                 backend: Optional[str], device: torch.device, rank: int,
                 groups: Dict[Tuple[str, ...], Tuple[object, Tuple[int, ...]]]):
        self.axis_names = axis_names
        self.shape = shape
        self.backend = backend
        self.device = device
        self.rank = rank
        self.ranks = np.arange(int(np.prod(shape)), dtype=np.int64) \
            .reshape(shape)
        self.coord = (tuple(int(c) for c in np.unravel_index(rank, shape))
                      if rank < self.ranks.size else None)
        self._groups = groups

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def __repr__(self) -> str:
        dims = ", ".join(f"{n}={s}" for n, s in
                         zip(self.axis_names, self.shape))
        return (f"Mesh(({dims}), backend={self.backend}, rank={self.rank}, "
                f"device={self.device})")

    def axes(self, axis) -> Tuple[str, ...]:
        """``axis`` (a name or a tuple of names) as a tuple in mesh order."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in names:
            if a not in self.axis_names:
                raise ValueError(f"mesh has no axis {a!r} (axes: "
                                 f"{list(self.axis_names)})")
        return tuple(a for a in self.axis_names if a in names)

    def axis_extent(self, axis) -> int:
        """The number of ranks along ``axis`` (a name or names)."""
        return int(np.prod([self.shape[self.axis_names.index(a)]
                            for a in self.axes(axis)]))

    def index(self, axis) -> int:
        """This rank's row-major position along ``axis`` (a name or names,
        taken in mesh order): its piece of a split over those axes."""
        if self.coord is None:
            raise RuntimeError(f"rank {self.rank} lies outside the "
                               f"{self.size}-rank mesh")
        idx = 0
        for a in self.axes(axis):
            i = self.axis_names.index(a)
            idx = idx * self.shape[i] + self.coord[i]
        return idx

    def group(self, axis):
        """(process group or None, its global ranks in group-rank order) of
        this rank's slice along ``axis``. The group ranks are the slice's
        positions along ``axis``, row-major."""
        if self.coord is None:
            raise RuntimeError(f"rank {self.rank} lies outside the "
                               f"{self.size}-rank mesh")
        key = self.axes(axis)
        hit = self._groups.get(key)
        if hit is None:               # a slice of one rank: no group needed
            return None, (self.rank,)
        return hit


def _pieces_message(shape: Tuple[int, ...], want: int, have: int) -> str:
    return (f"machine grid {shape} "
            f"({'×'.join(str(s) for s in shape)} = {want} pieces) "
            f"exceeds the {have} visible rank(s); shrink the grid or start "
            f"more ranks (torch.distributed world size >= {want})")


def _rank_device(device, rank: int) -> torch.device:
    """The rank's device: ``cuda:<local_rank % device_count>`` for None or
    an index-less ``cuda``; the device named otherwise. None without a card
    raises, as :func:`repro_torch.core.device.resolve_device` does."""
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda" or dev.index is not None:
            return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank {rank}: no CUDA device is available; pass device='cpu' "
            "to run the ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def _check_nccl(dev: torch.device, rank: int, want: int) -> None:
    """NCCL needs one card per rank: every rank publishes its (host, device)
    through the default group's store and every rank checks the mesh's
    ranks, so all of them raise together."""
    serial = _SERIAL[0]
    store = dist.distributed_c10d._get_default_store()
    store.set(f"repro_torch/mesh{serial}/{rank}",
              f"{socket.gethostname()}|{dev}")
    seen: Dict[str, int] = {}
    for r in range(want):
        host, name = store.get(f"repro_torch/mesh{serial}/{r}").decode() \
            .split("|")
        if not name.startswith("cuda"):
            raise ValueError(f"backend 'nccl' runs on CUDA devices; rank {r} "
                             f"runs on {name}")
        other = seen.setdefault(f"{host}|{name}", r)
        if other != r:
            raise ValueError(
                f"backend 'nccl' needs one card per rank, but ranks {other} "
                f"and {r} both run on {name} of {host}; ask for "
                f"backend='gloo' to let ranks share a card")


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              backend: Optional[str] = None, device=None) -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks, with the
    subgroups of ``backend`` ("nccl" or "gloo", required for more than
    one rank) and this rank's device (module docstring). Raises when the
    grid exceeds the world size, and for NCCL with two ranks on one
    device."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    want = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if want == 1:
        return Mesh(axes, shape, backend, _rank_device(device, 0), 0, {})
    have = (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)
    if want > have:
        raise ValueError(_pieces_message(shape, want, have))
    if backend not in BACKENDS:
        raise ValueError(f"backend must be named, one of {BACKENDS}: 'nccl' "
                         f"when each rank has its own card, 'gloo' "
                         f"otherwise; got {backend!r}")
    rank = dist.get_rank()
    dev = _rank_device(device, rank)
    _SERIAL[0] += 1
    if backend == "nccl":
        _check_nccl(dev, rank, want)
    ranks = np.arange(want).reshape(shape)
    groups = {}
    # every rank creates every subgroup, in this order
    for k in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), k):
            rest = [i for i in range(len(axes)) if i not in sub]
            moved = np.transpose(ranks, rest + list(sub)).reshape(
                -1, int(np.prod([shape[i] for i in sub])))
            if moved.shape[1] == 1:
                continue
            for members in moved:
                members = tuple(int(r) for r in members)
                g = dist.new_group(list(members), backend=backend)
                if rank in members:
                    groups[tuple(axes[i] for i in sub)] = (g, members)
    return Mesh(axes, shape, backend, dev, rank, groups)


def machine_to_mesh(machine: Machine, *, backend: Optional[str] = None,
                    device=None) -> Mesh:
    return make_mesh([d.size for d in machine.dims],
                     [d.name for d in machine.dims], backend=backend,
                     device=device)


def mesh_to_machine(mesh: Mesh) -> Machine:
    return Machine(*[(n, s) for n, s in zip(mesh.axis_names, mesh.shape)])


def resize_machine(machine: Machine, axis: str, size: int) -> Machine:
    """A new Machine with ``axis`` resized to ``size`` — the mesh-as-data
    primitive: machines are values, so elastic resize is construction, not
    mutation of trace state."""
    names = [d.name for d in machine.dims]
    if axis not in names:
        raise ValueError(f"machine has no axis {axis!r} (axes: {names})")
    if size < 1:
        raise ValueError(f"axis size must be >= 1, got {size}")
    return Machine(*[(d.name, size if d.name == axis else d.size)
                     for d in machine.dims])


def shrink_machine(machine: Machine, axis: Optional[str] = None,
                   by: int = 1) -> Machine:
    """The P→P−1 device-loss resize: shrink ``axis`` (default: the first
    dimension) by ``by`` pieces."""
    axis = axis if axis is not None else machine.dims[0].name
    cur = {d.name: d.size for d in machine.dims}.get(axis)
    if cur is None:
        raise ValueError(f"machine has no axis {axis!r}")
    if cur - by < 1:
        raise ValueError(
            f"cannot shrink axis {axis!r} from {cur} by {by}: no pieces left")
    return resize_machine(machine, axis, cur - by)


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes used for data parallelism ('pod' composes with 'data')."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def axis_size(mesh: Mesh, *axes: str) -> int:
    s = 1
    for a in axes:
        if a in mesh.axis_names:
            s *= mesh.shape[mesh.axis_names.index(a)]
    return s
