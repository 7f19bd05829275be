"""Production mesh definitions.

``make_production_mesh`` is a layout: the axes and shape the planner and
the dry-run read, with no process group and no device behind it (a
:class:`~..distributed.mesh.Mesh` on the ``meta`` device, this process
rank 0). ``make_smoke_mesh`` is the one-piece mesh a single process runs
on. Neither touches a process group.
"""
from __future__ import annotations

import torch

from ..distributed.mesh import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16) = 256 chips. Multi-pod: (pod=2,
    data=16, model=16) = 512 chips."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape, None, torch.device("meta"), 0, {})


def make_smoke_mesh(device=None) -> Mesh:
    """The one-device mesh with the production axis names, on ``device``
    (None: the card)."""
    return make_mesh((1, 1), ("data", "model"), device=device)
