"""Collectives over a :class:`~.mesh.Mesh`'s axes: the paper's
``communicate`` and the reductions after the distributed loop, as explicit
``torch.distributed`` calls in the subgroup of the named axes.

**Reductions sum in piece order.** A reduction all-gathers the partials
over the axis's group and adds them in group-rank order (which is piece
order), so every rank gets the same bits, and the same bits as the
single-process ``LoweredKernel.run()``, which adds pieces and grid windows
in that order too. Its cost beside a ring all-reduce of a b-byte partial
over W ranks: each rank receives (W − 1)·b bytes, where the ring moves
2·(W − 1)/W·b; in exchange no reduction order changes between runs.

**Host staging is a table, not a fallback.** Gloo carries CUDA tensors
for all_gather (and all_reduce, broadcast and reduce_scatter), copying
through host memory inside the collective. Its point-to-point sends
cannot read a device pointer ("writev ... Bad address" with torch 2.11 on
an H100), so :data:`HOST_STAGED` names ``("gloo", "p2p")``: for that
backend and op a CUDA tensor is always copied to the host first and the
received one copied back. :func:`staged_ops` lists what a mesh stages.

``TRAFFIC`` counts the payload bytes this process's collectives sent and
received (a gather of b bytes over W ranks sends and receives
b·(W − 1)), the host seconds its blocking gathers took, from the moment
their input was ready on the device, and the calls it staged through the
host; ``TRAFFIC_BY_KIND`` splits the received bytes by what the gather
was for (``all-gather``: a replication, ``reduce``: a reduction,
``permute``: a ring shift). Callers read them around a call.

**A layout mesh gathers on ``meta``.** On a mesh with no process group
(``launch.mesh.make_production_mesh``: axes and shape only), a gather
over an axis of W > 1 ranks returns the W parts a real gather would, as
``meta`` tensors of ``x``'s shape, and counts the bytes the real gather
would move; no process group is touched. So one rank's step runs
unchanged on ``meta`` and its collective bytes are the dry-run's.

:func:`prefetch` and :func:`wait` are the double buffer of
``executor.run_overlapped``: a host-to-device copy from pinned memory on
a copy stream, and the compute stream waiting on its event.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh

#: (backend, op) pairs whose CUDA tensors are copied through host memory
#: by these helpers, always.
HOST_STAGED = frozenset({("gloo", "p2p")})

TRAFFIC: Dict[str, float] = {"sent": 0, "received": 0, "seconds": 0.0,
                              "staged": 0}
COLLECTIVE_KINDS = ("all-gather", "reduce", "permute")
TRAFFIC_BY_KIND: Dict[str, float] = dict.fromkeys(COLLECTIVE_KINDS, 0)


def staged_ops(mesh: Mesh) -> Tuple[str, ...]:
    """The ops these helpers stage through the host on ``mesh``'s ranks."""
    if mesh.device.type != "cuda":
        return ()
    return tuple(sorted(op for b, op in HOST_STAGED if b == mesh.backend))


def _count(nbytes: int, peers: int, kind: str) -> None:
    TRAFFIC["sent"] += nbytes * peers
    TRAFFIC["received"] += nbytes * peers
    TRAFFIC_BY_KIND[kind] += nbytes * peers


def gather_parts(x: torch.Tensor, mesh: Mesh, axis,
                 async_op: bool = False, kind: str = "all-gather"):
    """Every rank's ``x`` along ``axis``, in group-rank order (a list of
    tensors shaped like ``x``). With ``async_op`` returns ``(work, parts)``;
    the parts are valid after ``work.wait()`` (``work`` is None for a
    one-rank axis and on a layout mesh). ``kind`` names the bytes in
    ``TRAFFIC_BY_KIND``."""
    g, members = mesh.group(axis)
    if g is None:
        w = mesh.axis_extent(axis)
        if w == 1:
            return (None, [x]) if async_op else [x]
        # a layout mesh: the parts a real gather returns, on meta
        parts = [torch.empty(x.shape, dtype=x.dtype, device="meta")
                 for _ in range(w)]
        _count(x.numel() * x.element_size(), w - 1, kind)
        return (None, parts) if async_op else parts
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in members]
    if not async_op and x.is_cuda:
        # the gather reads x through the host: wait for x here, so the
        # seconds below are the collective's own
        torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    work = dist.all_gather(parts, x, group=g, async_op=async_op)
    if not async_op:
        TRAFFIC["seconds"] += time.perf_counter() - t0
    _count(x.numel() * x.element_size(), len(members) - 1, kind)
    return (work, parts) if async_op else parts


def sum_parts(parts: List[torch.Tensor]) -> torch.Tensor:
    """Partials added in list order: one fixed order of adds."""
    return functools.reduce(torch.add, parts)


def replicate_all_gather(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """Paper ``communicate``: fetch the whole operand to every shard (the
    shards concatenated along dim 0 in piece order)."""
    return torch.cat(gather_parts(x, mesh, axis), 0)


def reduce_rows(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """Reduce overlapping output rows across shards (non-zero strategies):
    the sum over ``axis`` in piece order, on every rank."""
    return sum_parts(gather_parts(x, mesh, axis, kind="reduce"))


def reduce_scatter_rows(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """The sum over ``axis`` in piece order, of which this rank keeps its
    dim-0 block (the dim must divide by the axis size)."""
    total = reduce_rows(x, mesh, axis)
    w = mesh.axis_extent(axis)
    if total.shape[0] % w:
        raise ValueError(f"reduce_scatter_rows: dim 0 ({total.shape[0]}) "
                         f"does not divide by the {w} ranks of {axis}")
    step = total.shape[0] // w
    i = mesh.index(axis)
    return total[i * step:(i + 1) * step]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def hierarchical_grad_reduce(grads, mesh: Mesh, *, intra_axis: str = "data",
                             inter_axis: Optional[str] = "pod"):
    """Two-level data-parallel gradient reduction for multi-pod meshes:
    reduce-scatter within a pod, all-reduce the scattered shards across
    pods, all-gather back within the pod. Wire bytes on the slow links drop
    by the intra-pod factor vs. a flat all-reduce."""
    def one(g):
        g = reduce_scatter_rows(g, mesh, intra_axis)
        if inter_axis is not None:
            g = reduce_rows(g, mesh, inter_axis)
        return replicate_all_gather(g, mesh, intra_axis)
    return _tree_map(one, grads)


def ppermute_ring(x: torch.Tensor, mesh: Mesh, axis,
                  shift: int = 1) -> torch.Tensor:
    """Ring shift along ``axis``: piece i receives piece (i − shift)'s
    ``x`` (``batch_isend_irecv``; staged through the host where
    :data:`HOST_STAGED` says so)."""
    g, members = mesh.group(axis)
    n = len(members)
    if g is None or shift % n == 0:
        return x.clone()
    i = mesh.index(axis)
    staged = x.is_cuda and (mesh.backend, "p2p") in HOST_STAGED
    TRAFFIC["staged"] += int(staged)
    src = x.contiguous().cpu() if staged else x.contiguous()
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, members[(i + shift) % n], group=g),
           dist.P2POp(dist.irecv, buf, members[(i - shift) % n], group=g)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    _count(x.numel() * x.element_size(), 1, "permute")
    return buf.to(x.device) if staged else buf


# -- the double buffer of run_overlapped --------------------------------------

@dataclasses.dataclass
class Prefetch:
    """A host-to-device copy in flight: ``arrays`` (tensors on ``device``,
    in the structure given to :func:`prefetch`), the copy stream's
    ``event`` (None on the CPU) and the pinned host buffers the copy
    reads."""

    arrays: Any
    device: torch.device
    event: Optional[torch.cuda.Event] = None
    pinned: Tuple[torch.Tensor, ...] = ()


_COPY_STREAMS: Dict[str, torch.cuda.Stream] = {}


def copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The copy stream of ``device`` (one per device, made once)."""
    s = _COPY_STREAMS.get(str(device))
    if s is None:
        s = _COPY_STREAMS[str(device)] = torch.cuda.Stream(device)
    return s


def prefetch(arrays, device) -> Prefetch:
    """Start moving ``arrays`` (numpy arrays or CPU tensors, in a dict or a
    sequence) to ``device``. On a card each is copied into pinned host
    memory and from there, non-blocking, on the device's copy stream, where
    its destination is also allocated; the returned event marks the copies'
    end. On the CPU the arrays are wrapped as tensors (nothing moves)."""
    device = torch.device(device)
    items = arrays.items() if isinstance(arrays, dict) else enumerate(arrays)

    def host(a):
        return (torch.from_numpy(np.ascontiguousarray(a))
                if isinstance(a, np.ndarray) else a.contiguous())

    if device.type != "cuda":
        out = {k: host(a).to(device) for k, a in items}
        return Prefetch(out if isinstance(arrays, dict) else
                        tuple(out.values()), device)
    stream = copy_stream(device)
    pinned, out = [], {}
    with torch.cuda.stream(stream):
        for k, a in items:
            src = host(a).pin_memory()
            dst = torch.empty(src.shape, dtype=src.dtype, device=device)
            dst.copy_(src, non_blocking=True)
            pinned.append(src)
            out[k] = dst
        event = torch.cuda.Event()
        event.record(stream)
    return Prefetch(out if isinstance(arrays, dict) else tuple(out.values()),
                    device, event, tuple(pinned))


def wait(handle: Prefetch):
    """Make the current stream wait for a :func:`prefetch` (the host does
    not block) and return its device arrays, now safe to use on the
    current stream."""
    if handle.event is not None:
        current = torch.cuda.current_stream(handle.device)
        current.wait_event(handle.event)
        vals = (handle.arrays.values() if isinstance(handle.arrays, dict)
                else handle.arrays)
        for t in vals:
            t.record_stream(current)
    return handle.arrays
