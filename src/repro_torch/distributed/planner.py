"""Placement of lowered sparse-kernel shards over a mesh (the executor's
half of the reference's planner; the LM's parameter and cache placement
waits for the model families).

A placement is what a ``PartitionSpec`` says of the leading (color) axis:
``(axis,)`` shards it over the mesh axis (each rank takes its own pieces),
``()`` replicates the array on every rank.
"""
from __future__ import annotations


def sparse_pspecs(sharded_tensors, axis="x"):
    """Placements for lowered sparse-kernel shards (executor.py).

    Stacked shard arrays (leading color axis, any kind but ``replicated``)
    shard over the machine ``axis``; replicated operands are replicated.
    Returns ``{tensor_name: {array_name: placement}}`` so the builders stay
    format-general — the array set differs per format (pos/crd levels, COO
    dim columns, densified-root views) but the placement rule does not."""
    out = {}
    for name, sh in sharded_tensors.items():
        kind = getattr(sh, "kind", "replicated")
        spec = () if kind == "replicated" else (axis,)
        out[name] = {arr_name: spec for arr_name in sh.arrays}
    return out
