"""Sharding planner: placement specs for params / optimizer / batch / cache,
rule-based by leaf path and shape, and the placement of lowered
sparse-kernel shards over a mesh (the executor's half).

A **spec** is a tuple with one entry per dim, the entries of the
reference's ``PartitionSpec``: ``None`` (replicated), an axis name, or a
tuple of names (a one-name tuple is the name, as ``PartitionSpec``
normalizes it). The rules are the reference's, so for the same shapes
and mesh the specs are its entries exactly.

Layout: FSDP × TP. Every 2-D weight is sharded over both the 'data' axis
(FSDP) and the 'model' axis (the contraction-parallel dim). The
reference stacks each group's layers on a leading axis and never shards
it; the port's trees hold a list entry per group instead, so a leaf here
is the reference's leaf without those leading dims, and its spec the
reference's without their ``None`` entries. Every rule checks
divisibility and falls back to replication for that dim, so one planner
covers all ten archs on any mesh.

**Placement is FSDP at rest** (:func:`place`): each rank keeps only its
block of every leaf, by the spec (plain local tensors with the specs
beside them). A train step gathers the whole weights (:func:`gather`,
over ``collectives.replicate_all_gather``), runs on the rank's rows of
the batch and reduces the gradients back to the same blocks. The 'model'
axis shards storage only: the reference's tensor-parallel compute changes
no value (GSPMD), so here every rank along 'model' computes the same
rows (ROADMAP Queue 2).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..tree import tree_map, tree_map_with_path
from .collectives import replicate_all_gather
from .mesh import Mesh, axis_size, data_axes


def _entry(axes):
    """A spec entry as ``PartitionSpec`` normalizes it."""
    if isinstance(axes, (tuple, list)):
        axes = tuple(axes)
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes
    return axes


def spec(*entries) -> Tuple:
    return tuple(_entry(e) for e in entries)


def _div(dim: int, mesh: Mesh, axes) -> bool:
    if axes is None:
        return True
    ax = (axes,) if isinstance(axes, str) else tuple(axes)
    s = axis_size(mesh, *ax)
    return s > 0 and dim % s == 0


def _maybe(dim: int, mesh: Mesh, axes):
    return axes if axes is not None and _div(dim, mesh, axes) else None


# weight rules: (name fragment, (in_axis, out_axis)) for (in, out) matrices;
# logical 'fsdp' = data axes, 'tp' = model axis.
_W2_RULES = [
    ("unembed", ("fsdp", "tp")),
    ("embed", ("tp", "fsdp")),      # (vocab, d)
    ("wq", ("fsdp", "tp")),
    ("wk", ("fsdp", "tp")),
    ("wv", ("fsdp", "tp")),
    ("wo_gate", ("fsdp", "tp")),
    ("wo", ("tp", "fsdp")),         # (proj_out, d)
    ("wg", ("fsdp", "tp")),
    ("wu", ("fsdp", "tp")),
    ("wd", ("tp", "fsdp")),
    ("wx", ("fsdp", "tp")),
    ("wz", ("fsdp", "tp")),
    ("wB", ("fsdp", None)),
    ("wC", ("fsdp", None)),
    ("wdt", ("fsdp", None)),
    ("wi", ("fsdp", None)),
    ("wf", ("fsdp", None)),
    ("proj", ("fsdp", "tp")),
    ("router", ("fsdp", None)),
]


def _leaf_name(path) -> str:
    """The '/'-joined dict keys and field names of ``path`` (list indices
    left out, as the reference's stacked trees have none)."""
    return "/".join(str(p) for p in path if isinstance(p, str))


def _resolve(axis: Optional[str], mesh: Mesh, serve: bool = False):
    if axis == "fsdp":
        if serve:
            # FSDP re-gathers weights on every forward: right for training
            # (amortized against optimizer state), wrong for serving, where
            # it re-pays the gather per decoded token. Serving params are
            # TP-only (replicated across data).
            return None
        da = data_axes(mesh)
        return da if da else None
    if axis == "tp":
        return "model" if "model" in mesh.axis_names else None
    return axis


def param_spec_for(path, leaf, mesh: Mesh, serve: bool = False) -> Tuple:
    name = _leaf_name(path)
    shape = tuple(leaf.shape)
    rank = len(shape)
    if rank == 0:
        return ()
    base = name.rsplit("/", 1)[-1]
    rule = None
    for frag, axes in _W2_RULES:
        if base == frag or base.startswith(frag):
            rule = axes
            break
    if rule is None or rank < 2:
        return (None,) * rank
    in_ax = _resolve(rule[0], mesh, serve)
    out_ax = _resolve(rule[1], mesh, serve)
    lead = rank - 2
    sp = [None] * rank
    # MoE expert stacks (E, d, f): E on model (expert parallelism), d on
    # fsdp, no TP on f. Expert weights stay d-sharded even for serving
    # (weight-stationary).
    moe_expert = "moe" in name and base in ("wg", "wu", "wd")
    if moe_expert:
        e_dim = lead - 1 if lead >= 1 else None
        if e_dim is not None and _div(shape[e_dim], mesh, "model") \
                and "model" in mesh.axis_names:
            sp[e_dim] = "model"
        fs = _resolve("fsdp", mesh, serve=False)
        d_pos = rank - 2 if base in ("wg", "wu") else rank - 1
        if fs is not None and _div(shape[d_pos], mesh, fs):
            sp[d_pos] = fs
        return spec(*sp)
    sp[rank - 2] = _maybe(shape[rank - 2], mesh, in_ax)
    sp[rank - 1] = _maybe(shape[rank - 1], mesh, out_ax)
    # avoid duplicate axis use within one spec
    if sp[rank - 2] == sp[rank - 1]:
        sp[rank - 1] = None
    return spec(*sp)


def params_pspecs(params, mesh: Mesh, serve: bool = False):
    """The spec tree of a params tree (tensors, or anything with
    ``.shape``). ``serve=True`` selects the TP-only layout."""
    return tree_map_with_path(
        lambda path, leaf: param_spec_for(path, leaf, mesh, serve), params)


def opt_pspecs(opt, params, mesh: Mesh):
    """Optimizer state mirrors the param layout (step scalar replicated)."""
    pspec = params_pspecs(params, mesh)
    return type(opt)(step=(), mu=pspec, nu=tree_map(lambda s: s, pspec,
                                                    is_leaf=is_spec))


def batch_pspec(mesh: Mesh, global_batch: int) -> Tuple:
    da = data_axes(mesh)
    if da and global_batch % axis_size(mesh, *da) == 0:
        return spec(da, None)
    return (None, None)


def frontend_pspec(mesh: Mesh, global_batch: int) -> Tuple:
    da = data_axes(mesh)
    if da and global_batch % axis_size(mesh, *da) == 0:
        return spec(da, None, None)
    return (None, None, None)


def cache_pspecs(cache, mesh: Mesh, batch: int):
    """Cache tree specs: batch on data axes when divisible; attention-cache
    sequence dim on 'model' (plus data axes when batch can't shard — the
    long_500k sequence-parallel layout); SSM state heads on 'model'."""
    da = data_axes(mesh)
    batch_ok = bool(da) and batch % axis_size(mesh, *da) == 0 and batch > 1

    def one(path, leaf):
        name = _leaf_name(path).rsplit("/", 1)[-1]
        shape = tuple(leaf.shape)
        rank = len(shape)
        if name == "pos" or rank <= 1:
            return (None,) * rank
        if name in ("k", "v", "shared_k", "shared_v", "enc_k", "enc_v"):
            # (..., B, S, H, hd)
            sp = [None] * rank
            b_dim, s_dim = rank - 4, rank - 3
            if batch_ok:
                sp[b_dim] = da
                if _div(shape[s_dim], mesh, "model") and \
                        "model" in mesh.axis_names:
                    sp[s_dim] = "model"
            else:
                seq_axes = tuple(da) + (("model",) if "model" in
                                        mesh.axis_names else ())
                if seq_axes and _div(shape[s_dim], mesh, seq_axes):
                    sp[s_dim] = seq_axes
            return spec(*sp)
        if name.startswith("ssm") or name.startswith("tail"):
            # (G, [gs], B, H, N, P) states: trailing 4 dims fixed
            sp = [None] * rank
            b_dim, h_dim = rank - 4, rank - 3
            if batch_ok and rank >= 4:
                sp[b_dim] = da
            if rank >= 4 and _div(shape[h_dim], mesh, "model") and \
                    "model" in mesh.axis_names:
                sp[h_dim] = "model"
            return spec(*sp)
        if name.startswith("x"):
            # xLSTM states: (G, B, ...): mLSTM (G, B, H, hd, hd+1), sLSTM
            # (G, B, 2, d); batch is always dim 1, heads dim 2 only for
            # rank >= 5
            sp = [None] * rank
            if batch_ok and rank >= 2 and _div(shape[1], mesh, da):
                sp[1] = da
            if rank >= 5 and _div(shape[2], mesh, "model") and \
                    "model" in mesh.axis_names:
                sp[2] = "model"
            return spec(*sp)
        return (None,) * rank

    return tree_map_with_path(one, cache)


# ---------------------------------------------------------------------------
# Placement: each rank holds its block of every leaf
# ---------------------------------------------------------------------------

def is_spec(x) -> bool:
    """Whether ``x`` is a spec (a leaf of a spec tree)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh: which block of a leaf this rank holds."""

    mesh: Mesh
    spec: Tuple

    def block(self, shape) -> Tuple[slice, ...]:
        """This rank's index into a leaf of the whole ``shape``."""
        return block_of(shape, self.spec, self.mesh)


def shardings_from(pspec_tree, mesh: Mesh):
    return tree_map(lambda s: Sharding(mesh, s), pspec_tree, is_leaf=is_spec)


def _dims(sp: Tuple):
    """(dim, axes) for every sharded dim of a spec."""
    return [(d, (e,) if isinstance(e, str) else e)
            for d, e in enumerate(sp) if e is not None]


def block_of(shape, sp: Tuple, mesh: Mesh) -> Tuple[slice, ...]:
    """This rank's index into a leaf of the whole ``shape`` under spec
    ``sp``: along each sharded dim, its position along the dim's axes."""
    if len(sp) != len(shape):
        raise ValueError(f"spec {sp} does not fit a leaf of shape "
                         f"{tuple(shape)}")
    idx = [slice(None)] * len(shape)
    for d, axes in _dims(sp):
        n = mesh.axis_extent(axes)
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide by "
                             f"the {n} ranks of {axes}")
        step = shape[d] // n
        i = mesh.index(axes)
        idx[d] = slice(i * step, (i + 1) * step)
    return tuple(idx)


def place(tree, specs, mesh: Mesh):
    """Each leaf of ``tree`` (whole tensors, or numpy arrays) cut to this
    rank's block by ``specs``, on the mesh's device. On a one-rank mesh
    every block is the whole leaf and tensors already on the device are
    kept as they are."""
    def one(x, sp):
        x = torch.as_tensor(x)
        if mesh.size == 1:
            return x.to(mesh.device)
        # a copy the rank owns, not a view that keeps the whole alive
        return x.to(mesh.device)[block_of(x.shape, sp, mesh)].clone()
    return tree_map(one, tree, specs)


def gather(tree, specs, mesh: Mesh):
    """The whole leaves from every rank's blocks (:func:`place`'s
    inverse): along each sharded dim, the blocks of its axes gathered in
    rank order."""
    def one(x, sp):
        for d, axes in _dims(sp):
            x = replicate_all_gather(x.movedim(d, 0).contiguous(), mesh,
                                     axes).movedim(0, d)
        return x.contiguous()
    if mesh.size == 1:
        return tree
    return tree_map(one, tree, specs)


def sparse_pspecs(sharded_tensors, axis="x"):
    """Placements for lowered sparse-kernel shards (executor.py).

    Stacked shard arrays (leading color axis, any kind but ``replicated``)
    shard over the machine ``axis``; replicated operands are replicated
    (``()``: every rank holds the whole array). Returns ``{tensor_name:
    {array_name: placement}}`` so the builders stay format-general — the
    array set differs per format (pos/crd levels, COO dim columns,
    densified-root views) but the placement rule does not."""
    out = {}
    for name, sh in sharded_tensors.items():
        kind = getattr(sh, "kind", "replicated")
        sp = () if kind == "replicated" else (axis,)
        out[name] = {arr_name: sp for arr_name in sh.arrays}
    return out
