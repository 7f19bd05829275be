"""Step builders: train_step / prefill_step / decode_step for one
architecture, shape and mesh, with the planner's placement.

The train step is the reference's: the microbatch loop with f32 gradient
sums, their mean over ``accum``, the schedule at the step being taken
(1-based) and AdamW, with the metrics ``loss`` (the mean over
microbatches), ``gnorm`` and ``lr``. On a mesh of more than one rank each
rank holds only its blocks of the parameters and moments
(``planner.place``); a step gathers the whole weights, runs the rank's
rows of every microbatch, sums the gradients over the data axes in rank
order (``collectives.reduce_rows``) and keeps its blocks, and AdamW runs
on those. Ranks along 'model' compute the same rows (the axis shards
storage only; ROADMAP Queue 2).

A prefill or decode step on a mesh of more than one rank is built the
same way (:func:`build_step`): the rank holds its blocks of the serving
parameters (``params_pspecs(serve=True)``) and of the decode cache
(``cache_pspecs``), gathers the whole weights and the whole of its rows
of the cache (every dim but the batch), runs its rows of the batch (all
of them where the batch does not split over the data axes) and keeps its
blocks of the written cache. The port has no tensor- or
sequence-parallel serving compute.

``input_specs``, ``abstract_state``, ``step_shardings`` and
``build_step`` are the dry-run's stand-ins: ``meta`` tensors of the
inputs, the parameters and AdamW's moments, the planner's placement of
each argument, and the step over one rank's blocks (no ``jit``: the
step runs eagerly, on ``meta`` for the dry-run).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..distributed import collectives, planner
from ..distributed.mesh import Mesh, axis_size, data_axes
from ..models.layers import ShardCtx
from ..models.model import LM
from ..optim.adamw import (AdamWState, adamw_init, adamw_update, clip_scale,
                           global_norm)
from ..optim.schedules import cosine_with_warmup
from ..tree import leaves, tree_map, unflatten

#: attention variants a train step can take a gradient through
TRAINABLE_VARIANTS = ("auto", "dense", "chunked", "windowed")


def make_ctx(mesh: Mesh) -> ShardCtx:
    da = data_axes(mesh)
    return ShardCtx(batch=da, model="model" if "model" in mesh.axis_names
                    else None, seq="model", active=True,
                    dp=axis_size(mesh, *da) or 1,
                    axis_names=tuple(mesh.axis_names))


def rank_local_ctx(ctx: ShardCtx) -> ShardCtx:
    """The context of a rank's own rows: its batch is already its data
    shard (no axes left to shard it over, one MoE dispatch group, which is
    the reference's group of this shard)."""
    return dataclasses.replace(ctx, batch=(), dp=1)


def build_lm(cfg: ArchConfig, mesh: Mesh, serve: bool = False) -> LM:
    if serve:
        # serving holds no optimizer state; bf16 params are the standard
        # deployment format
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    return LM(cfg, make_ctx(mesh))


def effective_accum(cfg_batch: int, requested: int, mesh: Mesh) -> int:
    """Largest accum ≤ requested with a data-shardable microbatch."""
    dp = axis_size(mesh, *data_axes(mesh)) or 1
    accum = max(requested, 1)
    while accum > 1 and (cfg_batch % accum or (cfg_batch // accum) % dp):
        accum -= 1
    return accum


# ---------------------------------------------------------------------------
# Input specs (meta stand-ins)
# ---------------------------------------------------------------------------

META = torch.device("meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig, lm: LM) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input of the cell, whole (the
    global batch): ``tokens`` (int32) and ``frontend`` (bf16) for train
    and prefill, ``token`` (int32) and the decode ``cache`` for decode."""
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = torch.empty((B, S), dtype=torch.int32, device=META)
        if cfg.frontend != "none":
            specs["frontend"] = torch.empty(
                (B, cfg.frontend_tokens, cfg.d_model), dtype=torch.bfloat16,
                device=META)
    else:  # decode
        specs["token"] = torch.empty((B,), dtype=torch.int32, device=META)
        window = shape.attention_window or cfg.attention_window
        specs["cache"] = lm.init_cache(
            B, S, window=window,
            src_len=cfg.frontend_tokens if cfg.is_encdec else 0,
            device=META)
    return specs


def abstract_state(lm: LM):
    """The parameters and AdamW's state, as ``meta`` tensors."""
    params = lm.abstract_params()
    return params, adamw_init(params)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def make_loss_and_grads(lm: LM, shape: ShapeConfig):
    """``loss_and_grads(params, tokens, frontend=None) -> (loss, grads)``:
    one microbatch's loss (a detached 0-d tensor) and its gradient with
    respect to every parameter (a tree like ``params``), as the reference's
    ``jax.value_and_grad(loss_fn)``. The parameters themselves are not
    marked: the graph is built over detached aliases of them."""
    cfg = lm.cfg
    window = shape.attention_window or cfg.attention_window
    variant = cfg.train_attn_variant if shape.kind == "train" else "auto"
    if variant not in TRAINABLE_VARIANTS:
        raise RuntimeError(
            f"{cfg.name}: train_attn_variant={variant!r} has no gradient "
            "(the reference's Pallas flash kernel defines none, and "
            "jax.grad through it fails); training takes 'dense', "
            "'chunked' or 'windowed'")

    def loss_and_grads(params, tokens, frontend=None):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            loss = lm.loss(unflatten(params, flat), tokens, frontend,
                           window=window, variant=variant)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return loss.detach(), unflatten(params, grads)

    return loss_and_grads


def _rank_rows(x: torch.Tensor, mesh: Mesh, accum: int) -> torch.Tensor:
    """(accum, rows of a microbatch, ...) of this rank: its data shard of
    every microbatch, the reference's batch sharding over the data axes."""
    mb = x.shape[0] // accum
    x = x.reshape(accum, mb, *x.shape[1:])
    da = data_axes(mesh)
    dp = axis_size(mesh, *da) or 1
    if dp == 1:
        return x
    n = mb // dp
    i = mesh.index(da)
    return x[:, i * n:(i + 1) * n]


def make_train_step(lm: LM, shape: ShapeConfig, mesh: Mesh, *,
                    peak_lr: float = 3e-4, total_steps: int = 10000,
                    param_specs=None):
    """``(train_step, accum)``: ``train_step(params, opt_state, tokens,
    frontend=None) -> (params, opt_state, metrics)``, with the
    per-microbatch ``loss_and_grads`` it uses as ``train_step.
    loss_and_grads``. On a mesh of more than one rank, ``params`` and the
    moments are this rank's blocks by ``param_specs`` (the spec tree of
    the whole parameters; ``planner.place``) and ``tokens`` the whole
    global batch. Raises at once for an attention variant with no
    gradient (``flash``). Parameters and moments are updated in place."""
    cfg = lm.cfg
    requested = cfg.grad_accum_override or shape.grad_accum
    accum = effective_accum(shape.global_batch, requested, mesh)
    sharded = mesh.size > 1
    if sharded:
        if param_specs is None:
            raise ValueError("a step on a mesh of more than one rank needs "
                             "the parameters' specs (planner.params_pspecs "
                             "of the whole parameters)")
        lm = LM(cfg, rank_local_ctx(lm.ctx))
    loss_and_grads = make_loss_and_grads(lm, shape)
    da = data_axes(mesh)
    dp = axis_size(mesh, *da) or 1
    warmup = max(min(200, total_steps // 10), 1)

    def train_step(params, opt_state: AdamWState, tokens,
                   frontend=None):
        whole = planner.gather(params, param_specs, mesh) if sharded \
            else params
        tk = _rank_rows(tokens, mesh, accum)
        fe = (_rank_rows(frontend, mesh, accum) if frontend is not None
              else None)
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), whole)
        acc = leaves(gsum)
        losses = []
        for a in range(accum):
            loss, g = loss_and_grads(whole, tk[a],
                                     fe[a] if fe is not None else None)
            for s, gi in zip(acc, leaves(g)):
                s.add_(gi.to(torch.float32))
            del g
            losses.append(loss)
        loss = torch.stack(losses).mean()
        if sharded and dp > 1:
            # the rows' gradients summed over the data ranks in rank
            # order; each rank's loss is the mean over its rows
            acc = [collectives.reduce_rows(s, mesh, da) for s in acc]
            loss = collectives.reduce_rows(loss.reshape(1), mesh, da)[0] / dp
        for s in acc:
            s.div_(accum * dp if sharded else accum)
        lr = cosine_with_warmup(opt_state.step + 1, peak_lr=peak_lr,
                                warmup_steps=warmup, total_steps=total_steps)
        if sharded:
            # clip by the norm of the whole gradient (adamw_update's
            # default max norm, 1.0), then keep the blocks
            gnorm = global_norm(acc)
            scale = clip_scale(gnorm, 1.0)
            grads = unflatten(params, [
                s[planner.block_of(s.shape, sp, mesh)] * scale
                for s, sp in zip(acc, leaves(param_specs,
                                             is_leaf=planner.is_spec))])
            del acc, gsum
            new_p, new_opt, _ = adamw_update(params, grads, opt_state,
                                             lr=lr, grad_clip_norm=None)
        else:
            del acc
            new_p, new_opt, gnorm = adamw_update(params, gsum, opt_state,
                                                 lr=lr)
        metrics = {"loss": loss, "gnorm": gnorm, "lr": lr}
        return new_p, new_opt, metrics

    train_step.loss_and_grads = loss_and_grads
    return train_step, accum


def make_prefill_step(lm: LM, shape: ShapeConfig, variant: str = "auto"):
    cfg = lm.cfg
    window = shape.attention_window or cfg.attention_window

    def prefill_step(params, tokens, frontend=None):
        logits, _ = lm.apply(params, tokens, frontend, window=window,
                             variant=variant, last_only=True)
        return logits[:, 0]

    return prefill_step


def make_decode_step(lm: LM, shape: ShapeConfig):
    cfg = lm.cfg
    window = shape.attention_window or cfg.attention_window

    def decode_step(params, cache, token):
        return lm.decode_step(params, cache, token, window=window)

    return decode_step


def _rows(x: torch.Tensor, mesh: Mesh, sp) -> torch.Tensor:
    """This rank's rows of a whole batch-leading ``x`` under spec ``sp``."""
    return x[planner.block_of(x.shape, sp, mesh)]


def _rows_spec(sp, mesh: Mesh):
    """``sp`` without its batch entry (the data axes alone): the dims a
    rank gathers to hold the whole of its rows."""
    batch = planner.spec(data_axes(mesh))[0]
    return tuple(None if e == batch else e for e in sp)


def make_rank_prefill_step(lm: LM, shape: ShapeConfig, mesh: Mesh,
                           param_specs, variant: str = "auto"):
    """The prefill over one rank's blocks on a mesh of more than one rank
    (module docstring): ``(params, tokens, frontend=None) -> logits`` of
    the rank's rows, ``tokens`` the whole batch."""
    inner = make_prefill_step(LM(lm.cfg, rank_local_ctx(lm.ctx)), shape,
                              variant)
    B = shape.global_batch

    def prefill_step(params, tokens, frontend=None):
        whole = planner.gather(params, param_specs, mesh)
        fe = (_rows(frontend, mesh, planner.frontend_pspec(mesh, B))
              if frontend is not None else None)
        return inner(whole, _rows(tokens, mesh, planner.batch_pspec(mesh, B)),
                     fe)

    return prefill_step


def make_rank_decode_step(lm: LM, shape: ShapeConfig, mesh: Mesh,
                          param_specs, cache_specs, token_spec):
    """The decode step over one rank's blocks on a mesh of more than one
    rank (module docstring): ``(params, cache, token) -> (logits, cache)``
    with ``cache`` the rank's blocks (written in place) and ``token`` the
    whole batch's."""
    inner = make_decode_step(LM(lm.cfg, rank_local_ctx(lm.ctx)), shape)
    row_specs = tree_map(lambda sp: _rows_spec(sp, mesh), cache_specs,
                         is_leaf=planner.is_spec)

    def decode_step(params, cache, token):
        whole = planner.gather(params, param_specs, mesh)
        mine = _rows(token, mesh, token_spec)
        rows = planner.gather(cache, row_specs, mesh)
        # the rows' own positions: the held ones advance below
        rows["pos"] = _rows(rows["pos"], mesh, token_spec).clone()
        logits, rows = inner(whole, rows, mine)
        for key, held in cache.items():
            if key == "pos":
                held.add_(1)
            else:
                held.copy_(rows[key][planner.block_of(
                    rows[key].shape, row_specs[key], mesh)])
        return logits, cache

    return decode_step


# ---------------------------------------------------------------------------
# Placement of a full step
# ---------------------------------------------------------------------------

def token_pspec(mesh: Mesh, batch: int):
    """The decode tokens' spec: over the data axes when the batch splits."""
    da = data_axes(mesh)
    if batch % (axis_size(mesh, *da) or 1) == 0 and batch > 1:
        return planner.spec(da)
    return (None,)


def step_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, lm: LM):
    """``(args_abstract, shardings, donate_argnums)`` for the cell's step:
    the whole arguments as ``meta`` tensors, the placement of each
    (``planner.Sharding`` trees: the planner's specs on ``mesh``) and the
    arguments the step writes in place (train: the parameters and
    moments; decode: the cache), the reference's donated arguments."""
    serve = shape.kind != "train"
    B = shape.global_batch
    specs = input_specs(cfg, shape, lm)
    if shape.kind == "decode":
        params_abs = lm.abstract_params()
    else:
        params_abs, opt_abs = abstract_state(lm)
    p_sh = planner.shardings_from(
        planner.params_pspecs(params_abs, mesh, serve=serve), mesh)
    if shape.kind in ("train", "prefill"):
        b_sh = planner.Sharding(mesh, planner.batch_pspec(mesh, B))
        if shape.kind == "train":
            o_sh = planner.shardings_from(
                planner.opt_pspecs(opt_abs, params_abs, mesh), mesh)
            args, shard = [params_abs, opt_abs, specs["tokens"]], \
                [p_sh, o_sh, b_sh]
        else:
            args, shard = [params_abs, specs["tokens"]], [p_sh, b_sh]
        if "frontend" in specs:
            args.append(specs["frontend"])
            shard.append(planner.Sharding(
                mesh, planner.frontend_pspec(mesh, B)))
        return tuple(args), tuple(shard), ((0, 1) if shape.kind == "train"
                                           else ())
    cache_abs = specs["cache"]
    c_sh = planner.shardings_from(
        planner.cache_pspecs(cache_abs, mesh, B), mesh)
    tok_sh = planner.Sharding(mesh, token_pspec(mesh, B))
    return ((params_abs, cache_abs, specs["token"]), (p_sh, c_sh, tok_sh),
            (1,))


def _spec_tree(shardings):
    return tree_map(lambda sh: sh.spec, shardings,
                    is_leaf=lambda x: isinstance(x, planner.Sharding))


def build_step(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh,
               variant: str = "auto"):
    """``(step_fn, abstract_args, lm)`` for the cell: the step of one rank
    and its arguments as ``meta`` tensors, this rank's blocks of the
    parameters, moments and cache (the whole of each on a one-rank mesh;
    the batch is always whole, the step takes its rows). ``variant`` is
    the prefill's attention variant; train takes the config's."""
    lm = build_lm(cfg, mesh, serve=shape.kind != "train")
    args, shardings, _ = step_shardings(cfg, shape, mesh, lm)
    p_specs = _spec_tree(shardings[0])
    if shape.kind == "train":
        fn, accum = make_train_step(lm, shape, mesh,
                                    param_specs=p_specs)
        fn.accum = accum
        local = (planner.place(args[0], p_specs, mesh),
                 AdamWState(step=args[1].step,
                            mu=planner.place(args[1].mu, p_specs, mesh),
                            nu=planner.place(args[1].nu, p_specs, mesh)))
        return fn, local + tuple(args[2:]), lm
    params = planner.place(args[0], p_specs, mesh)
    if shape.kind == "prefill":
        fn = (make_rank_prefill_step(lm, shape, mesh, p_specs, variant)
              if mesh.size > 1 else make_prefill_step(lm, shape, variant))
        return fn, (params,) + tuple(args[1:]), lm
    c_specs = _spec_tree(shardings[1])
    fn = (make_rank_decode_step(lm, shape, mesh, p_specs, c_specs,
                                shardings[2].spec)
          if mesh.size > 1 else make_decode_step(lm, shape))
    return fn, (params, planner.place(args[1], c_specs, mesh), args[2]), lm
