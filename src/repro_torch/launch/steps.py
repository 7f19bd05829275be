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

``input_specs``, ``abstract_state``, ``step_shardings`` and
``build_step`` build XLA's abstract arguments for the dry-run; they come
with it (ROADMAP Queue 1 item 7e).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..distributed import collectives, planner
from ..distributed.mesh import Mesh, axis_size, data_axes
from ..models.layers import ShardCtx
from ..models.model import LM
from ..optim.adamw import AdamWState, adamw_update, clip_scale, global_norm
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


def make_prefill_step(lm: LM, shape: ShapeConfig):
    cfg = lm.cfg
    window = shape.attention_window or cfg.attention_window

    def prefill_step(params, tokens, frontend=None):
        logits, _ = lm.apply(params, tokens, frontend, window=window,
                             last_only=True)
        return logits[:, 0]

    return prefill_step


def make_decode_step(lm: LM, shape: ShapeConfig):
    cfg = lm.cfg
    window = shape.attention_window or cfg.attention_window

    def decode_step(params, cache, token):
        return lm.decode_step(params, cache, token, window=window)

    return decode_step
