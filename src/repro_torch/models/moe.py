"""Mixture-of-Experts with SpDISTAL-style sparse dispatch (the port of the
reference's ``models/moe.py``).

The router output is a sparse (tokens × experts) matrix with top-k
non-zeros per row. :func:`moe_apply` dispatches by coordinate fusion:

- flatten the (token, expert) assignment pairs into one coordinate;
- sort them by expert, a stable sort: the capacity drops depend on the
  order within an expert, and the reference's ``argsort`` is stable;
- split them into fixed-capacity expert buckets (a static-shape non-zero
  partition of the expert dimension; the assignments past an expert's
  capacity are dropped and land in a spill row that is cut off).

The combine un-permutes each token's ``top_k`` contributions to
(tokens, k, d) and sums them over k in a fixed order, so a result repeats
bit for bit on the card (a scatter-add with atomics would not).

:func:`dispatch_tensor` stores the same matrix in CSR, and
:func:`combine_kernel` lowers the combine ``y = dispatch @ c`` as a batched
serving kernel over it (the Hopper SpMM kernels).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from ..core import formats as F
from ..core.tensor import Tensor
from .layers import NO_SHARD, ShardCtx, dense_init


def dispatch_tensor(tope, topw, n_experts: int,
                    name: str = "dispatch") -> Tensor:
    """The router's top-k assignment as the paper's sparse matrix: a
    (tokens × experts) CSR Tensor whose row ``t`` holds token ``t``'s
    combine weights at its chosen expert columns."""
    tope = np.asarray(tope)
    topw = np.asarray(topw, np.float32)
    N, k = tope.shape
    coords = np.stack([np.repeat(np.arange(N, dtype=np.int64), k),
                       tope.reshape(-1).astype(np.int64)], axis=1)
    return Tensor.from_coo(name, (N, int(n_experts)), coords,
                           topw.reshape(-1), F.CSR(), dedupe=True)


def combine_kernel(disp: Tensor, machine, *, batch: int = 8,
                   schedule=None, device=None):
    """The MoE combine ``y(t) = dispatch(t, e) * c(e)`` lowered as a
    batched serving kernel on ``device`` (the card when None): each
    request is one model-dimension column of the stacked per-expert
    outputs, and ``run_many`` folds a batch of columns into a single SpMM
    against the frozen dispatch matrix. Returns a
    :class:`repro_torch.core.lower.BatchedKernel`."""
    from ..core.lower import lower_batched
    from ..core.tin import parse_tin
    N, E = disp.shape
    stmt = parse_tin("y(i) = dispatch(i,j) * c(j)",
                     y=Tensor.zeros_dense("y", (int(N),)),
                     dispatch=disp,
                     c=Tensor.zeros_dense("c", (int(E),)))
    return lower_batched(stmt, machine, batch=batch, schedule=schedule,
                         device=device)


def moe_init(gen: torch.Generator, d: int, f: int, n_experts: int,
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Experts stacked on a leading E axis; the router stays float32."""
    scale_in = (2.0 / (d + f)) ** 0.5

    def experts(shape):
        w = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return w.mul_(scale_in).to(dtype)

    return {
        "router": dense_init(gen, d, n_experts, torch.float32),
        "wg": experts((n_experts, d, f)),
        "wu": experts((n_experts, d, f)),
        "wd": experts((n_experts, f, d)),
    }


def _dispatch(params, xg, n_experts: int, top_k: int, C: int):
    """One data-parallel group's routing and coordinate-fusion dispatch.
    xg: (Nl, d) → (buckets (E, C, d), slot, order, w_eff, aux)."""
    Nl, d = xg.shape
    dt = xg.dtype
    logits = xg.float() @ params["router"]
    gates = torch.softmax(logits, dim=-1)                   # (Nl, E)
    topw, tope = torch.topk(gates, top_k, dim=-1)           # (Nl, k)
    topw = topw / (topw.sum(-1, keepdim=True) + 1e-9)
    # Switch-style load-balance aux loss
    me = gates.mean(0)
    cexp = Fn.one_hot(tope[:, 0], n_experts).float().mean(0)
    aux = n_experts * torch.sum(me * cexp)

    # coordinate fusion (token, expert) -> f; a stable sort by expert groups
    # the non-zeros by the expert level
    e_flat = tope.reshape(-1)
    t_flat = torch.arange(Nl, device=xg.device).repeat_interleave(top_k)
    w_flat = topw.reshape(-1).to(dt)
    order = torch.argsort(e_flat, stable=True)
    e_s, t_s, w_s = e_flat[order], t_flat[order], w_flat[order]
    # rank within expert = position inside the non-zero partition
    pos_all = torch.arange(e_s.numel(), device=xg.device)
    seg_start = torch.searchsorted(
        e_s, torch.arange(n_experts, device=xg.device), side="left")
    pos_in_e = pos_all - seg_start[e_s]
    keep = pos_in_e < C
    slot = torch.where(keep, e_s * C + pos_in_e, n_experts * C)
    # one spill row takes the dropped assignments and is cut off
    buckets = torch.zeros((n_experts * C + 1, d), dtype=dt, device=xg.device)
    buckets[slot] = xg[t_s]
    return (buckets[:-1].reshape(n_experts, C, d), slot, order,
            w_s * keep.to(dt), aux)


def moe_apply(params: Dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25,
              ctx: ShardCtx = NO_SHARD) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (y, aux_loss).

    Routing, sorting, ranks and capacity run per data-parallel group
    (``ctx.dp`` groups of N/dp tokens; one group on one card), with the
    per-group capacity C = ceil(N_loc·k/E · cf), truncated as the
    reference truncates it. Token order is restored by un-permuting each
    token's k weighted contributions and summing them over k in order."""
    B, S, d = x.shape
    N = B * S
    dt = x.dtype
    dp = max(ctx.dp, 1)
    if N % dp:
        dp = 1
    Nl = N // dp                                            # tokens per group
    xt = ctx.cs(x.reshape(dp, Nl, d), "batch", None, None)
    C = int(max(-(-Nl * top_k // n_experts) * capacity_factor, 1))

    groups = [_dispatch(params, xt[g], n_experts, top_k, C)
              for g in range(dp)]
    buckets = torch.stack([g[0] for g in groups])           # (dp, E, C, d)
    buckets = ctx.cs(buckets, "batch", "model", None, None)

    # expert FFNs (grouped einsum)
    h = torch.einsum("gecd,edf->gecf", buckets, params["wg"].to(dt))
    u = torch.einsum("gecd,edf->gecf", buckets, params["wu"].to(dt))
    h = ctx.cs(Fn.silu(h) * u, "batch", "model", None, None)
    y_e = torch.einsum("gecf,efd->gecd", h, params["wd"].to(dt))
    y_e = ctx.cs(y_e.reshape(dp, n_experts * C, d), "batch", None, None)

    # combine: each assignment's weighted output back at its flat (t, j)
    # coordinate, then the k contributions of a token summed in order
    ys = []
    for g, (_, slot, order, w_eff, _) in enumerate(groups):
        contrib = y_e[g][torch.clamp(slot, max=n_experts * C - 1)]
        contrib = contrib * w_eff[:, None]
        flat = torch.empty_like(contrib)
        flat[order] = contrib
        flat = flat.reshape(Nl, top_k, d)
        y = flat[:, 0]
        for j in range(1, top_k):
            y = y + flat[:, j]
        ys.append(y)
    y = ctx.cs(torch.stack(ys).reshape(B, S, d), "batch", None, None)
    aux = torch.stack([g[4] for g in groups]).mean().float()
    return y, aux
