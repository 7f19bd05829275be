"""Mamba2-style state-space blocks (SSD), zamba2's backbone (the port of the
reference's ``models/ssm.py``).

The forward uses the chunkwise-parallel SSD form through the shared
:mod:`.gla` core (g = Δ·A, s = Δ, K/Q = B/C projections shared across
heads). Decode carries the (H, N, P) state: O(1) per token.

As in the reference, against the full Mamba2: no conv1d branch, a single
B/C group and no bias terms.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .gla import gla_chunked, gla_decode_step
from .layers import NO_SHARD, ShardCtx, dense_init, rmsnorm


def ssm_dims(d_model: int, expand: int, head_dim: int) -> Tuple[int, int]:
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    return d_inner, n_heads


def ssm_init(gen: torch.Generator, d_model: int, *, state: int,
             expand: int = 2, head_dim: int = 64, groups: int = 1,
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
    d_inner, n_heads = ssm_dims(d_model, expand, head_dim)
    dev = gen.device
    return {
        "wx": dense_init(gen, d_model, d_inner, dtype),
        "wz": dense_init(gen, d_model, d_inner, dtype),
        "wB": dense_init(gen, d_model, groups * state, dtype),
        "wC": dense_init(gen, d_model, groups * state, dtype),
        "wdt": dense_init(gen, d_model, n_heads, dtype),
        # A = -exp(A_log); A_log and D stay float32 whatever the weights'
        "A_log": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "wo": dense_init(gen, d_inner, d_model, dtype),
        "norm": torch.ones((d_inner,), dtype=dtype, device=dev),
    }


def ssm_state_shape(cfg_batch: int, d_model: int, *, state: int,
                    expand: int = 2, head_dim: int = 64) -> Tuple[int, ...]:
    _, H = ssm_dims(d_model, expand, head_dim)
    return (cfg_batch, H, state, head_dim)


def _projections(params, x):
    dt_ = x.dtype
    B, S, _ = x.shape
    d_inner = params["wx"].shape[1]
    H = params["wdt"].shape[1]
    head_dim = d_inner // H
    xh = (x @ params["wx"].to(dt_)).reshape(B, S, H, head_dim)
    z = x @ params["wz"].to(dt_)
    Bm = x @ params["wB"].to(dt_)
    Cm = x @ params["wC"].to(dt_)
    dt = F.softplus(x.float() @ params["wdt"].float())        # (B,S,H)
    return xh, z, Bm, Cm, dt, H, head_dim, d_inner


def ssm_apply(params: Dict, x: torch.Tensor, *, state: int, expand: int = 2,
              head_dim: int = 64, chunk: int = 128,
              ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """Training / prefill forward. x: (B, S, d); S need not be a multiple
    of ``chunk`` (the inputs are zero-padded to one and the output cut)."""
    B, S, _ = x.shape
    dt_ = x.dtype
    xh, z, Bm, Cm, dt, H, hd, d_inner = _projections(params, x)
    xh = ctx.cs(xh, "batch", None, "model", None)
    A = -torch.exp(params["A_log"])
    log_decay = dt * A[None, None, :]
    pad = (-S) % chunk
    if pad:
        def f(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        xh, dt, Bm, Cm, log_decay = map(f, (xh, dt, Bm, Cm, log_decay))
    y, _ = gla_chunked(xh, log_decay, dt, Bm, Cm, chunk=chunk)
    y = y[:, :S]
    y = y + params["D"].to(dt_)[None, None, :, None] * xh[:, :S]
    y = y.reshape(B, S, d_inner)
    y = rmsnorm(y, params["norm"]) * F.silu(z)
    out = y @ params["wo"].to(dt_)
    return ctx.cs(out, "batch", None, None)


def ssm_decode(params: Dict, x: torch.Tensor, h: torch.Tensor, *,
               state: int, expand: int = 2, head_dim: int = 64,
               ctx: ShardCtx = NO_SHARD):
    """One decode step. x: (B, 1, d); h: (B, H, N, P) carried state.
    Returns (out, h_new)."""
    B, _, d = x.shape
    dt_ = x.dtype
    xh, z, Bm, Cm, dt, H, hd, d_inner = _projections(params, x)
    A = -torch.exp(params["A_log"])
    log_decay = (dt * A[None, None, :])[:, 0]                 # (B,H)
    y, h_new = gla_decode_step(h, xh[:, 0], log_decay, dt[:, 0],
                               Bm[:, 0], Cm[:, 0])
    y = y + params["D"].to(dt_)[None, :, None] * xh[:, 0]
    y = y.reshape(B, d_inner)
    y = rmsnorm(y, params["norm"]) * F.silu(z[:, 0])
    out = (y @ params["wo"].to(dt_)).reshape(B, 1, d)
    return ctx.cs(out, "batch", None, None), h_new
