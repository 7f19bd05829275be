"""Building blocks shared by the architectures (the port of the reference's
``models/layers.py``).

Parameters are plain nested dicts of tensors, as the reference's pytrees,
so the two packages' weights map key for key; layers are functions on
tensors. A matrix W is stored (d_in, d_out) and applied as
``x @ W.to(x.dtype)``; norms compute in float32. Initialisers draw from a
``torch.Generator`` (torch cannot reproduce JAX's PRNG, so the tests carry
the reference's weights over with :mod:`.convert`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Sharding context
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Logical axis → mesh axis mapping, as the reference's.

    ``batch`` names the mesh axes the batch dim is sharded over, ``model``
    the tensor-parallel axis, ``seq`` the sequence-sharding axis, ``dp`` the
    data-parallel degree. With ``active=False`` (one device) every
    constraint is a no-op; the sharded form waits for the planner."""

    batch: Tuple[str, ...] = ()
    model: Optional[str] = None
    seq: Optional[str] = None
    active: bool = False
    dp: int = 1

    def cs(self, x: torch.Tensor, *axes) -> torch.Tensor:
        """Constrain ``x`` to a placement built from logical axis names
        ('batch' | 'model' | 'seq' | None per dim)."""
        if not self.active:
            return x
        raise NotImplementedError(
            "sharding constraints (an active ShardCtx) wait for the "
            "planner's DTensor placements: ROADMAP Queue 1 item 7")


NO_SHARD = ShardCtx()


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> torch.Tensor:
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w.mul_(scale)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w.mul_(0.02)).to(dtype)


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int → (cos, sin) of shape (..., S, head_dim//2)."""
    half = head_dim // 2
    exps = -torch.arange(half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (..., S, hd//2), broadcast over H."""
    half = x.shape[-1] // 2
    c = cos.unsqueeze(-2).to(x.dtype)            # (..., S, 1, half)
    s = sin.unsqueeze(-2).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def swiglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    return F.silu(x_gate) * x_up


def softmax_fp32(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(scores.float(), dim=dim)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, f: int,
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return {"wg": dense_init(gen, d, f, dtype),
            "wu": dense_init(gen, d, f, dtype),
            "wd": dense_init(gen, f, d, dtype)}


def mlp_apply(params, x: torch.Tensor,
              ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    dt = x.dtype
    h = swiglu(x @ params["wg"].to(dt), x @ params["wu"].to(dt))
    h = ctx.cs(h, "batch", None, "model")
    out = h @ params["wd"].to(dt)
    return ctx.cs(out, "batch", None, None)
