"""AdamW over the port's parameter trees.

Optimizer state mirrors the params tree, so the planner's specs place
params, grads and both moments alike (``distributed/planner.py``: each rank
holds its slices). Moments are f32 whatever the parameters' dtype.

The update runs under ``torch.no_grad()`` leaf by leaf and writes the
parameters and both moments **in place**, returning them: the reference
returns new trees, but new copies of internlm2-1.8b's parameters and
moments (30 GB in f32) would not fit on the card beside the old ones.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar on the parameters' device
    mu: Any                  # first moment, a tree like params
    nu: Any                  # second moment, a tree like params


def adamw_init(params) -> AdamWState:
    """Zero f32 moments on each parameter's device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = leaves(params)
    device = first[0].device if first else torch.device("cpu")
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(grads) -> torch.Tensor:
    """The f32 norm of all leaves together, their squares summed in tree
    order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(grads)))


def clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that brings gradients of norm ``gnorm`` to at most
    ``max_norm``."""
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)


def adamw_update(params, grads, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip_norm: Optional[float] = 1.0):
    """One AdamW step; returns ``(params, state, gnorm)``. ``lr`` may be a
    scalar or a schedule value (a 0-d tensor).

    Global-norm clipping runs first (the norm is the only cross-parameter
    reduction); weight decay is decoupled and applies to every leaf, with
    bias-corrected moments, as in the reference. Parameters and moments
    are updated in place (module docstring)."""
    with torch.no_grad():
        step = state.step + 1
        scale = None
        if grad_clip_norm is not None:
            gnorm = global_norm(grads)
            scale = clip_scale(gnorm, grad_clip_norm)
        else:
            gnorm = torch.zeros((), dtype=torch.float32,
                                device=state.step.device)
        b1t = 1 - b1 ** step.to(torch.float32)
        b2t = 1 - b2 ** step.to(torch.float32)
        flat_p, flat_g = leaves(params), leaves(grads)
        flat_m, flat_v = leaves(state.mu), leaves(state.nu)
        if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
            raise ValueError("params, grads and moments differ in structure")
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            g32 = (g if scale is None else g * scale).to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * torch.square(g32))
            del g32
            delta = (m / b1t) / (torch.sqrt(v / b2t) + eps)
            p32 = p.to(torch.float32)
            delta += weight_decay * p32
            p.copy_(p32 - lr * delta)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm
