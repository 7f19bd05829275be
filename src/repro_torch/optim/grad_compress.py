"""Gradient compression for cross-pod data parallelism.

Two schemes, both with error feedback so compression noise doesn't bias the
optimizer:

- **int8 quantized all-reduce**: per-tensor max-abs scaling to int8 before
  the cross-pod reduction (4× wire-format saving on the slow pod-to-pod
  links; intra-pod reductions stay bf16/fp32).

- **top-k sparse gradient exchange**: the gradient becomes a *sparse
  vector* (values at the top-|g| coordinates, the paper's fused-coordinate
  form), exchanged with a non-zero partition.

Both operate on a tree of tensors and return (compressed_update,
new_error_state). ``torch.round`` rounds half to even, as ``jnp.round``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..tree import leaves, tree_map, unflatten


def int8_quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _zeros_like(grads):
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)


def compress_int8_ef(grads, err):
    """Quantize grads + error feedback to int8; returns (q, scales,
    new_err). Summing the dequantized values across the 'pod' axis is the
    compressed cross-pod all-reduce."""
    if err is None:
        err = _zeros_like(grads)
    comp = [int8_quantize(g.to(torch.float32) + e)
            for g, e in zip(leaves(grads), leaves(err))]
    q = unflatten(grads, [c[0] for c in comp])
    scales = unflatten(grads, [c[1] for c in comp])
    new_err = tree_map(
        lambda g, e, qq, s: g.to(torch.float32) + e - int8_dequantize(qq, s),
        grads, err, q, scales)
    return q, scales, new_err


def topk_sparsify(g: torch.Tensor, k_frac: float = 0.01):
    """Keep the top-|g| fraction; returns (values, flat_indices, shape),
    largest magnitude first, as ``jax.lax.top_k``."""
    flat = g.reshape(-1).to(torch.float32)
    k = max(int(flat.shape[0] * k_frac), 1)
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx, tuple(g.shape)


def topk_densify(values, idx, shape, dtype=torch.float32) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    out = torch.zeros((n,), dtype=dtype, device=values.device)
    return out.index_add_(0, idx, values.to(dtype)).reshape(shape)


def compress_topk_ef(grads, err, k_frac: float = 0.01):
    """Top-k sparsification with error feedback over a tree; returns
    (sparse (values, indices) pairs, new_err, dense)."""
    if err is None:
        err = _zeros_like(grads)

    def one(g, e):
        acc = g.to(torch.float32) + e
        v, i, shp = topk_sparsify(acc, k_frac)
        dense = topk_densify(v, i, shp)
        return (v, i), acc - dense, dense

    res = [one(g, e) for g, e in zip(leaves(grads), leaves(err))]
    sparse = unflatten(grads, [r[0] for r in res])
    new_err = unflatten(grads, [r[1] for r in res])
    dense = unflatten(grads, [r[2] for r in res])
    return sparse, new_err, dense
