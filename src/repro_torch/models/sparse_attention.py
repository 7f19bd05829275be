"""Block-sparse attention masks through the paper's format machinery.

The (q-block × kv-block) mask of a sparse attention pattern IS a sparse
matrix; it is stored in the paper's formats (Dense row-block level ×
Compressed column-block level) and distributed by the same partitioning
machinery as any other sparse tensor. ``band_plan`` builds the causal
sliding-window pattern; ``band_decode_kernel`` lowers it as the frozen
operand of a batched serving kernel (the Hopper SpMM kernels);
``block_sparse_attention`` executes attention over an ARBITRARY block mask
by gathering only the listed kv blocks (ELL-packed, ``mask_to_ell``). The
JAX package computes the latter outside any Pallas kernel; here it is
tensor operations on the inputs' device, one query block at a time.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import formats as F
from ..core.device import resolve_device
from ..core.tensor import Tensor


def band_plan(seq_len: int, q_block: int, window: int,
              name: str = "attn_mask") -> Tensor:
    """Causal sliding-window pattern as a block-CSR Tensor.

    Rows = query blocks, cols = kv blocks; entry present iff some (q, kv)
    pair inside the tile satisfies kv ≤ q and kv > q - window."""
    nq = -(-seq_len // q_block)
    rows, cols = [], []
    for qb in range(nq):
        q_lo = qb * q_block
        kv_lo_needed = max(q_lo - window + 1, 0)
        for kb in range(kv_lo_needed // q_block, qb + 1):
            rows.append(qb)
            cols.append(kb)
    coords = np.stack([np.array(rows), np.array(cols)], 1)
    vals = np.ones(coords.shape[0], np.float32)
    return Tensor.from_coo(name, (nq, nq), coords, vals, F.CSR())


def band_decode_kernel(seq_len: int, q_block: int, window: int,
                       machine, *, batch: int = 8, schedule=None,
                       device=None):
    """The band mask lowered as the frozen sparse operand of a batched
    serving kernel on ``device`` (the card when None).

    Each decode request carries a per-kv-block summary vector ``v`` (one
    entry per block — e.g. a pooled value/score statistic), and
    ``y = attn_mask @ v`` aggregates it under the sliding-window pattern.
    The mask never changes between requests, so the plan, the packed CSR
    shards, and the per-bucket runner are all built exactly once;
    ``run_many`` batches concurrent decode streams into one SpMM.
    Returns a :class:`repro_torch.core.lower.BatchedKernel`."""
    from ..core.lower import lower_batched
    from ..core.tin import parse_tin
    mask = band_plan(seq_len, q_block, window)
    nq = mask.shape[0]
    stmt = parse_tin("y(i) = attn_mask(i,j) * v(j)",
                     y=Tensor.zeros_dense("y", (nq,)),
                     attn_mask=mask,
                     v=Tensor.zeros_dense("v", (nq,)))
    return lower_batched(stmt, machine, batch=batch, schedule=schedule,
                         device=device)


def mask_to_ell(mask: Tensor, block_r: int = 1, device=None) -> torch.Tensor:
    """Pack the block mask's CSR into the ELL layout the gather consumes:
    (nq, max_blocks) kv-block ids, −1 for padding, on ``device`` (the card
    when None)."""
    pos = mask.levels[1].pos
    crd = mask.levels[1].crd
    nq = mask.shape[0]
    counts = np.diff(pos)
    maxb = int(counts.max()) if counts.size else 1
    idx = np.full((nq, maxb), -1, np.int32)
    for q in range(nq):
        lo, hi = int(pos[q]), int(pos[q + 1])
        idx[q, : hi - lo] = crd[lo:hi]
    return torch.from_numpy(idx).to(resolve_device(device))


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, block_idx: torch.Tensor,
                           q_block: int, causal: bool = True,
                           window: int = 0) -> torch.Tensor:
    """Attention over an arbitrary block mask, on the inputs' device.

    q, k, v: (B, S, H, hd); block_idx: (nq, maxb) kv-block ids (−1 = pad).
    Each query block gathers only its listed kv blocks — compute scales
    with nnz(blocks)·q_block², not S². Block sparsity is block-granular;
    ``causal`` and ``window`` refine the mask at element granularity inside
    edge blocks (band_plan + window reproduces exact sliding-window
    attention). Scores and softmax are float32.
    """
    B, S, H, hd = q.shape
    nq, maxb = block_idx.shape
    pad = nq * q_block - S
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                   for x in (q, k, v))
    qb = q.reshape(B, nq, q_block, H, hd)
    kb = k.reshape(B, nq, q_block, H, hd)
    vb = v.reshape(B, nq, q_block, H, hd)
    scale = hd ** -0.5
    block_idx = block_idx.to(q.device).long()
    ar = torch.arange(q_block, device=q.device)
    out = torch.empty_like(qb)
    for qi in range(nq):
        idx = block_idx[qi]                        # (maxb,)
        safe = idx.clamp_min(0)
        kg = kb[:, safe]                           # (B, maxb, qb, H, hd)
        vg = vb[:, safe]
        s = torch.einsum("bqhd,bmkhd->bhqmk", qb[:, qi], kg).float() * scale
        q_pos = qi * q_block + ar
        kv_pos = safe[:, None] * q_block + ar[None, :]
        valid = (idx >= 0)[:, None] & (kv_pos < S)
        if causal:
            valid = valid[None, :, :] & \
                (kv_pos[None] <= q_pos[:, None, None])
        else:
            valid = valid[None].expand(q_block, maxb, q_block)
        if window:
            valid = valid & (kv_pos[None] > q_pos[:, None, None] - window)
        s = s.masked_fill(~valid[None, None], -1e30)
        w = torch.softmax(s.reshape(B, H, q_block, -1), dim=-1)
        w = w.reshape(B, H, q_block, maxb, q_block).to(q.dtype)
        out[:, qi] = torch.einsum("bhqmk,bmkhd->bqhd", w, vg)
    return out.reshape(B, nq * q_block, H, hd)[:, :S]
