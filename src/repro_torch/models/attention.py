"""Attention (the port of the reference's ``models/attention.py``).

Variants of :func:`attention_apply`, as the reference's:

- ``dense``    — masked einsum attention.
- ``chunked``  — flash-style streaming softmax over KV blocks (a Python loop
                 in place of ``lax.scan``); O(S·Bk) memory for long prefill.
- ``windowed`` — block-banded causal attention over the trailing ``window``
                 keys (a loop over q blocks in place of ``lax.map``).
- ``flash``    — the Hopper kernel :func:`..kernels.flash_attention.
                 flash_attention` (the plain masked einsum on the CPU).
- ``auto``     — windowed if a window is set, chunked above 8192 positions,
                 else dense.

:func:`attention_decode` is one decode step against a ring-buffer KV cache.
GQA throughout: query head h reads KV head h // G, and K/V are contracted
in their native (B, S, Hkv, hd) layout, never repeated.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import flash_attention
from .layers import (NO_SHARD, ShardCtx, apply_rope, dense_init, rmsnorm,
                     rope_angles, softmax_fp32)

NEG_INF = -1e30


def attn_init(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
              head_dim: int, qk_norm: bool = False,
              dtype=torch.float32) -> Dict[str, torch.Tensor]:
    p = {
        "wq": dense_init(gen, d, n_heads * head_dim, dtype),
        "wk": dense_init(gen, d, n_kv * head_dim, dtype),
        "wv": dense_init(gen, d, n_kv * head_dim, dtype),
        "wo": dense_init(gen, n_heads * head_dim, d, dtype),
    }
    if qk_norm:
        p["q_norm"] = torch.ones((head_dim,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((head_dim,), dtype=dtype, device=gen.device)
    return p


def _project_qkv(params, x, n_heads, n_kv, head_dim, ctx: ShardCtx):
    B, S, _ = x.shape
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(B, S, n_heads, head_dim)
    k = (x @ params["wk"].to(dt)).reshape(B, S, n_kv, head_dim)
    v = (x @ params["wv"].to(dt)).reshape(B, S, n_kv, head_dim)
    q = ctx.cs(q, "batch", None, "model", None)
    k = ctx.cs(k, "batch", None, None, None)
    v = ctx.cs(v, "batch", None, None, None)
    if "q_norm" in params:
        q = rmsnorm(q, params["q_norm"])
        k = rmsnorm(k, params["k_norm"])
    return q, k, v


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Q,H,hd), k: (B,S,Hkv,hd) -> scores (B,Hkv,G,Q,S) in float32
    (the reference's bf16 operands with f32 accumulation: bf16 products are
    exact in f32, so the operands are widened first)."""
    B, Q, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Q, Hkv, H // Hkv, hd)
    return torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())


def _gqa_av(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w: (B,Hkv,G,Q,S), v: (B,S,Hkv,hd) -> out (B,Q,H,hd)."""
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    B, Q, Hkv, G, hd = out.shape
    return out.reshape(B, Q, Hkv * G, hd)


# ---------------------------------------------------------------------------
# Training / prefill attention
# ---------------------------------------------------------------------------

def _dense_attention(q, k, v, causal: bool, ctx: ShardCtx):
    B, S, H, hd = q.shape
    scale = hd ** -0.5
    scores = _gqa_scores(q, k) * scale            # (B,K,G,S,Skv)
    if causal:
        Sk = k.shape[1]
        mask = torch.ones((S, Sk), dtype=torch.bool,
                          device=q.device).tril(Sk - S)
        scores = torch.where(mask, scores, NEG_INF)
    w = softmax_fp32(scores).to(q.dtype)
    out = _gqa_av(w, v)
    return ctx.cs(out, "batch", None, "model", None)


def _chunked_attention(q, k, v, causal: bool, ctx: ShardCtx,
                       kv_block: int = 1024):
    """Flash-style streaming softmax over KV blocks (memory-bounded), with
    K/V blocks kept (B, kb, Hkv, hd)."""
    B, S, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    nb = -(-Sk // kv_block)
    pad = nb * kv_block - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    scale = hd ** -0.5
    q_pos = torch.arange(S, device=q.device)
    m = torch.full((B, Hkv, G, S), -float("inf"), device=q.device)
    l = torch.zeros((B, Hkv, G, S), device=q.device)
    acc = torch.zeros((B, Hkv, G, S, hd), device=q.device)
    for bidx in range(nb):
        kblk = k[:, bidx * kv_block:(bidx + 1) * kv_block]
        vblk = v[:, bidx * kv_block:(bidx + 1) * kv_block]
        kv_pos = bidx * kv_block + torch.arange(kv_block, device=q.device)
        s = _gqa_scores(q, kblk) * scale          # (B,K,G,S,kb)
        if causal:
            mask = (kv_pos[None, :] <= (q_pos[:, None] + (Sk - S))) \
                & (kv_pos < Sk)[None, :]
        else:
            mask = (kv_pos < Sk)[None, :].expand(S, kv_block)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        upd = torch.einsum("bkgqs,bskd->bkgqd", p.to(q.dtype), vblk)
        acc = acc * corr[..., None] + upd.float()
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    return ctx.cs(out, "batch", None, "model", None)


def _windowed_attention(q, k, v, window: int, ctx: ShardCtx,
                        q_block: int = 1024):
    """Block-banded causal attention: each query block attends to the
    trailing ``window`` keys; only the blocks inside the band are
    materialized, so compute scales with S·W, not S²."""
    B, S, H, hd = q.shape
    if k.shape[1] != S:
        raise ValueError("the windowed path expects self-attention")
    nqb = -(-S // q_block)
    pad = nqb * q_block - S
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                   for x in (q, k, v))
    span = window + q_block  # KV needed per q block
    scale = hd ** -0.5
    Sp = nqb * q_block
    blocks = []
    for bidx in range(nqb):
        qs = bidx * q_block
        ks = min(max(qs + q_block - span, 0), Sp - span)
        qb = q[:, qs:qs + q_block]
        kb, vb = k[:, ks:ks + span], v[:, ks:ks + span]
        s = _gqa_scores(qb, kb) * scale
        q_pos = qs + torch.arange(q_block, device=q.device)
        kv_pos = ks + torch.arange(span, device=q.device)
        mask = (kv_pos[None, :] <= q_pos[:, None]) \
            & (kv_pos[None, :] > q_pos[:, None] - window) \
            & (kv_pos[None, :] < S) & (q_pos[:, None] < S)
        s = torch.where(mask, s, NEG_INF)
        w = softmax_fp32(s).to(qb.dtype)
        blocks.append(_gqa_av(w, vb))
    out = torch.cat(blocks, dim=1)[:, :S]
    return ctx.cs(out, "batch", None, "model", None)


def attention_apply(params, x: torch.Tensor, *, n_heads: int, n_kv: int,
                    head_dim: int, rope_theta: float = 10000.0,
                    causal: bool = True, window: int = 0,
                    variant: str = "auto", ctx: ShardCtx = NO_SHARD,
                    positions: Optional[torch.Tensor] = None,
                    kv_override: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    use_rope: bool = True) -> torch.Tensor:
    """Full-sequence attention (training / prefill). ``kv_override``
    supplies external K/V for cross-attention; the caller turns rope and
    the causal mask off there."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, ctx)
    if use_rope:
        pos = (positions if positions is not None
               else torch.arange(S, device=x.device))
        cos, sin = rope_angles(pos, head_dim, rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if kv_override is not None:
        k, v = kv_override

    if variant == "auto":
        if window:
            variant = "windowed"
        elif S > 8192:
            variant = "chunked"
        else:
            variant = "dense"
    if variant == "windowed":
        out = _windowed_attention(q, k, v, window, ctx)
    elif variant == "chunked":
        out = _chunked_attention(q, k, v, causal, ctx)
    elif variant == "flash":
        if not causal:
            raise ValueError("the flash variant is causal self-attention")
        out = ctx.cs(flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous()),
                     "batch", None, "model", None)
    elif variant == "dense":
        out = _dense_attention(q, k, v, causal, ctx)
    else:
        raise ValueError(f"unknown attention variant {variant!r}")
    dt = x.dtype
    y = out.reshape(B, S, n_heads * head_dim) @ params["wo"].to(dt)
    return ctx.cs(y, "batch", None, None)


# ---------------------------------------------------------------------------
# Decode (single token, KV cache)
# ---------------------------------------------------------------------------

def attention_decode(params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor, *,
                     n_heads: int, n_kv: int, head_dim: int,
                     rope_theta: float = 10000.0, window: int = 0,
                     ctx: ShardCtx = NO_SHARD):
    """One decode step. x: (B, 1, d); cache_[kv]: (B, Sc, Hkv, hd), the full
    context or the ring-buffer window. Returns (y, new_cache_k,
    new_cache_v); the caches passed in are left as they are.

    The new KV goes to slot ``pos % Sc`` (the identity when Sc is the full
    context, a ring buffer when Sc is the window). Slots are valid once
    written: slot < pos + 1 before the buffer wraps, every slot after. RoPE
    is applied at absolute positions, so slot order does not matter."""
    B = x.shape[0]
    Sc = cache_k.shape[1]
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, ctx)
    cos, sin = rope_angles(pos[:, None], head_dim, rope_theta)  # (B,1,half)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    slot = (pos % Sc).long()
    bidx = torch.arange(B, device=x.device)
    cache_k = cache_k.clone()
    cache_v = cache_v.clone()
    cache_k[bidx, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot] = v[:, 0].to(cache_v.dtype)
    cache_k = ctx.cs(cache_k, "batch", "seq", None, None)
    cache_v = ctx.cs(cache_v, "batch", "seq", None, None)
    scale = head_dim ** -0.5
    s = _gqa_scores(q, cache_k) * scale           # (B,K,G,1,S)
    kv_pos = torch.arange(Sc, device=x.device)
    valid = kv_pos[None, :] < torch.clamp(pos[:, None] + 1, max=Sc)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    w = softmax_fp32(s).to(q.dtype)
    out = _gqa_av(w, cache_v)
    y = out.reshape(B, 1, n_heads * head_dim) @ params["wo"].to(x.dtype)
    return ctx.cs(y, "batch", None, None), cache_k, cache_v
