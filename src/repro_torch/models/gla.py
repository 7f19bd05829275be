"""Chunkwise gated linear attention (the port of the reference's
``models/gla.py``): the shared core of Mamba2 SSD and mLSTM.

Both blocks are instances of the recurrence

    h_t = exp(g_t) · h_{t-1} + s_t · K_t ⊗ x_t          (state (H, N, P))
    y_t = Q_t · h_t

with per-block choices of gate ``g``, scale ``s``, keys ``K`` and queries
``Q`` (SSD: g = Δ·A, s = Δ, K/Q = B/C shared across heads; mLSTM: g = log f,
s = i, K/Q = k/q per head). The chunkwise-parallel form splits S into chunks
of ``chunk`` steps: the intra-chunk terms are dense matmuls, and the
inter-chunk state is a loop over the S/chunk chunk states (the reference's
``lax.scan``).

The casts are the reference's: the cumulative gate in float32, the decay
matrices cast to the values' dtype before they meet the values, and in the
decode step ``exp`` of the gate in float32, then cast. In bfloat16 any other
placement drifts from the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _heads(t: torch.Tensor, B: int, S: int, H: int) -> torch.Tensor:
    """(B, S, N) keys or queries shared across heads → (B, S, H, N)."""
    if t.dim() == 3:
        return t[:, :, None, :].expand(B, S, H, t.shape[-1])
    return t


def gla_chunked(xv: torch.Tensor, log_decay: torch.Tensor,
                scale: torch.Tensor, K: torch.Tensor, Q: torch.Tensor,
                chunk: int = 128, init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, final_state).

    xv:        (B, S, H, P) values
    log_decay: (B, S, H)    per-step log gate (≤ 0 for stability)
    scale:     (B, S, H)    per-step input scale
    K, Q:      (B, S, H, N) or (B, S, N) (shared across heads)
    """
    B, S, H, P = xv.shape
    K, Q = _heads(K, B, S, H), _heads(Q, B, S, H)
    N = K.shape[-1]
    if S % chunk:
        raise ValueError(f"pad the sequence ({S}) to a multiple of the "
                         f"chunk ({chunk}) first")
    nc = S // chunk
    dt = xv.dtype

    def r4(t):
        return t.reshape(B, nc, chunk, *t.shape[2:])

    xv_c, g_c, s_c, K_c, Q_c = map(r4, (xv, log_decay, scale, K, Q))

    cum = torch.cumsum(g_c.float(), dim=2)                  # (B,nc,Q,H)
    # intra-chunk: M[h,q,k] = (Q[q]·K[k]) exp(cum[q]-cum[k]) s[k]  (k ≤ q)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,Q,Q,H)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=xv.device).tril()
    # masked before exp: above the diagonal seg is a sum of -g >= 0 that
    # can overflow, and exp's gradient there would be 0 * inf = NaN (the
    # reference masks after exp, and its jax.grad is NaN there); the
    # forward's values are the same
    decay = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                  float("-inf")))
    decay = decay.permute(0, 1, 4, 2, 3).to(dt)             # (B,nc,H,Q,Q)
    qk = torch.einsum("bcqhn,bckhn->bchqk", Q_c, K_c)
    M = qk * decay * s_c.to(dt).permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", M, xv_c)

    # chunk-final states
    dec_to_end = torch.exp(cum[:, :, -1:, :] - cum)         # (B,nc,Q,H)
    kx = (dec_to_end * s_c.float()).to(dt)
    h_chunk = torch.einsum("bckh,bckhn,bckhp->bchnp", kx, K_c, xv_c)
    chunk_decay = torch.exp(cum[:, :, -1, :]).to(dt)        # (B,nc,H)

    h = (init_state if init_state is not None
         else torch.zeros((B, H, N, P), dtype=dt, device=xv.device))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + h_chunk[:, c]
    h_prev = torch.stack(h_prev, dim=1)                     # (B,nc,H,N,P)

    dec_from_start = torch.exp(cum).to(dt)                  # (B,nc,Q,H)
    pt = torch.promote_types(dt, h_prev.dtype)    # a wider init_state
    y_inter = torch.einsum("bcqhn,bcqh,bchnp->bcqhp", Q_c.to(pt),
                           dec_from_start.to(pt), h_prev)
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y, h


def gla_decode_step(h: torch.Tensor, xv: torch.Tensor,
                    log_decay: torch.Tensor, scale: torch.Tensor,
                    K: torch.Tensor, Q: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence. h: (B,H,N,P); xv: (B,H,P);
    log_decay/scale: (B,H); K/Q: (B,H,N) or (B,N). Returns (y, h_new)."""
    B, H = log_decay.shape
    if K.dim() == 2:
        K = K[:, None, :].expand(B, H, K.shape[-1])
    if Q.dim() == 2:
        Q = Q[:, None, :].expand(K.shape)
    dt = xv.dtype
    decay = torch.exp(log_decay.float()).to(dt)
    upd = torch.einsum("bhn,bhp->bhnp", K, scale.to(dt)[..., None] * xv)
    h_new = h * decay[:, :, None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", Q.to(h_new.dtype), h_new)
    return y, h_new
