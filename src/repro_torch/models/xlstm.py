"""xLSTM blocks (Beck et al., arXiv:2405.04517), xlstm-125m (the port of
the reference's ``models/xlstm.py``).

- **mLSTM**: matrix-memory LSTM, gated linear attention with an exponential
  input gate and a sigmoid forget gate, in the chunkwise-parallel form of
  :mod:`.gla`. The normalizer state n_t rides in the same recurrence: the
  values carry a constant-1 channel, whose output channel is q·n_t, so one
  gla pass gives numerator and denominator.
- **sLSTM**: scalar-memory LSTM with exponential gating and per-head
  recurrent mixing, a loop over time (the reference's ``lax.scan``) of
  :func:`_slstm_step`; decode is one step. Its (c, h) state stays float32.

Both follow the paper's (m, s) pattern; mLSTM blocks carry the
up-projection (pre-LN residual), sLSTM blocks their output projection.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .gla import gla_chunked, gla_decode_step
from .layers import NO_SHARD, ShardCtx, dense_init, rmsnorm


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, d: int, n_heads: int,
               dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return {
        "wq": dense_init(gen, d, d, dtype),
        "wk": dense_init(gen, d, d, dtype),
        "wv": dense_init(gen, d, d, dtype),
        "wi": dense_init(gen, d, n_heads, torch.float32),
        "wf": dense_init(gen, d, n_heads, torch.float32),
        "wo": dense_init(gen, d, d, dtype),
        "norm": torch.ones((d,), dtype=dtype, device=gen.device),
    }


def _mlstm_gates(params, x):
    """log f = logsigmoid(f_pre) and the input gate exp(min(i_pre, 6))."""
    f_pre = x.float() @ params["wf"]
    i_pre = x.float() @ params["wi"]
    log_f = F.logsigmoid(f_pre)                    # (B,S,H) ≤ 0
    i_gate = torch.exp(torch.clamp(i_pre, max=6.0))
    return log_f, i_gate


def mlstm_state_shape(batch: int, d: int, n_heads: int) -> Tuple[int, ...]:
    hd = d // n_heads
    return (batch, n_heads, hd, hd + 1)


def _mlstm_qkv(params, x, n_heads):
    B, S, d = x.shape
    dt_ = x.dtype
    hd = d // n_heads
    q = (x @ params["wq"].to(dt_)).reshape(B, S, n_heads, hd)
    k = (x @ params["wk"].to(dt_)).reshape(B, S, n_heads, hd) * hd ** -0.5
    v = (x @ params["wv"].to(dt_)).reshape(B, S, n_heads, hd)
    # a ones channel on the values: the last output channel is q·n_t
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    return q, k, v_aug


def _mlstm_out(params, y_aug, B, S, d):
    denom = torch.clamp(torch.abs(y_aug[..., -1:]), min=1.0)
    y = (y_aug[..., :-1] / denom).reshape(B, S, d)
    y = rmsnorm(y, params["norm"])
    return y @ params["wo"].to(y.dtype)


def mlstm_apply(params: Dict, x: torch.Tensor, *, n_heads: int,
                chunk: int = 128, ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    B, S, d = x.shape
    q, k, v_aug = _mlstm_qkv(params, x, n_heads)
    log_f, i_gate = _mlstm_gates(params, x)
    pad = (-S) % chunk
    if pad:
        def f(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        q, k, v_aug, log_f, i_gate = map(f, (q, k, v_aug, log_f, i_gate))
    y_aug, _ = gla_chunked(v_aug, log_f, i_gate, k, q, chunk=chunk)
    out = _mlstm_out(params, y_aug[:, :S], B, S, d)
    return ctx.cs(out, "batch", None, None)


def mlstm_decode(params: Dict, x: torch.Tensor, h: torch.Tensor, *,
                 n_heads: int, ctx: ShardCtx = NO_SHARD):
    """x: (B,1,d); h: (B,H,hd,hd+1) (matrix memory + normalizer column).
    Returns (out, h_new)."""
    B, _, d = x.shape
    q, k, v_aug = _mlstm_qkv(params, x, n_heads)
    log_f, i_gate = _mlstm_gates(params, x)
    y_aug, h_new = gla_decode_step(h, v_aug[:, 0], log_f[:, 0],
                                   i_gate[:, 0], k[:, 0], q[:, 0])
    out = _mlstm_out(params, y_aug[:, None], B, 1, d)
    return ctx.cs(out, "batch", None, None), h_new


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, d: int, n_heads: int,
               dtype=torch.float32) -> Dict[str, torch.Tensor]:
    hd = d // n_heads
    r = torch.randn((n_heads, hd, hd), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return {
        "wz": dense_init(gen, d, d, dtype),
        "wi": dense_init(gen, d, d, torch.float32),
        "wf": dense_init(gen, d, d, torch.float32),
        "wo_gate": dense_init(gen, d, d, torch.float32),
        # block-diagonal recurrent mixing per head
        "r": r.mul_(hd ** -0.5),
        "proj": dense_init(gen, d, d, dtype),
        "norm": torch.ones((d,), dtype=dtype, device=gen.device),
    }


def slstm_state_shape(batch: int, d: int) -> Tuple[int, ...]:
    return (batch, 2, d)  # (c, h)


def _slstm_step(params, n_heads, carry, xt):
    """carry: (c, h) each (B, d) float32; xt: (B, d) pre-activations."""
    c, h = carry
    B, d = c.shape
    hd = d // n_heads
    hh = h.reshape(B, n_heads, hd)
    rec = torch.einsum("bhx,hxy->bhy", hh, params["r"]).reshape(B, d)
    z = torch.tanh(xt @ params["wz"].to(xt.dtype) + rec.to(xt.dtype))
    x32 = xt.float()
    i = torch.exp(torch.clamp(x32 @ params["wi"], max=6.0))
    f = torch.sigmoid(x32 @ params["wf"])
    o = torch.sigmoid(x32 @ params["wo_gate"])
    c_new = f * c + i * z.float()
    n = torch.clamp(torch.abs(c_new), min=1.0)
    h_new = o * (c_new / n)
    return (c_new, h_new.float()), h_new.to(xt.dtype)


def slstm_apply(params: Dict, x: torch.Tensor, *, n_heads: int,
                ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    B, S, d = x.shape
    carry = (torch.zeros((B, d), dtype=torch.float32, device=x.device),
             torch.zeros((B, d), dtype=torch.float32, device=x.device))
    ys = []
    for t in range(S):
        carry, yt = _slstm_step(params, n_heads, carry, x[:, t])
        ys.append(yt)
    y = rmsnorm(torch.stack(ys, dim=1), params["norm"])
    out = y @ params["proj"].to(x.dtype)
    return ctx.cs(out, "batch", None, None)


def slstm_decode(params: Dict, x: torch.Tensor, state: torch.Tensor, *,
                 n_heads: int, ctx: ShardCtx = NO_SHARD):
    """x: (B,1,d); state: (B,2,d) = (c,h). Returns (out, new_state)."""
    c, h = state[:, 0].float(), state[:, 1].float()
    (c_new, h_new), y = _slstm_step(params, n_heads, (c, h), x[:, 0])
    y = rmsnorm(y[:, None, :], params["norm"])
    out = y @ params["proj"].to(x.dtype)
    new_state = torch.stack([c_new, h_new], dim=1).to(state.dtype)
    return ctx.cs(out, "batch", None, None), new_state
