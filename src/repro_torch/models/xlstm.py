"""xLSTM blocks (Beck et al., arXiv:2405.04517), xlstm-125m (the port of
the reference's ``models/xlstm.py``).

- **mLSTM**: matrix-memory LSTM, gated linear attention with an exponential
  input gate and a sigmoid forget gate, in the chunkwise-parallel form of
  :mod:`.gla`. The normalizer state n_t rides in the same recurrence: the
  values carry a constant-1 channel, whose output channel is q·n_t, so one
  gla pass gives numerator and denominator.
- **sLSTM**: scalar-memory LSTM with exponential gating and per-head
  recurrent mixing. The four input projections (z and the three gates)
  depend on x alone and are taken once over the whole sequence; the
  recurrence is one op over time, :func:`..kernels.slstm.slstm_scan`
  (the reference's ``lax.scan``): on the card the Hopper kernel
  ``slstm_fwd`` (and ``slstm_bwd`` under autograd), one launch a layer;
  on the CPU the plain loop of the reference's step; on ``meta`` a fake
  and a FLOP formula, one dispatched op whatever S is. Decode is the same
  op at S = 1 from the cache's state. The (c, h) state stays float32.

Both follow the paper's (m, s) pattern; mLSTM blocks carry the
up-projection (pre-LN residual), sLSTM blocks their output projection.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.slstm import slstm_scan
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


def _slstm_inputs(params, x):
    """The step's four inputs over the whole sequence: zx = x·wz in x's
    dtype and the gate pre-activations x·wi, x·wf, x·wo_gate in f32."""
    x32 = x.float()
    return (x @ params["wz"].to(x.dtype), x32 @ params["wi"],
            x32 @ params["wf"], x32 @ params["wo_gate"])


def _slstm_out(params, y, dtype):
    return rmsnorm(y, params["norm"]) @ params["proj"].to(dtype)


def slstm_apply(params: Dict, x: torch.Tensor, *, n_heads: int,
                ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    B, S, d = x.shape
    zero = torch.zeros((B, d), dtype=torch.float32, device=x.device)
    y, _, _ = slstm_scan(*_slstm_inputs(params, x), params["r"], zero, zero)
    return ctx.cs(_slstm_out(params, y, x.dtype), "batch", None, None)


def slstm_decode(params: Dict, x: torch.Tensor, state: torch.Tensor, *,
                 n_heads: int, ctx: ShardCtx = NO_SHARD):
    """x: (B,1,d); state: (B,2,d) = (c,h). Returns (out, new_state): the
    scan at S = 1 from the state."""
    c, h = state[:, 0].float(), state[:, 1].float()
    y, c_new, h_new = slstm_scan(*_slstm_inputs(params, x), params["r"],
                                 c, h)
    out = _slstm_out(params, y, x.dtype)
    new_state = torch.stack([c_new, h_new], dim=1).to(state.dtype)
    return ctx.cs(out, "batch", None, None), new_state
