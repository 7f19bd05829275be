"""LM assembly (the port of the reference's ``models/model.py``), for the
dense family.

One :class:`LM` wraps an ArchConfig into init / apply / loss. Parameters are
a nested dict of tensors laid out as the reference's, except that
``blocks`` is a list with one dict per layer (the reference stacks them on
a leading group axis for ``lax.scan``; here a Python loop walks the
layers), so the reference's weights carry over key for key
(:mod:`.convert`). Activation rematerialization is a training concern and
does not apply to this forward pass.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from . import attention as A
from .layers import (NO_SHARD, ShardCtx, embed_init, mlp_apply, mlp_init,
                     rmsnorm)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


class LM:
    """Language model for one architecture config (the dense family)."""

    def __init__(self, cfg: ArchConfig, ctx: ShardCtx = NO_SHARD):
        self.cfg = cfg
        self.ctx = ctx
        self.dtype = DTYPES[cfg.dtype]
        self.param_dtype = DTYPES[cfg.param_dtype]
        self.vp = cfg.vocab_padded()
        self._plan_groups()

    def _plan_groups(self):
        """The reference's layer grouping. The port runs the dense group
        kind, one layer per group, with no encoder; the other kinds wait for
        their model code."""
        cfg = self.cfg
        if cfg.family == "hybrid" and cfg.hybrid_attn_every:
            kind = "hybrid"
        elif cfg.xlstm_pattern:
            kind = "xlstm"
        elif cfg.moe_experts and cfg.moe_every > 1:
            kind = "moe_interleaved"
        elif cfg.moe_experts:
            kind = "moe"
        elif cfg.family == "ssm":
            kind = "ssm"
        elif cfg.is_encdec:
            kind = "encdec"
        else:
            kind = "dense"
        if kind != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the {kind!r} layer groups are not ported yet "
                "(the MoE, SSM, hybrid, xLSTM and enc-dec model code: "
                "ROADMAP Queue 1 item 7)")
        self.group_kind = kind
        self.n_groups = cfg.n_layers

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------
    def _init_layer(self, gen: torch.Generator) -> Dict[str, Any]:
        cfg = self.cfg
        ones = lambda: torch.ones((cfg.d_model,), dtype=self.param_dtype,
                                  device=gen.device)
        return {
            "attn": A.attn_init(gen, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.resolved_head_dim,
                                qk_norm=cfg.qk_norm, dtype=self.param_dtype),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, self.param_dtype),
            "ln1": ones(),
            "ln2": ones(),
        }

    def init_params(self, generator: torch.Generator,
                    device=None) -> Dict[str, Any]:
        """Random parameters drawn from ``generator``, which must live on
        ``device`` (None: the card)."""
        device = resolve_device(device)
        if generator.device.type != device.type:
            raise ValueError(f"the generator lives on {generator.device}, "
                             f"the parameters are meant for {device}")
        cfg = self.cfg
        with torch.device(device):
            return {
                "embed": embed_init(generator, self.vp, cfg.d_model,
                                    self.param_dtype),
                "blocks": [self._init_layer(generator)
                           for _ in range(self.n_groups)],
                "final_norm": torch.ones((cfg.d_model,),
                                         dtype=self.param_dtype),
                "unembed": embed_init(generator, cfg.d_model, self.vp,
                                      self.param_dtype),
            }

    # ------------------------------------------------------------------
    # Forward (train / prefill)
    # ------------------------------------------------------------------
    def apply(self, params, tokens: torch.Tensor, *, window: int = 0,
              variant: str = "auto", last_only: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) integer → (logits (B, S', vp), aux_loss), with
        S' = 1 under ``last_only`` (prefill: only the next-token logits)."""
        cfg = self.cfg
        ctx = self.ctx
        akw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                   head_dim=cfg.resolved_head_dim,
                   rope_theta=cfg.rope_theta, window=window,
                   variant=variant, ctx=ctx)
        x = params["embed"][tokens.long()].to(self.dtype)
        x = ctx.cs(x, "batch", None, None)
        for gp in params["blocks"]:
            h = rmsnorm(x, gp["ln1"])
            x = x + A.attention_apply(gp["attn"], h, **akw)
            h = rmsnorm(x, gp["ln2"])
            x = x + mlp_apply(gp["mlp"], h, ctx)
        if last_only:
            x = x[:, -1:]
        x = rmsnorm(x, params["final_norm"])
        logits = x @ params["unembed"].to(self.dtype)
        logits = ctx.cs(logits, "batch", None, "model")
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    # ------------------------------------------------------------------
    # Loss (the forward value)
    # ------------------------------------------------------------------
    def loss(self, params, tokens: torch.Tensor, *, window: int = 0,
             variant: str = "auto") -> torch.Tensor:
        cfg = self.cfg
        logits, aux = self.apply(params, tokens, window=window,
                                 variant=variant)
        S = tokens.shape[1]
        lg = logits[:, -S:][:, :-1].float()
        tgt = tokens[:, 1:].long()
        vmask = torch.arange(self.vp, device=lg.device) < cfg.vocab_size
        lg = torch.where(vmask, lg, -1e30)        # mask padded vocab
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, tgt[..., None])[..., 0]
        return (lse - gold).mean() + 0.01 * aux

