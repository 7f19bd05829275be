"""LM assembly for the ten architectures (the port of the reference's
``models/model.py``).

One :class:`LM` wraps an ArchConfig into init / apply / loss / decode.
Layers are grouped as the reference groups them (llama4's dense + MoE
interleave, xLSTM's (m, s) pattern, zamba2's SSM layers + shared attention
block); the reference stacks each group's weights on a leading axis for
``lax.scan``, and here ``blocks`` is a list with one entry per group that a
Python loop walks:

- ``dense`` / ``moe``: a dict (``attn``, ``mlp`` or ``moe``, ``ln1``,
  ``ln2``) per layer; an enc-dec model's decoder is such a stack with
  ``cross`` (one ``attn`` + ``ln`` per layer) beside it, plus ``encoder``
  (a list of dense layers) and ``enc_norm``;
- ``moe_interleaved``: ``{"dense": [group_size - 1 dense layers], "moe":
  one MoE layer}``;
- ``ssm``: ``{"ssm", "ln"}``;
- ``hybrid``: a list of ``group_size`` ``{"ssm", "ln"}`` layers, with
  ``shared_attn`` (one block whose weights every group reuses) and
  ``tail`` (the layers past the last whole group) beside ``blocks``;
- ``xlstm``: ``{"m0", "ln0", "s1", "ln1", ...}`` after the pattern.

So the reference's weights carry over key for key (:mod:`.convert`).
Under ``cfg.remat`` each group's body runs under
``torch.utils.checkpoint`` (non-reentrant) while autograd records, its
activations recomputed in the backward, as the reference wraps its scan
body in ``jax.checkpoint``; the encoder and the hybrid tail are not
wrapped, as in the reference.

The decode cache has the reference's keys, shapes and dtypes (stacked on
the group axis); :meth:`LM.decode_step` writes it in place.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from . import attention as A
from . import moe as MOE
from . import ssm as SSM
from . import xlstm as XL
from .layers import (NO_SHARD, ShardCtx, embed_init, mlp_apply, mlp_init,
                     rmsnorm, softmax_fp32)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def _noncausal(variant: str) -> str:
    """The variant of the encoder's and the cross-attention's non-causal
    attention: the flash kernel is causal self-attention only, so under
    ``flash`` they take ``auto`` (the reference raises there)."""
    return "auto" if variant == "flash" else variant


class LM:
    """Language model for one architecture config."""

    def __init__(self, cfg: ArchConfig, ctx: ShardCtx = NO_SHARD):
        self.cfg = cfg
        self.ctx = ctx
        self.dtype = DTYPES[cfg.dtype]
        self.param_dtype = DTYPES[cfg.param_dtype]
        self.vp = cfg.vocab_padded()
        self._plan_groups()

    # ------------------------------------------------------------------
    # Layer grouping
    # ------------------------------------------------------------------
    def _plan_groups(self):
        cfg = self.cfg
        self.group_size, self.n_groups = 1, cfg.n_layers
        self.tail_layers = 0
        if cfg.family == "hybrid" and cfg.hybrid_attn_every:
            self.group_size = cfg.hybrid_attn_every
            self.n_groups = cfg.n_layers // self.group_size
            self.tail_layers = cfg.n_layers - self.n_groups * self.group_size
            self.group_kind = "hybrid"
        elif cfg.xlstm_pattern or (cfg.moe_experts and cfg.moe_every > 1):
            self.group_size = (len(cfg.xlstm_pattern) if cfg.xlstm_pattern
                               else cfg.moe_every)
            if cfg.n_layers % self.group_size:
                raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not "
                                 f"whole groups of {self.group_size}")
            self.n_groups = cfg.n_layers // self.group_size
            self.group_kind = ("xlstm" if cfg.xlstm_pattern
                               else "moe_interleaved")
        elif cfg.moe_experts:
            self.group_kind = "moe"
        elif cfg.family == "ssm":
            self.group_kind = "ssm"
        else:
            self.group_kind = "dense"

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------
    def _ones(self, gen: torch.Generator) -> torch.Tensor:
        return torch.ones((self.cfg.d_model,), dtype=self.param_dtype,
                          device=gen.device)

    def _init_attn(self, gen):
        cfg = self.cfg
        return A.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.resolved_head_dim, qk_norm=cfg.qk_norm,
                           dtype=self.param_dtype)

    def _init_dense_layer(self, gen):
        cfg = self.cfg
        return {"attn": self._init_attn(gen),
                "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, self.param_dtype),
                "ln1": self._ones(gen), "ln2": self._ones(gen)}

    def _init_moe_layer(self, gen):
        cfg = self.cfg
        return {"attn": self._init_attn(gen),
                "moe": MOE.moe_init(gen, cfg.d_model, cfg.d_ff,
                                    cfg.moe_experts, self.param_dtype),
                "ln1": self._ones(gen), "ln2": self._ones(gen)}

    def _init_ssm_layer(self, gen):
        cfg = self.cfg
        return {"ssm": SSM.ssm_init(gen, cfg.d_model, state=cfg.ssm_state,
                                    expand=cfg.ssm_expand,
                                    head_dim=cfg.ssm_head_dim,
                                    dtype=self.param_dtype),
                "ln": self._ones(gen)}

    def _init_group(self, gen):
        cfg = self.cfg
        kind = self.group_kind
        if kind == "dense":
            return self._init_dense_layer(gen)
        if kind == "moe":
            return self._init_moe_layer(gen)
        if kind == "moe_interleaved":
            return {"dense": [self._init_dense_layer(gen)
                              for _ in range(self.group_size - 1)],
                    "moe": self._init_moe_layer(gen)}
        if kind == "ssm":
            return self._init_ssm_layer(gen)
        if kind == "hybrid":
            return [self._init_ssm_layer(gen)
                    for _ in range(self.group_size)]
        out = {}
        for i, p in enumerate(cfg.xlstm_pattern):
            if p == "m":
                out[f"m{i}"] = XL.mlstm_init(gen, cfg.d_model, cfg.n_heads,
                                             self.param_dtype)
            else:
                out[f"s{i}"] = XL.slstm_init(gen, cfg.d_model, cfg.n_heads,
                                             self.param_dtype)
            out[f"ln{i}"] = self._ones(gen)
        return out

    def init_params(self, generator: torch.Generator,
                    device=None) -> Dict[str, Any]:
        """Random parameters drawn from ``generator``, which must live on
        ``device`` (None: the card)."""
        device = resolve_device(device)
        if generator.device.type != device.type:
            raise ValueError(f"the generator lives on {generator.device}, "
                             f"the parameters are meant for {device}")
        cfg = self.cfg
        gen = generator
        with torch.device(device):
            params: Dict[str, Any] = {
                "embed": embed_init(gen, self.vp, cfg.d_model,
                                    self.param_dtype),
                "blocks": [self._init_group(gen)
                           for _ in range(self.n_groups)],
                "final_norm": self._ones(gen),
                "unembed": embed_init(gen, cfg.d_model, self.vp,
                                      self.param_dtype),
            }
            if self.group_kind == "hybrid":
                shared = {"attn": self._init_attn(gen), "ln": self._ones(gen)}
                if cfg.d_ff:
                    shared["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff,
                                             self.param_dtype)
                    shared["ln2"] = self._ones(gen)
                params["shared_attn"] = shared
                if self.tail_layers:
                    params["tail"] = [self._init_ssm_layer(gen)
                                      for _ in range(self.tail_layers)]
            if cfg.is_encdec:
                params["encoder"] = [self._init_dense_layer(gen)
                                     for _ in range(cfg.encoder_layers)]
                params["enc_norm"] = self._ones(gen)
                params["cross"] = [{"attn": self._init_attn(gen),
                                    "ln": self._ones(gen)}
                                   for _ in range(self.n_groups)]
        return params

    # ------------------------------------------------------------------
    # Forward (train / prefill)
    # ------------------------------------------------------------------
    def _attn_kwargs(self, window: int, **extra):
        cfg = self.cfg
        return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim,
                    rope_theta=cfg.rope_theta, window=window,
                    ctx=self.ctx, **extra)

    def _ssm_kwargs(self):
        cfg = self.cfg
        return dict(state=cfg.ssm_state, expand=cfg.ssm_expand,
                    head_dim=cfg.ssm_head_dim, ctx=self.ctx)

    def _moe(self, p, h):
        cfg = self.cfg
        return MOE.moe_apply(p, h, n_experts=cfg.moe_experts,
                             top_k=cfg.moe_topk,
                             capacity_factor=cfg.moe_capacity_factor,
                             ctx=self.ctx)

    def _dense_layer(self, lp, x, akw):
        h = rmsnorm(x, lp["ln1"])
        x = x + A.attention_apply(lp["attn"], h, **akw)
        h = rmsnorm(x, lp["ln2"])
        return x + mlp_apply(lp["mlp"], h, self.ctx)

    def _ssm_layer(self, lp, x):
        h = rmsnorm(x, lp["ln"])
        return x + SSM.ssm_apply(lp["ssm"], h, **self._ssm_kwargs())

    def _shared_block(self, shared, x, akw):
        """zamba2: ONE shared-weight transformer block (attn + MLP) after
        every group of SSM layers."""
        h = rmsnorm(x, shared["ln"])
        x = x + A.attention_apply(shared["attn"], h, **akw)
        if "mlp" in shared:
            h = rmsnorm(x, shared["ln2"])
            x = x + mlp_apply(shared["mlp"], h, self.ctx)
        return x

    def _apply_group(self, gp, x, *, window: int, variant: str,
                     enc_out=None, cross=None, shared=None):
        cfg = self.cfg
        kind = self.group_kind
        akw = self._attn_kwargs(window, variant=variant)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if kind in ("dense", "moe"):
            h = rmsnorm(x, gp["ln1"])
            x = x + A.attention_apply(gp["attn"], h, **akw)
            if enc_out is not None and cross is not None:
                hc = rmsnorm(x, cross["ln"])
                x = x + A.attention_apply(
                    cross["attn"], hc, causal=False, use_rope=False,
                    kv_override=self._encode_kv(cross["attn"], enc_out),
                    **dict(akw, variant=_noncausal(variant)))
            h = rmsnorm(x, gp["ln2"])
            if kind == "moe":
                y, aux = self._moe(gp["moe"], h)
                x = x + y
            else:
                x = x + mlp_apply(gp["mlp"], h, self.ctx)
            return x, aux
        if kind == "moe_interleaved":
            for lp in gp["dense"]:
                x = self._dense_layer(lp, x, akw)
            mp = gp["moe"]
            h = rmsnorm(x, mp["ln1"])
            x = x + A.attention_apply(mp["attn"], h, **akw)
            h = rmsnorm(x, mp["ln2"])
            y, aux = self._moe(mp["moe"], h)
            return x + y, aux
        if kind == "ssm":
            return self._ssm_layer(gp, x), aux
        if kind == "hybrid":
            for lp in gp:
                x = self._ssm_layer(lp, x)
            if shared is not None:
                x = self._shared_block(shared, x, akw)
            return x, aux
        for i, p in enumerate(cfg.xlstm_pattern):
            h = rmsnorm(x, gp[f"ln{i}"])
            if p == "m":
                x = x + XL.mlstm_apply(gp[f"m{i}"], h, n_heads=cfg.n_heads,
                                       ctx=self.ctx)
            else:
                x = x + XL.slstm_apply(gp[f"s{i}"], h, n_heads=cfg.n_heads,
                                       ctx=self.ctx)
        return x, aux

    def _encode_kv(self, attn_params, enc_out):
        """The cross-attention K/V of one decoder layer over the encoder's
        output: (B, T, Hkv, hd) each."""
        cfg = self.cfg
        B, T, _ = enc_out.shape
        hd = cfg.resolved_head_dim
        dt = enc_out.dtype
        k = (enc_out @ attn_params["wk"].to(dt)).reshape(
            B, T, cfg.n_kv_heads, hd)
        v = (enc_out @ attn_params["wv"].to(dt)).reshape(
            B, T, cfg.n_kv_heads, hd)
        return k, v

    def _run_encoder(self, params, frontend_embeds, window, variant):
        akw = self._attn_kwargs(window, variant=_noncausal(variant))
        x = frontend_embeds.to(self.dtype)
        for lp in params["encoder"]:
            h = rmsnorm(x, lp["ln1"])
            x = x + A.attention_apply(lp["attn"], h, causal=False, **akw)
            h = rmsnorm(x, lp["ln2"])
            x = x + mlp_apply(lp["mlp"], h, self.ctx)
        return rmsnorm(x, params["enc_norm"])

    def apply(self, params, tokens: torch.Tensor,
              frontend_embeds: Optional[torch.Tensor] = None, *,
              window: int = 0, variant: str = "auto",
              last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) integer → (logits (B, S', vp), aux_loss), with
        S' = 1 under ``last_only`` (prefill: only the next-token logits).

        For decoder-only VLM / audio archs the frontend embeddings are
        prepended to the token embeddings (S' = T_f + S); for enc-dec they
        feed the encoder."""
        cfg = self.cfg
        ctx = self.ctx
        x = params["embed"][tokens.long()].to(self.dtype)
        x = ctx.cs(x, "batch", None, None)
        enc_out = None
        if cfg.is_encdec:
            if frontend_embeds is None:
                raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                                 "the encoder's frontend_embeds")
            enc_out = self._run_encoder(params, frontend_embeds, 0, variant)
        elif frontend_embeds is not None:
            x = torch.cat([frontend_embeds.to(self.dtype), x], dim=1)
            x = ctx.cs(x, "batch", None, None)

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        shared = params.get("shared_attn")
        remat = cfg.remat and torch.is_grad_enabled()
        for g, gp in enumerate(params["blocks"]):
            body = functools.partial(
                self._apply_group, gp, window=window, variant=variant,
                enc_out=enc_out,
                cross=params["cross"][g] if cfg.is_encdec else None,
                shared=shared)
            if remat:
                x, a = checkpoint(body, x, use_reentrant=False)
            else:
                x, a = body(x)
            aux = aux + a
        for lp in params.get("tail", ()):
            x = self._ssm_layer(lp, x)
        if last_only:
            x = x[:, -1:]
        x = rmsnorm(x, params["final_norm"])
        logits = x @ params["unembed"].to(self.dtype)
        logits = ctx.cs(logits, "batch", None, "model")
        return logits, aux

    # ------------------------------------------------------------------
    # Loss (the forward value)
    # ------------------------------------------------------------------
    def loss(self, params, tokens: torch.Tensor,
             frontend_embeds: Optional[torch.Tensor] = None, *,
             window: int = 0, variant: str = "auto") -> torch.Tensor:
        cfg = self.cfg
        logits, aux = self.apply(params, tokens, frontend_embeds,
                                 window=window, variant=variant)
        S = tokens.shape[1]
        lg = logits[:, -S:][:, :-1].float()       # drop frontend positions
        tgt = tokens[:, 1:].long()
        vmask = torch.arange(self.vp, device=lg.device) < cfg.vocab_size
        lg = torch.where(vmask, lg, -1e30)        # mask padded vocab
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, tgt[..., None])[..., 0]
        return (lse - gold).mean() + 0.01 * aux

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, context: int, *, window: int = 0,
                   src_len: int = 0, device=None) -> Dict[str, torch.Tensor]:
        """The decode cache on ``device`` (None: the card), stacked on the
        group axis as the reference's. ``context`` is the KV length of the
        attention caches (the window when windowed); the SSM and xLSTM
        states are O(1). The sLSTM states are float32."""
        device = resolve_device(device)
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        Sc = min(window, context) if window else context
        G = self.n_groups

        def zeros(shape, dtype=self.dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        kv = (batch, Sc, cfg.n_kv_heads, hd)
        ssm = SSM.ssm_state_shape(batch, cfg.d_model, state=cfg.ssm_state,
                                  expand=cfg.ssm_expand,
                                  head_dim=cfg.ssm_head_dim)
        cache = {"pos": zeros((batch,), torch.int32)}
        kind = self.group_kind
        if kind in ("dense", "moe"):
            cache["k"], cache["v"] = zeros((G,) + kv), zeros((G,) + kv)
        elif kind == "moe_interleaved":
            shp = (G, self.group_size) + kv
            cache["k"], cache["v"] = zeros(shp), zeros(shp)
        elif kind == "ssm":
            cache["ssm"] = zeros((G,) + ssm)
        elif kind == "hybrid":
            cache["ssm"] = zeros((G, self.group_size) + ssm)
            # the shared block's weights serve every group, but each
            # group's call sees other activations: one KV cache per group
            cache["shared_k"] = zeros((G,) + kv)
            cache["shared_v"] = zeros((G,) + kv)
            if self.tail_layers:
                cache["tail_ssm"] = zeros((self.tail_layers,) + ssm)
        else:
            for i, p in enumerate(cfg.xlstm_pattern):
                if p == "m":
                    cache[f"x{i}"] = zeros((G,) + XL.mlstm_state_shape(
                        batch, cfg.d_model, cfg.n_heads))
                else:
                    cache[f"x{i}"] = zeros(
                        (G,) + XL.slstm_state_shape(batch, cfg.d_model),
                        torch.float32)
        if cfg.is_encdec:
            enc = (G, batch, src_len, cfg.n_kv_heads, hd)
            cache["enc_k"], cache["enc_v"] = zeros(enc), zeros(enc)
        return cache

    def reset_slot(self, cache: Dict[str, torch.Tensor], slot: int) -> None:
        """Make batch row ``slot`` of the cache fresh: its position 0 and
        its SSM and xLSTM states zero. Its attention entries need no
        clearing: a step at position p reads only the slots below p + 1,
        which the steps since the reset have written."""
        cache["pos"][slot] = 0
        for key, t in cache.items():
            if key == "ssm" and self.group_kind == "hybrid":
                t[:, :, slot] = 0                 # (G, group_size, B, ...)
            elif key in ("ssm", "tail_ssm") or key.startswith("x"):
                t[:, slot] = 0                    # (G or tail, B, ...)

    def decode_step(self, params, cache: Dict[str, torch.Tensor],
                    token: torch.Tensor, *, window: int = 0
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """token: (B,) integer → (logits (B, vp), cache). The cache's
        tensors are written in place (the reference returns a new cache;
        copying an 8-slot llama3-8b KV cache would cost 4.3 GB a step) and
        the same dict is returned, its ``pos`` one further."""
        cfg = self.cfg
        ctx = self.ctx
        pos = cache["pos"]
        x = params["embed"][token.long()[:, None]].to(self.dtype)
        x = ctx.cs(x, "batch", None, None)
        akw = self._attn_kwargs(window)
        skw = self._ssm_kwargs()
        kind = self.group_kind

        def attn(lp, h, ck, cv):
            return A.attention_decode_(lp["attn"], h, ck, cv, pos, **akw)

        def ssm(lp, x, st):
            y, st2 = SSM.ssm_decode(lp["ssm"], rmsnorm(x, lp["ln"]), st,
                                    **skw)
            st.copy_(st2)
            return x + y

        for g, gp in enumerate(params["blocks"]):
            if kind in ("dense", "moe"):
                x = x + attn(gp, rmsnorm(x, gp["ln1"]), cache["k"][g],
                             cache["v"][g])
                if cfg.is_encdec:
                    cp = params["cross"][g]
                    x = x + self._cross_decode(
                        cp["attn"], rmsnorm(x, cp["ln"]), cache["enc_k"][g],
                        cache["enc_v"][g])
                h = rmsnorm(x, gp["ln2"])
                x = x + (self._moe(gp["moe"], h)[0] if kind == "moe"
                         else mlp_apply(gp["mlp"], h, ctx))
            elif kind == "moe_interleaved":
                for li, lp in enumerate(gp["dense"]):
                    x = x + attn(lp, rmsnorm(x, lp["ln1"]),
                                 cache["k"][g, li], cache["v"][g, li])
                    x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"]), ctx)
                mp = gp["moe"]
                x = x + attn(mp, rmsnorm(x, mp["ln1"]), cache["k"][g, -1],
                             cache["v"][g, -1])
                x = x + self._moe(mp["moe"], rmsnorm(x, mp["ln2"]))[0]
            elif kind == "ssm":
                x = ssm(gp, x, cache["ssm"][g])
            elif kind == "hybrid":
                for li, lp in enumerate(gp):
                    x = ssm(lp, x, cache["ssm"][g, li])
                shared = params["shared_attn"]
                x = x + attn(shared, rmsnorm(x, shared["ln"]),
                             cache["shared_k"][g], cache["shared_v"][g])
                if "mlp" in shared:
                    x = x + mlp_apply(shared["mlp"],
                                      rmsnorm(x, shared["ln2"]), ctx)
            else:
                for i, p in enumerate(cfg.xlstm_pattern):
                    h = rmsnorm(x, gp[f"ln{i}"])
                    st = cache[f"x{i}"][g]
                    step = XL.mlstm_decode if p == "m" else XL.slstm_decode
                    y, st2 = step(gp[f"{p}{i}"], h, st, n_heads=cfg.n_heads,
                                  ctx=ctx)
                    st.copy_(st2)
                    x = x + y
        for li, lp in enumerate(params.get("tail", ())):
            x = ssm(lp, x, cache["tail_ssm"][li])

        x = rmsnorm(x, params["final_norm"])
        logits = (x @ params["unembed"].to(self.dtype))[:, 0]
        logits = ctx.cs(logits, "batch", "model")
        pos.add_(1)
        return logits, cache

    def _cross_decode(self, attn_params, x, enc_k, enc_v):
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        B = x.shape[0]
        dt = x.dtype
        q = (x @ attn_params["wq"].to(dt)).reshape(B, 1, cfg.n_heads, hd)
        s = A._gqa_scores(q, enc_k) * hd ** -0.5
        w = softmax_fp32(s).to(dt)
        out = A._gqa_av(w, enc_v)
        return out.reshape(B, 1, cfg.n_heads * hd) @ \
            attn_params["wo"].to(dt)
