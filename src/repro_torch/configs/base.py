"""Architecture + shape configuration system (the port's own copy of the
reference's ``configs/base.py``, which is plain data and imports no JAX).

Every architecture is an :class:`ArchConfig` (one module per arch in this
package). Shapes are the four standard input shapes; ``long_500k`` runs
with block-sparse sliding-window attention for full-attention archs and
natively for SSM/hybrid archs. The port registers the architectures whose
family its ``models`` package runs (the dense family: llama3-8b).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                 # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int
    grad_accum: int = 1       # microbatch accumulation steps (train)
    attention_window: int = 0  # >0 → block-sparse sliding window override


# grad_accum=16 → per-device microbatch of 1 sequence on the 16-wide data
# axis: keeps dense-attention activations + remat peaks inside v5e HBM.
TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256, grad_accum=16)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

STANDARD_SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 → d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_capacity_factor: float = 1.25
    moe_every: int = 1        # every Nth layer is MoE (llama4 interleave)
    # SSM (Mamba2-style)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    # hybrid: one shared attention block applied every N ssm layers
    hybrid_attn_every: int = 0
    # xLSTM: per-layer pattern, cycled over n_layers ("m"=mLSTM, "s"=sLSTM)
    xlstm_pattern: Tuple[str, ...] = ()
    # enc-dec
    encoder_layers: int = 0
    # modality frontend stub (precomputed embeddings via input_specs)
    frontend: str = "none"    # none|vision|audio
    frontend_tokens: int = 0
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    # training-shape overrides (§Perf iteration 5): fewer, larger
    # microbatches cut per-microbatch gradient reductions and FSDP weight
    # gathers; chunked attention keeps big-microbatch memory bounded.
    grad_accum_override: int = 0
    train_attn_variant: str = "auto"
    # attention defaults
    attention_window: int = 0
    source: str = ""          # provenance note ([arXiv/hf; tier])

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch natively supports very long context."""
        return self.family in ("ssm", "hybrid")

    def vocab_padded(self, multiple: int = 256) -> int:
        """Vocab padded so the embedding shards evenly on any mesh axis we
        use (≤ 256); logits beyond vocab_size are masked to -inf in loss."""
        return int(-(-self.vocab_size // multiple) * multiple)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, hd = self.d_model, self.d_ff, self.resolved_head_dim
        qkv = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        mlp = 3 * d * f
        if self.moe_experts:
            mlp = 3 * d * f * self.moe_experts + d * self.moe_experts
        ssm = 0
        if self.family in ("ssm", "hybrid") and not self.xlstm_pattern:
            di = self.ssm_expand * d
            ssm = d * (2 * di + 2 * self.ssm_groups * self.ssm_state) + di * d
        per_layer = {
            "dense": qkv + mlp, "moe": qkv + mlp, "vlm": qkv + mlp,
            "audio": qkv + mlp, "ssm": ssm or (qkv + mlp), "hybrid": ssm,
        }[self.family]
        n = self.n_layers * per_layer + 2 * self.vocab_size * d
        if self.family == "hybrid" and self.hybrid_attn_every:
            n += qkv + mlp  # one shared block
        if self.is_encdec:
            n += self.encoder_layers * (qkv + mlp)
        return int(n)

    def active_param_count(self) -> int:
        """6·N_active·D convention for MoE rooflines."""
        if not self.moe_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        qkv = d * self.resolved_head_dim * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * self.resolved_head_dim * d
        mlp_active = 3 * d * f * self.moe_topk + d * self.moe_experts
        return int(self.n_layers * (qkv + mlp_active)
                   + 2 * self.vocab_size * d)

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            moe_experts=min(self.moe_experts, 4),
            moe_topk=min(self.moe_topk, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            encoder_layers=min(self.encoder_layers, 2),
            frontend_tokens=min(self.frontend_tokens, 8),
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            remat=False,
        )

    def shapes(self) -> Dict[str, ShapeConfig]:
        """The assigned shape set, with per-arch long_500k handling."""
        out = dict(STANDARD_SHAPES)
        if not self.sub_quadratic:
            # full-attention archs run long_500k only with the block-sparse
            # sliding window built on the paper's format machinery
            out["long_500k"] = dataclasses.replace(
                out["long_500k"], attention_window=8192)
        return out


_REGISTRY: Dict[str, "ArchConfig"] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def all_archs() -> Dict[str, ArchConfig]:
    if not _REGISTRY:
        _load_all()
    return dict(_REGISTRY)


def _load_all() -> None:
    # the ported architectures only; the other families wait for their
    # model code (ROADMAP Queue 1 item 7)
    from . import llama3_8b  # noqa: F401
