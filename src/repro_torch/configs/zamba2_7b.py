"""zamba2-7b — hybrid Mamba2 backbone + one shared transformer block
(attn+MLP, weights reused) applied every 6 SSM layers.
[arXiv:2411.15242; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,              # d_model / n_heads
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    hybrid_attn_every=6,       # 13 shared-block applications + 3 tail layers
    source="arXiv:2411.15242; unverified",
))
