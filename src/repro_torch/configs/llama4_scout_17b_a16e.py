"""llama4-scout-17b-a16e — 16-expert top-1 MoE (extreme routing skew: the
case where the paper's non-zero partitioning matters most), early fusion.
The shared-expert branch of the released model is folded into the routed
experts.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    rope_theta=500000.0,
    moe_experts=16,
    moe_topk=1,
    moe_capacity_factor=1.5,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
))
