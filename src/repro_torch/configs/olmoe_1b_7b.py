"""olmoe-1b-7b — 64-expert top-8 MoE, every layer. The expert dispatch is
the SpDISTAL coordinate-fusion + non-zero-partition path
(``models/moe.moe_apply``).
[arXiv:2409.02060; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    head_dim=128,
    moe_experts=64,
    moe_topk=8,
    moe_capacity_factor=1.25,
    source="arXiv:2409.02060; hf",
))
