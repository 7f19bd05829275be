"""qwen3-14b — dense GQA with qk_norm. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-8B; hf",
))
