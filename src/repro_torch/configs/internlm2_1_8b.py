"""internlm2-1.8b — dense GQA. [arXiv:2403.17297; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    head_dim=128,
    rope_theta=1000000.0,
    source="arXiv:2403.17297; hf",
))
