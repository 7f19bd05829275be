"""starcoder2-15b — dense GQA + RoPE. [arXiv:2402.19173; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    rope_theta=100000.0,
    source="arXiv:2402.19173; hf",
))
