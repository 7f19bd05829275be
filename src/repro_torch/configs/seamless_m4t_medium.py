"""seamless-m4t-medium — encoder-decoder, multimodal. The speech frontend
is a stub (input_specs provides precomputed frame embeddings feeding the
12-layer encoder); the 12-layer decoder handles the decode shapes.
[arXiv:2308.11596; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,               # decoder layers
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,         # padded internally to 256256 for sharding
    head_dim=64,
    frontend="audio",
    frontend_tokens=1024,      # speech frames after downsampling (stub)
    source="arXiv:2308.11596; hf",
))
