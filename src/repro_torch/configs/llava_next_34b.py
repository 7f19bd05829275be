"""llava-next-34b — VLM backbone (anyres tiling frontend is a stub;
input_specs provides precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    rope_theta=1000000.0,
    frontend="vision",
    frontend_tokens=576,       # one anyres base tile of 24x24 patches
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
))
