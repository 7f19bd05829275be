"""xlstm-125m — alternating mLSTM / sLSTM blocks (d_ff=0: the blocks carry
their own projections). [arXiv:2405.04517; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm_pattern=("m", "s"),
    source="arXiv:2405.04517; unverified",
))
