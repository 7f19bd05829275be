"""Model stack: LM assembly for the ten architectures and the layers it is
built from (attention, with causal GQA through the Hopper flash kernel;
the SSM, xLSTM and gated-linear-attention mixers; the MoE layer)."""
from .layers import NO_SHARD, ShardCtx
from .model import LM

__all__ = ["LM", "ShardCtx", "NO_SHARD"]
