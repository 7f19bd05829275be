"""Model stack: LM assembly and the layers it is built from (the dense
family, with causal GQA attention through the Hopper flash kernel)."""
from .layers import NO_SHARD, ShardCtx
from .model import LM

__all__ = ["LM", "ShardCtx", "NO_SHARD"]
