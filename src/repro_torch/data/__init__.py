"""Data: the deterministic, sharded, resumable token pipeline of the
training stack (:mod:`.pipeline`) and the sparse matrix generators
(:mod:`.spdata`)."""
from . import pipeline, spdata

__all__ = ["pipeline", "spdata"]
