"""Training optimizer (the port of the reference's ``optim``): AdamW with
f32 moments over the port's parameter trees (:mod:`.adamw`), the
learning-rate schedule (:mod:`.schedules`) and gradient compression with
error feedback (:mod:`.grad_compress`). Plain PyTorch, as the reference
computes all of it outside any Pallas kernel."""
from .adamw import AdamWState, adamw_init, adamw_update
from .schedules import cosine_with_warmup
from . import grad_compress

__all__ = ["AdamWState", "adamw_init", "adamw_update",
           "cosine_with_warmup", "grad_compress"]
