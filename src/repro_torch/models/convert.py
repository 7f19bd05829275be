"""Weights carried over from the reference.

The reference initialises its parameters from JAX PRNG keys, which torch
cannot reproduce, so a port test draws them with the reference, hands
them over as numpy arrays, and runs both models on the same weights.
Matrices keep their (d_in, d_out) layout.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from .model import DTYPES, LM


def _tensor(x, device, dtype=None) -> torch.Tensor:
    """One array as a tensor on ``device``, in ``dtype`` (default: the
    array's own float32, bfloat16 or float16)."""
    a = np.asarray(x)
    dtype = dtype or DTYPES[a.dtype.name]
    # np.array copies: arrays from JAX are read-only, and a tensor must own
    # its memory
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(device=device, dtype=dtype)


def attn_params_from_reference(params: Mapping[str, Any], device=None,
                               dtype=None) -> Dict[str, torch.Tensor]:
    """One ``attn_init`` tree (wq, wk, wv, wo and, with qk_norm, q_norm and
    k_norm) as the port's tensors on ``device`` (None: the card), in
    ``dtype`` (default: each array's own)."""
    device = resolve_device(device)
    return {k: _tensor(v, device, dtype) for k, v in params.items()}


def _tree(x, device, index=()):
    """A reference subtree (dicts of arrays) as tensors, each array taken at
    ``index`` along its leading (stacked) axes."""
    if isinstance(x, Mapping):
        return {k: _tree(v, device, index) for k, v in x.items()}
    return _tensor(np.asarray(x)[index], device)


def _unstack(x, device, n: int, index=()):
    """A subtree stacked on one more leading axis of length ``n`` as a list
    of ``n`` subtrees."""
    return [_tree(x, device, index + (i,)) for i in range(n)]


def _leading(x) -> int:
    while isinstance(x, Mapping):
        x = next(iter(x.values()))
    return int(np.asarray(x).shape[0])


def lm_params_from_reference(params: Mapping[str, Any], cfg: ArchConfig,
                             device=None) -> Dict[str, Any]:
    """The reference ``LM(cfg).init_params`` tree (numpy arrays, ``blocks``
    and the other per-layer stacks stacked on the group axis) as the port's
    parameters on ``device`` (None: the card): the same keys and each
    array's own dtype, with every stack a list (``moe_interleaved``'s dense
    layers and a ``hybrid`` group's SSM layers, stacked twice in the
    reference, a list per group); see :mod:`.model`."""
    device = resolve_device(device)
    lm = LM(cfg)
    blocks = params["blocks"]
    n = _leading(blocks)
    if n != lm.n_groups:
        raise ValueError(f"the reference tree holds {n} groups of layers, "
                         f"{cfg.name} has {lm.n_groups}")
    kind = lm.group_kind
    if kind == "moe_interleaved":
        groups = [{"dense": _unstack(blocks["dense"], device,
                                     lm.group_size - 1, (g,)),
                   "moe": _tree(blocks["moe"], device, (g,))}
                  for g in range(n)]
    elif kind == "hybrid":
        groups = [_unstack(blocks, device, lm.group_size, (g,))
                  for g in range(n)]
    else:
        groups = _unstack(blocks, device, n)
    out = {"blocks": groups}
    for key, v in params.items():
        if key in ("embed", "final_norm", "unembed", "enc_norm",
                   "shared_attn"):
            out[key] = _tree(v, device)
        elif key in ("tail", "encoder", "cross"):
            out[key] = _unstack(v, device, _leading(v))
        elif key != "blocks":
            raise ValueError(f"unknown key {key!r} in the reference tree")
    return out
