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
from .model import DTYPES


def _tensor(x, device, dtype=None) -> torch.Tensor:
    # np.array copies: arrays from JAX are read-only, and a tensor must own
    # its memory
    t = torch.from_numpy(np.array(x, dtype=np.float32))
    return t.to(device=device, dtype=dtype or torch.float32)


def attn_params_from_reference(params: Mapping[str, Any], device=None,
                               dtype=None) -> Dict[str, torch.Tensor]:
    """One ``attn_init`` tree (wq, wk, wv, wo and, with qk_norm, q_norm and
    k_norm) as the port's tensors on ``device`` (None: the card), in
    ``dtype`` (default float32)."""
    device = resolve_device(device)
    return {k: _tensor(v, device, dtype) for k, v in params.items()}


def lm_params_from_reference(params: Mapping[str, Any], cfg: ArchConfig,
                             device=None) -> Dict[str, Any]:
    """The reference ``LM(cfg).init_params`` tree (numpy arrays, ``blocks``
    stacked on the group axis) as the port's parameters: the same keys,
    ``blocks`` a list of per-layer dicts, in ``cfg.param_dtype`` on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    dtype = DTYPES[cfg.param_dtype]
    blocks = params["blocks"]
    n = np.asarray(blocks["ln1"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"the reference tree holds {n} layers, "
                         f"{cfg.name} has {cfg.n_layers}")

    def layer(i):
        return {"attn": attn_params_from_reference(
                    {k: np.asarray(v)[i] for k, v in blocks["attn"].items()},
                    device, dtype),
                "mlp": {k: _tensor(np.asarray(v)[i], device, dtype)
                        for k, v in blocks["mlp"].items()},
                "ln1": _tensor(np.asarray(blocks["ln1"])[i], device, dtype),
                "ln2": _tensor(np.asarray(blocks["ln2"])[i], device, dtype)}

    return {"embed": _tensor(params["embed"], device, dtype),
            "blocks": [layer(i) for i in range(n)],
            "final_norm": _tensor(params["final_norm"], device, dtype),
            "unembed": _tensor(params["unembed"], device, dtype)}
