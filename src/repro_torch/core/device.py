"""Where the port's entry points run.

Every entry point takes ``device``. ``None`` means the card (``cuda``); a
caller that wants the CPU says ``device="cpu"``, as the tests do. Without a
card, ``None`` raises instead of carrying on on the CPU, so a measurement
or a run meant for the card can never silently happen elsewhere.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
