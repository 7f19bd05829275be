"""Causal GQA flash attention, the LM stack's attention leaf.

One Hopper kernel (``csrc/flash_attention.cu``) with its plain PyTorch
version beside it. :func:`flash_attention` replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention``; the source note says
what bounds it on the card and what its design does about that. The
wrapper runs the plain version only when its inputs lie on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check_launch, library

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, k, v, o, B, S, H, Hkv, hd, is_bf16, scale, stream
    "flash_attention_fwd": (_P,) * 4 + (_I,) * 6 + (ctypes.c_float, _P),
}
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """The masked-einsum oracle: grouped scores in float32, the causal mask,
    a float32 softmax, the weights cast to q's dtype and applied to v."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) / hd ** 0.5
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return o.reshape(B, S, H, hd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Causal GQA attention: q (B, S, H, hd), k and v (B, S, Hkv, hd) with
    H = G·Hkv; query head h reads KV head h // G. Returns (B, S, H, hd) in
    q's dtype (float32 or bfloat16; q, k and v of one dtype, contiguous;
    hd in {16, 32, 64, 128}).

    ``block_q`` and ``block_k`` are the TPU kernel's tile sizes. They are
    checked and accepted so its callers run unchanged, but the Hopper kernel
    tiles as it likes (G query heads by 256 / (G·max(1, hd / 32)) positions
    a block, 64 keys a stage) and the result does not depend on them."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if min(block_q, block_k) <= 0:
        raise ValueError(f"flash_attention: block sizes must be positive, "
                         f"got ({block_q}, {block_k})")
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} is not one of "
                         f"{HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k and v must share one dtype "
                        f"of {DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return flash_attention_plain(q, k, v)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention: inputs must all lie on one CUDA "
                         f"device or all on the CPU, got "
                         f"{sorted(map(str, devices))}")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        err = library("flash_attention", _SIGNATURES).flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
            k.shape[2], hd, int(q.dtype == torch.bfloat16), hd ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    check_launch("flash_attention", err)
    return o
