"""Causal GQA flash attention, the LM stack's attention leaf.

One Hopper source (``csrc/flash_attention.cu``: tensor-core kernels for
bf16 and f16, whose warps split the output's columns at the padded hd 256,
384 and 512, with a column-chunk kernel past 512; CUDA-core kernels for
f32, one block a tile up to hd 512 and a thread-block cluster whose blocks
split the output's columns up to 4096, with a column-chunk kernel past it;
all but the column-chunk kernels compute the scores once at the full
width) with its plain PyTorch version beside it.
:func:`flash_attention` replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention``; the source note says
what bounds it on the card and what its design does about that. The
wrapper runs the plain version only when its inputs lie on the CPU; on a
CUDA tensor it launches the kernel or raises. Neither takes a gradient
through the wrapper (it refuses autograd, as the reference's kernel has no
backward); :func:`flash_attention_plain` called directly stays
differentiable. :data:`ROUTES` counts the launches by dtype and the width
the card ran; :func:`f32_plan` and :func:`f32_cluster_plan` mirror the f32
kernels' tiles.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ._build import check_launch, library

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, k, v, o, B, S, H, Hkv, hd, row, dtype code, scale, stream
    "flash_attention_fwd": (_P,) * 4 + (_I,) * 7 + (ctypes.c_float, _P),
    # hd -> BM, D, R, SR, OR, TOC, NJ, smem (F32Plan<hd>)
    "flash_f32_plan": (_I, ctypes.POINTER(ctypes.c_int)),
    # hd -> NC, BW, BM, D, R, SR, OR, TOC, NJ, smem, widest, resident
    # clusters
    "flash_f32_cluster_plan": (_I, ctypes.POINTER(ctypes.c_int)),
}
HEAD_DIMS = (16, 32, 64, 128, 256)  # the widths a head up to 256 is padded to
CHUNK = 128         # above 256, hd is padded to a multiple of this (kChunk)
# the widths whose 16-bit kernel reads rows of any multiple of 8 above 128
# up to them and zero-fills the rest itself (flash_mma_wide_kernel)
WIDE16 = (256, 384, 512)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# launches by (dtype name, padded width), counted where the wrapper
# launches, beside _build.LAUNCHES' one count for the kernel
ROUTES: Dict[Tuple[str, int], int] = {}
# flash_f32_kernel's widths, threads a block, keys a K/V tile and shared
# memory a block may take (csrc/flash_attention.cu)
F32_WIDTHS = (16, 32, 64, 128, 256, 384, 512)
F32_THREADS, F32_BK, F32_SMEM = 256, 64, 232448
_PLAN_KEYS = ("BM", "D", "R", "SR", "OR", "TOC", "NJ", "smem")
# flash_f32_cluster_kernel: blocks a cluster at most (kF32MaxCluster) and
# a block's columns at most (kF32MaxBlockCols), so it takes f32 from 640 to
# 4096; past that the f32 column-chunk kernel
F32_CLUSTER_MAX = 16
F32_CLUSTER_COLS = 256
_CLUSTER_KEYS = ("NC", "BW", "BM", "D", "R", "SR", "OR", "TOC", "NJ",
                 "smem", "widest", "resident")


def reset_routes() -> None:
    ROUTES.clear()


def f32_plan(hd: int) -> dict:
    """flash_f32_kernel<hd>'s tiles as F32Plan chooses them: BM stacked
    rows a block (128 at hd 128, 64 else); K and V in NSL slabs of 64 keys
    x D dims through a ring of R slabs; the scores' micro-tile SR rows x 4
    keys a thread; O's OR rows x NJ 16-byte chunks of each slab, TOC
    threads across a slab's CD chunks; CQ, CD, CP the 16-byte chunks in a
    row of Q, of a slab, of P^T; ``smem`` the bytes a block takes. The
    kernel decides; this mirrors it for the CPU emulation and the edge
    cases, and :func:`f32_plan_card` (the library's own report) is held
    equal to it on the card."""
    if hd not in F32_WIDTHS:
        raise ValueError(f"flash_f32_kernel has no instance for hd {hd}")
    BM = 128 if hd == 128 else 64
    D = hd if hd <= 256 else 128
    OC = BM * D // F32_THREADS              # O floats a thread a slab
    OR = 8 if OC >= 64 else 4 if OC >= 16 else OC // 4
    TOC = F32_THREADS * OR // BM
    fixed = (BM * hd + F32_BK * BM + 2 * BM) * 4
    slab = F32_BK * D * 4
    R = min(4, (F32_SMEM - fixed) // slab)
    return dict(BM=BM, D=D, NSL=hd // D, CQ=hd // 4, CD=D // 4, CP=BM // 4,
                SR=BM // 16, TOC=TOC, OR=OR, NJ=D // 4 // TOC, R=R,
                smem=fixed + R * slab)


def f32_plan_card(hd: int) -> dict:
    """The keys of :data:`_PLAN_KEYS` as the built library's
    ``flash_f32_plan`` reports F32Plan<hd> (needs the CUDA toolkit)."""
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    err = library("flash_attention", _SIGNATURES).flash_f32_plan(hd, out)
    if err:
        raise ValueError(f"flash_f32_plan: no instance for hd {hd} "
                         f"(CUDA error {err})")
    return dict(zip(_PLAN_KEYS, out))


def f32_cluster_plan(hd: int) -> dict:
    """flash_f32_cluster_kernel<BW>'s tiles at the f32 width ``hd`` (a
    multiple of 128 from 640 to F32_CLUSTER_MAX·F32_CLUSTER_COLS), as
    ClusterPlan chooses them: each block owns BW of the output's columns
    and the same dims of Q (CQ 16-byte chunks a row), BW = 128 while hd /
    128 blocks fit a cluster of F32_CLUSTER_MAX, else 256; NC = ceil(hd /
    BW) blocks a cluster (the last one's second 128 columns past hd where
    hd / 128 is odd); BM = 64 stacked rows; K and V in M = BW / 128 slabs
    of 64 keys x D = 128 dims a tile through a ring of R slabs; SR, OR,
    TOC, NJ, CD, CP as in :func:`f32_plan` (O's OR x NJ chunks a slab);
    PART floats a score tile (a block holds its partial and its slice's
    sums in two); ``smem`` the bytes a block takes; ``widest`` the widest
    width the kernel takes. :func:`f32_cluster_plan_card` is held equal to
    it on the card."""
    widest = F32_CLUSTER_MAX * F32_CLUSTER_COLS
    if hd <= 512 or hd % CHUNK or hd > widest:
        raise ValueError(f"flash_f32_cluster_kernel takes no hd {hd}")
    BW = CHUNK if hd // CHUNK <= F32_CLUSTER_MAX else F32_CLUSTER_COLS
    BM, D = 64, CHUNK
    OC = BM * D // F32_THREADS
    OR = 8 if OC >= 64 else 4 if OC >= 16 else OC // 4
    TOC = F32_THREADS * OR // BM
    part = BM * F32_BK
    fixed = (BM * BW + 2 * part + F32_BK * BM + 2 * BM) * 4
    slab = F32_BK * D * 4
    R = min(4, (F32_SMEM - fixed) // slab)
    return dict(NC=-(-hd // BW), BW=BW, M=BW // D, BM=BM, D=D, CQ=BW // 4,
                CD=D // 4, CP=BM // 4, SR=BM // 16, OR=OR, TOC=TOC,
                NJ=D // 4 // TOC, R=R, PART=part, smem=fixed + R * slab,
                widest=widest)


def f32_cluster_plan_card(hd: int) -> dict:
    """The keys of :data:`_CLUSTER_KEYS` as the built library's
    ``flash_f32_cluster_plan`` reports them; ``resident`` is the clusters
    of NC blocks the card holds at once (needs the CUDA toolkit and a
    card)."""
    out = (ctypes.c_int * len(_CLUSTER_KEYS))()
    err = library("flash_attention", _SIGNATURES).flash_f32_cluster_plan(
        hd, out)
    if err:
        raise ValueError(f"flash_f32_cluster_plan: no cluster for hd {hd} "
                         f"(CUDA error {err})")
    return dict(zip(_CLUSTER_KEYS, out))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale=None) -> torch.Tensor:
    """The masked-einsum oracle: grouped scores in float32 times ``scale``
    (hd ** -0.5 by default), the causal mask, a float32 softmax, the
    weights cast to q's dtype and applied to v."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(B, S, Hkv, H // Hkv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return o.reshape(B, S, H, hd)


def padded_width(hd: int) -> int:
    """The width the card's kernels run ``hd`` at: the next of HEAD_DIMS,
    or above 256 the next multiple of CHUNK."""
    if hd > HEAD_DIMS[-1]:
        return -(-hd // CHUNK) * CHUNK
    return next(w for w in HEAD_DIMS if w >= hd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Causal GQA attention: q (B, S, H, hd), k and v (B, S, Hkv, hd) with
    H = G·Hkv; query head h reads KV head h // G. Returns (B, S, H, hd) in
    q's dtype (q, k and v of one float dtype, contiguous): float32,
    bfloat16 or float16 and any hd, on the CPU (the plain version) and on
    the card. There a width up to 256 outside HEAD_DIMS is zero-padded to
    the next one, a width above 256 to a multiple of 128 (zero columns
    leave q·k unchanged; the scale stays the true width's), and the output
    sliced back; in bf16 and f16 at a width of 136-512 that is a multiple
    of 8 the kernel zero-fills the columns itself (:data:`WIDE16`), so
    nothing is copied.

    ``block_q`` and ``block_k`` are the TPU kernel's tile sizes. They are
    checked and accepted so its callers run unchanged, but the Hopper
    kernels tile as they like and the result does not depend on them. A
    block stacks the G query heads of one KV head row-wise over a run of
    positions and stages 64 keys at a time: bf16 and f16 run on the tensor
    cores (``mma.sync``), 64 rows a block (64 / G positions), 16 rows a
    warp up to hd 128; at the padded 256, 384 and 512 four warps share 32
    rows, splitting the keys of 128-key tiles of the full-width scores and
    then the output's columns. f32 runs on the CUDA cores, rows a block by
    width (:func:`f32_plan`), the scores once at the full width up to 512;
    from 640 to 4096 a cluster of at most 16 blocks, each owning 128 of
    the output's columns (up to 2048) or 256 (above), adds its blocks'
    partial scores in rank order, so the scores are still computed once
    (:func:`f32_cluster_plan`). Past 512 (16-bit) and 4096 (f32)
    column-chunk kernels take the width, whose blocks own 128 of the
    output's columns and recompute the full-width scores. The
    card's kernels load and store 16 bytes at a time: q, k and v must
    start on a 16-byte boundary there (a fresh tensor does).

    The kernel has no gradient, as the reference's Pallas kernel has none
    (no ``custom_vjp``; ``jax.grad`` through it fails): with autograd
    recording and any of q, k, v requiring grad it raises, on both
    devices, rather than return a result the backward would not reach.
    Training takes the ``dense``, ``chunked`` or ``windowed`` attention."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no gradient: the reference's Pallas kernel "
            "defines none, so the model cannot train through it; training "
            "takes the 'dense', 'chunked' or 'windowed' attention variant")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if min(block_q, block_k) <= 0:
        raise ValueError(f"flash_attention: block sizes must be positive, "
                         f"got ({block_q}, {block_k})")
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
    B, S, H, hd = q.shape
    if q.numel() == 0:
        return torch.empty_like(q)
    width = padded_width(hd)
    row = hd if (q.dtype != torch.float32 and width in WIDE16
                 and hd % 8 == 0) else width
    if row != hd:                         # zero columns: q·k is unchanged
        q, k, v = (torch.nn.functional.pad(x, (0, row - hd))
                   for x in (q, k, v))
    o = torch.empty_like(q)
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a "
                             f"16-byte boundary on the card, got address "
                             f"{x.data_ptr():#x}")
    with torch.cuda.device(q.device):
        err = library("flash_attention", _SIGNATURES).flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
            k.shape[2], width, row, _CODES[q.dtype], hd ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    check_launch("flash_attention", err)
    key = (str(q.dtype).removeprefix("torch."), width)
    ROUTES[key] = ROUTES.get(key, 0) + 1
    return o if row == hd else o[..., :hd].contiguous()
