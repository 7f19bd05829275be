#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py            # full size (below)
    python3 chip_smoke.py --log2-n 14 --log2-i 13 --log2-jk 9 \
        --log2-dense 10 --reps 4 --attn-layers 2 --attn-seq 512
                                     # a quick rehearsal

Phases, one line each (a failing phase raises and the script exits non-zero):

1. device  — the card's name, count, and ``nvidia-smi`` name and power limit.
2. build   — ``nvcc`` for ``sm_90a`` over every CUDA source (in parallel),
             with each kernel's registers, shared memory and spills.
3. kernels — each Hopper kernel against its plain PyTorch version on the
             card: first at edge-case shapes (empty rows, an empty piece, a
             row longer than 128 entries, a slice longer than one 256-entry
             segment, J in {1, 16, 130}, K and L in {1, 7, 32, 33}; for
             SpAdd3 an empty operand, a row longer than one merge task,
             coordinates in all three operands and sums that cancel to 0,
             shard padding that must not be read, block shapes (2, 2) and
             (4, 4) with a ragged last block column; for the blocked SpMV,
             SpMM and SDDMM an empty piece and block-row, a block-row
             longer than several 128-block segments, runs that start and
             end on segment edges, padding that must not be read, blocks
             (2, 2), (4, 4) and (4, 8) with a ragged last block-row and
             block-column, J in {1, 16, 33}, K in {1, 7, 32, 33}; for
             the SpMM nnz kernel the SpMV nnz and SpMTTKRP streams, runs
             across one and two 256-entry segments, J in {1, 7, 16, 32,
             33, 130}; for flash_attention every case of
             tests/test_flash_kernel.py with hd 128 added: G in {1, 2, 3,
             4, 8}, ragged S = 100, 200 and 300, f32 and bf16), later
             at the main path's shapes. Per-entry tolerance
             |got - plain| <= 1e-4 * scale + 1e-6, with ``scale`` the same
             computation on absolute values: f32 sums of up to a million
             terms, taken in a different order. A compressed result must
             have the plain version's pattern exactly. flash_attention is
             held at atol = rtol = 2e-5 in f32 and 3e-2 in bf16 (the
             reference test's), and its position 0 must equal v[0].
4. main    — five paths, each driven through the public entry points with
             the kernel launch counts reset just before and read just
             after; each of the path's kernels must have launched.
   a. ``powerlaw_matrix`` (n = m = 2^21, 16 entries per row on average,
      alpha 1.6, seed 0) in CSR on ``Machine(("x", 4))``: SpMV and SpMM
      (J = 32) under the rows and nnz strategies.
   b. SDDMM over the same matrix (K = 32), and SpTTV and SpMTTKRP (L = 32)
      over ``powerlaw_tensor3`` (2^20 x 2^16 x 2^16, 16 entries per slice
      on average, alpha 1.8, seed 0) in CSF, under rows and nnz.
   c. SpAdd3 ``A = B + C + D`` under rows and nnz: over the same matrix B
      with C and D its pattern shifted by 1 and 2 columns (values from
      seeds 1 and 2), and over BCSR((4, 4)) operands of the same side whose
      block pattern is ``powerlaw_matrix`` (side / 4, 4 blocks per
      block-row) and its shifts by 1 and 2 block columns; plus the dense
      sums of ``ops.spadd3_dense`` and ``ops.spadd3_bcsr_dense`` over such
      operands of side 2^15 (the dense output of side 2^21 would be 16 TiB).
   d. The blocked SpMV, SpMM (J = 32) and SDDMM (K = 32) under rows and
      nnz over the add path's BCSR((4, 4)) operand B (1,977,760 stored
      blocks at the default side; its longest block-row 331,322) and the
      matrix path's dense operands.
   e. The attention path, on a card freed of the sparse paths' data:
      llama3-8b at full width (d 4096, 32 heads, 8 KV heads, head_dim 128,
      d_ff 14336, vocab 128256), all 32 layers, bf16 weights from a seeded
      generator on the card (about 16 GB), ``LM.apply(variant="flash",
      last_only=True)`` over a prefill of 2 prompts of 4096 tokens (numpy
      seed 0): the host-clock median of the prefill, tokens/s and the peak
      memory. flash_attention must launch exactly once per layer and apply,
      and nothing else; two prefills must give the same bits. Checks: (a)
      the same weights under ``variant="dense"``, relative Frobenius error
      of the logits <= 5e-2; (b) f32 at full width and 2 layers, flash
      against dense on every position at atol = rtol = 1e-3.
   Every sparse cell is lowered cold and warm and run; its result is
   checked per entry against a float64 host computation on the numpy
   arrays (same tolerance form; a SpAdd3 union must have the host union's
   stored coordinates exactly), and the line reports the cold and warm
   lower times, the median ``run()`` time and the peak device memory. SpMM
   nnz, SDDMM, SpMTTKRP, SpAdd3 and the blocked cells must give the same
   bits on two ``run()``s. The counts are read before any other launch:
   each cell's kernel must have launched exactly once per ``run()`` and no
   other kernel at all.
5. timing, after every count is read: the median time of each cell's
   kernel on the cell's own inputs (CUDA events, median of 20), and the
   ``{"kernels": [...]}`` line: per kernel its launches on the main path,
   its time, its bound at these shapes, its plain version's time and one
   PyTorch library call's time on the same inputs (a yardstick only; the
   port never calls it, and for the blocked SpAdd3 kernels none exists),
   and a line for the SpMV rows kernel's second use, SpTTV over the (i, j)
   fibres. The blocked kernels' yardsticks are ``torch.sparse`` BSR
   products and ``sampled_addmm`` over the scalarised block pattern.
   flash_attention is timed at the model's layer shapes (q (2, 4096, 32,
   128), k and v (2, 4096, 8, 128)) in bf16 (the line's record) and f32
   (a line of its own), beside ``scaled_dot_product_attention(
   is_causal=True, enable_gqa=True)``; its bound is the causal flops over
   989 TFLOP/s bf16 (67 f32) against q, k, v and o moved once.

The last line is ``{"ok": true, "device": {...}}``. Without a card, or
without the package beside this file, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense
RTOL_ROW, ATOL = 1e-4, 1e-6
AVG_NNZ, PIECES, SPMM_J, SEED = 16, 4, 32, 0    # the main path's cells
AVG_SLICE, RANK = 16, 32       # powerlaw_tensor3's slices; SDDMM K, MTTKRP L
ADD_BLOCK, AVG_BLOCKS = (4, 4), 4   # the blocked SpAdd3 operands

KERNELS = {
    "spmv_csr_rows": ("src/repro_torch/kernels/csrc/spmv.cu",
                      "src/repro/kernels/spmv.py:72"),
    "spmv_coo_nnz": ("src/repro_torch/kernels/csrc/spmv.cu",
                     "src/repro/kernels/spmv.py:126"),
    "spmm_csr_rows": ("src/repro_torch/kernels/csrc/spmm.cu",
                      "src/repro/kernels/spmm.py:54"),
    "spmm_coo_nnz": ("src/repro_torch/kernels/csrc/spmm.cu",
                     "none; src/repro/kernels/ref.py:106 leaf_spmm_nnz"),
    "sddmm_coo": ("src/repro_torch/kernels/csrc/sddmm.cu",
                  "src/repro/kernels/sddmm.py:45"),
    "spmttkrp_coo": ("src/repro_torch/kernels/csrc/spmttkrp.cu",
                     "src/repro/kernels/spmttkrp.py:70"),
    # the union kernels compute the TPU kernels' sums in compressed form
    "spadd3_dense_rows": ("src/repro_torch/kernels/csrc/spadd3.cu",
                          "src/repro/kernels/spadd3.py:57"),
    "bcsr_spadd3_dense_rows": ("src/repro_torch/kernels/csrc/spadd3.cu",
                               "src/repro/kernels/bcsr.py:214"),
    "spadd3_union_rows": ("src/repro_torch/kernels/csrc/spadd3.cu",
                          "src/repro/kernels/spadd3.py:57"),
    "spadd3_union_nnz": ("src/repro_torch/kernels/csrc/spadd3.cu",
                         "src/repro/kernels/spadd3.py:57"),
    "bcsr_spadd3_union_rows": ("src/repro_torch/kernels/csrc/spadd3.cu",
                               "src/repro/kernels/bcsr.py:214"),
    "bcsr_spadd3_union_nnz": ("src/repro_torch/kernels/csrc/spadd3.cu",
                              "src/repro/kernels/bcsr.py:214"),
    "bcsr_spmv": ("src/repro_torch/kernels/csrc/bcsr.cu",
                  "src/repro/kernels/bcsr.py:68"),
    "bcsr_spmm": ("src/repro_torch/kernels/csrc/bcsr.cu",
                  "src/repro/kernels/bcsr.py:118"),
    "bcsr_sddmm": ("src/repro_torch/kernels/csrc/bcsr.cu",
                   "src/repro/kernels/bcsr.py:160"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:82"),
}
MATRIX_CELLS = (("spmv", "rows"), ("spmv", "nnz"), ("spmm", "rows"),
                ("spmm", "nnz"))
SLICE_CELLS = (("sddmm", "rows"), ("sddmm", "nnz"), ("spttv", "rows"),
               ("spttv", "nnz"), ("spmttkrp", "rows"), ("spmttkrp", "nnz"))
# lowered cells, then the dense sums driven through kernels.ops ("ops")
ADD_CELLS = (("spadd3", "rows"), ("spadd3", "nnz"), ("spadd3_bcsr", "rows"),
             ("spadd3_bcsr", "nnz"), ("spadd3_dense", "ops"),
             ("spadd3_bcsr_dense", "ops"))
BLOCKED_CELLS = (("spmv_bcsr", "rows"), ("spmv_bcsr", "nnz"),
                 ("spmm_bcsr", "rows"), ("spmm_bcsr", "nnz"),
                 ("sddmm_bcsr", "rows"), ("sddmm_bcsr", "nnz"))
# the kernels each path must launch
PATH_KERNELS = {"matrix": ("spmv_csr_rows", "spmv_coo_nnz", "spmm_csr_rows",
                           "spmm_coo_nnz"),
                "slice": ("sddmm_coo", "spmttkrp_coo", "spmv_csr_rows"),
                "add": ("spadd3_union_rows", "spadd3_union_nnz",
                        "bcsr_spadd3_union_rows", "bcsr_spadd3_union_nnz",
                        "spadd3_dense_rows", "bcsr_spadd3_dense_rows"),
                "blocked": ("bcsr_spmv", "bcsr_spmm", "bcsr_sddmm"),
                "attention": ("flash_attention",)}


def phase(tag: str, /, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


# ---------------------------------------------------------------------------
# Tolerance and timing
# ---------------------------------------------------------------------------

def check_rows(name: str, got, want, scale) -> float:
    """Per-entry check |got - want| <= RTOL_ROW * scale + ATOL, where
    ``scale`` is the same computation on absolute values; returns the max
    abs error. Computed in float64 on ``got``'s device, in chunks (a dense
    SpAdd3 result holds 2^30 entries)."""
    import torch
    dev = got.device if torch.is_tensor(got) else torch.device("cpu")
    got, want, scale = (torch.as_tensor(x).to(dev)
                        for x in (got, want, scale))
    if got.shape != want.shape or got.shape != scale.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    got, want, scale = (x.reshape(-1) for x in (got, want, scale))
    worst, step = 0.0, 1 << 26
    for lo in range(0, got.numel(), step):
        g, w, sc = (x[lo:lo + step].double() for x in (got, want, scale))
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite values")
        err = (g - w).abs()
        bad = err > RTOL_ROW * sc + ATOL
        if bad.any():
            i = int(bad.nonzero()[0])
            raise AssertionError(
                f"{name}: {int(bad.sum())} entries off; first at flat index "
                f"{lo + i}: got {g[i]} want {w[i]} scale {sc[i]}")
        if err.numel():
            worst = max(worst, float(err.max()))
    return worst


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_events(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``reps`` calls, each timed by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_host(fn, device, reps: int, warmup: int = 1,
              budget_s: float = 20.0) -> float:
    """Median milliseconds of up to ``reps`` calls on the host clock, each
    ending in a device synchronize; stops after ``budget_s`` seconds once 3
    calls are timed (a run() with host assembly takes seconds)."""
    for _ in range(warmup):
        fn()
    _sync(device)
    times = []
    t_end = time.perf_counter() + budget_s
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        if len(times) >= 3 and time.perf_counter() > t_end:
            break
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _abs_args(args):
    import torch
    return [a.abs() if torch.is_tensor(a) and a.is_floating_point() else a
            for a in args]


def kernel_cases(rng, device):
    """Edge-case batched inputs per kernel: (label, kernel name, args,
    args with absolute values for the tolerance). Pieces of one batch share
    R and the padded entry count N; one piece of every batch is empty,
    every matrix has an empty row, the (4, 300) one a row longer than 128
    entries; the SpMTTKRP streams have an empty row and rows longer than
    one and than two 256-entry segments."""
    import numpy as np
    import torch

    def csr(n, m, density):
        d = ((rng.random((n, m)) < density)
             * rng.standard_normal((n, m))).astype(np.float32)
        d[rng.integers(0, n)] = 0                                # empty row
        d[rng.integers(0, n)] = rng.standard_normal(m)           # dense row
        rows, cols = np.nonzero(d)
        pos = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=pos[1:])
        return pos, cols, d[rows, cols]

    def stack(pieces, R, N):
        P = len(pieces)
        pos = np.zeros((P, R + 1), np.int32)
        crd = np.zeros((P, N), np.int32)
        vals = np.zeros((P, N), np.float32)
        for p, (pp, cc, vv) in enumerate(pieces):
            pos[p, :pp.shape[0]] = pp
            pos[p, pp.shape[0]:] = pp[-1]
            crd[p, :cc.shape[0]] = cc
            vals[p, :vv.shape[0]] = vv
        return pos, crd, vals

    def dev(*xs):
        return [torch.as_tensor(x).to(device).contiguous() for x in xs]

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    shapes = [(8, 8), (37, 53), (64, 128), (130, 65), (1, 7), (256, 17),
              (4, 300)]
    for n, m in shapes:
        mats = [csr(n, m, 0.3), (np.zeros(n + 1, np.int64),
                                 np.zeros(0, np.int64),
                                 np.zeros(0, np.float32)), csr(n, m, 0.05)]
        N = max(1, max(x[1].shape[0] for x in mats))
        pos, crd, vals = stack(mats, n, N)
        c = normal(m)
        pos_t, crd_t, vals_t, c_t = dev(pos, crd, vals, c)
        yield (f"spmv_csr_rows {n}x{m}", "spmv_csr_rows",
               (pos_t, crd_t, vals_t, c_t),
               (pos_t, crd_t, vals_t.abs(), c_t.abs()))
        # the nnz kernel's input: row-sorted rebased rows, padding dropped
        rows = np.full((3, N), n, np.int32)
        for p in range(3):
            cnt = int(pos[p, -1])
            rows[p, :cnt] = np.repeat(np.arange(n), np.diff(pos[p]))
        rows_t, = dev(rows)
        yield (f"spmv_coo_nnz {n}x{m}", "spmv_coo_nnz",
               (rows_t, crd_t, vals_t, c_t, n),
               (rows_t, crd_t, vals_t.abs(), c_t.abs(), n))
        for J in (1, 16, 130):
            C_t, = dev(normal(m, J))
            yield (f"spmm_csr_rows {n}x{m} J={J}", "spmm_csr_rows",
                   (pos_t, crd_t, vals_t, C_t),
                   (pos_t, crd_t, vals_t.abs(), C_t.abs()))
            yield (f"spmm_coo_nnz {n}x{m} J={J}", "spmm_coo_nnz",
                   (rows_t, crd_t, vals_t, C_t, n),
                   (rows_t, crd_t, vals_t.abs(), C_t.abs(), n))
        # SDDMM over the same pieces: C shared (nnz) or per piece (rows)
        srows_t, = dev(np.minimum(rows, n - 1))
        for K, shared in ((1, True), (7, False), (32, True), (33, False)):
            C_t, Dt_t = dev(normal(n, K) if shared else normal(3, n, K),
                            normal(m, K))
            args = (srows_t, crd_t, vals_t, C_t, Dt_t)
            yield (f"sddmm_coo {n}x{m} K={K} "
                   f"{'shared' if shared else 'per-piece'}", "sddmm_coo",
                   args, _abs_args(args))

    # SpMTTKRP streams: three pieces, the middle one empty; row lengths
    # with an empty row, rows across one and two segment edges, a run that
    # starts on a segment edge, and a piece that is one row
    R, J, K = 40, 50, 30
    counts = rng.integers(0, 20, R)
    counts[[3, 7, 8, 20]] = [0, 700, 256, 300]
    lens = [counts, np.zeros(R, np.int64),
            np.bincount([R - 1] * 900, minlength=R)]
    N = int(max(x.sum() for x in lens)) + 5                  # a padding tail
    rows = np.full((3, N), R, np.int32)
    for p, cnt in enumerate(lens):
        rows[p, :cnt.sum()] = np.repeat(np.arange(R), cnt)
    jj = rng.integers(0, J, (3, N)).astype(np.int32)
    kk = rng.integers(0, K, (3, N)).astype(np.int32)
    vals = np.where(rows < R, normal(3, N), 0).astype(np.float32)
    rows_t, jj_t, kk_t, vals_t = dev(rows, jj, kk, vals)
    for L in (1, 7, 32, 33):
        C_t, D_t = dev(normal(J, L), normal(K, L))
        args = (rows_t, jj_t, kk_t, vals_t, C_t, D_t, R)
        yield (f"spmttkrp_coo R={R} N={N} L={L}", "spmttkrp_coo", args,
               _abs_args(args))
        # the same streams through the SpMM nnz kernel: runs across one and
        # two 256-entry segments and starting on a segment edge
        args = (rows_t, jj_t, vals_t, C_t, R)
        yield (f"spmm_coo_nnz R={R} N={N} J={L}", "spmm_coo_nnz", args,
               _abs_args(args))
    yield from spadd3_cases(rng, device)
    yield from bcsr_cases(rng, device)
    yield from flash_cases(rng, device)


def _addends(rng, n, m, tile=()):
    """Three operands' (rows, cols, vals) of an n x m (block) grid with the
    edge cases of SpAdd3: row 1 empty in all three, row 3 longer than two
    256-entry merge tasks, coordinates in all three operands, one in B and
    C whose sum cancels to 0, and operand D empty in rows >= n // 2."""
    import numpy as np
    out = []
    for t in range(3):
        d = rng.random((n, m)) < 0.25
        if n > 3:
            d[1] = False
            d[3] = rng.random(m) < 0.9                 # a long row
        d[0, :5] = True                                # in all three
        if t == 2:
            d[n // 2:] = False
        r, c = np.nonzero(d)
        out.append((r, c, rng.standard_normal((r.shape[0],) + tile)
                    .astype(np.float32)))
    (r0, c0, v0), (r1, c1, v1) = out[:2]
    k0 = np.flatnonzero((r0 == 2) & (c0 == 7))
    k1 = np.flatnonzero((r1 == 2) & (c1 == 7))
    if k0.size and k1.size:
        v1[k1] = -v0[k0]                               # cancels to 0
    return out


def _csr_of(n, rows, cols, vals):
    import numpy as np
    pos = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=n), out=pos[1:])
    return pos, cols.astype(np.int32), vals


def spadd3_cases(rng, device):
    """SpAdd3 edge cases: the dense kernels on CSR / BCSR operands with a
    ragged last block row and column; the rows union over three pieces
    (the middle one empty, operand D empty in a whole piece, shard padding
    filled with values that would show if read, a row longer than one merge
    task); the nnz runs over an add stream with duplicates inside and
    across chunks and an empty chunk."""
    import numpy as np
    import torch
    from repro_torch.kernels import spadd3

    def dev(*xs):
        return [torch.as_tensor(x).to(device).contiguous() for x in xs]

    for (n, m), block in (((37, 600), None), ((1, 7), None),
                          ((130, 45), (2, 2)), ((37, 53), (4, 4))):
        br, bc = block or (1, 1)
        tri = [_csr_of(-(-n // br), *x) for x in
               _addends(rng, -(-n // br), -(-m // bc), tuple(block or ()))]
        args = tuple(dev(*(x for t in tri for x in t))) + (n, m)
        name = "bcsr_spadd3_dense_rows" if block else "spadd3_dense_rows"
        yield (f"{name} {n}x{m} block={block}", name, args, _abs_args(args))
    P, R, garbage = 3, 40, 1e30
    for block in (None, (2, 2), (4, 4)):
        tile = tuple(block or ())
        pieces = [_addends(rng, R, 300, tile), None, _addends(rng, R, 300,
                                                               tile)]
        pieces[2][2] = tuple(x[:0] for x in pieces[2][2])   # D empty
        flat = []
        for t in range(3):
            N = max(x[t][0].shape[0] for x in pieces if x) + 7
            pos = np.zeros((P, R + 1), np.int32)
            crd = np.full((P, N), 1 << 30, np.int32)      # never read
            vals = np.full((P, N) + tile, garbage, np.float32)
            for p, x in enumerate(pieces):
                if x is not None:
                    pp, cc, vv = _csr_of(R, *x[t])
                    pos[p], crd[p, :cc.shape[0]] = pp, cc
                    vals[p, :cc.shape[0]] = vv
            flat += dev(pos, crd, vals)
        name = "bcsr_spadd3_union_rows" if block else "spadd3_union_rows"
        yield (f"{name} P={P} R={R} block={block}", name, tuple(flat),
               _abs_args(flat))
        # nnz: a 4-chunk add stream, chunk 2 empty, padding garbage
        rr, cc, vv = (np.concatenate(x) for x in zip(*pieces[0]))
        C = -(-rr.shape[0] // 3) + 5
        dims = np.zeros((2, 4, C), np.int32)
        svals = np.full((4, C) + tile, garbage, np.float32)
        counts = np.zeros(4, np.int32)
        for p, (lo, hi) in zip((0, 1, 3), ((0, C - 5), (C - 5, 2 * C - 10),
                                           (2 * C - 10, rr.shape[0]))):
            counts[p] = hi - lo
            dims[0, p, :hi - lo], dims[1, p, :hi - lo] = rr[lo:hi], cc[lo:hi]
            svals[p, :hi - lo] = vv[lo:hi]
        d0, d1, cnt, sv = dev(dims[0], dims[1], counts, svals)
        perm, seg_ptr, run_ptr, _, _ = spadd3.plan_runs(d0, d1, cnt,
                                                        (R, 300))
        args = (sv, perm, seg_ptr, run_ptr)
        name = "bcsr_spadd3_union_nnz" if block else "spadd3_union_nnz"
        yield (f"{name} chunks=4 block={block}", name, args,
               _abs_args(args))


def bcsr_cases(rng, device):
    """Blocked SpMV, SpMM and SDDMM edge cases over three pieces per block
    shape: piece 0 holds an empty block-row, a run that ends on the last
    block of segment 0, one that starts on the first block of segment 1
    and spans four segments, one cut by a segment edge and one that ends
    on a 32-block chunk edge inside a segment; piece 1 is empty; piece 2
    has a run ending on the first chunk edge and a block-row longer than
    two segments. Padding slots
    carry the dropped id R, huge block-columns and 1e30 tiles, which
    must not reach a sum. The dense operands are packed from matrices whose
    side is not a multiple of the block (a ragged last block-row and
    block-column)."""
    import numpy as np
    import torch
    from repro_torch.kernels.layout import (pack_mat_inner_blocks,
                                            pack_mat_row_blocks,
                                            pack_vec_blocks)

    def dev(*xs):
        return [torch.as_tensor(x).to(device).contiguous() for x in xs]

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    P, R, grid_cols = 3, 12, 9
    lens = [np.array([3, 0, 125, 400, 128, 7, 0, 2, 7, 30, 0, 5]),
            np.zeros(R, np.int64),
            np.array([0, 32, 300, 0, 0, 0, 0, 0, 0, 0, 2, 0])]
    N = int(max(x.sum() for x in lens)) + 9                  # a padding tail
    brow = np.full((P, N), R, np.int32)
    bcol = np.full((P, N), 1 << 30, np.int32)
    for p, cnt in enumerate(lens):
        brow[p, :cnt.sum()] = np.repeat(np.arange(R), cnt)
        bcol[p, :cnt.sum()] = rng.integers(0, grid_cols, cnt.sum())
    for br, bc in ((2, 2), (4, 4), (4, 8)):
        tiles = np.where((brow < R)[:, :, None, None], normal(P, N, br, bc),
                         np.float32(1e30)).astype(np.float32)
        n, m = R * br - 1, grid_cols * bc - 3                  # ragged
        brow_t, bcol_t, tiles_t = dev(brow, bcol, tiles)
        c_t, = dev(pack_vec_blocks(normal(m), grid_cols, bc))
        label = f"P={P} N={N} block=({br}, {bc})"
        yield (f"bcsr_spmv {label}", "bcsr_spmv",
               (brow_t, bcol_t, tiles_t, c_t, R),
               (brow_t, bcol_t, tiles_t.abs(), c_t.abs(), R))
        for J in (1, 16, 33):
            C_t, = dev(pack_mat_row_blocks(normal(m, J), grid_cols, bc))
            yield (f"bcsr_spmm {label} J={J}", "bcsr_spmm",
                   (brow_t, bcol_t, tiles_t, C_t, R),
                   (brow_t, bcol_t, tiles_t.abs(), C_t.abs(), R))
        # SDDMM reads every slot: zero tiles on the padding, as the shards
        for K, shared in ((1, True), (7, False), (32, True), (33, False)):
            Cm = pack_mat_row_blocks(normal(n, K), R, br).reshape(R * br, K)
            if not shared:
                Cm = np.stack([pack_mat_row_blocks(normal(n, K), R, br)
                               .reshape(R * br, K) for _ in range(P)])
            Dt = pack_mat_inner_blocks(normal(K, m), grid_cols, bc) \
                .transpose(0, 2, 1).reshape(grid_cols * bc, K)
            args = tuple(dev(brow, bcol, np.where(tiles < 1e29, tiles, 0),
                             Cm, Dt))
            yield (f"bcsr_sddmm {label} K={K} "
                   f"{'shared' if shared else 'per-piece'}", "bcsr_sddmm",
                   args, _abs_args(args))


# tests/test_flash_kernel.py's cases (B, S, H, Hkv, hd) and dtypes, with
# hd 128 added: G in {1, 2, 3, 4, 8}, ragged S = 200 and 100
FLASH_CASES = ((2, 256, 4, 2, 32, "float32"), (1, 200, 8, 8, 16, "float32"),
               (2, 384, 6, 2, 64, "float32"), (1, 128, 16, 2, 32, "float32"),
               (2, 256, 4, 2, 64, "bfloat16"), (1, 100, 2, 1, 16, "float32"),
               (2, 200, 8, 2, 128, "float32"), (2, 200, 8, 2, 128, "bfloat16"),
               (1, 300, 32, 8, 128, "float32"),
               (1, 300, 32, 8, 128, "bfloat16"))
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # atol = rtol


def flash_cases(rng, device):
    """flash_attention's edge cases: standard-normal q, k, v (made in
    float32 and cast) per FLASH_CASES."""
    import numpy as np
    import torch
    for B, S, H, Hkv, hd, dt in FLASH_CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=getattr(torch, dt))
            for shape in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
        yield (f"flash_attention B={B} S={S} H={H} Hkv={Hkv} hd={hd} {dt}",
               "flash_attention", (q, k, v), None)


def compare_flash(label, got, want, q, v) -> float:
    """flash_attention's result against its plain version's, entry by entry
    at FLASH_TOL (atol = rtol) of q's dtype, and its first position against
    v there (row 0 attends only to itself); returns the max abs error."""
    import torch
    tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
    if got.shape != want.shape or got.dtype != q.dtype:
        raise AssertionError(f"{label}: {tuple(got.shape)} {got.dtype}, "
                             f"want {tuple(want.shape)} {q.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{label}: non-finite values")
    err = (g - w).abs()
    bad = err > tol + tol * w.abs()
    if bad.any():
        raise AssertionError(f"{label}: {int(bad.sum())} entries off by up "
                             f"to {float(err.max())} (tolerance {tol})")
    G = q.shape[2] // v.shape[2]
    first = v[:, 0].float().repeat_interleave(G, dim=1)
    if not torch.allclose(g[:, 0], first, atol=1e-5, rtol=1e-5):
        raise AssertionError(f"{label}: position 0 is not v[0]")
    return float(err.max()) if err.numel() else 0.0


def kernel_fns():
    from repro_torch.kernels import (bcsr, flash_attention, sddmm, spadd3,
                                     spmm, spmttkrp, spmv)
    return {
        "spmv_csr_rows": (spmv.spmv_csr_rows, spmv.spmv_csr_rows_plain),
        "spmv_coo_nnz": (spmv.spmv_coo_nnz, spmv.spmv_coo_nnz_plain),
        "spmm_csr_rows": (spmm.spmm_csr_rows, spmm.spmm_csr_rows_plain),
        "spmm_coo_nnz": (spmm.spmm_coo_nnz, spmm.spmm_coo_nnz_plain),
        "sddmm_coo": (sddmm.sddmm_coo, sddmm.sddmm_coo_plain),
        "spmttkrp_coo": (spmttkrp.spmttkrp_coo,
                         spmttkrp.spmttkrp_coo_plain),
        "spadd3_dense_rows": (spadd3.spadd3_dense_rows,
                              spadd3.spadd3_dense_rows_plain),
        "bcsr_spadd3_dense_rows": (spadd3.bcsr_spadd3_dense_rows,
                                   spadd3.bcsr_spadd3_dense_rows_plain),
        "spadd3_union_rows": (spadd3.spadd3_union_rows,
                              spadd3.spadd3_union_rows_plain),
        "bcsr_spadd3_union_rows": (spadd3.bcsr_spadd3_union_rows,
                                   spadd3.bcsr_spadd3_union_rows_plain),
        "spadd3_union_nnz": (spadd3.spadd3_union_nnz,
                             spadd3.union_runs_plain),
        "bcsr_spadd3_union_nnz": (spadd3.bcsr_spadd3_union_nnz,
                                  spadd3.union_runs_plain),
        "bcsr_spmv": (bcsr.bcsr_spmv, bcsr.bcsr_spmv_plain),
        "bcsr_spmm": (bcsr.bcsr_spmm, bcsr.bcsr_spmm_plain),
        "bcsr_sddmm": (bcsr.bcsr_sddmm, bcsr.bcsr_sddmm_plain),
        "flash_attention": (flash_attention.flash_attention,
                            flash_attention.flash_attention_plain),
    }


def compare_kernel(label, name, args, abs_args) -> float:
    """A kernel's result against its plain version's on the same inputs.
    A compressed result (pos, crd, vals) must have the plain version's
    pattern exactly; the values are held to the per-entry tolerance
    (flash_attention's to its own, :func:`compare_flash`)."""
    import torch
    kernel, plain = kernel_fns()[name]
    got = kernel(*args)
    want = plain(*args)
    if name == "flash_attention":
        _sync(got.device)
        return compare_flash(label, got, want, args[0], args[2])
    scale = plain(*abs_args)
    if isinstance(got, tuple):
        for g, w in zip(got[:-1], want[:-1]):
            if not torch.equal(g.long(), w.long()):
                raise AssertionError(f"{label}: the pattern differs from "
                                     "the plain version's")
        got, want, scale = got[-1], want[-1], scale[-1]
    _sync(got.device)
    return check_rows(label, got, want, scale)


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def make_inputs(n: int, avg_nnz: int, J: int, seed: int,
                dims3=None, rank: int = RANK):
    """The operands, all from ``seed``: the sparse matrix B (reference
    generator, CSR) with c (m,), C (m, J) and SDDMM's Cs (n, K), Ds (K, m);
    when ``dims3`` is given, the 3-tensor B3 (CSF) with c3 (K3,),
    C3 (J3, L) and D3 (K3, L)."""
    import numpy as np
    from repro_torch.data.spdata import powerlaw_matrix, powerlaw_tensor3
    data = {"B": powerlaw_matrix("B", n, n, avg_nnz, alpha=1.6, seed=seed)}
    rng = np.random.default_rng(seed + 1)
    data["c"] = rng.standard_normal(n).astype(np.float32)
    data["C"] = rng.standard_normal((n, J)).astype(np.float32)
    data["Cs"] = rng.standard_normal((n, rank)).astype(np.float32)
    data["Ds"] = rng.standard_normal((rank, n)).astype(np.float32)
    if dims3 is not None:
        data["B3"] = powerlaw_tensor3("B", dims3, avg_nnz_per_slice=AVG_SLICE,
                                      alpha=1.8, seed=seed)
        rng = np.random.default_rng(seed + 1)
        data["c3"] = rng.standard_normal(dims3[2]).astype(np.float32)
        data["C3"] = rng.standard_normal((dims3[1], rank)).astype(np.float32)
        data["D3"] = rng.standard_normal((dims3[2], rank)).astype(np.float32)
    return data


def _shifted(T, name: str, shift: int, seed: int):
    """T's pattern (blocks for a blocked T) with every column moved right by
    ``shift`` (mod the width) and fresh standard-normal values or tiles
    from ``seed``."""
    import numpy as np
    import repro_torch.core as tc
    rng = np.random.default_rng(seed)
    if T.format.is_blocked:
        bc = T.block_coords().astype(np.int64)
        bc[:, 1] = (bc[:, 1] + shift) % T.levels[1].size
        tiles = rng.standard_normal(T.vals.shape).astype(np.float32)
        return tc.Tensor.from_blocks(name, T.shape, T.format, bc, tiles,
                                     dedupe=False)
    coords = T.coords().astype(np.int64)
    coords[:, 1] = (coords[:, 1] + shift) % T.shape[1]
    vals = rng.standard_normal(T.nnz).astype(np.float32)
    return tc.Tensor.from_coo(name, T.shape, coords, vals, T.format,
                              dedupe=False)


def add_operands(n: int, seed: int, B=None):
    """SpAdd3's addends, all from ``seed``: the scalar ones (B, B shifted by
    one and by two columns, CSR; ``B`` is the matrix path's when given) and
    the blocked ones (BCSR((4, 4)) over n x n: the block pattern of
    ``powerlaw_matrix`` (n / 4, 4 blocks per block-row), normal tiles, and
    its shifts by one and two block columns)."""
    import numpy as np
    import repro_torch.core as tc
    from repro_torch.data.spdata import powerlaw_matrix
    if B is None:
        B = powerlaw_matrix("B", n, n, AVG_NNZ, alpha=1.6, seed=seed)
    g = n // ADD_BLOCK[0]
    grid = powerlaw_matrix("Bg", g, g, AVG_BLOCKS, alpha=1.6, seed=seed)
    Bb = tc.Tensor.from_blocks(
        "B", (n, n), tc.BCSR(ADD_BLOCK), grid.coords(),
        np.random.default_rng(seed + 1).standard_normal(
            (grid.nnz,) + ADD_BLOCK).astype(np.float32), dedupe=False)
    return {"scalar": (B, _shifted(B, "C", 1, seed + 1),
                       _shifted(B, "D", 2, seed + 2)),
            "blocked": (Bb, _shifted(Bb, "C", 1, seed + 2),
                        _shifted(Bb, "D", 2, seed + 3))}


def statements(data):
    import numpy as np
    import repro_torch.core as tc
    B = data["B"]
    n, m = B.shape
    J = data["C"].shape[1]
    dense = tc.Tensor.from_dense
    out = {
        "spmv": tc.parse_tin("a(i) = B(i,j) * c(j)",
                             a=tc.Tensor.zeros_dense("a", (n,)), B=B,
                             c=dense("c", data["c"])),
        "spmm": tc.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                             A=tc.Tensor.zeros_dense("A", (n, J)), B=B,
                             C=dense("C", data["C"])),
        # the output is declared CSR with B's pattern (tests/conformance.py)
        "sddmm": tc.parse_tin(
            "A(i,j) = B(i,j) * C(i,k) * D(k,j)",
            A=tc.Tensor("A", B.shape, B.format, B.levels,
                        np.ones_like(B.vals)),
            B=B, C=dense("C", data["Cs"]), D=dense("D", data["Ds"])),
    }
    if "B3" in data:
        B3 = data["B3"]
        out["spttv"] = tc.parse_tin(
            "A(i,j) = B(i,j,k) * c(k)",
            A=tc.Tensor.from_coo("A", B3.shape[:2], np.zeros((0, 2)),
                                 np.zeros(0, np.float32), tc.CSR()),
            B=B3, c=dense("c", data["c3"]))
        out["spmttkrp"] = tc.parse_tin(
            "A(i,l) = B(i,j,k) * C(j,l) * D(k,l)",
            A=tc.Tensor.zeros_dense("A", (B3.shape[0],
                                          data["C3"].shape[1])),
            B=B3, C=dense("C", data["C3"]), D=dense("D", data["D3"]))
    if "blocked" in data.get("add", {}):
        # the blocked path: the add path's BCSR B and the dense operands
        Bb = data["add"]["blocked"][0]
        out["spmv_bcsr"] = tc.parse_tin(
            "a(i) = B(i,j) * c(j)", a=tc.Tensor.zeros_dense("a", (n,)), B=Bb,
            c=dense("c", data["c"]))
        out["spmm_bcsr"] = tc.parse_tin(
            "A(i,j) = B(i,k) * C(k,j)", A=tc.Tensor.zeros_dense("A", (n, J)),
            B=Bb, C=dense("C", data["C"]))
        # the output keeps B's blocks (its values are not read)
        out["sddmm_bcsr"] = tc.parse_tin(
            "A(i,j) = B(i,j) * C(i,k) * D(k,j)",
            A=tc.Tensor("A", Bb.shape, Bb.format, Bb.levels, Bb.vals),
            B=Bb, C=dense("C", data["Cs"]), D=dense("D", data["Ds"]))
    for kind, expr in (("scalar", "spadd3"), ("blocked", "spadd3_bcsr")):
        if kind in data.get("add", {}):
            ops_ = dict(zip("BCD", data["add"][kind]))
            out[expr] = tc.parse_tin(
                "A(i,j) = B(i,j) + C(i,j) + D(i,j)",
                A=tc.Tensor.from_coo("A", ops_["B"].shape, np.zeros((0, 2)),
                                     np.zeros(0, np.float32), tc.CSR()),
                **ops_)
    return out


def _same_bits(a, b) -> bool:
    import numpy as np
    import torch
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return np.array_equal(a.vals, b.vals) and all(
        (x.pos is None or np.array_equal(x.pos, y.pos))
        and (x.crd is None or np.array_equal(x.crd, y.crd))
        for x, y in zip(a.levels, b.levels))


def dense_call(data, expr: str, device):
    """(wrapper name, ops entry point, its arguments) of a dense SpAdd3
    cell: the three operands' storage, on the device."""
    import torch
    from repro_torch.kernels import ops
    ts = data["dense"]["blocked" if "bcsr" in expr else "scalar"]
    n, m = ts[0].shape
    trips = tuple(tuple(torch.as_tensor(x).to(device) for x in
                        (t.levels[1].pos, t.levels[1].crd, t.vals))
                  for t in ts)
    if "bcsr" in expr:
        return "bcsr_spadd3_dense_rows", ops.spadd3_bcsr_dense, trips + (n, m)
    return "spadd3_dense_rows", ops.spadd3_dense, trips + (n, m)


def drive_dense(data, expr: str, device, reps: int):
    """A dense SpAdd3 cell through ``kernels.ops`` (no lowering: the
    reference reaches its TPU kernels only there)."""
    import torch
    name, entry, args = dense_call(data, expr, device)
    calls = []

    def run():
        calls.append(1)
        return entry(*args, impl="cuda" if device.type == "cuda"
                     else "torch", device=device)

    base = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    run_ms = time_host(run, device, reps)
    res = run()
    bitwise = torch.equal(res, run())
    _sync(device)
    return {"kernel": None, "cold_s": 0.0, "warm_s": 0.0, "run_ms": run_ms,
            "runs": len(calls), "out": res, "bitwise": bitwise,
            "call": (name, tuple(x for t in args[:3] for x in t)
                     + args[3:]),
            "max_mem": (torch.cuda.max_memory_allocated(device) - base
                        if device.type == "cuda" else 0)}


def drive(stmts, cells, pieces: int, device, reps: int, data=None):
    """Lower (cold, then warm) and run each cell through the public entry
    points (the dense SpAdd3 cells through ``kernels.ops``). Returns
    {cell: record}."""
    import torch
    import repro_torch.core as tc
    from repro_torch.core import lower as L

    machine = tc.Machine(("x", pieces))
    out = {}
    for expr, strat in cells:
        if strat == "ops":
            out[f"{expr}/{strat}"] = drive_dense(data, expr, device, reps)
            continue
        stmt = stmts[expr]
        sched = (L.default_row_schedule if strat == "rows"
                 else L.default_nnz_schedule)(stmt, machine)
        base = 0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        L.clear_lowering_caches()
        t0 = time.perf_counter()
        k = L.lower(stmt, machine, schedule=sched, device=device)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        k = L.lower(stmt, machine, schedule=sched, device=device)
        warm_s = time.perf_counter() - t0
        if not k.cache.warm:
            raise AssertionError(f"{k.cell_id()}: warm re-lower missed a "
                                 f"cache: {k.cache.as_dict()}")
        calls = []

        def run(k=k, calls=calls):
            calls.append(1)
            return k.run()

        run_ms = time_host(run, device, reps)
        res, again = run(), run()
        _sync(device)
        out[f"{expr}/{strat}"] = {
            "kernel": k, "cold_s": cold_s, "warm_s": warm_s,
            "run_ms": run_ms, "runs": len(calls), "out": res,
            "bitwise": _same_bits(res, again), "call": leaf_call(k),
            # this cell's own peak, above what earlier cells still hold
            "max_mem": (torch.cuda.max_memory_allocated(device) - base
                        if device.type == "cuda" else 0)}
    return out


def reference_products(data, exprs):
    """float64 host results of ``exprs`` and their scales (the same
    computation on absolute values): SpMV and SpMM with np.bincount over the
    CSR arrays, SDDMM per stored entry in chunks, SpTTV per (i, j) fibre and
    SpMTTKRP per row of the 3-tensor."""
    import numpy as np
    out = {}

    def per_column(seg, w, gather, n_out, n_cols):
        """np.bincount of w·gather(l) per column l: (n_out, n_cols) and its
        scale."""
        Y = np.empty((n_out, n_cols))
        S = np.empty_like(Y)
        for l in range(n_cols):
            t = w * gather(l)
            Y[:, l] = np.bincount(seg, t, minlength=n_out)
            S[:, l] = np.bincount(seg, np.abs(t), minlength=n_out)
        return Y, S

    B = data["B"]
    n = B.shape[0]
    pos, crd = B.levels[1].pos, B.levels[1].crd
    rows = np.repeat(np.arange(n), np.diff(pos))
    v = B.vals.astype(np.float64)
    if "spmv" in exprs:
        out["spmv"] = per_column(rows, v, lambda _: data["c"][crd], n, 1)
        out["spmv"] = tuple(x[:, 0] for x in out["spmv"])
    if "spmm" in exprs:
        C = data["C"]
        out["spmm"] = per_column(rows, v, lambda l: C[:, l][crd], n,
                                 C.shape[1])
    if "sddmm" in exprs:
        Cs = data["Cs"].astype(np.float64)
        Ds = data["Ds"].T.astype(np.float64)
        want, scale = np.empty(B.nnz), np.empty(B.nnz)
        for lo in range(0, B.nnz, 1 << 20):
            hi = min(lo + (1 << 20), B.nnz)
            prod = Cs[rows[lo:hi]] * Ds[crd[lo:hi]]
            want[lo:hi] = v[lo:hi] * prod.sum(1)
            scale[lo:hi] = np.abs(v[lo:hi]) * np.abs(prod).sum(1)
        out["sddmm"] = (want, scale)
    if "spttv" in exprs or "spmttkrp" in exprs:
        B3 = data["B3"]
        p1, c1 = B3.levels[1].pos, B3.levels[1].crd
        p2, c2 = B3.levels[2].pos, B3.levels[2].crd
        ij = np.repeat(np.arange(c1.shape[0]), np.diff(p2))
        v3 = B3.vals.astype(np.float64)
        c3 = data["c3"]
        out["spttv"] = tuple(x[:, 0] for x in per_column(
            ij, v3, lambda _: c3[c2], c1.shape[0], 1))
        i = np.repeat(np.arange(B3.shape[0]), np.diff(p1))[ij]
        j = c1[ij]
        C3, D3 = data["C3"], data["D3"]
        out["spmttkrp"] = per_column(
            i, v3, lambda l: C3[:, l][j].astype(np.float64) * D3[:, l][c2],
            B3.shape[0], C3.shape[1])
    if {"spmv_bcsr", "spmm_bcsr", "sddmm_bcsr"} & set(exprs):
        Bb = data["add"]["blocked"][0]
        if "spmv_bcsr" in exprs:
            y, sc = blocked_products(Bb, data["c"][:, None])
            out["spmv_bcsr"] = (y[:, 0], sc[:, 0])
        if "spmm_bcsr" in exprs:
            out["spmm_bcsr"] = blocked_products(Bb, data["C"])
        if "sddmm_bcsr" in exprs:
            out["sddmm_bcsr"] = blocked_sampled(Bb, data["Cs"], data["Ds"])
    for expr, (where, kind) in ADD_SOURCES.items():
        if expr in exprs:
            out[expr] = host_union(data[where][kind])
    return out


def blocked_products(T, X, step: int = 1 << 17):
    """float64 host T @ X (n, J) and its scale for a BCSR T, in chunks of
    stored blocks: each chunk's (br, bc) @ (bc, J) products summed per
    block-row (the blocks are stored block-row by block-row)."""
    import numpy as np
    br, bc = T.format.block_shape
    n, m = T.shape
    brow, bcol = T.block_coords().astype(np.int64).T
    Xb = np.zeros((-(-m // bc) * bc, X.shape[1]))
    Xb[:m] = X
    Xb = Xb.reshape(-1, bc, X.shape[1])
    Y = np.zeros((-(-n // br), br, X.shape[1]))
    S = np.zeros_like(Y)
    for lo in range(0, brow.shape[0], step):
        b, t = brow[lo:lo + step], T.vals[lo:lo + step].astype(np.float64)
        xg = Xb[bcol[lo:lo + step]]
        start = np.flatnonzero(np.r_[True, b[1:] != b[:-1]])
        Y[b[start]] += np.add.reduceat(t @ xg, start, axis=0)
        S[b[start]] += np.add.reduceat(np.abs(t) @ np.abs(xg), start, axis=0)
    return (Y.reshape(-1, X.shape[1])[:n], S.reshape(-1, X.shape[1])[:n])


def blocked_sampled(T, Cs, Ds, step: int = 1 << 17):
    """float64 host SDDMM over a BCSR T: each stored tile times the (br, bc)
    block of Cs @ Ds it samples, and the scale, in T's storage order."""
    import numpy as np
    br, bc = T.format.block_shape
    n, m = T.shape
    K = Cs.shape[1]
    brow, bcol = T.block_coords().astype(np.int64).T
    Cb = np.zeros((-(-n // br) * br, K))
    Cb[:n] = Cs
    Db = np.zeros((-(-m // bc) * bc, K))
    Db[:m] = Ds.T
    Cb, Db = Cb.reshape(-1, br, K), Db.reshape(-1, bc, K)
    want = np.empty(T.vals.shape)
    scale = np.empty(T.vals.shape)
    for lo in range(0, brow.shape[0], step):
        t = T.vals[lo:lo + step].astype(np.float64)
        cg, dg = Cb[brow[lo:lo + step]], Db[bcol[lo:lo + step]]
        want[lo:lo + step] = t * (cg @ dg.transpose(0, 2, 1))
        scale[lo:lo + step] = np.abs(t) * (np.abs(cg)
                                           @ np.abs(dg).transpose(0, 2, 1))
    return want, scale


# the SpAdd3 cells' operands: (data key, kind)
ADD_SOURCES = {"spadd3": ("add", "scalar"), "spadd3_bcsr": ("add", "blocked"),
               "spadd3_dense": ("dense", "scalar"),
               "spadd3_bcsr_dense": ("dense", "blocked")}


def host_union(ts):
    """The float64 union B + C + D of three row-major (B)CSR operands on the
    host: its compressed levels (pos over the root, crd), its values and
    their scale (the sum of absolute values), per stored entry or tile."""
    import numpy as np
    n_root, width = ts[0].levels[0].size, ts[0].levels[1].size
    tile = ts[0].vals.shape[1:]
    keys, vals = [], []
    for t in ts:
        pos = t.levels[1].pos
        keys.append(np.repeat(np.arange(n_root, dtype=np.int64),
                              np.diff(pos)) * width + t.levels[1].crd)
        vals.append(t.vals.reshape(t.vals.shape[0], -1))
    key = np.concatenate(keys)
    order = np.argsort(key, kind="stable")      # three sorted runs
    key = key[order]
    v = np.concatenate(vals)[order].astype(np.float64)
    start = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    ukey = key[start]
    pos = np.zeros(n_root + 1, np.int64)
    np.cumsum(np.bincount(ukey // width, minlength=n_root), out=pos[1:])
    shape = (-1,) + tuple(tile)
    return {"pos": pos, "crd": ukey % width,
            "vals": np.add.reduceat(v, start, axis=0).reshape(shape),
            "scale": np.add.reduceat(np.abs(v), start, axis=0).reshape(shape),
            "block": tile or (1, 1)}


def check_union(name: str, got, want) -> float:
    """A SpAdd3 result: a union Tensor must store exactly the host union's
    coordinates; a dense sum must hold the union's values at its cells and
    zero everywhere else."""
    import numpy as np
    import torch
    if not torch.is_tensor(got):
        for key in ("pos", "crd"):
            if not np.array_equal(getattr(got.levels[1], key), want[key]):
                raise AssertionError(f"{name}: stored {key} differs from "
                                     "the host union's")
        return check_rows(name, got.vals, want["vals"], want["scale"])
    br, bc = want["block"]
    n, m = got.shape
    brow = np.repeat(np.arange(want["pos"].shape[0] - 1), np.diff(
        want["pos"]))
    r = (brow[:, None] * br + np.arange(br)[None, :])[:, :, None]
    c = (want["crd"][:, None] * bc + np.arange(bc)[None, :])[:, None, :]
    r, c = np.broadcast_arrays(r, c)
    keep = ((r < n) & (c < m)).reshape(-1)
    rows, cols = (torch.from_numpy(x.reshape(-1)[keep]).to(got.device)
                  for x in (r, c))
    at = got[rows, cols]
    if int(torch.count_nonzero(got)) != int(torch.count_nonzero(at)):
        raise AssertionError(f"{name}: non-zero values outside the union")
    return check_rows(name, at, want["vals"].reshape(-1)[keep],
                      want["scale"].reshape(-1)[keep])


def check_cell(name: str, rec, data, want) -> float:
    """Hold one cell's result against the host computation. A sparse
    output must keep B's (i, j) pattern: SDDMM's values are compared in B's
    storage order, SpTTV's per (i, j) fibre of the 3-tensor."""
    import numpy as np
    expr = name.split("/")[0]
    got = rec["out"]
    if expr.startswith("spadd3"):
        if not rec["bitwise"]:
            raise AssertionError(f"{name}: two runs gave different bits")
        return check_union(name, got, want[expr])
    if expr.endswith("_bcsr") and not rec["bitwise"]:
        raise AssertionError(f"{name}: two run()s gave different bits")
    if expr in ("sddmm", "spttv", "sddmm_bcsr"):
        src = (data["B"] if expr == "sddmm" else data["B3"]
               if expr == "spttv" else data["add"]["blocked"][0])
        if expr != "spttv" and got.levels is not src.levels:
            raise AssertionError(f"{name}: the output lost B's pattern")
        if expr == "spttv":
            fibres = np.stack([np.repeat(np.arange(src.shape[0]),
                                         np.diff(src.levels[1].pos)),
                               src.levels[1].crd], 1)
            if not np.array_equal(got.coords(), fibres):
                raise AssertionError(f"{name}: the output's pattern is not "
                                     "B's (i, j) fibres")
        got = got.vals
    if (expr in ("sddmm", "spmttkrp") or name == "spmm/nnz") \
            and not rec["bitwise"]:
        raise AssertionError(f"{name}: two run()s gave different bits")
    return check_rows(name, got, *want[expr])


def leaf_call(k):
    """(kernel name, args) of the Hopper kernel a lowered cell launches, on
    the cell's own inputs; None for a leaf with no kernel (the flat SpTTV
    products)."""
    name = k.leaf_name
    if name.startswith(("bcsr_spmv", "bcsr_spmm")):
        # (brow, bcol, tiles, packed dense operand, max_brows)
        return name[:9], (*k.args[:4], int(k.args[4]))
    if name.startswith("bcsr_sddmm"):
        return "bcsr_sddmm", k.args[:5]
    if name in ("spadd3_rows", "bcsr_spadd3_rows"):
        return name.replace("_rows", "_union_rows"), k.args[:9]
    if name in ("spadd3_nnz", "bcsr_spadd3_nnz"):
        return name.replace("_nnz", "_union_nnz"), k.args[:4]
    max_rows = int(k.shards["B"].meta["max_rows"])
    if name in ("spmv_rows", "spttv_rows"):
        return "spmv_csr_rows", k.args[:4]
    if name == "spmv_nnz":
        return "spmv_coo_nnz", (*k.args[:4], max_rows)
    if name == "spmm_rows":
        return "spmm_csr_rows", k.args[:4]
    if name == "spmm_nnz":
        return "spmm_coo_nnz", (*k.args[:4], max_rows)
    if name.startswith("sddmm"):
        return "sddmm_coo", k.args[:5]
    if name.startswith("spmttkrp"):
        return "spmttkrp_coo", (*k.args[:6], max_rows)
    return None


def run_slice(data, cells, pieces: int, device, reps: int = 10):
    """Phase 4 for one path: drive its cells and check every result
    against the host computation. Returns ({cell: record}, launches), the
    launches of each kernel during the drive alone, read straight after
    it: on the card each cell's kernel must have launched once per
    ``run()`` and no other kernel at all, on the CPU none."""
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import _build
    device = resolve_device(device)
    before = dict(_build.LAUNCHES)
    recs = drive(statements(data), cells, pieces, device, reps, data)
    launches = {k: n - before[k] for k, n in _build.LAUNCHES.items()}
    expected = dict.fromkeys(launches, 0)
    for rec in recs.values():
        if rec["call"] is not None and device.type == "cuda":
            expected[rec["call"][0]] += rec["runs"]
    if launches != expected:
        raise AssertionError(f"launches during the drive {launches} are not "
                             f"one per run() of each cell's kernel: "
                             f"{expected}")
    want = reference_products(data, {expr for expr, _ in cells})
    for name, rec in recs.items():
        rec["max_abs_err"] = check_cell(name, rec, data, want)
    return recs, launches


# ---------------------------------------------------------------------------
# Phase 5: the kernels line
# ---------------------------------------------------------------------------

def _moved(name: str, args, nnz: int, n_out: int):
    """(bytes, f32 operations) of one kernel call: each input read once and
    each output written once (real entries and outputs), and the operations
    the data needs. For SpAdd3, ``nnz`` counts the three operands' stored
    entries (or blocks) and ``n_out`` the union's (dense: its cells)."""
    if "spadd3" in name and "union_nnz" not in name:
        tile = args[2][(0,) * (1 if "dense" in name else 2)].numel()
        pos_bytes = sum(args[i].numel() * 4 for i in (0, 3, 6))
        if "dense" in name:                       # + the dense output
            return (nnz * (4 + 4 * tile) + pos_bytes + n_out * 4,
                    nnz * tile)
        P, R = args[0].shape[0], args[0].shape[1] - 1
        return (nnz * (4 + 4 * tile) + pos_bytes
                + n_out * (4 + 4 * tile) + (P * R + 1) * 8,
                (nnz - n_out) * tile)
    if "union_nnz" in name:
        vals, perm, seg_ptr, run_ptr = args
        tile = vals[0, 0].numel()
        return (nnz * (4 + 4 * tile) + (seg_ptr.numel() + run_ptr.numel()) * 4
                + n_out * 4 * tile, (nnz - n_out) * tile)
    if name in ("bcsr_spmv", "bcsr_spmm"):
        # nnz: stored blocks; the output is the kernel's block-row windows
        brow, _, tiles, x, max_brows = args
        tile = tiles[0, 0].numel()
        w = x.shape[2] if x.dim() == 3 else 1
        return (nnz * (8 + 4 * tile) + x.numel() * 4
                + brow.shape[0] * max_brows * tiles.shape[2] * w * 4,
                2 * nnz * tile * w)
    if name == "bcsr_sddmm":
        C, Dt = args[3], args[4]
        tile = args[2][0, 0].numel()
        return (nnz * (8 + 8 * tile) + C.numel() * 4 + Dt.numel() * 4,
                nnz * tile * (2 * Dt.shape[1] + 1))
    if name in ("spmv_csr_rows", "spmm_csr_rows"):
        pos, _, _, x = args
        P, R = pos.shape[0], pos.shape[1] - 1
        w = x.shape[1] if x.dim() == 2 else 1
        return (nnz * 8 + P * (R + 1) * 4 + x.numel() * 4 + P * R * w * 4,
                2 * nnz * w)
    if name == "spmv_coo_nnz":
        c, max_rows = args[3], args[4]
        return nnz * 12 + c.numel() * 4 + args[0].shape[0] * max_rows * 4, \
            2 * nnz
    if name == "spmm_coo_nnz":
        C, max_rows = args[3], args[4]
        J = C.shape[1]
        return (nnz * 12 + C.numel() * 4
                + args[0].shape[0] * max_rows * J * 4, 2 * nnz * J)
    if name == "sddmm_coo":
        C, Dt = args[3], args[4]
        K = Dt.shape[1]
        return nnz * 16 + C.numel() * 4 + Dt.numel() * 4, nnz * (2 * K + 1)
    C, D = args[4], args[5]                       # spmttkrp_coo
    L = C.shape[1]
    return nnz * 16 + (C.numel() + D.numel()) * 4 + n_out * L * 4, \
        3 * nnz * L


def kernel_record(name, args, launches, nnz, n_out, library, reps):
    """Time one kernel, its plain version and a library yardstick
    (``library`` = (what it calls, fn or None)) at the main path's shapes,
    and compute its bound from this run's inputs."""
    kernel, plain = kernel_fns()[name]
    nbytes, flops = _moved(name, args, nnz, n_out)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    source, replaces = KERNELS[name]
    err = compare_kernel(f"{name} main-path shapes", name, args,
                         _abs_args(args))
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": err,
        "ms": time_events(lambda: kernel(*args), reps),
        "plain_ms": time_events(lambda: plain(*args), max(reps // 4, 3)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": (time_events(library[1], reps)
                       if library[1] is not None else None),
        "library_call": library[0],
    }


def kernel_records(data, cells, launches, reps: int):
    """The six kernels at the main path's shapes, each on the inputs of
    the cell it serves: spmv/rows, spmv/nnz, spmm/rows, spmm/nnz, sddmm/nnz,
    spmttkrp/rows. Plus the SpMV rows kernel on SpTTV's (i, j) fibres
    (spttv/rows), returned apart, and {cell: ms} of every cell's kernel on
    its own inputs (those cells' times, and the other cells timed here)."""
    import torch
    B, B3 = data["B"], data["B3"]
    dev = cells["spmv/rows"]["kernel"].device
    n, m = B.shape

    def csr(pos, crd, vals, shape):
        return torch.sparse_csr_tensor(
            torch.as_tensor(pos).to(dev), torch.as_tensor(crd).to(dev),
            torch.as_tensor(vals).to(dev), size=shape)

    Bcsr = csr(B.levels[1].pos, B.levels[1].crd, B.vals, (n, m))
    n_ij = B3.levels[1].crd.shape[0]
    B3ij = csr(B3.levels[2].pos, B3.levels[2].crd, B3.vals,
               (n_ij, B3.shape[2]))
    order = ("spmv/rows", "spmv/nnz", "spmm/rows", "spmm/nnz", "sddmm/nnz",
             "spmttkrp/rows", "spttv/rows")
    call = {c: leaf_call(cells[c]["kernel"]) for c in order}
    sd = call["sddmm/nnz"][1]
    D_lib = sd[4].t().contiguous()
    ttv = call["spttv/rows"][1]
    on_b = "torch.sparse_csr_tensor(B) @ x, the whole matrix"
    library = {
        "spmv/rows": (on_b, lambda: Bcsr @ call["spmv/rows"][1][3]),
        "spmv/nnz": (on_b, lambda: Bcsr @ call["spmv/nnz"][1][3]),
        "spmm/rows": (on_b, lambda: Bcsr @ call["spmm/rows"][1][3]),
        "spmm/nnz": (on_b, lambda: Bcsr @ call["spmm/nnz"][1][3]),
        "sddmm/nnz": (
            "torch.sparse.sampled_addmm(B, C, D, beta=0).values() * B's "
            "values", lambda: torch.sparse.sampled_addmm(
                Bcsr, sd[3], D_lib, beta=0.0).values() * Bcsr.values()),
        "spmttkrp/rows": ("none: no single PyTorch call computes MTTKRP",
                          None),
        "spttv/rows": ("torch.sparse_csr_tensor(pos2, crd2, vals) @ c",
                       lambda: B3ij @ ttv[3]),
    }
    records, cell_ms = [], {}
    for cell in order:
        name, args = call[cell]
        three = cell.startswith(("spmttkrp", "spttv"))
        records.append(kernel_record(
            name, args, launches[name], B3.nnz if three else B.nnz,
            B3.shape[0] if three else n, library[cell], reps))
        cell_ms[cell] = records[-1]["ms"]
    fns = kernel_fns()
    for cell, rec in cells.items():
        other = rec["call"]
        if cell not in cell_ms and other is not None:
            cell_ms[cell] = time_events(
                lambda: fns[other[0]][0](*other[1]), reps)
    return records[:-1], records[-1], cell_ms


def blocked_kernel_records(data, cells, launches, reps: int):
    """The three blocked kernels, each on the inputs of one cell it serves
    (spmv_bcsr/rows, spmm_bcsr/rows, sddmm_bcsr/nnz), and {cell: ms} of
    all six blocked cells' kernels. Yardsticks: ``torch.sparse`` BSR @ c
    and @ C, and ``sampled_addmm`` over the scalarised block pattern."""
    import torch
    Bb = data["add"]["blocked"][0]
    dev = cells["spmv_bcsr/rows"]["kernel"].device
    br, bc = Bb.format.block_shape
    pos, crd, tiles = (torch.as_tensor(x).to(dev) for x in
                       (Bb.levels[1].pos, Bb.levels[1].crd, Bb.vals))
    bsr = torch.sparse_bsr_tensor(pos, crd, tiles, size=Bb.shape)
    # B as a scalar CSR: row b·br + r holds, block by block in block-column
    # order, the bc entries of row r of each stored block of block-row b
    nb, L = crd.numel(), (pos[1:] - pos[:-1]).long()
    brow = torch.repeat_interleave(torch.arange(L.numel(), device=dev), L)
    start = pos[:-1].long()[brow]
    r = torch.arange(br, device=dev)[None, :, None]
    cc = torch.arange(bc, device=dev)[None, None, :]
    at = (start * br * bc + (torch.arange(nb, device=dev) - start) * bc
          )[:, None, None] + r * (L[brow] * bc)[:, None, None] + cc
    at = at.reshape(-1)
    svals = torch.empty(nb * br * bc, device=dev)
    svals[at] = tiles.reshape(-1)
    scols = torch.empty(nb * br * bc, dtype=torch.int64, device=dev)
    scols[at] = (crd.long()[:, None, None] * bc + cc).expand(
        nb, br, bc).reshape(-1)
    crow = torch.zeros(L.numel() * br + 1, dtype=torch.int64, device=dev)
    torch.cumsum(L.repeat_interleave(br) * bc, 0, out=crow[1:])
    scalar = torch.sparse_csr_tensor(crow, scols, svals, size=Bb.shape)
    del brow, start, at
    call = {c: leaf_call(cells[c]["kernel"]) for c in
            ("spmv_bcsr/rows", "spmm_bcsr/rows", "sddmm_bcsr/nnz")}
    c = torch.as_tensor(data["c"]).to(dev)
    C = torch.as_tensor(data["C"]).to(dev)
    Cs = torch.as_tensor(data["Cs"]).to(dev)
    Ds = torch.as_tensor(data["Ds"]).to(dev)
    library = {
        "spmv_bcsr/rows": ("torch.sparse_bsr_tensor(B) @ c, the whole "
                           "matrix", lambda: bsr @ c),
        "spmm_bcsr/rows": ("torch.sparse_bsr_tensor(B) @ C",
                           lambda: bsr @ C),
        "sddmm_bcsr/nnz": (
            "torch.sparse.sampled_addmm(B as scalar CSR, C, D, beta=0)"
            ".values() * B's values",
            lambda: torch.sparse.sampled_addmm(
                scalar, Cs, Ds, beta=0.0).values() * scalar.values()),
    }
    records, cell_ms = [], {}
    for cell, (name, args) in call.items():
        records.append(kernel_record(name, args, launches[name],
                                     Bb.vals.shape[0], Bb.shape[0],
                                     library[cell], reps))
        cell_ms[cell] = records[-1]["ms"]
    fns = kernel_fns()
    for cell, rec in cells.items():
        if cell not in cell_ms:
            other = rec["call"]
            cell_ms[cell] = time_events(
                lambda: fns[other[0]][0](*other[1]), reps)
    return records, cell_ms


def device_breakdown(fn, reps: int = 3):
    """Device milliseconds per call of each CUDA kernel that ``fn``
    launches, from ``torch.profiler`` over ``reps`` calls (a wrapper with a
    count and a fill phase launches two)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        name = evt.key.replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").split("(")[0].split(",")[0]
        if us > 0:
            out[name[-48:]] = out.get(name[-48:], 0.0) + us / 1e3 / reps
    return out


def add_kernel_records(data, cells, launches, reps: int):
    """The six SpAdd3 kernels, each on the inputs of the cell it serves (the
    add path's four lowered cells and two dense ops cells), and {cell: ms}
    of those cells' kernels."""
    import torch
    dev = cells["spadd3/rows"]["kernel"].device

    def csr_sum(ts):
        mats = [torch.sparse_csr_tensor(
            *(torch.as_tensor(x).to(dev) for x in
              (t.levels[1].pos, t.levels[1].crd, t.vals)), size=t.shape)
            for t in ts]
        return lambda: mats[0] + mats[1] + mats[2]

    union = csr_sum(data["add"]["scalar"])
    dense = csr_sum(data["dense"]["scalar"])
    on_add = "torch.sparse_csr_tensor addition B + C + D (cuSPARSE)"
    no_bsr = "none: no single PyTorch call adds BSR matrices"
    library = {
        "spadd3_dense/ops": (on_add + ", .to_dense()",
                             lambda: dense().to_dense()),
        "spadd3/rows": (on_add, union), "spadd3/nnz": (on_add, union),
        "spadd3_bcsr_dense/ops": (no_bsr, None),
        "spadd3_bcsr/rows": (no_bsr, None), "spadd3_bcsr/nnz": (no_bsr, None),
    }
    records, cell_ms = [], {}
    for cell in ("spadd3_dense/ops", "spadd3_bcsr_dense/ops", "spadd3/rows",
                 "spadd3/nnz", "spadd3_bcsr/rows", "spadd3_bcsr/nnz"):
        rec = cells[cell]
        name, args = rec["call"]
        expr = cell.split("/")[0]
        where, kind = ADD_SOURCES[expr]
        nnz = sum(t.vals.shape[0] for t in data[where][kind])
        out = rec["out"]
        n_out = (out.numel() if torch.is_tensor(out)
                 else out.levels[1].crd.shape[0])
        records.append(kernel_record(name, args, launches[name], nnz, n_out,
                                     library[cell], reps))
        cell_ms[cell] = records[-1]["ms"]
        if "union_rows" in name:
            fn = kernel_fns()[name][0]
            phase("profile", name=name, **{
                k.replace(" ", "_"): f"{v:.4f}" for k, v in
                device_breakdown(lambda: fn(*args)).items()})
    return records, cell_ms


# ---------------------------------------------------------------------------
# Phase 4e and 5: the attention path (the LM forward) and its kernel
# ---------------------------------------------------------------------------

ARCH = "llama3-8b"
PREFILL_BATCH, PREFILL_SEQ = 2, 4096
LOGITS_RTOL = 5e-2     # (a): bf16 flash vs dense logits, relative Frobenius
F32_TOL = 1e-3         # (b): f32 flash vs dense logits, atol = rtol
CHECK_LAYERS = 2       # (b)'s depth, at full width


def lm_config(**over):
    """llama3-8b with its weights in bf16, as the serving path builds it
    (``param_dtype="bfloat16"``; activations bf16, the config's default),
    with ``over`` replaced."""
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(ARCH), param_dtype="bfloat16",
                               **over)


def prefill_tokens(cfg, batch: int, seq: int, device):
    """(batch, seq) token ids from numpy seed 0."""
    import numpy as np
    import torch
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                               (batch, seq))
    return torch.from_numpy(ids).to(device)


def run_attention(cfg, batch: int, seq: int, device, reps: int):
    """Phase 4 for the attention path: ``LM(cfg).apply(variant="flash",
    last_only=True)`` over a prefill of ``batch`` prompts of ``seq`` tokens,
    with weights from a seeded generator on the device. The flash applies
    (warm-up, timed, and two more whose bits must agree) run with the
    launch counts read straight after them: on the card flash_attention
    must have launched once per layer and apply, and no other kernel at
    all. Then the checks: (a) the same weights under ``variant="dense"``,
    relative Frobenius error of the logits <= LOGITS_RTOL; (b) an f32 model
    of CHECK_LAYERS layers at the same width, flash against dense on all
    positions at F32_TOL. Returns the record and the launches."""
    import dataclasses
    import torch
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.models import LM
    device = resolve_device(device)
    lm = LM(cfg)
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device).manual_seed(SEED),
                            device)
    _sync(device)
    init_s = time.perf_counter() - t0
    tokens = prefill_tokens(cfg, batch, seq, device)
    calls = []

    def prefill(variant="flash"):
        calls.append(variant)
        return lm.apply(params, tokens, variant=variant, last_only=True)[0]

    param_bytes = sum(t.numel() * t.element_size() for t in
                      _tensors(params))
    with torch.inference_mode():
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        before = dict(_build.LAUNCHES)
        run_ms = time_host(prefill, device, reps)
        out, again = prefill(), prefill()
        _sync(device)
        launches = {k: n - before[k] for k, n in _build.LAUNCHES.items()}
        runs = len(calls)
        max_mem = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
        expected = dict.fromkeys(launches, 0)
        if device.type == "cuda":
            expected["flash_attention"] = cfg.n_layers * runs
        if launches != expected:
            raise AssertionError(f"launches during the prefill {launches} are "
                                 f"not one flash_attention per layer and "
                                 f"apply: {expected}")
        # device ms per kernel of one prefill, after the counts are read
        profile = (device_breakdown(prefill, reps=1)
                   if device.type == "cuda" else {})
        dense = prefill("dense")
    if out.shape != (batch, 1, lm.vp) or not torch.isfinite(out).all():
        raise AssertionError(f"prefill logits: shape {tuple(out.shape)}, "
                             f"want {(batch, 1, lm.vp)}, all finite")
    bitwise = torch.equal(out, again)
    if not bitwise:
        raise AssertionError("two prefills gave different bits")
    rel = float((out.float() - dense.float()).norm()
                / dense.float().norm())
    if not rel <= LOGITS_RTOL:
        raise AssertionError(f"flash vs dense logits: relative Frobenius "
                             f"error {rel} > {LOGITS_RTOL}")
    del params, out, again, dense
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                                n_layers=CHECK_LAYERS)
    lm32 = LM(cfg32)
    p32 = lm32.init_params(torch.Generator(device).manual_seed(SEED + 1),
                           device)
    with torch.inference_mode():
        flash = lm32.apply(p32, tokens, variant="flash")[0]
        dense = lm32.apply(p32, tokens, variant="dense")[0]
    err = (flash - dense).abs()
    bad = int((err > F32_TOL + F32_TOL * dense.abs()).sum())
    if bad:
        raise AssertionError(f"f32 flash vs dense logits: {bad} entries off "
                             f"by up to {float(err.max())} (tolerance "
                             f"{F32_TOL})")
    rec = {"init_s": init_s, "run_ms": run_ms, "runs": runs,
           "tokens_per_s": batch * seq / (run_ms / 1e3),
           "param_bytes": param_bytes, "max_mem": max_mem,
           "bitwise": bitwise, "rel_frobenius": rel,
           "f32_max_abs_err": float(err.max()), "layers": cfg.n_layers,
           "profile": profile}
    del p32, flash, dense, err
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rec, launches


def _tensors(tree):
    """The tensors of a nested dict / list of parameters."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def flash_record(cfg, batch: int, seq: int, device, dtype: str,
                 launches: int, reps: int):
    """flash_attention at the model's layer shapes (q (batch, seq, H, hd);
    k, v (batch, seq, Hkv, hd); standard normal from a seeded generator) in
    ``dtype``: checked against the plain version, timed beside it and
    beside ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
    (a yardstick the port never calls), with its bound: the causal flops
    2·2·B·H·hd·S²/2 over the dtype's peak against q, k, v and o moved once
    over the memory rate."""
    import torch
    import torch.nn.functional as F
    kernel, plain = kernel_fns()["flash_attention"]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device).manual_seed(SEED)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(
        getattr(torch, dtype)) for shape in
        ((batch, seq, H, hd), (batch, seq, Hkv, hd), (batch, seq, Hkv, hd)))
    err = compare_flash(f"flash_attention {dtype} main-path shapes",
                        kernel(q, k, v), plain(q, k, v), q, v)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    flops = 2 * 2 * batch * H * hd * seq * seq / 2
    nbytes = q.element_size() * 2 * batch * seq * hd * (H + Hkv)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS) * 1e3
    source, replaces = KERNELS["flash_attention"]
    return {
        "name": "flash_attention", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": time_events(lambda: kernel(q, k, v), reps),
        "plain_ms": time_events(lambda: plain(q, k, v), max(reps // 4, 3)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": time_events(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps),
        "library_call": "torch.nn.functional.scaled_dot_product_attention("
                        "is_causal=True, enable_gqa=True)",
        "dtype": dtype,
    }


def sparse_paths(args, device):
    """Phases 4a-d and 5 for the four sparse paths: drive each with the
    launch counts of exactly its run, check the cells, then time the
    kernels at the main path's shapes. Returns the kernel records and the
    SpTTV rows record; the paths' data goes with the call."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build

    # 4. the main path: each path with the launch counts of exactly its run
    t0 = time.perf_counter()
    dims3 = (1 << args.log2_i, 1 << args.log2_jk, 1 << args.log2_jk)
    data = make_inputs(1 << args.log2_n, AVG_NNZ, SPMM_J, SEED, dims3)
    B, B3 = data["B"], data["B3"]
    phase("data", n=B.shape[0], nnz=B.nnz,
          longest_row=int(np.diff(B.levels[1].pos).max()),
          tensor=("x".join(map(str, B3.shape))), tensor_nnz=B3.nnz,
          fibres=B3.levels[1].crd.shape[0],
          longest_slice=int(np.diff(B3.levels[2].pos[B3.levels[1].pos])
                            .max()),
          seconds=f"{time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    data["add"] = add_operands(B.shape[0], SEED, B)
    data["dense"] = add_operands(1 << args.log2_dense, SEED)
    phase("data-add", stream=sum(t.nnz for t in data["add"]["scalar"]),
          blocks=sum(t.vals.shape[0] for t in data["add"]["blocked"]),
          dense_side=1 << args.log2_dense,
          dense_stream=sum(t.nnz for t in data["dense"]["scalar"]),
          dense_blocks=sum(t.vals.shape[0] for t in data["dense"]["blocked"]),
          longest_block_row=int(np.diff(
              data["add"]["blocked"][0].levels[1].pos).max()),
          seconds=f"{time.perf_counter() - t0:.1f}")
    cells, launches = {}, dict.fromkeys(_build.LAUNCHES, 0)
    for path, path_cells in (("matrix", MATRIX_CELLS), ("slice", SLICE_CELLS),
                             ("add", ADD_CELLS), ("blocked", BLOCKED_CELLS)):
        _build.reset_launches()
        recs, path_launches = run_slice(data, path_cells, PIECES, device,
                                        max(args.reps // 2, 1))
        for cell, rec in recs.items():
            k = rec["kernel"]
            out = rec["out"]
            phase("main", cell=k.cell_id() if k else cell,
                  leaf=k.leaf_name if k else rec["call"][0],
                  stored=("-" if torch.is_tensor(out)
                          else out.vals.shape[0]),
                  cold_lower_s=f"{rec['cold_s']:.3f}",
                  warm_lower_s=f"{rec['warm_s']:.4f}",
                  run_ms=f"{rec['run_ms']:.3f}", runs=rec["runs"],
                  max_abs_err=f"{rec['max_abs_err']:.3g}",
                  bitwise_repeat=rec["bitwise"],
                  max_mem_gb=f"{rec['max_mem'] / 2**30:.2f}")
        missing = [k for k in PATH_KERNELS[path] if path_launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {path} "
                                 f"path: {missing}")
        phase("launches", path=path, **path_launches)
        for k, v in path_launches.items():
            launches[k] += v
        cells.update(recs)

    # 3b + 5. kernels at the main path's shapes, timed once every count
    # is read
    records, ttv, cell_ms = kernel_records(
        data, {c: r for c, r in cells.items()
               if not c.startswith("spadd3") and "_bcsr/" not in c},
        launches, args.reps)
    add_records, add_ms = add_kernel_records(data, cells, launches,
                                             args.reps)
    blocked_records, blocked_ms = blocked_kernel_records(
        data, {c: r for c, r in cells.items() if "_bcsr/" in c
               and not c.startswith("spadd3")}, launches, args.reps)
    records += add_records + blocked_records
    cell_ms.update(add_ms)
    cell_ms.update(blocked_ms)
    for cell, rec in cells.items():
        phase("cell-kernel", cell=(rec["kernel"].cell_id()
                                   if rec["kernel"] else cell),
              kernel_ms=(f"{cell_ms[cell]:.4f}" if cell in cell_ms
                         else "-"))
    return records, ttv


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-n", type=int, default=21,
                    help="matrix side as a power of two (default 21; a "
                    "smaller side is a quick rehearsal)")
    ap.add_argument("--log2-i", type=int, default=20,
                    help="the 3-tensor's first dimension (default 20)")
    ap.add_argument("--log2-jk", type=int, default=16,
                    help="the 3-tensor's second and third dimensions "
                    "(default 16)")
    ap.add_argument("--log2-dense", type=int, default=15,
                    help="side of the dense SpAdd3 sums (default 15: a "
                    "4 GiB output)")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed kernel launches (run() takes half)")
    ap.add_argument("--attn-layers", type=int, default=0,
                    help="layers of the attention path's llama3-8b (default "
                    "0: all 32; fewer is a quick rehearsal)")
    ap.add_argument("--attn-seq", type=int, default=PREFILL_SEQ,
                    help=f"prefill length (default {PREFILL_SEQ})")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: the repro_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from repro_torch.kernels import _build

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    phase("device", name=repr(kind), count=count, torch=torch.__version__,
          cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build(force=True)
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}",
          sources=",".join(sorted(logs)))
    for src, log in sorted(logs.items()):
        for line in log.splitlines():
            if ("Compiling entry" in line or "Used" in line
                    or "spill" in line):
                print(f"  {src}: {line.strip()}")

    # 3a. kernels against plain at edge-case shapes
    rng = np.random.default_rng(SEED)
    worst = {}
    for label, name, kargs, abs_args in kernel_cases(rng, device):
        err = compare_kernel(label, name, kargs, abs_args)
        worst[name] = max(worst.get(name, 0.0), err)
    phase("kernels-edge", **{k: f"{v:.3g}" for k, v in worst.items()})

    # 4a-d + 5. the sparse paths, their kernels timed after every count
    records, ttv = sparse_paths(args, device)

    # 4e. the attention path, on a card freed of the sparse paths' data
    from repro_torch.core import lower as L
    L.clear_lowering_caches()
    gc.collect()
    torch.cuda.empty_cache()
    over = {"n_layers": args.attn_layers} if args.attn_layers else {}
    cfg = lm_config(**over)
    _build.reset_launches()
    attn, attn_launches = run_attention(cfg, PREFILL_BATCH, args.attn_seq,
                                        device, 5)
    missing = [k for k in PATH_KERNELS["attention"]
               if attn_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the attention "
                             f"path: {missing}")
    phase("main", cell=f"{ARCH} prefill", layers=attn["layers"],
          d_model=cfg.d_model, heads=f"{cfg.n_heads}/{cfg.n_kv_heads}",
          batch=PREFILL_BATCH, seq=args.attn_seq,
          run_ms=f"{attn['run_ms']:.3f}", runs=attn["runs"],
          tokens_per_s=f"{attn['tokens_per_s']:.1f}",
          init_s=f"{attn['init_s']:.2f}",
          weights_gb=f"{attn['param_bytes'] / 2**30:.2f}",
          max_mem_gb=f"{attn['max_mem'] / 2**30:.2f}",
          bitwise_repeat=attn["bitwise"],
          rel_frobenius_vs_dense=f"{attn['rel_frobenius']:.4g}",
          f32_max_abs_err=f"{attn['f32_max_abs_err']:.3g}")
    phase("launches", path="attention", **attn_launches)
    top = sorted(attn["profile"].items(), key=lambda kv: -kv[1])[:8]
    phase("profile", name="prefill",
          total_ms=f"{sum(attn['profile'].values()):.2f}",
          **{k.replace(" ", "_"): f"{v:.2f}" for k, v in top})
    flash = [flash_record(cfg, PREFILL_BATCH, args.attn_seq, device, dt,
                          attn_launches["flash_attention"], args.reps)
             for dt in ("bfloat16", "float32")]
    records.append(flash[0])
    for r in records + [dict(ttv, name="spmv_csr_rows(spttv)"),
                        dict(flash[1], name="flash_attention(f32)")]:
        phase("kernel", name=r["name"], max_abs_err=f"{r['max_abs_err']:.3g}",
              ms=f"{r['ms']:.4f}", bound_ms=f"{r['bound_ms']:.4f}",
              plain_ms=f"{r['plain_ms']:.3f}",
              library_ms=("null" if r["library_ms"] is None
                          else f"{r['library_ms']:.4f}"))
    phase("total", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
