"""A numpy emulation of the index logic of flash_attention's wide 16-bit
kernel (``flash_mma_wide_kernel<W, T>`` in
src/repro_torch/kernels/csrc/flash_attention.cu, W = 256, 384 and 512:
the widths the wrapper pads 16-bit hd 129-512 to), held against the
kernel's plain version and the Pallas kernel in interpret mode.

The emulation walks the kernel's blocks, steps and warps as the kernel
does. A block holds 64 stacked rows (row rho is query head gr·GB + rho % GB
at position q0 + rho // GB), heaviest tiles first, over tiles of 128 keys.
Its shared memory is modelled as flat arrays of 16-byte chunks (8 values),
filled with NaN, at the kernel's swizzled addresses: Q whole and resident,
loaded once; a ring of R slabs of 128 keys x D dims (``plan``) through
which a tile's K slabs, then its V slabs, flow; the 64 x 128 P tile; and
the row groups' maxima and sums. Step i loads slab i + R - 1 into slot
(i - 1) % R before it reads slot i % R, the earliest the kernel's cp.async
may land, so a slot reused too soon or an unloaded chunk shows as a wrong
value or a NaN. Keys past S are zero-filled. Rows of q, k, v and o hold hd
values in memory when hd is a multiple of 8 (the wrapper copies nothing):
the kernel zero-fills the dims past hd and stores none of them, so the
writes are counted over those hd columns.

Warp w is row group rg = w // 4 (rows 32 rg .., two 16-row m-tiles) and
part pt = w % 4 of it. In the scores it takes keys 32 pt .. 32 pt + 31 of
the tile at the full width, summed over the K slabs; it masks (only in
tiles that reach past the group's first position), takes its row max,
writes it to shared memory and reads the four parts' back (a named barrier
of the group between); all four take the same max; it writes its p,
rounded to the 16-bit type, into its keys' chunks of the P tile and keeps
its keys' part of l. In P·V it reads its 32 rows of P (all 128 keys) and
takes columns D / 4 · pt .. of every V slab. At the end l is the four
parts, part 0's first, and o = acc / max(l, 1e-30), rounded. A row group
wholly past a tile's rows or past S skips the tile. Its products are
numpy's, not the tensor cores': the point is which rows, keys, slabs, slots
and columns meet. Every (position, head, column) must be written exactly
once.

Inputs are standard normal from a numpy seed, rounded to the dtype. Causal
attention over the first S positions depends on nothing later, so the
Pallas reference for every S is the prefix of one call at the largest S.
"""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 padded_width)
from test_torch_flash_emulation import ROUNDING
from test_torch_flash_f32_emulation import swz

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "flash_attention.cu").read_text()
# the kernel's constants: stacked rows a block, rows a row group, warps a
# group, keys a tile, most ring slots, the most shared memory a block may
# take
ROWS, GROUP, SPLIT, BK, RING, SMEM_MAX = 64, 32, 4, 128, 4, 232448
WARPS = SPLIT * ROWS // GROUP
WIDTHS = (256, 384, 512)
NEG = np.float32(-1e30)
LOG2E = 1.4426950408889634
HKV = 2


def plan(W: int) -> dict:
    """WidePlan<W>: D dims a slab (128 at 384, 256 else), NSL slabs a
    tile, 16-byte chunks a row of Q, of a slab and of P, R ring slots (as
    many as 227 KB leave, at most 4), shared bytes (Q, the ring, P, the
    groups' maxima and sums), a warp's columns of a V slab (CW), and the
    f32 registers a thread holds: O (32 rows x W / 4 columns over 32
    lanes), its scores (32 rows x 32 keys) and a k-step's P fragments."""
    D = 128 if W == 384 else 256
    cpq, cps, cpp = W // 8, D // 8, BK // 8
    fixed = (ROWS * cpq + ROWS * cpp) * 16 + 2 * SPLIT * ROWS * 4
    R = min(RING, (SMEM_MAX - fixed) // (BK * cps * 16))
    return dict(D=D, NSL=W // D, CPQ=cpq, CPS=cps, CPP=cpp, R=R,
                smem=fixed + R * BK * cps * 16, CW=D // SPLIT,
                o_regs=GROUP * (W // SPLIT) // 32, s_regs=GROUP * 32 // 32,
                p_regs=2 * 4)


def emulate(q, k, v, round_fn):
    """o (B, S, H, hd) as flash_mma_wide_kernel's blocks and warps compute
    it, from float32 arrays already rounded to the 16-bit type (``round_fn``
    rounds p and o to it); hd is zero-padded to the kernel's width (the
    scale stays the true width's). Rows hold RW values in memory, as the
    wrapper passes them: hd when it is a multiple of 8 (the kernel
    zero-fills the dims past it and stores none of them), else the padded
    width."""
    B, S, H, hd = q.shape
    W = padded_width(hd)
    assert W in WIDTHS
    RW = hd if hd % 8 == 0 else W
    q, k, v = (np.pad(x, ((0, 0),) * 3 + ((0, W - hd),)) for x in (q, k, v))
    P = plan(W)
    D, NSL, CPQ, CPS, CPP, R, CW = (P[n] for n in ("D", "NSL", "CPQ", "CPS",
                                                   "CPP", "R", "CW"))
    Hkv = k.shape[2]
    G = H // Hkv
    GB = min(G, ROWS)
    BQ = ROWS // GB
    n_gr = -(-G // GB)
    n_qt = -(-S // BQ)
    n_bh = B * Hkv * n_gr
    scale = np.float32(hd ** -0.5 * LOG2E)
    w = np.arange(WARPS)
    rg, pt = w // SPLIT, w % SPLIT
    w_rows = GROUP * rg[:, None] + np.arange(GROUP)     # (8, 32)
    w_keys = 32 * pt[:, None] + np.arange(32)           # (8, 32)
    w_cols = CW // 8 * pt[:, None] + np.arange(CW // 8)  # slab chunks
    keys = np.arange(BK)
    o = np.full((B, S, H, RW), np.nan, np.float32)
    writes = np.zeros((B, S, H, RW), np.int64)
    for bid in range(n_qt * n_bh):
        qt = n_qt - 1 - bid // n_bh
        bh = bid % n_bh
        gr = bh % n_gr
        kvh = (bh // n_gr) % Hkv
        b = bh // (n_gr * Hkv)
        q0 = qt * BQ
        kv_end = min(S, q0 + BQ)
        n_steps = -(-kv_end // BK) * 2 * NSL
        rho = np.arange(ROWS)
        qi, g = rho // GB, gr * GB + rho % GB
        live = (qi < BQ) & (g < G) & (q0 + qi < S)
        h = kvh * G + g
        # the diagonal stop: no tile starts past the block's last live row
        assert (kv_end - 1) // BK * BK <= (q0 + qi[live]).max()
        p_lo = q0 + GROUP * rg // GB
        p_hi = q0 + np.minimum(GROUP * rg + GROUP - 1, GB * BQ - 1) // GB
        rg_live = (GROUP * rg < GB * BQ) & (p_lo < S)
        pos = q0 + w_rows // GB                          # (8, 32)

        rows = np.zeros((ROWS, W), np.float32)
        rows[live] = q[b, q0 + qi[live], h[live]]
        sQ = np.full((ROWS * CPQ, 8), np.nan, np.float32)
        sQ[swz(CPQ, rho[:, None], np.arange(CPQ))] = rows.reshape(ROWS,
                                                                  CPQ, 8)
        ring = np.full((R, BK * CPS, 8), np.nan, np.float32)
        sP = np.full((ROWS * CPP, 8), np.nan, np.float32)
        sMax = np.full((SPLIT, ROWS), np.nan, np.float32)
        sL = np.full((SPLIT, ROWS), np.nan, np.float32)

        def load(i):                       # K slabs, then V slabs
            k0, p = i // (2 * NSL) * BK, i % (2 * NSL)
            src = k if p < NSL else v
            d0 = (p % NSL) * D
            inside = k0 + keys < S
            tile = np.zeros((BK, D), np.float32)
            tile[inside] = src[b, k0 + keys[inside], kvh, d0:d0 + D]
            ring[i % R][swz(CPS, keys[:, None], np.arange(CPS))] = \
                tile.reshape(BK, CPS, 8)

        s = np.zeros((WARPS, GROUP, 32), np.float32)
        m = np.full((WARPS, GROUP), NEG, np.float32)
        l = np.zeros((WARPS, GROUP), np.float32)
        acc = np.zeros((WARPS, NSL, GROUP, CW), np.float32)
        for i in range(min(R - 1, n_steps)):
            load(i)
        for i in range(n_steps):
            if i + R - 1 < n_steps:
                load(i + R - 1)            # into slot (i - 1) % R
            slab = ring[i % R]
            k0, p = i // (2 * NSL) * BK, i % (2 * NSL)
            go = rg_live[rg] & (k0 <= p_hi[rg])
            gw = np.flatnonzero(go)
            if p < NSL:
                if p == 0:
                    s[:] = 0
                Qg = sQ[swz(CPQ, w_rows[gw, :, None],
                            p * CPS + np.arange(CPS))].reshape(-1, GROUP, D)
                Kg = slab[swz(CPS, w_keys[gw, :, None],
                              np.arange(CPS))].reshape(-1, 32, D)
                s[gw] += np.einsum("wrd,wkd->wrk", Qg, Kg, dtype=np.float32)
                if p < NSL - 1 or not gw.size:
                    continue
                masked = (k0 + BK - 1 > p_lo[rg])[:, None, None]
                key = (k0 + w_keys)[:, None, :]
                dead = masked & ((key > pos[:, :, None]) | (key >= S))
                y = np.where(dead, NEG, s * scale).astype(np.float32)
                mx = np.maximum(m, y.max(-1))
                sMax[pt[gw, None], w_rows[gw]] = mx[gw]
                # the group's named barrier; then the four parts' maxima
                mx = np.maximum(mx, sMax[:, w_rows].max(0))
                corr = np.exp2(m - mx)
                pj = np.where(dead, np.float32(0), np.exp2(y - mx[..., None]))
                g2 = go[:, None]
                l = np.where(g2, l * corr + pj.sum(-1, dtype=np.float32), l)
                acc = np.where(go[:, None, None, None],
                               acc * corr[:, None, :, None], acc)
                m = np.where(g2, mx, m)
                sP[swz(CPP, w_rows[gw, :, None], (w_keys[gw, None] // 8)),
                   w_keys[gw, None] % 8] = round_fn(pj[gw])
            else:
                # after the V slab's barrier: the warp's 32 rows of P
                pa = sP[swz(CPP, w_rows[gw, :, None],
                            np.arange(CPP))].reshape(-1, GROUP, BK)
                Vg = slab[swz(CPS, keys[None, :, None],
                              w_cols[gw, None, :])].reshape(-1, BK, CW)
                acc[gw, p - NSL] += np.einsum("wrk,wkc->wrc", pa, Vg,
                                              dtype=np.float32)
        sL[pt[:, None], w_rows] = l
        den = sL[0, w_rows]
        for part in range(1, SPLIT):                     # part 0's first
            den = den + sL[part, w_rows]
        den = np.maximum(den, np.float32(1e-30))
        out = round_fn(acc / den[:, None, :, None])      # (8, NSL, 32, CW)
        # warp w's row w_rows[w, r], column D sl + CW pt + c
        ww, sl, r, c = np.meshgrid(w, np.arange(NSL), np.arange(GROUP),
                                   np.arange(CW), indexing="ij")
        row = w_rows[ww, r]
        col = D * sl + CW * pt[ww] + c
        ok = live[row] & (col < RW)
        at = (b, q0 + qi[row][ok], h[row][ok], col[ok])
        o[at] = out[ok]
        np.add.at(writes, at, 1)
    assert (writes == 1).all(), "an output not written exactly once"
    return o[..., :hd]


def _qkv(G, hd, S, seed=0):
    rng = np.random.default_rng([seed, G, hd])
    return [rng.standard_normal((1, S, HKV * G if i == 0 else HKV, hd))
            .astype(np.float32) for i in range(3)]


DTYPES = ("bfloat16", "float16")
HDS = (136, 200, 256, 300, 320, 392, 512)
GROUPS = (1, 3, 8)
SEQS = (1, 15, 17, 33, 65, 129, 200)


@functools.lru_cache(maxsize=None)
def _pallas(G, hd, dtype):
    """The Pallas kernel in interpret mode at the largest S."""
    round_fn, jdt, _ = ROUNDING[dtype]
    q, k, v = (round_fn(x) for x in _qkv(G, hd, max(SEQS)))
    return np.asarray(ref_flash(*(jnp.asarray(x, jdt) for x in (q, k, v))),
                      np.float32)


@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("hd", HDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_walk_matches_plain_and_pallas(dtype, hd, G, S):
    """The walk in bf16 (3e-2) and f16 (1e-2) against the plain version
    and the Pallas kernel; position 0 is v[0]. hd 300 comes padded to 384;
    136, 200, 320 and 392 unpadded (136 and 200 inside the one 256-dim
    slab of 256, 392 inside the second 256-dim slab of 512)."""
    round_fn, _, tol = ROUNDING[dtype]
    q, k, v = (round_fn(x[:, :S]) for x in _qkv(G, hd, max(SEQS)))
    got = emulate(q, k, v, round_fn)
    before = dict(_build.LAUNCHES)
    plain = flash_attention(*(torch.from_numpy(x).to(getattr(torch, dtype))
                              for x in (q, k, v))).float().numpy()
    assert _build.LAUNCHES == before                  # the CPU launches none
    want = _pallas(G, hd, dtype)[:, :S]
    np.testing.assert_allclose(got, plain, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got[:, 0], np.repeat(v[:, 0], G, axis=1),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("hd", [200, 320, 512])
@pytest.mark.parametrize("G", [1, 130])
def test_wide_rows_cover_every_output_once(G, hd):
    """The stacked-row map (more heads than a block's rows split over
    groups, too) writes each (position, head, column) once; q = k = 0 and
    v = 1, so every output is 1."""
    S = 70
    q = np.zeros((1, S, G, hd), np.float32)
    kv = np.zeros((1, S, 1, hd), np.float32)
    np.testing.assert_array_equal(
        emulate(q, kv, kv + 1, ROUNDING["bfloat16"][0]), 1)


@pytest.mark.parametrize("W", WIDTHS)
def test_wide_warps_split_scores_and_columns_once(W):
    """Per tile, the warps' (row, key) scores cover the 64 x 128 tile once
    and their (row, column) parts of O the 64 x W output once; the four
    warps of a row group share its rows in both."""
    P = plan(W)
    scores = np.zeros((ROWS, BK), np.int64)
    cols = np.zeros((ROWS, W), np.int64)
    for w in range(WARPS):
        rows = GROUP * (w // SPLIT) + np.arange(GROUP)
        scores[np.ix_(rows, 32 * (w % SPLIT) + np.arange(32))] += 1
        for sl in range(P["NSL"]):
            cols[np.ix_(rows, P["D"] * sl + P["CW"] * (w % SPLIT)
                        + np.arange(P["CW"]))] += 1
    assert (scores == 1).all() and (cols == 1).all()


@pytest.mark.parametrize("name,value", [
    ("kWideRows", ROWS), ("kGroupRows", GROUP), ("kSplit", SPLIT),
    ("kWideBK", BK), ("kWideRing", RING), ("kSmemBytes", SMEM_MAX)])
def test_wide_constants_match_the_source(name, value):
    """The emulation's rows, rows a group, warps a group, keys a tile, ring
    slots and shared-memory limit are the kernel's own constants."""
    found = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert found and int(found.group(1)) == value


@pytest.mark.parametrize("W", WIDTHS)
def test_wide_plan_fits_a_block(W):
    """WidePlan<W>: its slab width is the source's rule, its shared bytes
    the source's static_assert, within the 227 KB a block may take with at
    least two ring slots; O, the scores and a k-step's P fragments fit a
    thread's 255 registers with room to spare, O at most 128 floats."""
    P = plan(W)
    assert "static constexpr int D = W == 384 ? 128 : 256;" in SOURCE
    found = re.search(rf"WidePlan<{W}>::smem == (\d+)", SOURCE)
    assert found and int(found.group(1)) == P["smem"]
    assert P["smem"] <= SMEM_MAX and P["R"] >= 2
    assert P["o_regs"] <= 128
    assert P["o_regs"] + P["s_regs"] + P["p_regs"] <= 255 - 64
