"""A numpy emulation of the index logic of flash_attention's f32 kernel
(``flash_f32_kernel<HD>`` in src/repro_torch/kernels/csrc/flash_attention.cu),
held against the kernel's plain version and the Pallas kernel in interpret
mode at 1e-5.

The emulation walks the kernel's blocks, steps and threads as the kernel
does. A block holds BM stacked rows (128 at hd 128, 64 else; row rho is
query head gr·GB + rho % GB at position q0 + rho // GB), heaviest tiles
first, over tiles of 64 keys. Its shared memory is modelled as flat
arrays of 16-byte chunks, filled with NaN, at the kernel's addresses: Q
row-major, a ring of R slabs of 64 keys x D dims (the whole width up to
hd 256, 128 above) XOR-swizzled by ``swz``, P^T (keys x rows) swizzled
the same way, and the rows' rescale and sums. Step i loads slab i + R - 1 into
slot (i - 1) % R before it reads slot i % R, the earliest the kernel's
cp.async may land, so a slot reused too soon or an unloaded chunk shows
as a wrong value or a NaN. Keys past S are zero-filled. Each of the 256
threads reads only its own micro-tiles: SR = BM / 16 score rows (SR·ty +
r) x 4 keys (tx + 16 j), summed over the K slabs at the full width, and
OR rows (OR·oy + r) x NJ chunks (ox + TOC·j) of each V slab's part of
O. The softmax runs as the kernel's: the scale
hd^-0.5·log2(e), exp2, the finite -1e30, masked p set to 0 again, masking
only in tiles that reach past the block's first position, the KV loop
stopped at the block's diagonal, each row's max over its 16 lanes, and
the lanes' partial sums reduced at the end by the xor tree (offsets 1, 2,
4, 8). Its products are numpy's, not the kernel's FMA chains: the point is
which rows, keys, chunks and slots meet. Every output must be written
exactly once.

Inputs are standard normal from a numpy seed. Causal attention over the
first S positions depends on nothing later, so the Pallas reference for
every S is the prefix of one call at the largest S of the width.
"""
import functools
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (F32_BK, F32_SMEM,
                                                 F32_THREADS, F32_WIDTHS,
                                                 f32_plan, flash_attention,
                                                 padded_width)

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "flash_attention.cu").read_text()
THREADS, BK, SMEM = F32_THREADS, F32_BK, F32_SMEM
NEG = np.float32(-1e30)
LOG2E = 1.4426950408889634
HKV = 2
TOL = 1e-5


def swz(cpr: int, r, c):
    """The kernel's ``swz<CPR>``: chunk c of row r, XOR-swizzled."""
    r, c = np.asarray(r), np.asarray(c)
    if cpr >= 8:
        return r * cpr + (c ^ (r & 7))
    return r * cpr + (c ^ ((r // (8 // cpr)) % cpr))


def emulate(q, k, v):
    """o (B, S, H, hd) as flash_f32_kernel's blocks and threads compute it,
    from float32 arrays; hd is zero-padded to the kernel's width (the scale
    stays the true width's)."""
    B, S, H, hd = q.shape
    width = padded_width(hd)
    q, k, v = (np.pad(x, ((0, 0),) * 3 + ((0, width - hd),))
               for x in (q, k, v))
    P = f32_plan(width)
    BM, D, NSL, CQ, CD, CP = (P[n] for n in ("BM", "D", "NSL", "CQ", "CD",
                                             "CP"))
    SR, TOC, OR, NJ, R = (P[n] for n in ("SR", "TOC", "OR", "NJ", "R"))
    Hkv = k.shape[2]
    G = H // Hkv
    GB = min(G, BM)
    BQ = BM // GB
    n_gr = -(-G // GB)
    n_qt = -(-S // BQ)
    n_bh = B * Hkv * n_gr
    scale = np.float32(hd ** -0.5 * LOG2E)
    t = np.arange(THREADS)
    tx, ty = t % 16, t // 16
    ox, oy = t % TOC, t // TOC
    s_rows = SR * ty[:, None] + np.arange(SR)          # (256, SR)
    s_keys = tx[:, None] + 16 * np.arange(4)           # (256, 4)
    o_rows = OR * oy[:, None] + np.arange(OR)          # (256, OR)
    o_chunks = ox[:, None] + TOC * np.arange(NJ)       # (256, NJ)
    keys = np.arange(BK)
    o = np.full((B, S, H, width), np.nan, np.float32)
    writes = np.zeros((B, S, H, width // 4), np.int64)
    for bid in range(n_qt * n_bh):
        qt = n_qt - 1 - bid // n_bh
        bh = bid % n_bh
        gr = bh % n_gr
        kvh = (bh // n_gr) % Hkv
        b = bh // (n_gr * Hkv)
        q0 = qt * BQ
        kv_end = min(S, q0 + BQ)
        n_steps = -(-kv_end // BK) * 2 * NSL
        rho = np.arange(BM)
        qi, g = rho // GB, gr * GB + rho % GB
        live = (qi < BQ) & (g < G) & (q0 + qi < S)
        h = kvh * G + g
        # the diagonal stop: no tile starts past the block's last live row
        assert (kv_end - 1) // BK * BK <= (q0 + qi[live]).max()

        sQ = np.zeros((BM * CQ, 4), np.float32)
        sQ.reshape(BM, width)[live] = q[b, q0 + qi[live], h[live]]
        ring = np.full((R, BK * CD, 4), np.nan, np.float32)
        sP = np.full((BK * CP, 4), np.nan, np.float32)
        sCorr = np.full(BM, np.nan, np.float32)
        sL = np.full(BM, np.nan, np.float32)

        def load(i):                       # K slabs, then V slabs
            k0, p = i // (2 * NSL) * BK, i % (2 * NSL)
            src = k if p < NSL else v
            d0 = (p % NSL) * D
            inside = k0 + keys < S
            tile = np.zeros((BK, D), np.float32)
            tile[inside] = src[b, k0 + keys[inside], kvh, d0:d0 + D]
            ring[i % R][swz(CD, keys[:, None], np.arange(CD))] = \
                tile.reshape(BK, CD, 4)

        s = np.zeros((THREADS, SR, 4), np.float32)
        m = np.full((THREADS, SR), NEG, np.float32)
        l = np.zeros((THREADS, SR), np.float32)
        acc = np.zeros((THREADS, NSL, OR, 4 * NJ), np.float32)
        for i in range(min(R - 1, n_steps)):
            load(i)
        for i in range(n_steps):
            if i + R - 1 < n_steps:
                load(i + R - 1)            # into slot (i - 1) % R
            slab = ring[i % R]
            p = i % (2 * NSL)
            if p < NSL:
                if p == 0:
                    s[:] = 0
                Qg = sQ[s_rows[:, :, None] * CQ + p * CD + np.arange(CD)]
                Kg = slab[swz(CD, s_keys[:, :, None], np.arange(CD))]
                s += np.einsum("trcx,tjcx->trj", Qg, Kg, dtype=np.float32)
                if p == NSL - 1:
                    k0 = i // (2 * NSL) * BK
                    masked = k0 + BK - 1 > q0
                    pos = q0 + s_rows // GB
                    key = k0 + s_keys[:, None, :]
                    dead = masked & ((key > pos[:, :, None]) | (key >= S))
                    y = np.where(dead, NEG, s * scale).astype(np.float32)
                    mx = np.maximum(m, y.max(-1))
                    # the row's 16 lanes (tx) share one max
                    mx = np.repeat(mx.reshape(16, 16, SR).max(1), 16,
                                   axis=0)
                    corr = np.exp2(m - mx)
                    m = mx
                    l = l * corr
                    pj = np.where(dead, np.float32(0),
                                  np.exp2(y - mx[:, :, None]))
                    for j in range(4):
                        l = l + pj[:, :, j]
                    s = pj
                    lead = tx == 0
                    sCorr[s_rows[lead]] = corr[lead]
                    for j, rc in itertools.product(range(4),
                                                   range(SR // 4)):
                        sP[swz(CP, s_keys[:, j], SR * ty // 4 + rc)] = \
                            s[:, 4 * rc:4 * rc + 4, j]
            else:
                if p == NSL:
                    acc *= sCorr[o_rows][:, None, :, None]
                sPf = sP.reshape(-1)
                Pg = sPf[swz(CP, keys[None, None], (o_rows // 4)[:, :, None])
                         * 4 + (o_rows % 4)[:, :, None]]
                Vg = slab[swz(CD, keys[None, None], o_chunks[:, :, None])]
                acc[:, p - NSL] += np.einsum(
                    "trk,tjkx->trjx", Pg, Vg,
                    dtype=np.float32).reshape(THREADS, OR, 4 * NJ)
        for off in (1, 2, 4, 8):
            l = l + l[t ^ off]
        lead = tx == 0
        sL[s_rows[lead]] = l[lead]
        den = np.maximum(sL, np.float32(1e-30))
        # thread tt's row OR oy + r, chunk sl CD + ox + TOC j
        tt, r, sl, j = np.meshgrid(np.arange(THREADS), np.arange(OR),
                                   np.arange(NSL), np.arange(NJ),
                                   indexing="ij")
        row = o_rows[tt, r]
        ok = live[row]
        at = (b, q0 + qi[row][ok], h[row][ok],
              (sl * CD + o_chunks[tt, j])[ok])
        vals = acc.reshape(THREADS, NSL, OR, NJ, 4)[tt, sl, r, j]
        o.reshape(B, S, H, width // 4, 4)[at] = \
            (vals / den[row][..., None])[ok]
        np.add.at(writes, at, 1)
    assert (writes == 1).all(), "an output not written exactly once"
    return o[..., :hd]


def _qkv(G, hd, S, seed=0):
    rng = np.random.default_rng([seed, G, hd])
    return [rng.standard_normal((1, S, HKV * G if i == 0 else HKV, hd))
            .astype(np.float32) for i in range(3)]


WIDTHS = (16, 32, 64, 128, 256, 320, 512)
GROUPS = (1, 3, 8)


def seqs(hd):
    """S at the tiles' edges: 1, one past a 64-key stage, and one below
    and one past the block's stacked rows."""
    bm = f32_plan(padded_width(hd))["BM"]
    return sorted({1, BK + 1, bm - 1, bm + 1})


@functools.lru_cache(maxsize=None)
def _pallas(G, hd):
    """The Pallas kernel in interpret mode at the width's largest S."""
    q, k, v = _qkv(G, hd, max(seqs(hd)))
    return np.asarray(ref_flash(q, k, v), np.float32)


@pytest.mark.parametrize("G,hd,S", [(G, hd, S) for hd in WIDTHS
                                    for G in GROUPS for S in seqs(hd)])
def test_f32_walk_matches_plain_and_pallas(G, hd, S):
    q, k, v = (x[:, :S] for x in _qkv(G, hd, max(seqs(hd))))
    got = emulate(q, k, v)
    before = dict(_build.LAUNCHES)
    plain = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert _build.LAUNCHES == before                  # the CPU launches none
    want = _pallas(G, hd)[:, :S]
    np.testing.assert_allclose(got, plain.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[:, 0], np.repeat(v[:, 0], G, axis=1),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("hd", [16, 128, 512])
@pytest.mark.parametrize("G", [1, 130])
def test_f32_rows_cover_every_output_once(G, hd):
    """The stacked-row map (more heads than a block's rows split over
    groups, too) writes each (position, head, chunk) once; q = k = 0 and
    v = 1, so every output is 1."""
    S = 70
    q = np.zeros((1, S, G, hd), np.float32)
    kv = np.zeros((1, S, 1, hd), np.float32)
    np.testing.assert_array_equal(emulate(q, kv, kv + 1), 1)


@pytest.mark.parametrize("name,value", [("kF32Threads", F32_THREADS),
                                        ("kBK", F32_BK),
                                        ("kSmemBytes", F32_SMEM)])
def test_f32_plan_constants_match_the_source(name, value):
    """f32_plan's threads, keys a tile and shared-memory limit are the
    kernel's own constants."""
    found = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert found and int(found.group(1)) == value


@pytest.mark.parametrize("hd", F32_WIDTHS)
def test_f32_plan_fits_a_block(hd):
    """Every width's tiles: shared memory within the 227 KB a block may
    take and at least two ring slots; the score and output micro-tiles
    cover the block's rows, keys and dims once; O's registers at most 128
    floats a thread."""
    P = f32_plan(hd)
    assert P["smem"] <= SMEM and P["R"] >= 2
    assert 16 * P["SR"] == P["BM"] and P["SR"] % 4 == 0
    assert (THREADS // P["TOC"]) * P["OR"] == P["BM"]
    assert P["TOC"] * P["NJ"] == P["CD"]
    assert P["NSL"] * P["OR"] * 4 * P["NJ"] <= 128
    assert {128: 230400, 256: 213504, 384: 213504,
            512: 213504}.get(hd, P["smem"]) == P["smem"]
