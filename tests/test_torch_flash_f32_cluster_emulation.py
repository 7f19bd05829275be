"""A numpy emulation of the index logic of flash_attention's f32 cluster
kernel (``flash_f32_cluster_kernel<BW>`` in
src/repro_torch/kernels/csrc/flash_attention.cu: f32 at the widths the
wrapper pads hd 513-4096 to), held against the kernel's plain version and
the Pallas kernel in interpret mode at 1e-5.

The emulation walks the kernel's clusters, blocks, steps and threads as the
kernel does. A cluster of NC = ceil(W / BW) blocks holds 64 stacked rows
(row rho is query head gr·GB + rho % GB at position q0 + rho // GB),
heaviest tiles first, over tiles of 64 keys; block r owns O's columns BW r
.. and the same BW dims of Q, M = BW / 128 slabs of them (BW 128 up to
2048, 256 above, where the last block's second 128 columns lie past W when
W / 128 is odd: zero-filled and never stored). Each block's shared memory
is modelled as flat arrays of 16-byte chunks, filled with NaN, at the
kernel's addresses: its slice of Q row-major, a ring of R slabs of 64 keys
x 128 dims XOR-swizzled by ``swz``, the partial score tile and the sums
(thread t's 16 scores at the float4s t + 256 x), P^T (keys x rows)
swizzled the same way, and the rows' rescale and sums. The slabs come in
the kernel's order (K of tile 0, then K of tile t + 1 and V of tile t,
then the last V, each as its M slabs in column order); step i loads slab i
+ R - 1 into slot (i - 1) % R before it reads slot i % R, the earliest the
kernel's cp.async may land, so a slot reused too soon or an unloaded chunk
shows as a wrong value or a NaN. Keys past S are zero-filled.

Per tile every block stores its partial over its BW dims; then block r
adds slice r of the tile (float4s SL·r .., SL = 1024 / NC rounded up) over
the NC blocks' partials in rank order into its sums (the reduce-scatter);
then every partial is filled with NaN, as a peer past the second barrier
may already store its next partial; then every thread loads its 16 scores
from the blocks that own them (the all-gather), and every sum is filled
with NaN, as a peer past the next tile's first barrier may store its next
sums. The tile before's P·V runs in two halves around the reduce-scatter:
at BW 256 the first V slab before it and the second after it, each read
from the ring when its step comes. Each float4 of a tile must be summed by
exactly one block, and all blocks must hold the same bits. The softmax is
flash_f32_kernel's (the scale hd^-0.5·log2(e), exp2, the finite -1e30,
masked p set to 0 again, masking only in tiles that reach past the block's
first position, each row's max over its 16 lanes, the lanes' partial sums
reduced at the end by the xor tree), run by every block on its own copy
of the scores. Its products are numpy's, not the kernel's FMA chains: the
point is which rows, keys, dims, buffers and slots meet. Every output
must be written exactly once.

Inputs are standard normal from a numpy seed. Causal attention over the
first S positions depends on nothing later, so the Pallas reference for
every S is the prefix of one call at the largest S of the width.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (CHUNK, F32_BK,
                                                 F32_CLUSTER_COLS,
                                                 F32_CLUSTER_MAX, F32_SMEM,
                                                 F32_THREADS,
                                                 f32_cluster_plan,
                                                 flash_attention,
                                                 padded_width)
from test_torch_flash_f32_emulation import swz

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "flash_attention.cu").read_text()
THREADS, BK = F32_THREADS, F32_BK
NEG = np.float32(-1e30)
LOG2E = 1.4426950408889634
HKV = 2
TOL = 1e-5


def slab_order(n_tiles: int) -> list:
    """The kernel's unit of each group of M steps (M slabs, one a 128
    columns of a block), as ("K" or "V", tile): K of tile 0; then K of
    tile (u + 1) // 2 for odd u and V of tile u // 2 - 1 for even u; the
    last unit V of the last tile (the kernel's ``load``, u = i // M)."""
    n_steps = 2 * n_tiles
    out = []
    for i in range(n_steps):
        is_v = i > 0 and (i % 2 == 0 or i == n_steps - 1)
        tile = ((n_tiles - 1 if i == n_steps - 1 else i // 2 - 1) if is_v
                else (i + 1) // 2)
        out.append(("V" if is_v else "K", tile))
    return out


def emulate(q, k, v):
    """o (B, S, H, hd) as flash_f32_cluster_kernel's clusters, blocks and
    threads compute it, from float32 arrays; hd is zero-padded to the
    kernel's width (the scale stays the true width's)."""
    B, S, H, hd = q.shape
    W = padded_width(hd)
    P = f32_cluster_plan(W)
    NC, BW, M, BM, D = (P[n] for n in ("NC", "BW", "M", "BM", "D"))
    CQ, CD, CP = P["CQ"], P["CD"], P["CP"]
    SR, TOC, OR, NJ, R = (P[n] for n in ("SR", "TOC", "OR", "NJ", "R"))
    PART4 = P["PART"] // 4
    # the cluster's columns: W, then zeros up to NC·BW (never stored)
    q, k, v = (np.pad(x, ((0, 0),) * 3 + ((0, NC * BW - hd),))
               for x in (q, k, v))
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
    ranks = np.arange(NC)
    o = np.full((B, S, H, W), np.nan, np.float32)
    writes = np.zeros((B, S, H, W // 4), np.int64)
    for cid in range(n_qt * n_bh):                     # blockIdx.x // NC
        qt = n_qt - 1 - cid // n_bh
        bh = cid % n_bh
        gr = bh % n_gr
        kvh = (bh // n_gr) % Hkv
        b = bh // (n_gr * Hkv)
        q0 = qt * BQ
        kv_end = min(S, q0 + BQ)
        n_tiles = -(-kv_end // BK)
        order = [(kind, tile, x) for kind, tile in slab_order(n_tiles)
                 for x in range(M)]
        rho = np.arange(BM)
        qi, g = rho // GB, gr * GB + rho % GB
        live = (qi < BQ) & (g < G) & (q0 + qi < S)
        h = kvh * G + g
        assert (kv_end - 1) // BK * BK <= (q0 + qi[live]).max()

        # each block's shared memory, block r at its rank
        rows = np.zeros((BM, NC * BW), np.float32)
        rows[live] = q[b, q0 + qi[live], h[live]]
        sQ = rows.reshape(BM, NC, CQ, 4).transpose(1, 0, 2, 3).reshape(
            NC, BM * CQ, 4)
        ring = np.full((NC, R, BK * CD, 4), np.nan, np.float32)
        part = np.full((NC, PART4, 4), np.nan, np.float32)
        sums = np.full((NC, PART4, 4), np.nan, np.float32)
        SL = -(-PART4 // NC)                           # float4s a slice
        sP = np.full((NC, BK * CP, 4), np.nan, np.float32)
        sCorr = np.full((NC, BM), np.nan, np.float32)
        sL = np.full((NC, BM), np.nan, np.float32)

        def load(i):                   # slab i of every block into slot i % R
            kind, tile, x = order[i]
            src = k if kind == "K" else v
            k0 = tile * BK
            inside = k0 + keys < S
            slab = np.zeros((BK, NC, M, D), np.float32)
            slab[inside] = src[b, k0 + keys[inside], kvh].reshape(
                -1, NC, M, D)
            ring[:, i % R][:, swz(CD, keys[:, None], np.arange(CD))] = \
                slab[:, :, x].transpose(1, 0, 2).reshape(NC, BK, CD, 4)

        m = np.full((NC, THREADS, SR), NEG, np.float32)
        l = np.zeros((NC, THREADS, SR), np.float32)
        acc = np.zeros((NC, THREADS, M, OR, 4 * NJ), np.float32)
        n_steps = len(order)
        for i in range(min(R - 1, n_steps)):
            load(i)

        def step(i, want):
            """slab i's slots, once slab i + R - 1 is on its way"""
            assert order[i] == want
            if i + R - 1 < n_steps:
                load(i + R - 1)        # into slot (i - 1) % R
            return ring[:, i % R]

        def pv(slab, x):               # O_x (+ P V), every block
            sPf = sP.reshape(NC, -1)
            Pg = sPf[:, swz(CP, keys[None, None], (o_rows // 4)[:, :, None])
                     * 4 + (o_rows % 4)[:, :, None]]
            Vg = slab[:, swz(CD, keys[None, None], o_chunks[:, :, None])]
            acc[:, :, x] += np.einsum("ntrk,ntjkx->ntrjx", Pg, Vg,
                                      dtype=np.float32).reshape(
                acc[:, :, x].shape)

        def rescale():                 # O = O . corr
            acc[:] = acc * sCorr[:, o_rows][:, :, None, :, None]

        def pv_half(i, tile, half):
            """the tile before's P V, half ``half``: both halves of the keys
            of its one V slab at M = 1 (the slab read once), slab x = half
            at M = 2"""
            if M == 1 and half == 1:
                return i
            for x in range(M):
                if M > 1 and x != half:
                    continue
                slab = step(i, ("V", tile - 1, x))
                i += 1
                if x == 0:
                    rescale()
                pv(slab, x)
            return i

        i = 0
        for tile in range(n_tiles):
            k0 = tile * BK
            partial = np.zeros((NC, THREADS, SR, 4), np.float32)
            for x in range(M):
                slab = step(i, ("K", tile, x))
                i += 1
                Qg = sQ[:, s_rows[:, :, None] * CQ + x * CD + np.arange(CD)]
                Kg = slab[:, swz(CD, s_keys[:, :, None], np.arange(CD))]
                partial = partial + np.einsum(
                    "ntrcx,ntjcx->ntrj", Qg, Kg, dtype=np.float32)
            for x in range(SR):
                part[:, x * THREADS + t] = partial[:, :, x]
            if tile > 0:
                i = pv_half(i, tile, 0)
            # block r adds slice r over the NC partials in rank order
            summed = np.zeros(PART4, np.int64)
            for r in ranks:
                e = np.arange(r * SL, min(r * SL + SL, PART4))
                acc4 = np.zeros((len(e), 4), np.float32)
                for rank in ranks:
                    acc4 = acc4 + part[rank, e]
                sums[r, e] = acc4
                summed[e] += 1
            assert (summed == 1).all(), "a float4 not summed exactly once"
            if tile > 0:
                i = pv_half(i, tile, 1)
            part[:] = np.nan              # peers may store the next partial
            # every thread's 16 scores, from the blocks that summed them
            s = np.zeros((NC, THREADS, SR, 4), np.float32)
            for x in range(SR):
                e = x * THREADS + t
                s[:, :, x] = sums[e // SL, e][None]
            sums[:] = np.nan              # peers may store the next sums
            assert not np.isnan(s).any()
            assert all(np.array_equal(s[0], s[r]) for r in ranks)
            masked = k0 + BK - 1 > q0
            pos = q0 + s_rows // GB
            key = k0 + s_keys[:, None, :]
            dead = masked & ((key > pos[:, :, None]) | (key >= S))
            y = np.where(dead, NEG, s * scale).astype(np.float32)
            mx = np.maximum(m, y.max(-1))
            # a row's 16 lanes (tx) share one max
            mx = np.repeat(mx.reshape(NC, 16, 16, SR).max(2), 16, axis=1)
            corr = np.exp2(m - mx)
            m = mx
            l = l * corr
            pj = np.where(dead, np.float32(0), np.exp2(y - mx[..., None]))
            for j in range(4):
                l = l + pj[..., j]
            lead = tx == 0
            sCorr[:, s_rows[lead]] = corr[:, lead]
            for j in range(4):
                for rc in range(SR // 4):
                    sP[:, swz(CP, s_keys[:, j], SR * ty // 4 + rc)] = \
                        pj[:, :, 4 * rc:4 * rc + 4, j]
        for x in range(M):             # V of the last tile
            slab = step(i, ("V", n_tiles - 1, x))
            i += 1
            if x == 0:
                rescale()
            pv(slab, x)
        assert i == n_steps
        for off in (1, 2, 4, 8):
            l = l + l[:, t ^ off]
        lead = tx == 0
        sL[:, s_rows[lead]] = l[:, lead]
        den = np.maximum(sL, np.float32(1e-30))
        # block r, thread tt's row OR oy + r, slab x's chunk ox + TOC j: the
        # output's chunk (BW r + D x) / 4 + ox + TOC j, stored below W
        rr, tt, xx, ri, j = np.meshgrid(ranks, t, np.arange(M),
                                        np.arange(OR), np.arange(NJ),
                                        indexing="ij")
        row = o_rows[tt, ri]
        chunk = (rr * BW + xx * D) // 4 + o_chunks[tt, j]
        ok = live[row] & (chunk < W // 4)
        at = (b, q0 + qi[row][ok], h[row][ok], chunk[ok])
        vals = acc.reshape(NC, THREADS, M, OR, NJ, 4)[rr, tt, xx, ri, j]
        o.reshape(B, S, H, W // 4, 4)[at] = \
            (vals / den[rr, row][..., None])[ok]
        np.add.at(writes, at, 1)
    assert (writes == 1).all(), "an output not written exactly once"
    return o[..., :hd]


def _qkv(G, hd, S, seed=0):
    rng = np.random.default_rng([seed, G, hd])
    return [rng.standard_normal((1, S, HKV * G if i == 0 else HKV, hd))
            .astype(np.float32) for i in range(3)]


# the widest cluster of 128-column blocks (16 blocks) and of the kernel
# (16 blocks of 256 columns)
WIDEST = CHUNK * F32_CLUSTER_MAX
F32_WIDEST = F32_CLUSTER_COLS * F32_CLUSTER_MAX
WIDTHS = (520, 640, 768, 1024)
GROUPS = (1, 3, 8)
SEQS = (1, 17, 65, 130)
CASES = [(G, hd, S) for hd in WIDTHS for G in GROUPS for S in SEQS] + [
    (G, WIDEST, 17) for G in (1, 3)] + [
    (G, hd, S) for hd in (WIDEST + CHUNK, F32_WIDEST)
    for G, S in ((1, 130), (3, 17))]


@functools.lru_cache(maxsize=None)
def _pallas(G, hd, S):
    """The Pallas kernel in interpret mode at S."""
    q, k, v = _qkv(G, hd, S)
    return np.asarray(ref_flash(q, k, v), np.float32)


@pytest.mark.parametrize("G,hd,S", CASES)
def test_cluster_walk_matches_plain_and_pallas(G, hd, S):
    """The walk against the plain version and the Pallas kernel at 1e-5;
    position 0 is v[0]. hd 520 comes padded to 640; 2048 is the widest
    cluster of 128-column blocks, 16 of them; 2176 takes 9 blocks of 256
    columns (the last one's second 128 past hd), 4096 16 of them, the
    kernel's widest; S 130 runs the tile before's P·V in its two halves."""
    s_max = max(SEQS) if hd in WIDTHS else S
    q, k, v = (x[:, :S] for x in _qkv(G, hd, s_max))
    got = emulate(q, k, v)
    before = dict(_build.LAUNCHES)
    plain = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert _build.LAUNCHES == before                  # the CPU launches none
    want = _pallas(G, hd, s_max)[:, :S]
    np.testing.assert_allclose(got, plain.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[:, 0], np.repeat(v[:, 0], G, axis=1),
                               atol=1e-6, rtol=1e-6)


def test_plain_version_matches_pallas_at_hd_2176():
    """The port's plain flash_attention (what the wrapper runs on the CPU)
    against the Pallas kernel in interpret mode at f32 hd 2176, past the
    widest cluster of 128-column blocks, at 1e-5."""
    q, k, v = _qkv(2, WIDEST + CHUNK, 33, seed=4)
    plain = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(plain.numpy(), np.asarray(
        ref_flash(q, k, v), np.float32), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("G", [1, 130])
def test_cluster_rows_cover_every_output_once(G):
    """The stacked-row map (more heads than a block's rows split over
    groups, too) writes each (position, head, chunk) once, each chunk by
    the block of its columns; q = k = 0 and v = 1, so every output is 1."""
    S, hd = 70, 640
    q = np.zeros((1, S, G, hd), np.float32)
    kv = np.zeros((1, S, 1, hd), np.float32)
    np.testing.assert_array_equal(emulate(q, kv, kv + 1), 1)


@pytest.mark.parametrize("n_tiles", [1, 2, 3, 7])
def test_slab_order_loads_each_slab_once_before_its_use(n_tiles):
    """Each K and V slab of every tile is loaded once; K of tile t + 1 is
    used before V of tile t (its product covers the barrier), and V of a
    tile comes after its K."""
    order = slab_order(n_tiles)
    assert sorted(order) == sorted((kind, tile) for kind in "KV"
                                   for tile in range(n_tiles))
    used = [("K", 0)] + [x for tile in range(1, n_tiles)
                         for x in (("K", tile), ("V", tile - 1))] + [
        ("V", n_tiles - 1)]
    assert order == used


@pytest.mark.parametrize("name,value", [
    ("kF32Threads", F32_THREADS), ("kBK", F32_BK), ("kSmemBytes", F32_SMEM),
    ("kChunk", CHUNK), ("kF32MaxCluster", F32_CLUSTER_MAX),
    ("kF32MaxBlockCols", F32_CLUSTER_COLS)])
def test_cluster_constants_match_the_source(name, value):
    """f32_cluster_plan's threads, keys a tile, shared-memory limit, slab
    width, widest cluster and widest block are the kernel's own
    constants."""
    found = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert found and int(found.group(1)) == value


@pytest.mark.parametrize("hd", [640, 1024, WIDEST, WIDEST + CHUNK,
                                F32_WIDEST])
def test_cluster_plan_fits_a_block(hd):
    """ClusterPlan<BW>: its shared bytes are the source's static_assert
    and within the 227 KB a block may take, with at least two ring slots;
    a thread's 16 scores tile the partial and its micro-tiles cover the
    block's rows, keys and each 128-column slab once; O 32 floats a thread
    a slab; one block for every 128 columns up to 16 blocks (hd 2048), one
    for every 256 above, up to the widest cluster, and no plan past it."""
    P = f32_cluster_plan(hd)
    found = re.search(rf"ClusterPlan<{P['BW']}>::smem == (\d+)", SOURCE)
    assert found and int(found.group(1)) == P["smem"] <= F32_SMEM
    assert P["BW"] == (CHUNK if hd <= WIDEST else F32_CLUSTER_COLS)
    assert P["BW"] == P["M"] * P["D"] and P["CQ"] * 4 == P["BW"]
    assert P["R"] >= 2 and P["NC"] <= F32_CLUSTER_MAX
    assert (P["NC"] - 1) * P["BW"] < hd <= P["NC"] * P["BW"] <= P["widest"]
    assert 4 * P["SR"] * THREADS == P["PART"] == P["BM"] * BK
    assert (THREADS // P["TOC"]) * P["OR"] == P["BM"]
    assert P["TOC"] * P["NJ"] == P["CD"] and P["OR"] * 4 * P["NJ"] == 32
    with pytest.raises(ValueError):
        f32_cluster_plan(P["widest"] + CHUNK)
    with pytest.raises(ValueError):
        f32_cluster_plan(512)
