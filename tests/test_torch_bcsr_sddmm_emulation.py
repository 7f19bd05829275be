"""A numpy emulation of the index logic of bcsr_sddmm
(src/repro_torch/kernels/csrc/bcsr.cu), held against the kernel's plain
version, the JAX package's Pallas kernel ``bcsr_sddmm`` (interpret mode)
and its leaf ``leaf_bcsr_sddmm``.

A warp takes a run of 64 consecutive stored blocks of a piece (the last
run fewer) for one row group of 4 rows and one tile of S columns of their
blocks; lanes sit on (column slot, k-quad): G lanes a column (G = K / 4
rounded up to a power of two, at most 32), S = 32 / G columns. The ids come
32 at a time (lane t holds block t's, clamped into the grid), and the warp
takes its blocks U = 4 at a time: per k tile of 4G floats it loads every
block's Dt quad first, then, block by block, reloads the C quads of its 4
rows only when (block-row, k tile) differs from what it holds, and adds its
quad's four products into one partial per row (fma, in k order). A tree of
xor shuffles at offsets G/2 .. 1 sums each column's G lanes; lane q of a
column writes rows q, q + G, ... of the row group, out = tile * sum. The
stores are counted (each output exactly once) and so are the C reloads:
within a warp's run of blocks of one block-row (one k tile) C is gathered
once. The kernel's 16-byte and 4-byte quad loads read the same values (a
lane's quad past K reads 0), so one emulation serves both. Products are
fused into the adds (fma, emulated in float64 and rounded once to
float32); the plain version and the JAX functions add in other orders and
are held per entry at 1e-5 * scale + 1e-6, ``scale`` the same product on
absolute values.
"""
import numpy as np
import pytest
import torch

from repro.kernels import bcsr as rbcsr
from repro.kernels import ref as rref

from repro_torch.kernels import _build, bcsr

WARP, ROWS, U, BLOCKS = 32, 4, 4, 64   # kWarp, kSdRows, kSdU, kSdBlocks
RTOL, ATOL = 1e-5, 1e-6
OVERSIZED = [(33, 1), (16, 32), (1, 300), (64, 8)]


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def group_size(K):
    g = 1
    while g < WARP and 4 * g < K:
        g *= 2
    return g


def _quad(table, row, k, K, use):
    """Each lane's four floats of ``table[row, k .. k + 3]`` (0 past K or
    where not ``use``): (4, 32)."""
    out = np.zeros((4, WARP), np.float32)
    for i in range(4):
        ok = use & (k + i < K)
        out[i, ok] = table[row[ok], (k + i)[ok]]
    return out


def emulate(brow, bcol, tiles, C, Dt):
    """out (P, N, br, bc) as bcsr_sddmm's launch computes it (NaN where
    nothing was stored), the stores to each output and the C reloads of
    each warp, {(p, run, row group, column tile): count}."""
    P, N, br, bc = tiles.shape
    K = Dt.shape[1]
    Cp = C if C.ndim == 3 else np.broadcast_to(C, (P,) + C.shape)
    grid_r, grid_c = Cp.shape[1] // br, Dt.shape[0] // bc
    G = group_size(K)
    S, W = WARP // G, -(-ROWS // G)
    n_rg, n_ct, n_kt = -(-br // ROWS), -(-bc // S), -(-K // (4 * G))
    lane = np.arange(WARP)
    q = lane % G
    out = np.full(tiles.shape, np.nan, np.float32)
    writes = np.zeros(tiles.shape, np.int64)
    reloads = {}
    for p, run, rg, ct in np.ndindex(P, -(-N // BLOCKS), n_rg, n_ct):
        b0, b1 = run * BLOCKS, min(N, run * BLOCKS + BLOCKS)
        r0 = rg * ROWS
        nr = min(ROWS, br - r0)
        c = ct * S + lane // G
        col_in = c < bc
        ctag, creg = -1, None
        reloads[p, run, rg, ct] = 0
        for base in range(b0, b1, WARP):
            cnt = min(b1 - base, WARP)
            row_l = np.clip(brow[p, base:base + cnt], 0, grid_r - 1)
            col_l = np.clip(bcol[p, base:base + cnt], 0, grid_c - 1)
            for t0 in range(0, cnt, U):
                live = [t0 + u < cnt for u in range(U)]
                rows = [int(row_l[min(t0 + u, cnt - 1)]) for u in range(U)]
                drow = [col_l[min(t0 + u, cnt - 1)] * bc
                        + np.where(col_in, c, 0) for u in range(U)]
                part = np.zeros((U, ROWS, WARP), np.float32)
                for kt in range(n_kt):
                    k = kt * 4 * G + 4 * q
                    d = [_quad(Dt, drow[u], k, K, live[u] & col_in)
                         for u in range(U)]
                    for u in range(U):
                        if not live[u]:
                            break
                        key = rows[u] * n_kt + kt
                        if key != ctag:
                            ctag = key
                            reloads[p, run, rg, ct] += 1
                            first = rows[u] * br + r0
                            creg = [_quad(Cp[p], np.full(WARP, first + r), k,
                                          K, np.full(WARP, r < nr))
                                    for r in range(ROWS)]
                        for r in range(ROWS):
                            acc = part[u, r]
                            for i in range(4):
                                acc = _fma(creg[r][i], d[u][i], acc)
                            part[u, r] = acc
                for u in range(U):
                    if not live[u]:
                        break
                    off = G // 2
                    while off:
                        part[u] = (part[u] + part[u][:, lane ^ off]) \
                            .astype(np.float32)
                        off //= 2
                    e = base + t0 + u
                    for wi in range(W):
                        rr = q + wi * G
                        ok = col_in & (rr < nr)
                        r = r0 + rr[ok]
                        val = part[u][np.minimum(rr, ROWS - 1), lane]
                        out[p, e, r, c[ok]] = (
                            tiles[p, e, r, c[ok]] * val[ok]).astype(np.float32)
                        np.add.at(writes[p, e], (r, c[ok]), 1)
    return out, writes, reloads


def _check(brow, bcol, tiles, C, Dt):
    got, writes, reloads = emulate(brow, bcol, tiles, C, Dt)
    assert (writes == 1).all(), "an output written twice or never"
    T = torch.from_numpy
    before = dict(_build.LAUNCHES)
    plain = bcsr.bcsr_sddmm(T(brow), T(bcol), T(tiles), T(C), T(Dt)).numpy()
    assert _build.LAUNCHES == before                  # the CPU launches none
    scale = bcsr.bcsr_sddmm(T(brow), T(bcol), T(np.abs(tiles)),
                            T(np.abs(C)), T(np.abs(Dt))).numpy()
    tol = RTOL * scale + ATOL
    assert (np.abs(got - plain) <= tol).all()
    P, N, br, bc = tiles.shape
    K = Dt.shape[1]
    grid_r, grid_c = C.shape[-2] // br, Dt.shape[0] // bc
    rb, cb = np.clip(brow, 0, grid_r - 1), np.clip(bcol, 0, grid_c - 1)
    D_blk = Dt.reshape(grid_c, bc, K).transpose(0, 2, 1)
    pad = -N % 16
    for p in range(P):
        C_blk = (C[p] if C.ndim == 3 else C).reshape(grid_r, br, K)
        leaf = np.asarray(rref.leaf_bcsr_sddmm(rb[p], cb[p], tiles[p], C_blk,
                                               D_blk))
        assert (np.abs(got[p] - leaf) <= tol[p]).all()
        if N:
            pallas = np.asarray(rbcsr.bcsr_sddmm(
                np.pad(rb[p], (0, pad)), np.pad(cb[p], (0, pad)),
                np.pad(tiles[p], ((0, pad), (0, 0), (0, 0))), C_blk, D_blk,
                interpret=True))[:N]
            assert (np.abs(got[p] - pallas) <= tol[p]).all()
    return reloads


def _operands(seed, P, N, block, grid_r, grid_c, K, shared, runs=None):
    """Block-row ids sorted within each piece (``runs``: explicit run
    lengths of piece 0), ids below 0 and past the grid (clamped), padding
    slots with zero tiles."""
    rng = np.random.default_rng(seed)
    br, bc = block
    brow = np.sort(rng.integers(-2, grid_r + 2, (P, N)), axis=1)
    if runs is not None:
        brow[0] = np.repeat(np.arange(len(runs)), runs)[:N]
    bcol = rng.integers(-2, grid_c + 2, (P, N))
    tiles = rng.standard_normal((P, N, br, bc)).astype(np.float32)
    tiles[:, N - N // 6:] = 0                     # padding slots
    C = rng.standard_normal((grid_r * br, K) if shared
                            else (P, grid_r * br, K)).astype(np.float32)
    Dt = rng.standard_normal((grid_c * bc, K)).astype(np.float32)
    return (brow.astype(np.int32), bcol.astype(np.int32), tiles, C, Dt)


@pytest.mark.parametrize("K", [1, 3, 4, 7, 8, 16, 32, 33, 64, 128, 256])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-piece"])
def test_lane_groups_and_k_tiles(K, shared):
    """(4, 4) blocks at every lane-group size (G = 1 .. 32 at K = 4 .. 128),
    K % 4 != 0 (a lane's quad past K reads 0), K = 256 in two k tiles (C
    reloaded per k tile), C shared or per piece; N = 150 leaves a last warp
    of 22 blocks."""
    _check(*_operands(K, 2, 150, (4, 4), 9, 11, K, shared))


@pytest.mark.parametrize("block", [(1, 1), (2, 2), (3, 5), (4, 8), (8, 4),
                                   (32, 8)] + OVERSIZED,
                         ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("K", [7, 32])
def test_any_block(block, K):
    """Blocks of the card's edge cases and the four that once exceeded the
    kernels (more than 32 rows or 256 entries): row groups of 4 rows with
    a ragged last one, column tiles of S columns with a ragged last one,
    idle column slots when bc < S."""
    _check(*_operands(sum(block) + K, 2, 70, block, 3, 4, K,
                      K == 32))


@pytest.mark.parametrize("N", [1, 4, 5, 31, 33, 63, 64, 65, 129])
def test_ragged_last_warp(N):
    """A last warp cut anywhere in its 64 blocks, its last chunk of 32 and
    its last group of U = 4 blocks."""
    _check(*_operands(N, 2, N, (4, 4), 5, 6, 32, N % 2 == 1))


def test_c_is_gathered_once_per_run():
    """Runs of one block-row: a warp reloads C once for each change of
    block-row it sees (plus one at its start), not once per block; the
    result does not depend on the order of the ids (a shuffled stream
    reloads more and gives the same outputs, slot by slot)."""
    runs = [70, 3, 1, 1, 0, 50, 3]               # 128 blocks: two warps
    brow, bcol, tiles, C, Dt = _operands(1, 1, 128, (4, 4), 7, 9, 32, True,
                                         runs=runs)
    reloads = _check(brow, bcol, tiles, C, Dt)
    for w in range(2):
        ids = brow[0, w * BLOCKS:(w + 1) * BLOCKS]
        assert reloads[0, w, 0, 0] == 1 + int((ids[1:] != ids[:-1]).sum())
    perm = np.random.default_rng(2).permutation(128)
    shuffled = _check(brow[:, perm], bcol[:, perm], tiles[:, perm], C, Dt)
    assert sum(shuffled.values()) > sum(reloads.values())
    got, _, _ = emulate(brow, bcol, tiles, C, Dt)
    got_s, _, _ = emulate(brow[:, perm], bcol[:, perm], tiles[:, perm], C,
                          Dt)
    np.testing.assert_array_equal(got_s, got[:, perm])


def test_empty_piece_and_zero_tiles():
    """Two pieces of one stream length, the second all padding (zero
    tiles, the dropped id): every slot is stored, the padding as 0."""
    brow, bcol, tiles, C, Dt = _operands(4, 2, 40, (2, 2), 3, 3, 8, True)
    brow[1], tiles[1] = 3, 0
    _check(brow, bcol, tiles, C, Dt)
