"""A numpy emulation of the index logic of spmv_coo_nnz's two phases
(src/repro_torch/kernels/csrc/spmv.cu), held against the kernel's plain
version and the Pallas kernel in interpret mode.

Phase 1 takes fixed 1024-entry blocks, four consecutive entries a thread:
the runs inside each thread summed in order, a segmented scan of the
threads' last runs over equal row ids (the warp's shuffle scan, then the
carry from the lane before and from earlier warps, nearest first, in the
kernel's order), a run wholly inside its block written to y by its last
entry, and the block's first- and last-run partials left in head and
tail. Phase 2 takes each row at its first crossing edge, finds its last
block by the kernel's search over the blocks' first ids, and folds
tail[first] + head[first + 1] + ... + head[last] as the kernel's warp does:
lane l adds blocks a + l, a + l + 32, ... in order, then a butterfly over
offsets 16, 8, 4, 2, 1. y starts at 0 (the kernel clears it) and every
element may be written at most once. All sums are float32 in the kernel's
order, so the emulation predicts the kernel's bits; the plain version and
the Pallas kernel add in other orders and are held at 1e-4 (the
reference's SpMV tolerance).

The pieces: chip_smoke.nnz_split_pieces (a run ending on a block's last
entry, runs of exactly 1024 and 1025, a row over six blocks, more than 1024
empty rows, padding with the dropped id, an empty piece, a piece that is
one row), pieces whose runs end at every offset around one block edge,
and random pieces with long runs (ending anywhere in a thread's four
entries and a warp's 128).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import _build, spmv

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

PER, THREADS, WARP = 4, 256, 32          # kPer, kThreads, kWarp
BLK = PER * THREADS                      # kNnzBlock
NONE = 2**31 - 1


def _warp_scan(v, key):
    """The shuffle-up segmented inclusive scan of one warp."""
    for d in (1, 2, 4, 8, 16):
        up = np.concatenate([np.zeros(d, np.float32), v[:-d]])
        up_key = np.concatenate([np.full(d, -2**31), key[:-d]])
        v = np.where(up_key == key, v + up, v).astype(np.float32)
    return v


def _fold(hp, tp, a, b):
    """tp[a] + hp[a + 1] + ... + hp[b] in the warp's order."""
    lanes = np.zeros(WARP, np.float32)
    for lane in range(WARP):
        for t in range(a + lane, b + 1, WARP):
            lanes[lane] += tp[t] if t == a else hp[t]
    for off in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[np.arange(WARP) ^ off]).astype(np.float32)
    return lanes[0]


def emulate(rows, cols, vals, c, max_rows):
    """y (P, max_rows) as spmv_coo_nnz's phases compute it."""
    P, N = rows.shape
    m = c.shape[0]
    nb = -(-N // BLK)
    y = np.zeros((P, max_rows), np.float32)
    writes = np.zeros((P, max_rows), np.int64)
    head = np.full((P, nb), np.nan, np.float32)
    tail = np.full((P, nb), np.nan, np.float32)
    for p in range(P):
        pr = rows[p]
        for blk in range(nb):
            lo, hi = blk * BLK, min(N, blk * BLK + BLK)
            r = np.full(BLK, NONE, np.int64)
            v = np.zeros(BLK, np.float32)
            r[:hi - lo] = pr[lo:hi]
            v[:hi - lo] = vals[p, lo:hi] * c[np.clip(cols[p, lo:hi], 0,
                                                     m - 1)]
            r, v = r.reshape(THREADS, PER), v.reshape(THREADS, PER)
            for j in range(1, PER):
                v[:, j] = np.where(r[:, j] == r[:, j - 1],
                                   v[:, j] + v[:, j - 1], v[:, j])
            last = r[:, -1]
            s = np.concatenate([_warp_scan(v[w:w + WARP, -1], last[w:w + WARP])
                                for w in range(0, THREADS, WARP)])
            first_row, last_row = r[::WARP, 0], last[WARP - 1::WARP]
            last_sum = s[WARP - 1::WARP]
            for t in range(THREADS):
                if lo + PER * t >= hi:
                    break
                w = t // WARP
                carry = np.float32(0)
                if t % WARP and last[t - 1] == r[t, 0]:
                    carry = s[t - 1]
                if first_row[w] == r[t, 0]:
                    for k in range(w - 1, -1, -1):
                        if last_row[k] != r[t, 0]:
                            break
                        carry = np.float32(carry + last_sum[k])
                        if first_row[k] != r[t, 0]:
                            break
                after = r[t + 1, 0] if t + 1 < THREADS else NONE
                for j in range(PER):
                    i = lo + PER * t + j
                    last_run = i == hi - 1
                    nxt = r[t, j + 1] if j + 1 < PER else after
                    if i >= hi or not (last_run or nxt != r[t, j]):
                        continue
                    row = r[t, j]
                    total = (np.float32(v[t, j] + carry) if row == r[t, 0]
                             else v[t, j])
                    first_run = row == r[0, 0]
                    if first_run:
                        head[p, blk] = total
                    if last_run:
                        tail[p, blk] = total
                    cross = ((first_run and lo > 0 and pr[lo - 1] == row)
                             or (last_run and hi < N and pr[hi] == row))
                    if not cross and 0 <= row < max_rows:
                        y[p, row] = total
                        writes[p, row] += 1
        for e in range(1, nb):
            r = pr[e * BLK]
            starts = pr[e * BLK - 1] == r and (e == 1
                                               or pr[(e - 1) * BLK - 1] != r)
            if not (starts and 0 <= r < max_rows):
                continue
            lo_b, hi_b = e, nb
            while hi_b - lo_b > 1:
                mid = (lo_b + hi_b) // 2
                if pr[mid * BLK] == r:
                    lo_b = mid
                else:
                    hi_b = mid
            y[p, r] = _fold(head[p], tail[p], e - 1, lo_b)
            writes[p, r] += 1
    assert writes.max(initial=0) <= 1, "a row written twice"
    return y


def _check(rows, cols, vals, c, max_rows):
    got = emulate(rows, cols, vals, c, max_rows)
    assert np.isfinite(got).all()
    before = dict(_build.LAUNCHES)
    plain = spmv.spmv_coo_nnz(*(torch.from_numpy(x) for x in
                                (rows, cols, vals, c)), max_rows).numpy()
    assert _build.LAUNCHES == before                  # the CPU launches none
    np.testing.assert_allclose(got, plain, atol=1e-4, rtol=1e-4)
    cc = np.clip(cols, 0, c.shape[0] - 1)
    for p in range(rows.shape[0]):
        want = np.asarray(rops.spmv_nnz(rows[p], cc[p], vals[p], c,
                                        n_rows=max_rows, impl="pallas"))
        np.testing.assert_allclose(got[p], want, atol=1e-4, rtol=1e-4)


def test_block_edge_pieces():
    rows, cols, vals, m, R = chip_smoke.nnz_split_pieces(
        np.random.default_rng(0))
    c = np.random.default_rng(1).standard_normal(m).astype(np.float32)
    _check(rows, cols, vals, c, R)


@pytest.mark.parametrize("shift", range(-3, 4))
def test_runs_around_one_edge(shift):
    """Runs of 1, 2 and 3 entries and one that fills block 0, then one of
    1024 + shift: its end walks over block 1's last entry and block 2's
    first; a run of 2048 after it spans a whole block whatever the
    shift."""
    lens = np.array([1, 2, 3, BLK - 6, BLK + shift, 2 * BLK, 5, 0, 0, 4])
    rows = np.repeat(np.arange(lens.size, dtype=np.int32), lens)[None]
    rng = np.random.default_rng(shift + 10)
    cols = rng.integers(0, 7, rows.shape).astype(np.int32)
    vals = rng.standard_normal(rows.shape).astype(np.float32)
    c = rng.standard_normal(7).astype(np.float32)
    _check(rows, cols, vals, c, lens.size)


@pytest.mark.parametrize("seed", range(12))
def test_random_pieces(seed):
    """Three pieces of mostly short runs with a few long ones (up to 6,000
    entries, some exactly a block long), gaps of empty rows and a padding
    tail of the dropped id."""
    rng = np.random.default_rng(seed)
    R = 600
    P, pieces = 3, []
    for _ in range(P):
        lens = rng.geometric(0.35, R) - 1
        lens[rng.random(R) < 0.3] = 0
        long = rng.choice(R, 4, replace=False)
        lens[long] = rng.choice([BLK, BLK + 1, 2000, 6000], 4)
        pieces.append(lens)
    N = max(int(x.sum()) for x in pieces) + int(rng.integers(0, 300))
    rows = np.full((P, N), R, np.int32)
    for p, lens in enumerate(pieces):
        rows[p, :lens.sum()] = np.repeat(np.arange(R), lens)
    cols = rng.integers(0, 50, (P, N)).astype(np.int32)
    vals = np.where(rows < R, rng.standard_normal((P, N)), 0) \
        .astype(np.float32)
    c = rng.standard_normal(50).astype(np.float32)
    _check(rows, cols, vals, c, R)
