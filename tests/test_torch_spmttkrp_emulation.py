"""A numpy emulation of the index logic of spmttkrp_coo
(src/repro_torch/kernels/csrc/spmttkrp.cu and segment_fold.cuh), held
against the kernel's plain version, the JAX package's Pallas kernel
``spmttkrp_ell`` (interpret mode) and its leaf ``leaf_spmttkrp_nnz``.

A starts at 0 (the wrapper zeroes it). Phase 1 takes fixed 256-entry
segments, lanes on l; a segment of dropped ids only (below 0 or at/after
max_rows) returns at once. The entries come 32 at a time (a dropped id
gathers nothing and adds 0), each group of 4 entries' lines of C and D
gathered before their FMAs; which entries end a run comes from one ballot
per 32, each lane comparing its id with the next lane's (the last lane
with the first id of the next 32, loaded when there are more in the
segment). A run of equal ids is summed in entry order from
0, acc += (v . C) . D: a run that ends inside its segment is written to A,
the segment's first run goes to head[seg] when it continues from the
previous segment, and its last run to tail[seg] when it continues into
the next. The fold (segment_fold.cuh): the heads of each group of 64
segments summed in order; each row at its first crossing edge (rows[256 s
- 1] == rows[256 s], and not so at the edge before) finds its last
segment by the kernel's search over the segments' first ids and folds
tail[first] + the heads before the first group inside the row + those
groups' sums + the heads after. Every row of A may be written at most
once and every kept entry gathered exactly once (asserted). Products are fused into the adds (fma, emulated
in float64 and rounded once to float32); the plain version and the JAX
functions add in other orders and are held per element at 1e-4 * scale +
1e-6, ``scale`` the same product on absolute values (chip_smoke's
tolerance: a row here sums up to 1.56 M products).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.layout import ell_pack
from repro.kernels.spmttkrp import spmttkrp_ell
from repro_torch.kernels import _build, spmttkrp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SEG, GROUP, WARP, AHEAD = spmttkrp.SEGMENT, spmttkrp.GROUP, 32, 4


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _fold(x, a, b, acc):
    """acc + x[a] + ... + x[b], one at a time (fold_in_order)."""
    for s in range(a, b + 1):
        acc = (acc + x[s]).astype(np.float32)
    return acc


def phase1(pr, vc, dv, max_rows, A, writes, gathers):
    """head, tail (nseg, L; NaN where unwritten) of one piece; the runs
    inside a segment go to A (writes counted), each entry's gathers to
    ``gathers``. ``vc`` = v . C[j] and ``dv`` = D[k] per entry (0 for a
    dropped id)."""
    N, L = vc.shape
    nseg = -(-N // SEG)
    span = nseg * SEG
    idx = np.arange(span).reshape(nseg, SEG)
    lo, hi = idx[:, 0], np.minimum(idx[:, 0] + SEG, N)
    n_in = hi - lo
    r_pad = np.concatenate([pr, np.full(span - N, -1, pr.dtype)])
    kept = (pr >= 0) & (pr < max_rows)
    # the lanes' ids per 32 (a lane past the segment holds -1), the next
    # lane's by shuffle, the last lane's from the next 32 when there are
    # more in the segment; run ends by ballot
    r_l = np.where(idx < hi[:, None], r_pad[idx], -1)
    lane = idx % SEG % WARP
    nxt = np.concatenate([r_l[:, 1:], np.full((nseg, 1), -1)], axis=1)
    last_lane = lane == WARP - 1
    more = idx + 1 < hi[:, None]
    nxt = np.where(last_lane & more, r_pad[np.minimum(idx + 1, span - 1)],
                   np.where(last_lane, r_l, nxt))
    ends = (idx + 1 < hi[:, None]) & (r_l != nxt)
    # the gathers (a C and a D line each): batch base, group t0 of AHEAD,
    # slot u; a segment of dropped ids only returns before any
    live = ~((r_pad[lo] >= max_rows) | (pr[hi - 1] < 0))
    for b0 in range(0, SEG, WARP):
        for t0 in range(0, WARP, AHEAD):
            for u in range(AHEAD):
                e = lo + b0 + t0 + u
                ok = (e < hi) & live
                ok[ok] &= kept[e[ok]]
                np.add.at(gathers, e[ok], 1)
    open_lo = np.zeros(nseg, bool)
    open_lo[1:] = pr[lo[1:] - 1] == pr[lo[1:]]
    open_hi = np.zeros(nseg, bool)
    open_hi[:-1] = pr[hi[:-1]] == pr[hi[:-1] - 1]
    head = np.full((nseg, L), np.nan, np.float32)
    tail = np.full((nseg, L), np.nan, np.float32)
    vc_pad = np.concatenate([vc, np.zeros((span - N, L), np.float32)])
    dv_pad = np.concatenate([dv, np.zeros((span - N, L), np.float32)])
    acc = np.zeros((nseg, L), np.float32)
    first = np.ones(nseg, bool)
    for i in range(SEG):
        act = i < n_in
        e = idx[:, i]
        acc = np.where(act[:, None], _fma(vc_pad[e], dv_pad[e], acc), acc)
        end = ends[:, i] & act
        to_head = end & first & open_lo
        head[to_head] = acc[to_head]
        row = r_pad[e]
        to_a = end & ~(first & open_lo) & (row >= 0) & (row < max_rows)
        A[row[to_a]] = acc[to_a]
        np.add.at(writes, row[to_a], 1)
        acc[end] = 0
        first &= ~end
    last = pr[hi - 1]
    for s in range(nseg):
        if first[s] and open_lo[s]:
            head[s] = acc[s]
        elif open_hi[s]:
            tail[s] = acc[s]
        elif 0 <= last[s] < max_rows:
            A[last[s]] = acc[s]
            writes[last[s]] += 1
    return head, tail


def emulate(rows, jj, kk, vals, C, D, max_rows):
    """A (P, max_rows, L) as spmttkrp_coo's launches compute it."""
    P, N = rows.shape
    (J, L), K = C.shape, D.shape[0]
    nseg = -(-N // SEG)
    n_groups = nseg // GROUP
    A = np.zeros((P, max_rows, L), np.float32)
    writes = np.zeros((P, max_rows), np.int64)
    for p in range(P):
        pr = rows[p]
        kept = (pr >= 0) & (pr < max_rows)
        v = np.where(kept, vals[p], 0).astype(np.float32)
        vc = (v[:, None] * np.where(kept[:, None],
                                    C[np.clip(jj[p], 0, J - 1)], 0)) \
            .astype(np.float32)
        dv = np.where(kept[:, None], D[np.clip(kk[p], 0, K - 1)], 0) \
            .astype(np.float32)
        gathers = np.zeros(N, np.int64)
        head, tail = phase1(pr, vc, dv, max_rows, A[p], writes[p], gathers)
        assert (gathers == kept).all(), "a kept entry gathered twice or never"
        if nseg < 2:
            continue
        group = np.stack([_fold(head, g * GROUP, g * GROUP + GROUP - 1,
                                np.zeros(L, np.float32))
                          for g in range(n_groups)]) if n_groups else None
        for e in range(1, nseg):
            r = pr[e * SEG]
            first = pr[e * SEG - 1] == r and (e == 1
                                               or pr[(e - 1) * SEG - 1] != r)
            if not (first and 0 <= r < max_rows):
                continue
            lo_s, hi_s = e, nseg                  # the kernel's search
            while hi_s - lo_s > 1:
                mid = (lo_s + hi_s) // 2
                if pr[mid * SEG] == r:
                    lo_s = mid
                else:
                    hi_s = mid
            a, b = e - 1, lo_s
            g_lo, g_hi = (a + GROUP) // GROUP, (b + 1) // GROUP
            acc, s = tail[a], a + 1
            if g_lo < g_hi:
                acc = _fold(head, s, g_lo * GROUP - 1, acc)
                acc = _fold(group, g_lo, g_hi - 1, acc)
                s = g_hi * GROUP
            A[p, r] = _fold(head, s, b, acc)
            writes[p, r] += 1
    assert writes.max(initial=0) <= 1, "a row written twice"
    return A


def _check(rows, jj, kk, vals, C, D, max_rows, pallas=False):
    got = emulate(rows, jj, kk, vals, C, D, max_rows)
    assert np.isfinite(got).all()
    T = torch.from_numpy
    before = dict(_build.LAUNCHES)
    plain = spmttkrp.spmttkrp_coo(T(rows), T(jj), T(kk), T(vals), T(C),
                                  T(D), max_rows).numpy()
    assert _build.LAUNCHES == before                  # the CPU launches none
    scale = spmttkrp.spmttkrp_coo(T(rows), T(jj), T(kk), T(np.abs(vals)),
                                  T(np.abs(C)), T(np.abs(D)),
                                  max_rows).numpy()
    tol = 1e-4 * scale + 1e-6
    assert (np.abs(got - plain) <= tol).all()
    jc = np.clip(jj, 0, C.shape[0] - 1)
    kc = np.clip(kk, 0, D.shape[0] - 1)
    for p in range(rows.shape[0]):
        want = np.asarray(rref.leaf_spmttkrp_nnz(rows[p], jc[p], kc[p],
                                                 vals[p], C, D, max_rows))
        assert (np.abs(got[p] - want) <= tol[p]).all()
        if pallas:                       # the TPU kernel over the kept ones
            keep = (rows[p] >= 0) & (rows[p] < max_rows)
            pos = np.zeros(max_rows + 1, np.int64)
            np.cumsum(np.bincount(rows[p][keep], minlength=max_rows),
                      out=pos[1:])
            blocks, kp = ell_pack(pos, jc[p][keep], vals[p][keep],
                                  extra=(kc[p][keep],))
            out = np.asarray(spmttkrp_ell(blocks.rows_rel, blocks.crd, kp,
                                          blocks.vals, C, D,
                                          interpret=True))[:max_rows]
            assert (np.abs(got[p] - out) <= tol[p]).all()


def _factors(rng, J, K, L):
    return (rng.standard_normal((J, L)).astype(np.float32),
            rng.standard_normal((K, L)).astype(np.float32))


@pytest.mark.parametrize("L", [1, 7, 32, 33])
def test_chip_smoke_streams(L):
    """chip_smoke's SpMTTKRP streams (an empty row, rows across one and two
    segment edges and starting on one, an empty piece, a piece that is one
    row, a padding tail) at every L of its edge cases, against the Pallas
    kernel too."""
    rng = np.random.default_rng(L)
    R, J, K = 40, 50, 30
    counts = rng.integers(0, 20, R)
    counts[[3, 7, 8, 20]] = [0, 700, 256, 300]
    lens = [counts, np.zeros(R, np.int64),
            np.bincount([R - 1] * 900, minlength=R)]
    N = int(max(x.sum() for x in lens)) + 5
    rows = np.full((3, N), R, np.int32)
    for p, cnt in enumerate(lens):
        rows[p, :cnt.sum()] = np.repeat(np.arange(R), cnt)
    jj = rng.integers(0, J, (3, N)).astype(np.int32)
    kk = rng.integers(0, K, (3, N)).astype(np.int32)
    vals = np.where(rows < R, rng.standard_normal((3, N)), 0) \
        .astype(np.float32)
    _check(rows, jj, kk, vals, *_factors(rng, J, K, L), R, pallas=True)


@pytest.mark.parametrize("L", [1, 32, 33])
def test_group_and_block_edge_pieces(L):
    """chip_smoke's block-edge pieces (runs of 1024 and 1025, a row over six
    blocks, 1,190 empty rows, padding ids, an empty piece, a piece of one
    row) and group-edge pieces (rows over 64, 65, 128 and 129 segments),
    with k drawn beside their columns and out-of-range j and k."""
    rng = np.random.default_rng(L + 100)
    for make in (chip_smoke.nnz_split_pieces, chip_smoke.nnz_group_pieces):
        rows, cols, vals, m, R = make(rng)
        kk = rng.integers(-2, 40, rows.shape).astype(np.int32)
        _check(rows, cols, kk, vals, *_factors(rng, m, 37, L), R)


@pytest.mark.parametrize("span", [63, 64, 65, 127, 128, 129, 130])
def test_rows_over_group_edges(span):
    """Three pieces whose long row spans ``span`` segments from different
    first segments, so its whole groups of 64 start and end at every
    offset, then short rows."""
    rng = np.random.default_rng(span)
    pieces = []
    for start in (0, 5 * SEG + 3, 63 * SEG + 255):
        end = (start // SEG + span - 1) * SEG + int(rng.integers(1, SEG))
        lens = np.concatenate([[start, end - start],
                               rng.integers(0, 3, 40)])
        pieces.append(np.repeat(np.arange(lens.size, dtype=np.int32), lens))
    R = 42
    N = max(x.size for x in pieces) + 11
    rows = np.full((3, N), R, np.int32)
    for p, x in enumerate(pieces):
        rows[p, :x.size] = x
    jj = rng.integers(0, 9, (3, N)).astype(np.int32)
    kk = rng.integers(0, 11, (3, N)).astype(np.int32)
    vals = np.where(rows < R, rng.standard_normal((3, N)), 0) \
        .astype(np.float32)
    _check(rows, jj, kk, vals, *_factors(rng, 9, 11, 4), R)


def test_a_row_of_more_than_6000_segments():
    """The main path's longest slice spans about 6,230 segments; here a row
    of 6,100 segments (1,561,600 entries) between short rows, folded
    through 95 whole groups."""
    rng = np.random.default_rng(6000)
    lens = np.concatenate([[100, 6100 * SEG], rng.integers(0, 5, 30)])
    rows = np.repeat(np.arange(lens.size, dtype=np.int32), lens)[None]
    N = rows.shape[1]
    jj = rng.integers(0, 64, (1, N)).astype(np.int32)
    kk = rng.integers(0, 64, (1, N)).astype(np.int32)
    vals = rng.standard_normal((1, N)).astype(np.float32)
    _check(rows, jj, kk, vals, *_factors(rng, 64, 64, 4), lens.size)


@pytest.mark.parametrize("shift", range(-3, 4))
def test_runs_around_one_edge(shift):
    """Runs of 1, 2 and 3 entries and one that fills segment 0, then one of
    256 + shift: its end walks over segment 1's last entry, the ballot's
    last lane and segment 2's first; a run of 512 spans a whole segment."""
    lens = np.array([1, 2, 3, SEG - 6, SEG + shift, 2 * SEG, 5, 0, 0, 4])
    rows = np.repeat(np.arange(lens.size, dtype=np.int32), lens)[None]
    rng = np.random.default_rng(shift + 10)
    jj = rng.integers(0, 7, rows.shape).astype(np.int32)
    kk = rng.integers(0, 5, rows.shape).astype(np.int32)
    vals = rng.standard_normal(rows.shape).astype(np.float32)
    _check(rows, jj, kk, vals, *_factors(rng, 7, 5, 7), lens.size)


def test_dropped_ids_and_an_empty_piece():
    """Negative ids first (one run across a segment edge), ids past
    max_rows last, j and k out of range, and a piece of padding only."""
    rng = np.random.default_rng(3)
    R, N = 30, 4 * SEG + 9
    rows = np.full((2, N), R + 3, np.int32)
    lead = np.concatenate([np.full(SEG + 7, -2), np.full(5, -1)])
    body = np.sort(rng.integers(0, R, N - lead.size - 40))
    rows[0] = np.concatenate([lead, body, np.full(40, R)]).astype(np.int32)
    jj = rng.integers(-3, 12, (2, N)).astype(np.int32)
    kk = rng.integers(-3, 14, (2, N)).astype(np.int32)
    vals = rng.standard_normal((2, N)).astype(np.float32)
    _check(rows, jj, kk, vals, *_factors(rng, 9, 11, 32), R)
