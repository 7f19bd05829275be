"""A numpy emulation of the index logic of spmm_coo_nnz
(src/repro_torch/kernels/csrc/spmm.cu), held against the kernel's plain
version and the JAX package's leaf ``leaf_spmm_nnz``.

Y starts at 0 (the kernel clears it). Phase 1 takes fixed 256-entry
segments: a run of equal row ids is summed in storage order from 0; a run
that ends inside its segment is written to Y, the segment's first run goes
to head[seg] when it continues from the previous segment, and its last run
to tail[seg] when it continues into the next. The group pass sums the heads
of each group of 64 segments in order. Phase 2 takes each row at its first
crossing edge (rows[256 s - 1] == rows[256 s], and not so at the edge
before), finds its last segment by the kernel's search over the segments'
first ids and folds tail[first] + the heads before the first group inside
the row + those groups' sums + the heads after, in that order. Every
element of Y may be written at most once. Dropped ids (below 0 or at/after
max_rows) add nothing and are never written; columns are clamped into
[0, K). All sums are float32 in the kernel's order (its products may be
fused into the adds); the plain version and the JAX leaf add in other
orders and are held per element at 1e-4 * scale + 1e-6, with ``scale`` the
same product on absolute values (chip_smoke's tolerance: rows here sum up
to 33,000 products).

The pieces: chip_smoke.nnz_split_pieces, chip_smoke.nnz_group_pieces (rows
over 64, 65, 128 and 129 segments), rows over 63-130 segments from several
starting offsets, runs ending around one segment edge, negative and
padding ids, an empty piece; J in {1, 7, 32, 33}.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro_torch.kernels import _build, spmm

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SEG, GROUP = spmm.SEGMENT, spmm.GROUP


def _fold(x, a, b, acc):
    """acc + x[a] + ... + x[b], one at a time (fold_in_order)."""
    for s in range(a, b + 1):
        acc = (acc + x[s]).astype(np.float32)
    return acc


def emulate(rows, cols, vals, C, max_rows):
    """Y (P, max_rows, J) as spmm_coo_nnz's launches compute it."""
    P, N = rows.shape
    K, J = C.shape
    nseg = -(-N // SEG)
    n_groups = nseg // GROUP
    Y = np.zeros((P, max_rows, J), np.float32)
    writes = np.zeros((P, max_rows), np.int64)
    prod = (vals[..., None] * C[np.clip(cols, 0, K - 1)]).astype(np.float32)
    prod[(rows < 0) | (rows >= max_rows)] = 0
    for p in range(P):
        pr = rows[p]
        head = np.full((nseg, J), np.nan, np.float32)
        tail = np.full((nseg, J), np.nan, np.float32)
        for seg in range(nseg):
            lo, hi = seg * SEG, min(N, seg * SEG + SEG)
            open_lo = lo > 0 and pr[lo - 1] == pr[lo]
            open_hi = hi < N and pr[hi] == pr[hi - 1]
            cuts = lo + 1 + np.flatnonzero(pr[lo + 1:hi] != pr[lo:hi - 1])
            starts = np.concatenate([[lo], cuts])
            ends = np.concatenate([cuts, [hi]])
            for k, (a, b) in enumerate(zip(starts, ends)):
                acc = np.cumsum(prod[p, a:b], axis=0, dtype=np.float32)[-1]
                row = pr[a]
                if k == 0 and open_lo:
                    head[seg] = acc
                elif b == hi and open_hi:
                    tail[seg] = acc
                elif 0 <= row < max_rows:
                    Y[p, row] = acc
                    writes[p, row] += 1
        group = np.stack([_fold(head, g * GROUP, g * GROUP + GROUP - 1,
                                np.zeros(J, np.float32))
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
            Y[p, r] = _fold(head, s, b, acc)
            writes[p, r] += 1
    assert writes.max(initial=0) <= 1, "a row written twice"
    return Y


def _check(rows, cols, vals, C, max_rows):
    got = emulate(rows, cols, vals, C, max_rows)
    assert np.isfinite(got).all()
    before = dict(_build.LAUNCHES)
    plain = spmm.spmm_coo_nnz(*(torch.from_numpy(x) for x in
                                (rows, cols, vals, C)), max_rows).numpy()
    assert _build.LAUNCHES == before                  # the CPU launches none
    scale = spmm.spmm_coo_nnz(*(torch.from_numpy(x) for x in
                                (rows, cols, np.abs(vals), np.abs(C))),
                              max_rows).numpy()
    tol = 1e-4 * scale + 1e-6
    assert (np.abs(got - plain) <= tol).all()
    cc = np.clip(cols, 0, C.shape[0] - 1)
    for p in range(rows.shape[0]):
        want = np.asarray(rref.leaf_spmm_nnz(rows[p], cc[p], vals[p], C,
                                             max_rows))
        assert (np.abs(got[p] - want) <= tol[p]).all()


def _C(rng, m, J):
    return rng.standard_normal((m, J)).astype(np.float32)


@pytest.mark.parametrize("J", [1, 7, 32, 33])
def test_chip_smoke_pieces(J):
    """chip_smoke's block-edge pieces (runs of 1024 and 1025, a row over
    six blocks, 1,190 empty rows, padding ids, an empty piece, a piece of
    one row) and its group-edge pieces (rows over 64, 65, 128 and 129
    segments)."""
    rng = np.random.default_rng(J)
    for make in (chip_smoke.nnz_split_pieces, chip_smoke.nnz_group_pieces):
        rows, cols, vals, m, R = make(rng)
        _check(rows, cols, vals, _C(rng, m, J), R)


@pytest.mark.parametrize("span", [63, 64, 65, 127, 128, 129, 130])
def test_rows_over_group_edges(span):
    """Three pieces whose long row spans ``span`` segments from different
    first segments (so its whole groups start and end at every offset),
    then short rows; a row before it of 0, 1 or 63 segments."""
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
    cols = rng.integers(0, 9, (3, N)).astype(np.int32)
    vals = np.where(rows < R, rng.standard_normal((3, N)), 0) \
        .astype(np.float32)
    _check(rows, cols, vals, _C(rng, 9, 33), R)


@pytest.mark.parametrize("shift", range(-3, 4))
def test_runs_around_one_edge(shift):
    """Runs of 1, 2 and 3 entries and one that fills segment 0, then one of
    256 + shift: its end walks over segment 1's last entry and segment 2's
    first; a run of 512 after it spans a whole segment whatever the
    shift."""
    lens = np.array([1, 2, 3, SEG - 6, SEG + shift, 2 * SEG, 5, 0, 0, 4])
    rows = np.repeat(np.arange(lens.size, dtype=np.int32), lens)[None]
    rng = np.random.default_rng(shift + 10)
    cols = rng.integers(0, 7, rows.shape).astype(np.int32)
    vals = rng.standard_normal(rows.shape).astype(np.float32)
    _check(rows, cols, vals, _C(rng, 7, 7), lens.size)


def test_dropped_ids_and_an_empty_piece():
    """Negative ids first (one run across a segment edge), ids past
    max_rows last, columns out of range, and a piece of padding only."""
    rng = np.random.default_rng(3)
    R, N = 30, 4 * SEG + 9
    rows = np.full((2, N), R + 3, np.int32)
    lead = np.concatenate([np.full(SEG + 7, -2), np.full(5, -1)])
    body = np.sort(rng.integers(0, R, N - lead.size - 40))
    rows[0] = np.concatenate([lead, body, np.full(40, R)]).astype(np.int32)
    cols = rng.integers(-3, 12, (2, N)).astype(np.int32)
    vals = rng.standard_normal((2, N)).astype(np.float32)
    _check(rows, cols, vals, _C(rng, 9, 32), R)
