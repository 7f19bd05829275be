"""A numpy emulation of the index logic of bcsr_spmm
(src/repro_torch/kernels/csrc/bcsr.cu), held against the kernel's plain
version and the JAX package's leaf ``leaf_bcsr_spmm_nnz``, and against an
emulation of the phase 1 it replaced, bit for bit.

Y starts at 0 (the wrapper zeroes it). Phase 1 takes fixed 128-block
segments, a warp per (segment, 32-wide j tile, group of rows), lanes on j,
one stored block at a time: for the templated (4, 4) block (with 16-byte
tile loads allowed) one group of all 4 rows, the block's tile and C lines
gathered before its run-end test; any other block groups of 8 rows. The
ids come 32 blocks at a time; a block whose id lies outside [0, R) adds
nothing. A run of equal ids is summed in stream order from 0, one fma per
c in order into each (r, j) sum, and goes where segment_fold.cuh's
convention puts it: the segment's first run to head[seg] when it began in
an earlier segment, its last run to tail[seg] when it goes on into the
next, any other run of a kept id to Y (a segment whose ids all lie outside
[0, R) writes nothing). The fold (segment_fold::fold_rows<128>, shared
with bcsr_spmv and emulated in test_torch_bcsr_spmv_emulation.py, W = br·J
outputs a block-row): the heads of each group of 64 segments summed in
order; each block-row at its first crossing edge folds tail[first] + the
heads before the first group inside it + those groups' sums + the heads
after. Every output may be written at most once (asserted). The replaced
phase 1 (a thread per (r, j), ids and tiles staged 32 blocks at a time,
each segment's first run in head and its last in tail) is emulated beside
it: its head, tail and Y moved to the new convention must have the same
bits. Products are
fused into the adds (fma, emulated in float64 and rounded once to
float32); the plain version and the JAX leaf sum in other orders and are
held per entry at 1e-5 * scale + 1e-6, ``scale`` the same product on
absolute values.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref

from repro_torch.kernels import _build, bcsr
from test_torch_bcsr_spmv_emulation import fold_rows

SEG, WARP, GENERIC_ROWS = bcsr.SEGMENT, 32, 8   # kSeg, kWarp, kRows
SHAPES = {(4, 4)}                               # the templated instances
RTOL, ATOL = 1e-5, 1e-6


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _segments(pr, R):
    """(seg, lo, hi, open_lo, open_hi) of the segments whose ids are not
    all dropped; open_lo (open_hi): the run of its first (last) id goes on
    beyond it."""
    N = pr.size
    for seg in range(-(-N // SEG)):
        lo, hi = seg * SEG, min(N, seg * SEG + SEG)
        if not (pr[lo] >= R or pr[hi - 1] < 0):
            yield (seg, lo, hi, lo > 0 and pr[lo - 1] == pr[lo],
                   hi < N and pr[hi] == pr[hi - 1])


def phase1(brow, bcol, tiles, C_blk, R, aligned=True):
    """head, tail (P, nseg, br, J; NaN where unwritten), Y (P, R, br, J)
    and the writes to each slot, as the new phase 1 computes them."""
    P, N, br, bc = tiles.shape
    grid_cols, _, J = C_blk.shape
    nseg = -(-N // SEG)
    exact = (br, bc) in SHAPES and (aligned or (br * bc) % 4)
    BR = br if exact else GENERIC_ROWS
    n_rg, n_jt = -(-br // BR), -(-J // WARP)
    head = np.full((P, nseg, br, J), np.nan, np.float32)
    tail = head.copy()
    Y = np.zeros((P, R, br, J), np.float32)
    writes = {k: np.zeros(x.shape, np.int64) for k, x in
              (("head", head), ("tail", tail), ("Y", Y))}
    lanes = np.arange(WARP)
    for p in range(P):
        pr, pc = brow[p], np.clip(bcol[p], 0, grid_cols - 1)
        for seg, lo, hi, open_lo, open_hi in _segments(pr, R):
            first = pr[lo]

            def slot(row, at_end):
                """The kernel's Slots::at: (kind, index) or None."""
                if row == first and open_lo:
                    return "head", seg
                if at_end and open_hi:
                    return "tail", seg
                return ("Y", row) if 0 <= row < R else None

            for jt in range(n_jt):
                j = jt * WARP + lanes
                live = j < J
                jl, jj = j[live], np.minimum(j, J - 1)
                for rg in range(n_rg):
                    r0 = rg * BR
                    rs = np.arange(r0, min(br, r0 + BR))

                    def put(where, acc):
                        if where is None:
                            return
                        kind, idx = where
                        out = {"head": head, "tail": tail, "Y": Y}[kind]
                        for i, r in enumerate(rs):
                            out[(p, idx, r, jl)] = acc[i, live]
                            writes[kind][(p, idx, r, jl)] += 1

                    acc = np.zeros((rs.size, WARP), np.float32)
                    cur = first
                    for base in range(lo, hi, WARP):
                        cnt = min(WARP, hi - base)
                        for t in range(cnt):
                            e = base + t
                            row = pr[e]
                            if row != cur:            # a run ends
                                put(slot(cur, False), acc)
                                acc = np.zeros_like(acc)
                                cur = row
                            if not 0 <= row < R:      # dropped: not read
                                continue
                            tv = tiles[p, e][rs]
                            cv = np.where(live, C_blk[pc[e]][:, jj], 0)
                            for c in range(bc):
                                acc = _fma(tv[:, c, None], cv[c], acc)
                    put(slot(cur, True), acc)
    return head, tail, Y, writes


def phase1_before(brow, bcol, tiles, C_blk, R):
    """The replaced phase 1: a thread per (r, j) of each segment, blocks in
    stream order, acc += tile[r, c] * C[col, c, j] (one fma) per c."""
    P, N, br, bc = tiles.shape
    grid_cols, _, J = C_blk.shape
    nseg = -(-N // SEG)
    head = np.full((P, nseg, br, J), np.nan, np.float32)
    tail = head.copy()
    Y = np.zeros((P, R, br, J), np.float32)
    for p in range(P):
        pr, pc = brow[p], np.clip(bcol[p], 0, grid_cols - 1)
        for seg, lo, hi, _, _ in _segments(pr, R):
            first = cur = pr[lo]
            acc = np.zeros((br, J), np.float32)
            for e in range(lo, hi):
                if pr[e] != cur:
                    if cur == first:
                        head[p, seg] = acc
                    elif 0 <= cur < R:
                        Y[p, cur] = acc
                    acc = np.zeros_like(acc)
                    cur = pr[e]
                if 0 <= pr[e] < R:
                    for c in range(bc):
                        acc = _fma(tiles[p, e, :, c, None], C_blk[pc[e], c],
                                   acc)
            (head if cur == first else tail)[p, seg] = acc
    return head, tail, Y


def to_new_convention(brow, head, tail, Y, R):
    """The replaced phase 1's partials (each segment's first run in head,
    its last, when another block-row, in tail) moved to segment_fold.cuh's
    slots, in place on copies."""
    head, tail, Y = head.copy(), tail.copy(), Y.copy()
    for p in range(brow.shape[0]):
        pr = brow[p]
        for seg, lo, hi, open_lo, open_hi in _segments(pr, R):
            first, last = pr[lo], pr[hi - 1]
            runs = [(first, head[p, seg].copy(), first == last)]
            if first != last:
                runs.append((last, tail[p, seg].copy(), True))
            head[p, seg] = tail[p, seg] = np.nan
            for row, acc, at_end in runs:
                if row == first and open_lo:
                    head[p, seg] = acc
                elif at_end and open_hi:
                    tail[p, seg] = acc
                elif 0 <= row < R:
                    Y[p, row] = acc
    return head, tail, Y


def fold(brow, head, tail, Y, R):
    """segment_fold::fold_rows<128> over phase 1's partials, in place on
    Y (P, R, br, J); returns the writes to each block-row."""
    P, nseg = head.shape[:2]
    return np.stack([fold_rows(brow[p], head[p].reshape(nseg, -1),
                               tail[p].reshape(nseg, -1),
                               Y[p].reshape(R, -1), R) for p in range(P)])


def _check(brow, bcol, tiles, C_blk, R, aligned=True):
    head, tail, Y, writes = phase1(brow, bcol, tiles, C_blk, R, aligned)
    assert all(w.max(initial=0) <= 1 for w in writes.values()), \
        "a phase-1 output written twice"
    old = to_new_convention(brow, *phase1_before(brow, bcol, tiles, C_blk, R),
                            R)
    for new, was in zip((head, tail, Y), old):
        np.testing.assert_array_equal(new.view(np.int32), was.view(np.int32))
    assert fold(brow, head, tail, Y, R).max(initial=0) <= 1, \
        "a block-row written twice"
    P, _, br, bc = tiles.shape
    J = C_blk.shape[2]
    got = Y.reshape(P, R * br, J)
    assert np.isfinite(got).all()
    T = torch.from_numpy
    before = dict(_build.LAUNCHES)
    plain = bcsr.bcsr_spmm(T(brow), T(bcol), T(tiles), T(C_blk), R).numpy()
    assert _build.LAUNCHES == before                  # the CPU launches none
    dropped = ((brow < 0) | (brow >= R))[:, :, None, None]
    abs_tiles = np.where(dropped, 0, np.abs(tiles)).astype(np.float32)
    scale = bcsr.bcsr_spmm(T(brow), T(bcol), T(abs_tiles),
                           T(np.abs(C_blk)), R).numpy()
    tol = RTOL * scale + ATOL
    assert (np.abs(got - plain) <= tol).all()
    cc = np.clip(bcol, 0, C_blk.shape[0] - 1)
    for p in range(P):
        want = np.asarray(rref.leaf_bcsr_spmm_nnz(
            brow[p], cc[p], np.where(dropped[p], 0, tiles[p]), C_blk, R))
        assert (np.abs(got[p] - want) <= tol[p]).all()


def pieces(rng, lens, grid_cols, R, lead=(), pad=9):
    """(brow, bcol): block-row b repeated lens[p][b] times per piece,
    after ``lead`` (per piece, ids below 0), then ``pad`` slots of the
    dropped id R; block-columns random, some past the grid."""
    body = [np.concatenate([np.asarray(lead[p] if p < len(lead) else [],
                                       np.int64),
                            np.repeat(np.arange(R), ln)])
            for p, ln in enumerate(lens)]
    N = max(b.size for b in body) + pad
    brow = np.full((len(lens), N), R, np.int32)
    for p, b in enumerate(body):
        brow[p, :b.size] = b
    bcol = rng.integers(-2, grid_cols + 3, brow.shape).astype(np.int32)
    return brow, bcol


def operands(rng, brow, br, bc, J, grid_cols, R):
    """Tiles (1e30 where the id is dropped: never to be multiplied) and
    C_blk (grid_cols, bc, J)."""
    tiles = rng.standard_normal(brow.shape + (br, bc)).astype(np.float32)
    dropped = (brow < 0) | (brow >= R)
    tiles[dropped] = np.float32(1e30)
    C_blk = rng.standard_normal((grid_cols, bc, J)).astype(np.float32)
    return tiles, C_blk


# chip_smoke.bcsr_cases' block-rows: an empty one, a run ending on the
# last block of segment 0, one starting on the first block of segment 1
# over four segments, one cut by a segment edge, one ending on a 32-block
# chunk edge; an empty piece; a run ending on the first chunk edge and one
# longer than two segments. A fourth piece starts with 130 dropped
# negative ids (across a segment edge) and holds short runs.
EDGE_R, EDGE_COLS = 12, 9
EDGE_LENS = [np.array([3, 0, 125, 400, 128, 7, 0, 2, 7, 30, 0, 5]),
             np.zeros(EDGE_R, np.int64),
             np.array([0, 32, 300, 0, 0, 0, 0, 0, 0, 0, 2, 0]),
             np.array([1, 2, 3, 0, 5, 1, 1, 0, 0, 9, 33, 4])]
EDGE_LEAD = [[], [], [], [-3] * 100 + [-1] * 30]
BLOCKS = [(br, bc) for br in (1, 2, 3, 4, 8, 32) for bc in (1, 4, 5, 8)]
JS = [1, 16, 32, 33, 130]


@pytest.mark.parametrize("br,bc", BLOCKS,
                         ids=[f"{br}x{bc}" for br, bc in BLOCKS])
def test_block_shapes(br, bc):
    """The templated (4, 4) instance and the generic one (every other
    block, groups of 8 rows: br = 1 .. 32, bc = 1 .. 8) over the edge
    pieces, J cycling through 1, 16, 32, 33, 130 (up to 33 when
    br = 32)."""
    i = BLOCKS.index((br, bc))
    J = JS[i % (4 if br == 32 else 5)]
    rng = np.random.default_rng(i)
    brow, bcol = pieces(rng, EDGE_LENS, EDGE_COLS, EDGE_R, EDGE_LEAD)
    _check(brow, bcol, *operands(rng, brow, br, bc, J, EDGE_COLS, EDGE_R),
           EDGE_R)


@pytest.mark.parametrize("J", JS)
@pytest.mark.parametrize("br,bc", [(4, 4), (3, 5)], ids=["4x4", "3x5"])
def test_widths(br, bc, J):
    """Every J over the main path's block and a generic one, j tiles
    ragged at 1, 16, 33 and 130."""
    rng = np.random.default_rng(J)
    brow, bcol = pieces(rng, EDGE_LENS, EDGE_COLS, EDGE_R, EDGE_LEAD)
    _check(brow, bcol, *operands(rng, brow, br, bc, J, EDGE_COLS, EDGE_R),
           EDGE_R)


@pytest.mark.parametrize("shift", range(-2, 3))
@pytest.mark.parametrize("br,bc", [(1, 1), (2, 2), (4, 4)],
                         ids=["1x1", "2x2", "4x4"])
def test_runs_around_segment_and_unroll_edges(br, bc, shift):
    """Runs of 1, 2 and 3 blocks, then one ending at 128 + shift, one of
    exactly 128 and one of 257: run ends walk over a segment edge and
    32-block chunk edges, under the templated instance and the generic
    one."""
    lens = np.array([1, 2, 3, SEG - 6 + shift, SEG, 2 * SEG + 1, 5, 0, 1, 3])
    R = lens.size
    rng = np.random.default_rng(shift + 10)
    brow, bcol = pieces(rng, [lens, lens[::-1]], 7, R, pad=shift + 3)
    _check(brow, bcol, *operands(rng, brow, br, bc, 33, 7, R), R)


def test_unaligned_tiles_take_the_generic_instance():
    """A tile base off a 16-byte boundary sends a (4, 4) block to the
    generic instance (scalar tile loads, one block at a time): the same
    sums, the same bits as the replaced phase 1."""
    rng = np.random.default_rng(7)
    brow, bcol = pieces(rng, EDGE_LENS, EDGE_COLS, EDGE_R, EDGE_LEAD)
    _check(brow, bcol, *operands(rng, brow, 4, 4, 32, EDGE_COLS, EDGE_R),
           EDGE_R, aligned=False)


def test_empty_and_fully_dropped_pieces():
    """A piece of dropped ids only (negative, then R), an empty piece and
    one block-row of one block: nothing but that block-row is written."""
    rng = np.random.default_rng(8)
    lens = [np.zeros(5, np.int64), np.zeros(5, np.int64),
            np.array([0, 0, 1, 0, 0])]
    brow, bcol = pieces(rng, lens, 4, 5, [[-1] * 140], pad=150)
    _check(brow, bcol, *operands(rng, brow, 2, 4, 16, 4, 5), 5)
