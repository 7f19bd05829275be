"""A numpy emulation of the index logic of bcsr_spmv
(src/repro_torch/kernels/csrc/bcsr.cu and segment_fold.cuh), lane by lane,
held against the kernel's plain version and the JAX package's leaf
``leaf_bcsr_spmv_nnz``.

y starts at 0 (the wrapper zeroes it). Phase 1 takes fixed 128-block
segments; a segment whose ids all lie below 0 or at/after R returns at
once. The (4, 4) instance (tile and c bases on 16-byte boundaries) gives a
segment a warp, lanes on stored blocks, 32 a chunk, each lane with its
block's four row sums (x·x first, then y, z, w by fma; a lane past the
segment holds an id past every other): when block 0 starts another
block-row than the carried run's, the carried run is written; an
inclusive scan over the chunk's 32 lanes (shuffles 1 .. 16 up, among
equal ids) sums each run's rows, a run that ends inside the chunk is
written with the carry added when it continues the carried run, and the
chunk's last run is carried on. Any other block, or an unaligned base,
takes the generic instance: a warp per (segment, r), lanes on 32 blocks a
chunk, the same scan for row r alone. Where a run goes (segment_fold.cuh's
convention): the segment's first run, when it began in an earlier segment,
to head[seg]; its last run, when it goes on into the next, to tail[seg];
any other run of a kept id to y. The fold: the heads
of each group of 64 segments summed in order; each block-row at its first
crossing edge (brow[128 s - 1] == brow[128 s], and not so at the edge
before) finds its last segment by the kernel's search over the segments'
first ids and folds tail[first] + the heads before the first group inside
the block-row + those groups' sums + the heads after, W = br outputs a
block-row. Every slot may be written at most once (asserted). Products
are fused into the adds where the kernel fuses them (emulated in float64
and rounded once to float32); the plain version and the JAX leaf sum in
other orders and are held per entry at 1e-5 * scale + 1e-6, ``scale`` the
same product on absolute values.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro_torch.kernels import _build, bcsr

SEG, GROUP, WARP = bcsr.SEGMENT, bcsr.GROUP, 32
PAST = np.iinfo(np.int32).max            # INT_MAX: past every id
RTOL, ATOL = 1e-5, 1e-6


def _fma(a, b, c):
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


class Slots:
    """head, tail (nseg, W) and y (R, W) of one piece (NaN where unwritten
    in head and tail) with every write counted; ``at`` is the kernel's
    Slots::at."""

    def __init__(self, nseg, R, W):
        self.head = np.full((nseg, W), np.nan, np.float32)
        self.tail = self.head.copy()
        self.y = np.zeros((R, W), np.float32)
        self.writes = {k: np.zeros(x.shape, np.int64) for k, x in
                       (("head", self.head), ("tail", self.tail),
                        ("y", self.y))}
        self.R = R

    def put(self, seg, first, open_lo, open_hi, row, at_end, w, val):
        if row == first and open_lo:
            kind, i = "head", seg
        elif at_end and open_hi:
            kind, i = "tail", seg
        elif 0 <= row < self.R:
            kind, i = "y", row
        else:
            return
        getattr(self, kind)[i, w] = val
        self.writes[kind][i, w] += 1


def _edges(pr, seg, R):
    """(lo, hi, first, open_lo, open_hi) of segment ``seg``, or None when
    its ids all lie outside [0, R)."""
    N = pr.size
    lo, hi = seg * SEG, min(N, seg * SEG + SEG)
    first, last = int(pr[lo]), int(pr[hi - 1])
    if first >= R or last < 0:
        return None
    return (lo, hi, first, lo > 0 and pr[lo - 1] == first,
            hi < N and pr[hi] == last)


def phase1_44(pr, pc, tiles, c_blk, R, slots):
    """The (4, 4) instance over one piece, lane by lane: lanes on blocks,
    four row sums a lane."""
    lane = np.arange(WARP)
    grid_cols = c_blk.shape[0]
    for seg in range(-(-pr.size // SEG)):
        edges = _edges(pr, seg, R)
        if edges is None:
            continue
        lo, hi, first, open_lo, open_hi = edges

        def put(row, at_end, val):
            for w in range(4):
                slots.put(seg, first, open_lo, open_hi, row, at_end, w,
                          val[w])

        cur, carry = first, np.zeros(4, np.float32)
        for base in range(lo, hi, WARP):
            cnt = min(WARP, hi - base)
            k = np.full(WARP, PAST, np.int64)
            k[:cnt] = pr[base:base + cnt]
            use = (k >= 0) & (k < R)
            e = np.minimum(base + lane, pr.size - 1)
            t = np.where(use[:, None, None], tiles[e], 0)       # (32, 4, 4)
            c = np.where(use[:, None],
                         c_blk[np.clip(pc[e], 0, grid_cols - 1)], 0)
            v = (t[:, :, 0] * c[:, None, 0]).astype(np.float32)  # (32, 4)
            for i in (1, 2, 3):
                v = _fma(t[:, :, i], c[:, None, i], v)
            if k[0] != cur:                        # the carried run ended
                put(cur, False, carry)
                carry = np.zeros(4, np.float32)
            for d in (1, 2, 4, 8, 16):
                w = np.concatenate([v[:d], v[:-d]])
                kw = np.concatenate([k[:d], k[:-d]])
                v = np.where(((lane >= d) & (kw == k))[:, None], v + w,
                             v).astype(np.float32)
            nxt = np.concatenate([k[1:], k[-1:]])
            total = np.where((k == cur)[:, None], v + carry,
                             v).astype(np.float32)
            for i in range(cnt - 1):               # runs ending here
                if nxt[i] != k[i]:
                    put(int(k[i]), False, total[i])
            carry, cur = total[cnt - 1], int(k[cnt - 1])
        put(cur, True, carry)


def phase1_generic(pr, pc, tiles, c_blk, R, slots):
    """The generic instance over one piece: a warp per (segment, r)."""
    lane = np.arange(WARP)
    br, bc = tiles.shape[1:]
    grid_cols = c_blk.shape[0]
    for seg in range(-(-pr.size // SEG)):
        edges = _edges(pr, seg, R)
        if edges is None:
            continue
        lo, hi, first, open_lo, open_hi = edges
        for r in range(br):
            def put(row, at_end, val):
                slots.put(seg, first, open_lo, open_hi, row, at_end, r, val)

            cur, carry = first, np.float32(0)
            for base in range(lo, hi, WARP):
                cnt = min(WARP, hi - base)
                key = np.full(WARP, PAST, np.int64)
                key[:cnt] = pr[base:base + cnt]
                v = np.zeros(WARP, np.float32)
                for t in range(cnt):
                    if 0 <= key[t] < R:
                        cv = c_blk[np.clip(pc[base + t], 0, grid_cols - 1)]
                        for c in range(bc):
                            v[t] = _fma(tiles[base + t, r, c], cv[c], v[t])
                if key[0] != cur:
                    put(cur, False, carry)
                    carry = np.float32(0)
                for d in (1, 2, 4, 8, 16):
                    w = np.concatenate([v[:d], v[:-d]])
                    kw = np.concatenate([key[:d], key[:-d]])
                    v = np.where((lane >= d) & (kw == key), v + w,
                                 v).astype(np.float32)
                nxt = np.concatenate([key[1:], key[-1:]])
                total = (v + np.where(key == cur, carry, 0)).astype(
                    np.float32)
                for t in range(cnt - 1):
                    if nxt[t] != key[t]:
                        put(int(key[t]), False, total[t])
                carry, cur = total[cnt - 1], int(key[cnt - 1])
            put(cur, True, carry)


def _fold(x, a, b, acc):
    """acc + x[a] + ... + x[b], one at a time (fold_in_order)."""
    for s in range(a, b + 1):
        acc = (acc + x[s]).astype(np.float32)
    return acc


def fold_rows(pr, head, tail, out, R):
    """segment_fold::fold_rows<128> over one piece's partials, in place on
    ``out`` (R, W); returns the writes to each row."""
    nseg, W = head.shape
    n_groups = nseg // GROUP
    writes = np.zeros(R, np.int64)
    group = [_fold(head, g * GROUP, g * GROUP + GROUP - 1,
                   np.zeros(W, np.float32)) for g in range(n_groups)]
    for e in range(1, nseg):
        r = int(pr[e * SEG])
        starts = pr[e * SEG - 1] == r and (e == 1
                                           or pr[(e - 1) * SEG - 1] != r)
        if not (starts and 0 <= r < R):
            continue
        lo_s, hi_s = e, nseg                      # the kernel's search
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
        out[r] = _fold(head, s, b, acc)
        writes[r] += 1
    return writes


def emulate(brow, bcol, tiles, c_blk, R, aligned=True):
    """y (P, R·br) as bcsr_spmv's launches compute it."""
    P, N, br, bc = tiles.shape
    nseg = -(-N // SEG)
    out = np.zeros((P, R, br), np.float32)
    for p in range(P):
        slots = Slots(nseg, R, br)
        if (br, bc) == (4, 4) and aligned:
            phase1_44(brow[p], bcol[p], tiles[p], c_blk, R, slots)
        else:
            phase1_generic(brow[p], bcol[p], tiles[p], c_blk, R, slots)
        assert all(w.max(initial=0) <= 1 for w in slots.writes.values()), \
            "a phase-1 slot written twice"
        writes = fold_rows(brow[p], slots.head, slots.tail, slots.y, R)
        assert (writes + slots.writes["y"].max(1, initial=0)).max(
            initial=0) <= 1, "a block-row written twice"
        out[p] = slots.y
    return out.reshape(P, R * br)


def _check(brow, bcol, tiles, c_blk, R, aligned=True):
    got = emulate(brow, bcol, tiles, c_blk, R, aligned)
    assert np.isfinite(got).all()
    T = torch.from_numpy
    before = dict(_build.LAUNCHES)
    plain = bcsr.bcsr_spmv(T(brow), T(bcol), T(tiles), T(c_blk), R).numpy()
    assert _build.LAUNCHES == before                  # the CPU launches none
    dropped = ((brow < 0) | (brow >= R))[:, :, None, None]
    abs_tiles = np.where(dropped, 0, np.abs(tiles)).astype(np.float32)
    scale = bcsr.bcsr_spmv(T(brow), T(bcol), T(abs_tiles), T(np.abs(c_blk)),
                           R).numpy()
    tol = RTOL * scale + ATOL
    assert (np.abs(got - plain) <= tol).all()
    cc = np.clip(bcol, 0, c_blk.shape[0] - 1)
    keep = (brow >= 0) & (brow < R)
    for p in range(brow.shape[0]):
        want = np.asarray(rref.leaf_bcsr_spmv_nnz(
            np.where(keep[p], brow[p], 0), cc[p],
            np.where(dropped[p], 0, tiles[p]), c_blk, R))
        assert (np.abs(got[p] - want) <= tol[p]).all()


def pieces(rng, lens, grid_cols, R, lead=(), pad=9):
    """(brow, bcol): block-row b repeated lens[p][b] times per piece, after
    ``lead`` (per piece, ids below 0), then ``pad`` slots of the dropped id
    R; block-columns random, some past the grid."""
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


def operands(rng, brow, br, bc, grid_cols, R):
    """Tiles (1e30 where the id is dropped: never to be multiplied) and
    c_blk (grid_cols, bc)."""
    tiles = rng.standard_normal(brow.shape + (br, bc)).astype(np.float32)
    tiles[(brow < 0) | (brow >= R)] = np.float32(1e30)
    return tiles, rng.standard_normal((grid_cols, bc)).astype(np.float32)


@pytest.mark.parametrize("span", [0, 1, 63, 64, 65, 130])
def test_block_rows_across_segments(span):
    """A block-row that crosses ``span`` segment edges (so whole groups of
    64 fold at 64, 65 and 130), from two offsets: one that starts on a
    segment's first block (its first partial is a tail) and one inside a
    segment; short runs before and after, padding with the dropped id."""
    rng = np.random.default_rng(span)
    R = 9
    lens = []
    for start in (SEG, 3 * SEG + 37):
        n = (start // SEG + span + 1) * SEG - start - 19 if span else 50
        lens.append(np.array([start - 3, 1, 2, n, 3, 1, 0, 4, 2]))
    brow, bcol = pieces(rng, lens, 11, R)
    _check(brow, bcol, *operands(rng, brow, 4, 4, 11, R), R)


@pytest.mark.parametrize("shift", range(-3, 4))
def test_runs_ending_on_step_and_segment_edges(shift):
    """Runs of 1, 2, 3, 5, 7 and 8 blocks, then runs ending 128 + shift
    blocks in (on a segment edge at 0), at 8 and 32 blocks past it (step
    and chunk edges), one of exactly 128 and one of 257."""
    lens = np.array([1, 2, 3, 5, 7, 8, SEG - 26 + shift, 8, 24, SEG,
                     2 * SEG + 1, 5, 0, 1, 3])
    R = lens.size
    rng = np.random.default_rng(shift + 10)
    brow, bcol = pieces(rng, [lens, lens[::-1]], 7, R, pad=shift + 3)
    _check(brow, bcol, *operands(rng, brow, 4, 4, 7, R), R)


def test_dropped_ids_below_and_past_the_window():
    """130 ids below 0 (a run across a segment edge), ids at and past R
    inside the stream's tail, block-columns past the grid."""
    rng = np.random.default_rng(3)
    R = 12
    lens = [np.array([1, 2, 3, 0, 5, 1, 1, 0, 0, 9, 33, 4]),
            np.array([3, 0, 125, 400, 128, 7, 0, 2, 7, 30, 0, 5])]
    brow, bcol = pieces(rng, lens, 9, R, [[-3] * 100 + [-1] * 30], pad=140)
    brow[1, -60:-30] = R + 5                          # past the window
    _check(brow, bcol, *operands(rng, brow, 4, 4, 9, R), R)


def test_empty_and_fully_dropped_pieces():
    """A piece of dropped ids only (negative, then R), an empty piece and
    one block-row of one block: nothing but that block-row is written."""
    rng = np.random.default_rng(8)
    lens = [np.zeros(5, np.int64), np.zeros(5, np.int64),
            np.array([0, 0, 1, 0, 0])]
    brow, bcol = pieces(rng, lens, 4, 5, [[-1] * 140], pad=150)
    _check(brow, bcol, *operands(rng, brow, 4, 4, 4, 5), 5)


@pytest.mark.parametrize("br,bc", [(3, 5), (33, 1), (64, 8), (4, 4)],
                         ids=["3x5", "33x1", "64x8", "4x4-unaligned"])
def test_generic_instance(br, bc):
    """Other blocks, and a (4, 4) tile or c base off a 16-byte boundary,
    take the generic instance: runs across segment edges, dropped ids,
    an empty piece."""
    rng = np.random.default_rng(br * 100 + bc)
    R = 6
    lens = [np.array([3, 0, 125, 140, 7, 2]), np.zeros(R, np.int64),
            np.array([1, 2, 300, 0, 5, 1])]
    brow, bcol = pieces(rng, lens, 5, R, [[], [], [-2] * 40])
    _check(brow, bcol, *operands(rng, brow, br, bc, 5, R), R,
           aligned=(br, bc) != (4, 4))


def test_chip_smoke_blocked_pieces():
    """chip_smoke.bcsr_cases' pieces at the main path's block: an empty
    block-row, runs ending on the last block of segment 0 and starting on
    the first of segment 1 over four segments, an empty piece, 130 dropped
    ids below 0."""
    rng = np.random.default_rng(12)
    R = 12
    lens = [np.array([3, 0, 125, 400, 128, 7, 0, 2, 7, 30, 0, 5]),
            np.zeros(R, np.int64),
            np.array([0, 32, 300, 0, 0, 0, 0, 0, 0, 0, 2, 0]),
            np.array([1, 2, 3, 0, 5, 1, 1, 0, 0, 9, 33, 4])]
    brow, bcol = pieces(rng, lens, 9, R, [[], [], [], [-2] * 100 + [-1] * 30])
    _check(brow, bcol, *operands(rng, brow, 4, 4, 9, R), R)
