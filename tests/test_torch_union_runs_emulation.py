"""A numpy emulation of the index logic of the SpAdd3 nnz union kernel
(``union_runs_warp_kernel`` in src/repro_torch/kernels/csrc/spadd3.cu),
held bit for bit against an emulation of the order of the
one-thread-per-output kernel it replaced (``union_runs_kernel``, which
still serves scalar values on the card, being faster there; the scalar
cases here hold the warp kernel's 4-byte layout, which serves tiles off a
16-byte boundary), and against the kernel's plain version
``union_runs_plain`` and the JAX package's nnz leaves
(``leaf_spadd_union_chunk`` / ``leaf_bcsr_spadd_union_chunk`` per chunk,
then the cross-chunk dedupe in chunk order).

plan_runs sorts the add stream into runs (one per output coordinate) of
per-chunk segments of entries, laid out so that 32 consecutive runs own
one contiguous slice of seg_ptr and one of perm. A warp takes runs u0 ..
u0 + nu - 1 (nu = 32 but in the last warp): lane t loads run_ptr[u0 + t],
every lane run_ptr[u0 + nu]; the warp stages seg_ptr[s0 .. s1] (at most
129 of them) and perm[e0 .. e1) (at most 256) in shared memory and reads
any further ones from device memory. Item it of the warp is float W·(it %
nq) .. of run it // nq (W = 4 when the tile is a multiple of 4 floats and
the values' and output's bases are 16-byte aligned, else 1; nq = tile / W),
so the items are the runs' output floats in order; a lane takes items
lane, lane + 32, ... four at a time and gathers the first three entries of
each before any add. Each output float is 0 + (0 + segment 0's entries in
order) + (0 + segment 1's) + ..., float32 adds. Every output float is
written exactly once and every entry read once per float of its run
(asserted).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro_torch.kernels import _build, spadd3

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

WARP, SEG_CAP, PERM_CAP, AHEAD_STEPS, AHEAD_ENT = 32, 128, 256, 4, 3
RTOL, ATOL = 1e-5, 1e-6


def emulate(flat, perm, seg_ptr, run_ptr, tile, aligned=True):
    """(U, tile) as the kernel's warps compute it from ``flat`` (slots,
    tile) float32 values; returns the sums and the staged-read counts."""
    U = run_ptr.size - 1
    W = 4 if tile % 4 == 0 and aligned else 1
    nq = tile // W
    out = np.full((U, tile), np.nan, np.float32)
    writes = np.zeros((U, tile), np.int64)
    reads = np.zeros((seg_ptr[-1], tile), np.int64)
    staged = {"seg": 0, "perm": 0, "seg_global": 0, "perm_global": 0}
    for u0 in range(0, U, WARP):
        nu = min(WARP, U - u0)
        rp = run_ptr[u0:u0 + nu]
        s0, s1 = int(rp[0]), int(run_ptr[u0 + nu])
        s_seg = seg_ptr[s0:s0 + min(s1 - s0 + 1, SEG_CAP + 1)]

        def seg_at(s):
            if s - s0 <= SEG_CAP:
                staged["seg"] += 1
                return int(s_seg[s - s0])
            staged["seg_global"] += 1
            return int(seg_ptr[s])

        e0 = int(s_seg[0])
        ne = seg_at(s1) - e0
        s_perm = perm[e0:e0 + min(ne, PERM_CAP)]

        def value(e, k):
            if e - e0 < PERM_CAP:
                staged["perm"] += 1
                slot = s_perm[e - e0]
            else:
                staged["perm_global"] += 1
                slot = perm[e]
            reads[e, k:k + W] += 1
            return flat[slot, k:k + W]

        items = nu * nq
        for it0 in range(0, items, WARP * AHEAD_STEPS):
            for lane in range(WARP):
                ahead = []
                for a in range(AHEAD_STEPS):      # every gather first
                    it = it0 + WARP * a + lane
                    run = it // nq if it < items else nu - 1
                    sb = int(rp[run])
                    se = int(rp[run + 1]) if run + 1 < nu else s1
                    k = (it - run * nq) * W
                    eb, ee = seg_at(sb), seg_at(se)
                    x = [value(eb + i, k) if it < items and eb + i < ee
                         else np.zeros(W, np.float32)
                         for i in range(AHEAD_ENT)]
                    ahead.append((it, sb, se, k, eb, x))
                for it, sb, se, k, eb, x in ahead:
                    if it >= items:
                        break
                    total = np.zeros(W, np.float32)
                    e = eb
                    for s in range(sb, se):
                        part = np.zeros(W, np.float32)
                        end = seg_at(s + 1)
                        while e < end:
                            i = e - eb
                            v = x[i] if i < AHEAD_ENT else value(e, k)
                            part = (part + v).astype(np.float32)
                            e += 1
                        total = (total + part).astype(np.float32)
                    out[u0 + it // nq, k:k + W] = total
                    writes[u0 + it // nq, k:k + W] += 1
    assert (writes == 1).all(), "an output float not written exactly once"
    assert (reads == 1).all(), "an entry not read once per float"
    return out, staged


def emulate_before(flat, perm, seg_ptr, run_ptr):
    """The replaced kernel's order: a thread per (run, tile cell), total =
    0 + each segment's part, part = 0 + its entries."""
    U = run_ptr.size - 1
    out = np.zeros((U, flat.shape[1]), np.float32)
    for u in range(U):
        total = np.zeros(flat.shape[1], np.float32)
        for s in range(run_ptr[u], run_ptr[u + 1]):
            part = np.zeros(flat.shape[1], np.float32)
            for e in range(seg_ptr[s], seg_ptr[s + 1]):
                part = (part + flat[perm[e]]).astype(np.float32)
            total = (total + part).astype(np.float32)
        out[u] = total
    return out


def jax_union(d0, d1, count, vals, shape):
    """The reference's nnz leaf per chunk, then the cross-chunk dedupe in
    chunk order; (coords sorted row-major, sums)."""
    tile = vals.shape[2:]
    sums = {}
    for p in range(d0.shape[0]):
        if tile:
            r, c, v, n = rref.leaf_bcsr_spadd_union_chunk(
                d0[p], d1[p], vals[p], count[p], shape[0])
        else:
            r, c, v, n = rref.leaf_spadd_union_chunk(
                d0[p], d1[p], vals[p], count[p], shape[0])
        r, c, v = (np.asarray(x)[:int(n)] for x in (r, c, v))
        for i in range(r.size):
            key = (int(r[i]), int(c[i]))
            sums[key] = (sums[key] + v[i]).astype(np.float32) \
                if key in sums else v[i].astype(np.float32)
    keys = sorted(sums)
    return np.asarray(keys), np.stack([sums[k] for k in keys])


def _check(rng, counts, tile, P=8, shape=(40, 50), spread=None,
           aligned=True, expect_overflow=False):
    d0, d1, count, vals = chip_smoke.union_run_stream(rng, counts, P, shape,
                                                      tile, spread)
    T = torch.from_numpy
    perm, seg_ptr, run_ptr, pos, crd = spadd3.plan_runs(
        T(d0), T(d1), T(count), shape)
    perm, seg_ptr, run_ptr = (x.numpy() for x in (perm, seg_ptr, run_ptr))
    U = run_ptr.size - 1
    assert U == len(counts)
    flat = vals.reshape(P * vals.shape[1], -1)
    tsize = flat.shape[1]
    got, staged = emulate(flat, perm, seg_ptr, run_ptr, tsize, aligned)
    assert (staged["perm_global"] > 0) == expect_overflow
    np.testing.assert_array_equal(
        got.view(np.int32),
        emulate_before(flat, perm, seg_ptr, run_ptr).view(np.int32))
    before = dict(_build.LAUNCHES)
    wrap = spadd3.bcsr_spadd3_union_nnz if tile else spadd3.spadd3_union_nnz
    plain = wrap(T(vals), T(perm), T(seg_ptr), T(run_ptr)).numpy()
    assert _build.LAUNCHES == before                  # the CPU launches none
    scale = wrap(T(np.abs(vals)), T(perm), T(seg_ptr), T(run_ptr)).numpy()
    tol = RTOL * scale.reshape(U, -1) + ATOL
    assert (np.abs(got - plain.reshape(U, -1)) <= tol).all()
    keys, want = jax_union(d0, d1, count, vals, shape)
    rows = np.repeat(np.arange(shape[0]), np.diff(pos.numpy()))
    np.testing.assert_array_equal(np.stack([rows, crd.numpy()], 1), keys)
    assert (np.abs(got - want.reshape(U, -1)) <= tol).all()


TILES = [(), (4, 4), (3, 5)]
IDS = ["scalar", "4x4", "3x5"]


@pytest.mark.parametrize("tile", TILES, ids=IDS)
@pytest.mark.parametrize("U", [1, 31, 33, 77])
def test_short_runs(tile, U):
    """Runs of 1, 2 and 3 entries over random chunks (up to 3 segments), U
    not a multiple of 32 (and 1): ragged last warps."""
    rng = np.random.default_rng(U)
    _check(rng, rng.integers(1, 4, U), tile)


@pytest.mark.parametrize("tile", TILES, ids=IDS)
def test_long_runs_over_eight_segments(tile):
    """chip_smoke's run stream: runs of 40 entries round-robin over 8
    chunks (8 segments of 5) among runs of 1-3, U = 59: a long run loops
    past the three entries gathered ahead; 32 such runs in one warp
    overflow the staged walk (129 seg_ptr and 256 perm entries), read on
    from device memory in order."""
    rng = np.random.default_rng(40)
    counts = np.concatenate([rng.integers(1, 4, 10), [40] * 40,
                             rng.integers(1, 4, 9)])
    spread = np.where(counts == 40, 8, 0)
    _check(rng, counts, tile, shape=(60, 70), spread=spread,
           expect_overflow=True)


@pytest.mark.parametrize("tile", [(), (4, 4)], ids=["scalar", "4x4"])
def test_runs_over_one_to_eight_segments(tile):
    """Runs of 2 to 16 entries each spread over 1 to 8 chunks, so the
    segment structure inside one warp's walk varies run by run."""
    rng = np.random.default_rng(8)
    spread = rng.integers(1, 9, 50)
    counts = spread * rng.integers(1, 3, 50)
    _check(rng, counts, tile, spread=spread)


@pytest.mark.parametrize("tile", [(4, 4), (2, 2)], ids=["4x4", "2x2"])
def test_unaligned_base_takes_four_byte_loads(tile):
    """Values off a 16-byte boundary (or a tile that is a multiple of 4
    floats seen one float at a time) take the 4-byte path: the same
    order, the same bits."""
    rng = np.random.default_rng(5)
    _check(rng, rng.integers(1, 4, 45), tile, aligned=False)


def test_an_empty_chunk_and_one_run():
    """A stream whose seven entries are one coordinate, all in chunk 1;
    chunks 0, 2 and 3 empty."""
    rng = np.random.default_rng(6)
    d0, d1, count, vals = chip_smoke.union_run_stream(
        rng, [7], 4, (5, 5), (4, 4), spread=[1])
    d0[1], d1[1], vals[1] = d0[0], d1[0], vals[0]
    d0[0], count[1], count[0] = 0, count[0], 0
    T = torch.from_numpy
    perm, seg_ptr, run_ptr, _, _ = spadd3.plan_runs(T(d0), T(d1), T(count),
                                                   (5, 5))
    flat = vals.reshape(-1, 16)
    got, _ = emulate(flat, perm.numpy(), seg_ptr.numpy(), run_ptr.numpy(),
                     16)
    np.testing.assert_array_equal(
        got, emulate_before(flat, perm.numpy(), seg_ptr.numpy(),
                            run_ptr.numpy()))
    np.testing.assert_allclose(got[0], vals[1, :7].reshape(7, 16).sum(0),
                               rtol=1e-5, atol=1e-6)
