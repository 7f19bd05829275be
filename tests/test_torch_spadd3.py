"""The port's SpAdd3 leaves and kernels (scalar and blocked) against the JAX
package's.

- The union leaves (``leaf_spadd3_rows``, ``leaf_spadd_union_chunk`` and
  the blocked twins) against the jnp leaves: rows, cols and counts equal,
  vals at 1e-6.
- ``ops.spadd3_dense`` and ``ops.spadd3_bcsr_dense`` (``impl="torch"``, and
  ``impl="cuda"``, whose wrappers run their plain versions on CPU tensors)
  against the reference's ``impl="pallas"`` (the Pallas kernels in
  interpret mode) and ``impl="xla"`` at 1e-5: a sum of three f32 values.
- The lowered path's union wrappers on the CPU: their plain versions, no
  launch, and the run plan of the nnz strategy against the reference's
  per-chunk union followed by its host dedupe.
The CUDA kernels themselves run only on a card (tests/test_torch_gpu.py)."""
import numpy as np
import pytest
import torch

from repro.core import formats as RF
from repro.core.tensor import Tensor as RTensor
from repro.kernels import ops as rops
from repro.kernels import ref as rref

from repro_torch.kernels import _build, ops, ref, spadd3

IMPLS = ["torch", "cuda"]


def _np(x):
    return x.cpu().numpy()


def _dense(rng, shape, density):
    d = ((rng.random(shape) < density)
         * rng.standard_normal(shape)).astype(np.float32)
    d[rng.integers(0, shape[0])] = 0                        # empty row
    d[rng.integers(0, shape[0])] = rng.standard_normal(shape[1])  # long row
    return d


def _storage(d, fm):
    t = RTensor.from_dense("X", d, fm)
    return t.levels[1].pos, t.levels[1].crd, t.vals


def _shard(rng, R, N, density, block=None):
    """One padded row shard as the materializers pack it: pos (R + 1,)
    densified with the last rows empty, crd and vals padded to N."""
    m = 11
    d = _dense(rng, (R * (block[0] if block else 1) - 1, m), density)
    d[-2:] = 0                                     # rows past the window
    pos, crd, vals = _storage(d, RF.BCSR(block) if block else RF.CSR())
    pos = np.concatenate([pos, np.full(R + 1 - pos.shape[0], pos[-1])])
    n = crd.shape[0]
    crd = np.concatenate([crd, np.zeros(N - n, np.int32)])
    vals = np.concatenate([vals, np.zeros((N - n,) + vals.shape[1:],
                                          np.float32)])
    return pos.astype(np.int32), crd.astype(np.int32), vals


@pytest.mark.parametrize("block", [None, (2, 2), (3, 4)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_union_leaves_vs_jnp(seed, block):
    rng = np.random.default_rng(seed)
    R = 7
    trip = [_shard(rng, R, N, dens, block)
            for N, dens in ((60, 0.4), (45, 0.25), (50, 0.0))]
    flat = [x for t in trip for x in t]
    tflat = [torch.from_numpy(x) for x in flat]
    if block:
        got = ref.leaf_bcsr_spadd3_rows(*tflat)
        want = rref.leaf_bcsr_spadd3_rows(*flat)
    else:
        got = ref.leaf_spadd3_rows(*tflat, n_cols=11)
        want = rref.leaf_spadd3_rows(*flat, n_cols=11)
    _same_union(got, want)
    # the per-chunk leaf over a padded slice of a concatenated stream
    rows = np.concatenate([rng.integers(0, R, 30), np.full(6, 5)])
    cols = rng.integers(0, 4, 36)
    vals = rng.standard_normal((36,) + (block or ())).astype(np.float32)
    args = (rows.astype(np.int32), cols.astype(np.int32), vals)
    count = np.int32(31)
    leaf, rleaf = ((ref.leaf_bcsr_spadd_union_chunk,
                    rref.leaf_bcsr_spadd_union_chunk) if block else
                   (ref.leaf_spadd_union_chunk, rref.leaf_spadd_union_chunk))
    _same_union(leaf(*(torch.from_numpy(x) for x in args),
                     torch.tensor(count), R),
                rleaf(*args, count, R))


def _same_union(got, want):
    g_r, g_c, g_v, g_k = (_np(x) for x in got)
    w_r, w_c, w_v, w_k = (np.asarray(x) for x in want)
    assert int(g_k) == int(w_k) > 0
    np.testing.assert_array_equal(g_r, w_r)
    np.testing.assert_array_equal(g_c, w_c)
    np.testing.assert_allclose(g_v, w_v, atol=1e-6)


def test_empty_union_leaf():
    """An all-empty shard gives count 0 (the jnp leaf raises here: ROADMAP
    Queue 3)."""
    e = (torch.zeros(4, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
         torch.zeros(0))
    _, _, v, k = ref.leaf_spadd3_rows(*e, *e, *e, n_cols=5)
    assert int(k) == 0 and v.shape == (0,)


@pytest.mark.parametrize("shape", [(16, 24), (65, 40), (1, 7), (37, 130)])
def test_spadd3_dense_vs_pallas(shape):
    rng = np.random.default_rng(4)
    trips, total = [], np.zeros(shape, np.float32)
    for i in range(3):
        d = _dense(rng, shape, 0.1 + 0.05 * i)
        trips.append(_storage(d, RF.CSR()))
        total += d
    n, m = shape
    want = np.asarray(rops.spadd3_dense(*trips, n_rows=n, n_cols=m,
                                        impl="pallas"))
    xla = np.asarray(rops.spadd3_dense(*trips, n_rows=n, n_cols=m,
                                       impl="xla"))
    np.testing.assert_allclose(want, total, atol=1e-5)
    for impl in IMPLS:
        got = _np(ops.spadd3_dense(*trips, n_rows=n, n_cols=m, impl=impl,
                                   device="cpu"))
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got, xla, atol=1e-5)


@pytest.mark.parametrize("shape", [(19, 13), (33, 71)])
@pytest.mark.parametrize("block", [(2, 2), (4, 4)])
def test_spadd3_bcsr_dense_vs_pallas(block, shape):
    """n_cols is not a multiple of bc: the boundary tiles' padding is
    sliced off."""
    rng = np.random.default_rng(5)
    trips, total = [], np.zeros(shape, np.float32)
    for i in range(3):
        d = _dense(rng, shape, 0.1 + 0.1 * i)
        trips.append(_storage(d, RF.BCSR(block)))
        total += d
    n, m = shape
    assert m % block[1]
    want = np.asarray(rops.spadd3_bcsr_dense(*trips, n_rows=n, n_cols=m,
                                             impl="pallas"))
    xla = np.asarray(rops.spadd3_bcsr_dense(*trips, n_rows=n, n_cols=m,
                                            impl="xla"))
    np.testing.assert_allclose(want, total, atol=1e-5)
    for impl in IMPLS:
        got = _np(ops.spadd3_bcsr_dense(*trips, n_rows=n, n_cols=m,
                                        impl=impl, device="cpu"))
        assert got.shape == shape
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got, xla, atol=1e-5)


def test_dense_kernel_contract_is_checked():
    """The dense kernels need distinct columns per row of each operand:
    ops refuses a row with a repeated column before any launch."""
    pos = np.array([0, 2], np.int32)
    good = (pos, np.array([0, 1], np.int32), np.ones(2, np.float32))
    bad = (pos, np.array([1, 1], np.int32), np.ones(2, np.float32))
    with pytest.raises(ValueError, match="strictly increase"):
        ops.spadd3_dense(good, bad, good, 1, 3, impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="impl"):
        ops.spadd3_dense(good, good, good, 1, 3, impl="pallas", device="cpu")


def _stack(trips):
    return [torch.from_numpy(np.stack(x)) for x in zip(*trips)]


@pytest.mark.parametrize("block", [None, (2, 3)])
def test_union_rows_wrapper_on_cpu(block):
    """The rows leaf over three pieces (the middle one empty) runs its plain
    version on the CPU: one CSR over the P·R rows whose row p·R + r holds
    piece p's row r of B + C + D, columns increasing."""
    rng = np.random.default_rng(8)
    R, N = 6, 70
    ops_ = []
    for dens in (0.3, 0.2, 0.5):
        empty = (np.zeros(R + 1, np.int32), np.zeros(N, np.int32),
                 np.zeros((N,) + (block or ()), np.float32))
        pieces = [_shard(rng, R, N, dens, block), empty,
                  _shard(rng, R, N, dens, block)]
        ops_.append(_stack(pieces))
    flat = [x for t in ops_ for x in t]
    wrapper = (spadd3.bcsr_spadd3_union_rows if block
               else spadd3.spadd3_union_rows)
    before = dict(_build.LAUNCHES)
    row_pos, crd, vals = wrapper(*flat)
    assert _build.LAUNCHES == before          # no kernel ran on the CPU
    row_pos, crd, vals = _np(row_pos), _np(crd), _np(vals)
    tile = block or ()
    for p in range(3):
        for r in range(R):
            want = {}
            for pos, c, v in ops_:
                for e in range(int(pos[p, r]), int(pos[p, r + 1])):
                    want[int(c[p, e])] = (want.get(int(c[p, e]), 0)
                                          + _np(v[p, e]))
            lo, hi = row_pos[p * R + r], row_pos[p * R + r + 1]
            assert list(crd[lo:hi]) == sorted(want)
            for k, col in enumerate(sorted(want)):
                np.testing.assert_allclose(vals[lo + k], want[col],
                                           atol=1e-6)
                assert vals[lo + k].shape == tile
    assert row_pos[R] == row_pos[2 * R]       # the empty piece


@pytest.mark.parametrize("block", [None, (2, 2)])
@pytest.mark.parametrize("weights", [None, (1.0, 3.0, 2.0)])
def test_plan_runs_match_the_reference_assembly(block, weights):
    """The nnz leaf: plan_runs once, then the run sums, equal the
    reference's per-chunk union leaf followed by its cross-chunk host
    dedupe (Tensor.from_coo / from_blocks): same coordinates in storage
    order, values at 1e-6; BCSC's runs come in column-major order."""
    from repro.core import partition as RP
    rng = np.random.default_rng(11)
    shape = (13, 9)
    fm = RF.BCSR(block) if block else RF.CSR()
    ts = [RTensor.from_dense(k, _dense(rng, shape, 0.3), fm) for k in "BCD"]
    w = None if weights is None else np.asarray(weights)
    S = RP.materialize_add_stream(ts, 3, w)
    a = S.arrays
    if block:
        grid = (S.meta["grid_rows"], S.meta["grid_cols"])
        leaf = rref.leaf_bcsr_spadd_union_chunk
    else:
        grid = shape
        leaf = rref.leaf_spadd_union_chunk
    outs = [leaf(a["dim0"][p], a["dim1"][p], a["vals"][p], a["nnz_count"][p],
                 grid[0]) for p in range(3)]
    coords = np.concatenate([np.stack([np.asarray(o[0])[:int(o[3])],
                                       np.asarray(o[1])[:int(o[3])]], 1)
                             for o in outs])
    vals = np.concatenate([np.asarray(o[2])[:int(o[3])] for o in outs])
    t = lambda k: torch.from_numpy(a[k])
    for fmt_ in ([fm, RF.BCSC(block)] if block else [fm]):
        if block:
            want = RTensor.from_blocks("A", shape, fmt_, coords, vals,
                                       dedupe=True)
        else:
            want = RTensor.from_coo("A", shape, coords, vals, fmt_,
                                    dedupe=True)
        root = fmt_.dim_of_level(0)
        perm, seg_ptr, run_ptr, pos, crd = spadd3.plan_runs(
            t("dim0"), t("dim1"), t("nnz_count"), grid, root)
        np.testing.assert_array_equal(_np(pos), want.levels[1].pos)
        np.testing.assert_array_equal(_np(crd), want.levels[1].crd)
        before = dict(_build.LAUNCHES)
        got = (spadd3.bcsr_spadd3_union_nnz if block
               else spadd3.spadd3_union_nnz)(t("vals"), perm, seg_ptr,
                                             run_ptr)
        assert _build.LAUNCHES == before
        np.testing.assert_allclose(_np(got), want.vals, atol=1e-6)


def test_union_wrappers_refuse_what_they_cannot_run():
    meta = torch.empty((2, 4), dtype=torch.int32, device="meta")
    crd = torch.empty((2, 6), dtype=torch.int32, device="meta")
    vals = torch.empty((2, 6), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        spadd3.spadd3_union_rows(meta, crd, vals, meta, crd, vals, meta, crd,
                                 vals)
    with pytest.raises(ValueError, match="CUDA device"):
        spadd3.spadd3_union_nnz(vals, crd[0], meta[0], meta[0])
    pos = torch.zeros((2, 4), dtype=torch.int32)
    c = torch.zeros((2, 6), dtype=torch.int32)
    v = torch.zeros((2, 6))
    with pytest.raises(TypeError, match="crd2 must be torch.int32"):
        spadd3.spadd3_union_rows(pos, c, v, pos, c.long(), v, pos, c, v)
    with pytest.raises(ValueError, match="bad shapes"):
        spadd3.spadd3_union_rows(pos, c, v, pos, c, v[:, :3], pos, c, v)
    with pytest.raises(ValueError, match="pos must be"):
        spadd3.spadd3_dense_rows(pos[0], c[0], v[0], pos[0], c[0], v[0],
                                 pos[0], c[0], v[0], 7, 5)


@pytest.mark.parametrize("block", [None, (2, 2)])
def test_transpose_walk_shards_are_row_sorted(block):
    """The rows union merges sorted column lists. CSC and BCSC row shards
    come from the transpose walk, a lexsort by (row, column): within every
    row of every piece the columns strictly increase, as in a CSR shard, so
    the lowered path sorts nothing for them."""
    import repro_torch.core as tc
    from repro_torch.core import partition as TP
    rng = np.random.default_rng(13)
    d = _dense(rng, (19, 13), 0.4)
    fm = tc.BCSC(block) if block else tc.CSC()
    t = tc.Tensor.from_dense("B", d, fm)
    bounds = TP.block_aligned_row_bounds(19, 3, block[0] if block else 1)
    part = TP.partition_tensor_rows(t, bounds)
    assert part.walk_perm is not None
    sh = (TP.materialize_bcsr_rows if block else TP.materialize_csr_rows)(
        t, part)
    pos, crd = sh.arrays["pos1"], sh.arrays["crd1"]
    for p in range(3):
        for r in range(pos.shape[1] - 1):
            cols = crd[p, pos[p, r]:pos[p, r + 1]]
            assert (np.diff(cols) > 0).all()
