"""The port's blocked (BCSR, BCSC) SpMV, SpMM and SDDMM against the JAX
package's.

- The five blocked leaves against the jnp leaves at 1e-5 (sums of a few f32
  products, in another order).
- ``ops.spmv_bcsr``, ``ops.spmm_bcsr`` and ``ops.sddmm_bcsr``
  (``impl="torch"``, and ``impl="cuda"``, whose wrappers run their plain
  versions on CPU tensors) against the reference's ``impl="pallas"`` (the
  Pallas kernels in interpret mode) and ``impl="xla"`` at 1e-4, at the
  shapes and blocks of tests/test_bcsr_blocked.py::test_bcsr_pallas_kernels.
- ``materialize_bcsr_nnz``: arrays and meta equal to the reference's.
- The kernel wrappers on the CPU: their plain versions, no launch.
The CUDA kernels themselves run only on a card (tests/test_torch_gpu.py)."""
import numpy as np
import pytest
import torch

from repro.core import formats as RF
from repro.core import partition as RP
from repro.core.tensor import Tensor as RTensor
from repro.kernels import ops as rops
from repro.kernels import ref as rref

from repro_torch.core import formats as TF
from repro_torch.core import partition as TP
from repro_torch.core.tensor import Tensor as TTensor
from repro_torch.kernels import _build, bcsr, layout, ops, ref

CASES = [((19, 13), (2, 2)), ((37, 53), (4, 8))]
IMPLS = ["torch", "cuda"]


def _operand(shape, block, seed, density=0.3):
    rng = np.random.default_rng(seed)
    n, m = shape
    d = ((rng.random((n, m)) < density)
         * rng.standard_normal((n, m))).astype(np.float32)
    d[rng.integers(0, n)] = 0                                   # empty row
    t = RTensor.from_dense("B", d, RF.BCSR(block))
    return rng, d, t.levels[1].pos, t.levels[1].crd, t.vals, t


def _np(x):
    return x.cpu().numpy()


@pytest.mark.parametrize("shape,block", CASES, ids=["19x13-2x2", "37x53-4x8"])
def test_spmv_bcsr_vs_pallas(shape, block):
    rng, d, pos, crd, tiles, _ = _operand(shape, block, 0)
    c = rng.standard_normal(shape[1]).astype(np.float32)
    want = np.asarray(rops.spmv_bcsr(pos, crd, tiles, c, impl="pallas"))
    xla = np.asarray(rops.spmv_bcsr(pos, crd, tiles, c, impl="xla"))
    np.testing.assert_allclose(want[:shape[0]], d @ c, atol=1e-4, rtol=1e-4)
    for impl in IMPLS:
        got = _np(ops.spmv_bcsr(pos, crd, tiles, c, impl=impl, device="cpu"))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got, xla, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("J", [1, 9, 33])
@pytest.mark.parametrize("shape,block", CASES, ids=["19x13-2x2", "37x53-4x8"])
def test_spmm_bcsr_vs_pallas(shape, block, J):
    rng, d, pos, crd, tiles, _ = _operand(shape, block, 1)
    C = rng.standard_normal((shape[1], J)).astype(np.float32)
    want = np.asarray(rops.spmm_bcsr(pos, crd, tiles, C, impl="pallas"))
    xla = np.asarray(rops.spmm_bcsr(pos, crd, tiles, C, impl="xla"))
    np.testing.assert_allclose(want[:shape[0]], d @ C, atol=1e-4, rtol=1e-4)
    for impl in IMPLS:
        got = _np(ops.spmm_bcsr(pos, crd, tiles, C, impl=impl, device="cpu"))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got, xla, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("K", [1, 7, 32, 33])
@pytest.mark.parametrize("shape,block", CASES, ids=["19x13-2x2", "37x53-4x8"])
def test_sddmm_bcsr_vs_pallas(shape, block, K):
    rng, d, _, _, tiles, t = _operand(shape, block, 2)
    n, m = shape
    Cs = rng.standard_normal((n, K)).astype(np.float32)
    Ds = rng.standard_normal((K, m)).astype(np.float32)
    bcoords = t.block_coords()
    args = (bcoords[:, 0], bcoords[:, 1], tiles, Cs, Ds)
    want = np.asarray(rops.sddmm_bcsr(*args, impl="pallas"))
    xla = np.asarray(rops.sddmm_bcsr(*args, impl="xla"))
    dense = RTensor("o", t.shape, t.format, t.levels, want,
                    np.float32).to_dense()
    np.testing.assert_allclose(dense, d * (Cs @ Ds), atol=1e-4, rtol=1e-4)
    for impl in IMPLS:
        got = _np(ops.sddmm_bcsr(*args, impl=impl, device="cpu"))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got, xla, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape,block", CASES, ids=["19x13-2x2", "37x53-4x8"])
def test_blocked_leaves_vs_jnp(shape, block, seed):
    """The five leaves on the same packed inputs: a shard padded past its
    last stored block (zero tiles), dense operands packed by the port's own
    copy of the reference's packers."""
    rng, _, pos, crd, tiles, t = _operand(shape, block, 10 + seed)
    br, bc = block
    n, m = shape
    grid_rows, grid_cols = -(-n // br), -(-m // bc)
    pad = 5
    crd_p = np.concatenate([crd, np.zeros(pad, crd.dtype)])
    tiles_p = np.concatenate([tiles, np.zeros((pad, br, bc), np.float32)])
    c = rng.standard_normal(m).astype(np.float32)
    C = rng.standard_normal((m, 6)).astype(np.float32)
    Cs = rng.standard_normal((n, 7)).astype(np.float32)
    Ds = rng.standard_normal((7, m)).astype(np.float32)
    c_blk = layout.pack_vec_blocks(c, grid_cols, bc)
    C_blk = layout.pack_mat_row_blocks(C, grid_cols, bc)
    Cs_blk = layout.pack_mat_row_blocks(Cs, grid_rows, br)
    Ds_blk = layout.pack_mat_inner_blocks(Ds, grid_cols, bc)
    brow = np.repeat(np.arange(grid_rows), np.diff(pos)).astype(np.int32)
    brow_p = np.concatenate([brow, np.full(pad, grid_rows, np.int32)])
    T = torch.from_numpy
    pairs = [
        (ref.leaf_bcsr_spmv_rows(T(pos), T(crd_p), T(tiles_p), T(c_blk)),
         rref.leaf_bcsr_spmv_rows(pos, crd_p, tiles_p, c_blk)),
        (ref.leaf_bcsr_spmv_nnz(T(brow_p), T(crd_p), T(tiles_p), T(c_blk),
                                grid_rows),
         rref.leaf_bcsr_spmv_nnz(brow_p, crd_p, tiles_p, c_blk, grid_rows)),
        (ref.leaf_bcsr_spmm_rows(T(pos), T(crd_p), T(tiles_p), T(C_blk)),
         rref.leaf_bcsr_spmm_rows(pos, crd_p, tiles_p, C_blk)),
        (ref.leaf_bcsr_spmm_nnz(T(brow_p), T(crd_p), T(tiles_p), T(C_blk),
                                grid_rows),
         rref.leaf_bcsr_spmm_nnz(brow_p, crd_p, tiles_p, C_blk, grid_rows)),
        (ref.leaf_bcsr_sddmm(T(brow), T(crd), T(tiles), T(Cs_blk),
                             T(Ds_blk)),
         rref.leaf_bcsr_sddmm(brow, crd, tiles, Cs_blk, Ds_blk)),
    ]
    for got, want in pairs:
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_packers_match_the_reference():
    from repro.kernels import layout as rlayout
    rng = np.random.default_rng(3)
    c = rng.standard_normal(13).astype(np.float32)
    C = rng.standard_normal((13, 5)).astype(np.float32)
    Cv = rng.standard_normal((3, 6, 5)).astype(np.float32)
    for got, want in (
            (layout.pack_vec_blocks(c, 7, 2),
             rlayout.pack_vec_blocks(c, 7, 2)),
            (layout.pack_mat_row_blocks(C, 4, 4),
             rlayout.pack_mat_row_blocks(C, 4, 4)),
            (layout.pack_rowwindow_blocks(Cv, 2, 4),
             rlayout.pack_rowwindow_blocks(Cv, 2, 4)),
            (layout.pack_rowwindow_blocks(Cv, 1, 4),
             rlayout.pack_rowwindow_blocks(Cv, 1, 4)),
            (layout.pack_mat_inner_blocks(C.T, 2, 8),
             rlayout.pack_mat_inner_blocks(C.T, 2, 8))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pieces", [2, 4])
@pytest.mark.parametrize("key,block", [("bcsr", (2, 2)), ("bcsc", (2, 2)),
                                       ("bcsr", (4, 8)), ("bcsc", (4, 8))])
def test_materialize_bcsr_nnz_matches_reference(key, block, pieces):
    _, d, _, _, _, _ = _operand((37, 53), block, 4)
    Rt = RTensor.from_dense("B", d, (RF.BCSR if key == "bcsr"
                                     else RF.BCSC)(block))
    Tt = TTensor.from_dense("B", d, TF.format_from_key(key, block))
    RP.clear_shard_cache()
    TP.clear_shard_cache()
    want = RP.materialize_bcsr_nnz(
        Rt, RP.partition_tensor_nonzeros(Rt, pieces))
    got = TP.materialize_bcsr_nnz(
        Tt, TP.partition_tensor_nonzeros(Tt, pieces))
    assert got.kind == want.kind == "bcsr_nnz"
    assert got.meta == want.meta
    assert got.meta["root_dim"] == (0 if key == "bcsr" else 1)
    assert sorted(got.arrays) == sorted(want.arrays)
    for name, x in want.arrays.items():
        assert got.arrays[name].dtype == x.dtype, name
        np.testing.assert_array_equal(got.arrays[name], x)
    # a second materialization is a cache hit
    hits = TP.SHARD_CACHE_STATS["hits"]
    TP.materialize_bcsr_nnz(Tt, TP.partition_tensor_nonzeros(Tt, pieces))
    assert TP.SHARD_CACHE_STATS["hits"] == hits + 1


def test_wrappers_on_cpu_use_plain_versions():
    """On CPU tensors the three wrappers return their plain versions'
    results (sorted ids, a dropped padding tail, an empty piece) and launch
    nothing; a malformed call raises on every device; a (32, 16) block, of
    more than 256 entries, runs."""
    rng = np.random.default_rng(5)
    P, N, br, bc, R, gc = 3, 40, 4, 8, 6, 5
    brow = np.sort(rng.integers(0, R, (P, N)), axis=1).astype(np.int32)
    brow[0, -7:] = R                                     # dropped padding
    brow[1] = R                                          # an empty piece
    bcol = rng.integers(0, gc, (P, N)).astype(np.int32)
    tiles = rng.standard_normal((P, N, br, bc)).astype(np.float32)
    T = torch.from_numpy
    before = dict(_build.LAUNCHES)
    c_blk = T(rng.standard_normal((gc, bc)).astype(np.float32))
    C_blk = T(rng.standard_normal((gc, bc, 9)).astype(np.float32))
    C = T(rng.standard_normal((P, R * br, 7)).astype(np.float32))
    Dt = T(rng.standard_normal((gc * bc, 7)).astype(np.float32))
    y = bcsr.bcsr_spmv(T(brow), T(bcol), T(tiles), c_blk, R)
    Y = bcsr.bcsr_spmm(T(brow), T(bcol), T(tiles), C_blk, R)
    out = bcsr.bcsr_sddmm(T(brow), T(bcol), T(tiles), C, Dt)
    assert _build.LAUNCHES == before
    assert y.shape == (P, R * br) and Y.shape == (P, R * br, 9)
    assert out.shape == (P, N, br, bc)
    assert not y[1].any() and not Y[1].any()
    Cn, Dn = _np(C).reshape(P, R, br, 7), _np(Dt).reshape(gc, bc, 7)
    for p in range(P):
        for b in range(R):
            sel = brow[p] == b
            tp, cp = tiles[p][sel], bcol[p][sel]
            np.testing.assert_allclose(
                _np(y[p, b * br:(b + 1) * br]),
                np.einsum("nrc,nc->r", tp, _np(c_blk)[cp]), atol=1e-4)
            np.testing.assert_allclose(
                _np(Y[p, b * br:(b + 1) * br]),
                np.einsum("nrc,ncj->rj", tp, _np(C_blk)[cp]), atol=1e-4)
        ids = np.minimum(brow[p], R - 1)                 # clamped per block
        np.testing.assert_allclose(
            _np(out[p]), tiles[p] * np.einsum("nrk,nck->nrc", Cn[p][ids],
                                               Dn[bcol[p]]), atol=1e-4)
    with pytest.raises(ValueError):
        bcsr.bcsr_spmm(T(brow), T(bcol[:, :5]), T(tiles), C_blk, R)
    with pytest.raises(ValueError):
        bcsr.bcsr_sddmm(T(brow), T(bcol), T(tiles), C[:, :-1], Dt)
    with pytest.raises(TypeError):
        bcsr.bcsr_spmv(T(brow).long(), T(bcol), T(tiles), c_blk, R)
    # a block of more than 256 entries is taken (once refused here)
    ids = torch.zeros((1, 1), dtype=torch.int32)
    big = bcsr.bcsr_spmv(ids, ids, torch.ones((1, 1, 32, 16)),
                         torch.ones((1, 16)), 1)
    assert torch.equal(big, torch.full((1, 32), 16.0))
