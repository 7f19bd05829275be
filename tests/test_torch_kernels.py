"""The port's SpMV and SpMM kernels against the JAX package's.

At the ops level, ``repro_torch.kernels.ops`` (``impl="torch"``, and
``impl="cuda"``, whose wrappers run their plain versions on CPU tensors) is
held against ``repro.kernels.ops`` with ``impl="pallas"`` in interpret mode,
at the shapes of tests/test_kernels_pallas.py plus an empty row, an empty
piece and a row longer than 128 entries. Tolerances are the reference's own:
1e-4 for SpMV, 1e-3 for SpMM. Each torch leaf is held against its jnp leaf.
The CUDA kernels themselves run only on a card (tests/test_torch_gpu.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import formats as RF
from repro.core.tensor import Tensor as RTensor
from repro.kernels import ops as rops
from repro.kernels import ref as rref

from repro_torch.kernels import _build, ops, ref, spmm, spmv

SHAPES_2D = [(8, 8), (37, 53), (64, 128), (130, 65), (1, 7), (256, 17),
             (4, 300)]
DENSITIES = [0.05, 0.3]
IMPLS = ["torch", "cuda"]


def _csr(rng, n, m, density):
    d = ((rng.random((n, m)) < density)
         * rng.standard_normal((n, m))).astype(np.float32)
    if n > 1:
        d[rng.integers(0, n)] = 0                           # empty row
    d[rng.integers(0, n)] = rng.standard_normal(m)          # long row
    t = RTensor.from_dense("B", d, RF.CSR())
    return t.levels[1].pos, t.levels[1].crd, t.vals, d


def _np(x):
    return x.cpu().numpy()


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("shape", SHAPES_2D)
def test_spmv_vs_pallas(shape, density):
    rng = np.random.default_rng(abs(hash(shape)) % 2**31)
    pos, crd, vals, d = _csr(rng, *shape, density)
    c = rng.standard_normal(shape[1]).astype(np.float32)
    want = np.asarray(rops.spmv(pos, crd, vals, c, impl="pallas"))
    for impl in IMPLS:
        got = _np(ops.spmv(pos, crd, vals, c, impl=impl, device="cpu"))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(want, d @ c, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("shape", SHAPES_2D[:4] + SHAPES_2D[6:])
def test_spmv_nnz_vs_pallas(shape):
    rng = np.random.default_rng(1)
    n, m = shape
    pos, crd, vals, d = _csr(rng, n, m, 0.25)
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(pos))
    c = rng.standard_normal(m).astype(np.float32)
    want = np.asarray(rops.spmv_nnz(rows, crd, vals, c, n_rows=n,
                                    impl="pallas"))
    for impl in IMPLS:
        got = _np(ops.spmv_nnz(rows, crd, vals, c, n_rows=n, impl=impl,
                               device="cpu"))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(want, d @ c, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("j", [1, 16, 130])
@pytest.mark.parametrize("shape", SHAPES_2D[:4])
def test_spmm_vs_pallas(shape, j):
    rng = np.random.default_rng(2)
    pos, crd, vals, d = _csr(rng, *shape, 0.2)
    C = rng.standard_normal((shape[1], j)).astype(np.float32)
    want = np.asarray(rops.spmm(pos, crd, vals, C, impl="pallas"))
    for impl in IMPLS:
        got = _np(ops.spmm(pos, crd, vals, C, impl=impl, device="cpu"))
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(want, d @ C, atol=1e-3, rtol=1e-3)


def _leaf_inputs(rng, R=9, N=40, m=11, J=5):
    """One padded shard: pos with trailing empty rows and a padding tail,
    nnz rows with ids outside [0, R) that segment_sum drops."""
    counts = rng.integers(0, 6, R)
    counts[2] = 0
    pos = np.zeros(R + 1, np.int32)
    np.cumsum(counts, out=pos[1:])
    nnz = int(pos[-1])
    crd = np.zeros(N, np.int32)
    vals = np.zeros(N, np.float32)
    crd[:nnz] = rng.integers(0, m, nnz)
    vals[:nnz] = rng.standard_normal(nnz)
    rows = np.sort(rng.integers(-2, R + 3, N)).astype(np.int32)
    c = rng.standard_normal(m).astype(np.float32)
    C = rng.standard_normal((m, J)).astype(np.float32)
    return pos, crd, vals, rows, c, C


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_leaves_vs_jnp(seed):
    rng = np.random.default_rng(seed)
    pos, crd, vals, rows, c, C = _leaf_inputs(rng)
    R = pos.shape[0] - 1
    t = [torch.from_numpy(x) for x in (pos, crd, vals, rows, c, C)]
    tp, tcrd, tv, tr, tcv, tC = t
    np.testing.assert_array_equal(
        _np(ref.rows_from_pos(tp, crd.shape[0])),
        np.asarray(rref.rows_from_pos(jnp.asarray(pos), crd.shape[0])))
    pairs = [
        (ref.leaf_spmv_rows(tp, tcrd, tv, tcv),
         rref.leaf_spmv_rows(pos, crd, vals, c)),
        (ref.leaf_spmv_nnz(tr, tcrd, tv, tcv, R),
         rref.leaf_spmv_nnz(rows, crd, vals, c, R)),
        (ref.leaf_spmm_rows(tp, tcrd, tv, tC),
         rref.leaf_spmm_rows(pos, crd, vals, C)),
        (ref.leaf_spmm_nnz(tr, tcrd, tv, tC, R),
         rref.leaf_spmm_nnz(rows, crd, vals, C, R)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def _batch(rng):
    """Three pieces sharing R and N; the middle one is empty."""
    pieces = [_leaf_inputs(rng), None, _leaf_inputs(rng)]
    R, N = 9, 40
    pos = np.zeros((3, R + 1), np.int32)
    crd = np.zeros((3, N), np.int32)
    vals = np.zeros((3, N), np.float32)
    rows = np.full((3, N), R, np.int32)
    for p, x in enumerate(pieces):
        if x is None:
            continue
        pos[p], crd[p], vals[p] = x[0], x[1], x[2]
        nnz = int(x[0][-1])
        rows[p, :nnz] = np.repeat(np.arange(R), np.diff(x[0]))
    c, C = pieces[0][4], pieces[0][5]
    return pos, crd, vals, rows, c, C


def test_batched_wrappers_on_cpu_use_plain_versions():
    rng = np.random.default_rng(5)
    pos, crd, vals, rows, c, C = _batch(rng)
    R = pos.shape[1] - 1
    t = [torch.from_numpy(x) for x in (pos, crd, vals, rows, c, C)]
    tp, tcrd, tv, tr, tcv, tC = t
    before = dict(_build.LAUNCHES)
    y = spmv.spmv_csr_rows(tp, tcrd, tv, tcv)
    y_nnz = spmv.spmv_coo_nnz(tr, tcrd, tv, tcv, R)
    Y = spmm.spmm_csr_rows(tp, tcrd, tv, tC)
    assert _build.LAUNCHES == before          # no kernel ran on the CPU
    for p in range(3):
        dense = np.zeros((R, c.shape[0]), np.float32)
        for r in range(R):
            for e in range(pos[p, r], pos[p, r + 1]):
                dense[r, crd[p, e]] += vals[p, e]
        np.testing.assert_allclose(_np(y[p]), dense @ c, atol=1e-5)
        np.testing.assert_allclose(_np(y_nnz[p]), dense @ c, atol=1e-5)
        np.testing.assert_allclose(_np(Y[p]), dense @ C, atol=1e-5)
    assert not y[1].any() and not Y[1].any()


def test_wrappers_refuse_a_device_they_cannot_run_on():
    meta = [torch.empty((2, 4), dtype=torch.int32, device="meta"),
            torch.empty((2, 6), dtype=torch.int32, device="meta"),
            torch.empty((2, 6), dtype=torch.float32, device="meta"),
            torch.empty((5,), dtype=torch.float32, device="meta")]
    with pytest.raises(ValueError, match="CUDA device"):
        spmv.spmv_csr_rows(*meta)
    with pytest.raises(ValueError, match="impl"):
        ops.spmv(np.zeros(2, np.int32), np.zeros(1, np.int32),
                 np.zeros(1, np.float32), np.zeros(3, np.float32),
                 impl="pallas", device="cpu")



def test_wrappers_check_dtypes_and_layout_on_every_device():
    pos = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    crd = torch.tensor([[0, 1]], dtype=torch.int32)
    vals = torch.ones((1, 2))
    c = torch.ones(3)
    with pytest.raises(TypeError, match="crd must be torch.int32"):
        spmv.spmv_csr_rows(pos, crd.long(), vals, c)
    with pytest.raises(TypeError, match="C must be torch.float32"):
        spmm.spmm_csr_rows(pos, crd, vals, torch.ones((3, 2)).double())
    with pytest.raises(ValueError, match="contiguous"):
        spmm.spmm_csr_rows(pos, crd, vals, torch.ones((2, 3)).t())
    with pytest.raises(ValueError, match="bad shapes"):
        spmv.spmv_coo_nnz(crd, crd, vals[:, :1], c, 2)
