"""The port's SpMV, SpMM, SDDMM, SpTTV and SpMTTKRP kernels against the JAX
package's.

At the ops level, ``repro_torch.kernels.ops`` (``impl="torch"``, and
``impl="cuda"``, whose wrappers run their plain versions on CPU tensors) is
held against ``repro.kernels.ops`` with ``impl="pallas"`` in interpret mode,
at the shapes of tests/test_kernels_pallas.py plus an empty row, an empty
piece and a row longer than 128 entries. Tolerances are the reference's own:
1e-4 for SpMV, 1e-3 for SpMM; 1e-4 for SDDMM, SpTTV and SpMTTKRP (sums of a
few f32 products, in another order). Each torch leaf is held against its jnp
leaf.
The CUDA kernels themselves run only on a card (tests/test_torch_gpu.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import formats as RF
from repro.core.tensor import Tensor as RTensor
from repro.kernels import ops as rops
from repro.kernels import ref as rref

from repro_torch.kernels import _build, ops, ref, sddmm, spmm, spmttkrp, spmv

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


def _skewed_rows(rng, m: int, pad: int = 11):
    """Two pieces over one padded N: a skewed CSR (a row of 1,300 entries,
    six 256-item chunks of the rows kernels' merge-path split; rows of
    exactly 256 and 257; a run of 300 empty rows; rows of 0-2 entries), and
    an empty piece. The padding tail holds value 0, as the shards' does."""
    lens = rng.integers(0, 3, 420)
    lens[40:340] = 0
    lens[[5, 360, 361]] = [1300, 256, 257]
    nnz = int(lens.sum())
    pos = np.zeros((2, lens.shape[0] + 1), np.int32)
    np.cumsum(lens, out=pos[0, 1:])
    crd = np.zeros((2, nnz + pad), np.int32)
    vals = np.zeros((2, nnz + pad), np.float32)
    crd[0, :nnz] = rng.integers(0, m, nnz)
    vals[0, :nnz] = rng.standard_normal(nnz)
    return pos, crd, vals


@pytest.mark.parametrize("j", [0, 1, 33])
def test_rows_leaves_on_long_rows_vs_pallas(j):
    """The rows wrappers on CPU tensors (the kernels' plain versions, their
    oracle on the card) over a skewed piece against the Pallas kernels in
    interpret mode (j = 0: SpMV; else SpMM with J = j), at 1e-5; the empty
    piece gives zeros."""
    rng = np.random.default_rng(17 + j)
    m = 90
    pos, crd, vals = _skewed_rows(rng, m)
    nnz = int(pos[0, -1])
    x = rng.standard_normal((m, j) if j else m).astype(np.float32)
    op = rops.spmm if j else rops.spmv
    want = np.asarray(op(pos[0], crd[0, :nnz], vals[0, :nnz], x,
                         impl="pallas"))
    leaf = spmm.spmm_csr_rows if j else spmv.spmv_csr_rows
    before = dict(_build.LAUNCHES)
    got = _np(leaf(*(torch.from_numpy(a) for a in (pos, crd, vals, x))))
    assert _build.LAUNCHES == before          # no kernel ran on the CPU
    np.testing.assert_allclose(got[0], want, atol=1e-5, rtol=1e-5)
    assert not got[1].any()


@pytest.mark.parametrize("pad", [0, 11, 300])
def test_merge_chunks_cover_the_merged_list(pad):
    """The rows kernels' scratch size: the merged list of a piece (each
    row's entries, then its end item) built directly in numpy fills
    exactly ceil(len / 256) chunks when N = nnz, and the padding tail of a
    shard (N > nnz) only adds chunks, never removes one."""
    rng = np.random.default_rng(pad)
    pos, _, _ = _skewed_rows(rng, 90, pad)
    lens = np.diff(pos[0])
    R, nnz = lens.shape[0], int(pos[0, -1])
    merged = np.concatenate([np.r_[np.zeros(n, bool), True] for n in lens])
    assert merged.size == R + nnz and merged.sum() == R
    used = np.unique(np.arange(merged.size) // spmv.ITEMS).size
    if pad == 0:
        assert spmv.merge_chunks(R, nnz) == used
    assert spmv.merge_chunks(R, nnz + pad) >= used
    assert spmv.merge_chunks(0, 0) == 0


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
    rows = torch.empty((2, 6), dtype=torch.int32, device="meta")
    vals = torch.empty((2, 6), dtype=torch.float32, device="meta")
    mat = torch.empty((5, 3), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        sddmm.sddmm_coo(rows, rows, vals, mat, mat)
    with pytest.raises(ValueError, match="CUDA device"):
        spmttkrp.spmttkrp_coo(rows, rows, rows, vals, mat, mat, 4)
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


@pytest.mark.parametrize("K", [1, 4, 32, 33])
@pytest.mark.parametrize("shape", SHAPES_2D[:4] + SHAPES_2D[6:])
def test_sddmm_vs_pallas(shape, K):
    rng = np.random.default_rng(3)
    n, m = shape
    pos, crd, vals, d = _csr(rng, n, m, 0.2)
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(pos))
    C = rng.standard_normal((n, K)).astype(np.float32)
    D = rng.standard_normal((K, m)).astype(np.float32)
    want = np.asarray(rops.sddmm(rows, crd, vals, C, D, impl="pallas"))
    for impl in IMPLS:
        got = _np(ops.sddmm(rows, crd, vals, C, D, impl=impl, device="cpu"))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(want, vals * (C[rows] * D[:, crd].T).sum(1),
                               atol=1e-4, rtol=1e-4)


def _csf(rng, dims, density):
    """A CSF tensor with an empty slice and one slice much longer than a
    kernel segment (256 entries) when the dims allow it."""
    d = ((rng.random(dims) < density)
         * rng.standard_normal(dims)).astype(np.float32)
    d[rng.integers(0, dims[0])] = 0                         # empty slice
    d[rng.integers(0, dims[0])] = rng.standard_normal(dims[1:])  # long slice
    t = RTensor.from_dense("B", d, RF.CSF(3))
    return (t.levels[1].pos, t.levels[1].crd, t.levels[2].pos,
            t.levels[2].crd, t.vals, d)


@pytest.mark.parametrize("L", [1, 6, 33])
@pytest.mark.parametrize("dims", [(10, 8, 6), (25, 13, 9), (7, 30, 20)])
def test_spttv_spmttkrp_vs_pallas(dims, L):
    rng = np.random.default_rng(5)
    p1, c1, p2, c2, vals, d = _csf(rng, dims, 0.15)
    cv = rng.standard_normal(dims[2]).astype(np.float32)
    want = np.asarray(rops.spttv(p1, c1, p2, c2, vals, cv, impl="pallas"))
    for impl in IMPLS:
        got = _np(ops.spttv(p1, c1, p2, c2, vals, cv, impl=impl,
                            device="cpu"))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    C = rng.standard_normal((dims[1], L)).astype(np.float32)
    D = rng.standard_normal((dims[2], L)).astype(np.float32)
    want = np.asarray(rops.spmttkrp(p1, c1, p2, c2, vals, C, D,
                                    impl="pallas"))
    for impl in IMPLS:
        got = _np(ops.spmttkrp(p1, c1, p2, c2, vals, C, D, impl=impl,
                               device="cpu"))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(want, np.einsum("ijk,jl,kl->il", d, C, D),
                               atol=1e-3, rtol=1e-3)


def _padded_csf(rng, R=6, pad_ij=3, pad_nnz=5):
    """One CSF row shard as the materializer packs it: an empty row, and
    padding tails on the fibre and entry axes."""
    p1, c1, p2, c2, vals, _ = _csf(rng, (R, 7, 5), 0.3)
    n_ij, nnz = c1.shape[0], c2.shape[0]
    pos2 = np.concatenate([p2, np.full(pad_ij, p2[-1])]).astype(np.int32)
    crd1 = np.concatenate([c1, np.zeros(pad_ij, np.int32)]).astype(np.int32)
    crd2 = np.concatenate([c2, np.zeros(pad_nnz, np.int32)]).astype(np.int32)
    v = np.concatenate([vals, np.zeros(pad_nnz, np.float32)])
    return p1.astype(np.int32), crd1, pos2, crd2, v, n_ij, nnz


@pytest.mark.parametrize("seed", [0, 1])
def test_3d_and_sddmm_leaves_vs_jnp(seed):
    rng = np.random.default_rng(seed)
    p1, c1, p2, c2, v, n_ij, nnz = _padded_csf(rng)
    cv = rng.standard_normal(5).astype(np.float32)
    C = rng.standard_normal((7, 4)).astype(np.float32)
    D = rng.standard_normal((5, 4)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (p1, c1, p2, c2, v, cv, C, D)]
    R = p1.shape[0] - 1
    # flat-walk rows with ids outside [0, R) that segment_sum drops
    i_nnz = np.sort(rng.integers(-1, R + 2, c2.shape[0])).astype(np.int32)
    j = rng.integers(0, 7, c2.shape[0]).astype(np.int32)
    ti, tj = torch.from_numpy(i_nnz), torch.from_numpy(j)
    pairs = [
        (ref.leaf_spttv_rows(*t[:6]), rref.leaf_spttv_rows(p1, c1, p2, c2,
                                                           v, cv)),
        (ref.leaf_spttv_nnz(ti, t[3], t[4], t[5], R),
         rref.leaf_spttv_nnz(i_nnz, c2, v, cv, R)),
        (ref.leaf_spmttkrp_rows(*t[:5], t[6], t[7]),
         rref.leaf_spmttkrp_rows(p1, c1, p2, c2, v, C, D)),
        (ref.leaf_spmttkrp_nnz(ti, tj, t[3], t[4], t[6], t[7], R),
         rref.leaf_spmttkrp_nnz(i_nnz, j, c2, v, C, D, R)),
    ]
    # SDDMM on a 2-D shard
    pos, crd, vals, rows, c, _ = _leaf_inputs(rng)
    Cl = rng.standard_normal((pos.shape[0] - 1, 3)).astype(np.float32)
    Dm = rng.standard_normal((3, c.shape[0])).astype(np.float32)
    rows = np.clip(rows, 0, pos.shape[0] - 2)
    tt = [torch.from_numpy(x) for x in (pos, crd, vals, rows, Cl, Dm)]
    pairs += [
        (ref.leaf_sddmm_rows(tt[0], tt[1], tt[2], tt[4], tt[5]),
         rref.leaf_sddmm_rows(pos, crd, vals, Cl, Dm)),
        (ref.leaf_sddmm_nnz(tt[3], tt[1], tt[2], tt[4], tt[5]),
         rref.leaf_sddmm_nnz(rows, crd, vals, Cl, Dm)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_flatten_csf_matches_the_reference_stream():
    """The CSF rows leaf's stream equals the (i, j) per entry that the
    reference's ops.spmttkrp flattens on the host; the padding tail gets
    the dropped row id, so the rows stay non-decreasing."""
    rng = np.random.default_rng(9)
    p1, c1, p2, c2, v, n_ij, nnz = _padded_csf(rng)
    R = p1.shape[0] - 1
    rows, j = spmttkrp.flatten_csf(*(torch.from_numpy(x) for x in (p1, c1,
                                                                   p2)),
                                   c2.shape[0])
    i_of_ij = np.repeat(np.arange(R), np.diff(p1))
    ij_of_nnz = np.repeat(np.arange(n_ij), np.diff(p2[:n_ij + 1]))
    np.testing.assert_array_equal(_np(rows[:nnz]), i_of_ij[ij_of_nnz])
    np.testing.assert_array_equal(_np(j[:nnz]), c1[ij_of_nnz])
    assert (_np(rows[nnz:]) == R).all()
    assert (np.diff(_np(rows)) >= 0).all()
    assert rows.dtype == j.dtype == torch.int32


def test_new_batched_wrappers_on_cpu_use_plain_versions():
    """sddmm_coo (C shared and per piece) and spmttkrp_coo over three
    pieces, the middle one empty, against numpy."""
    rng = np.random.default_rng(6)
    pos, crd, vals, rows, c, C = _batch(rng)
    P, R = pos.shape[0], pos.shape[1] - 1
    m, K, L = c.shape[0], 3, 5
    Cs = rng.standard_normal((P, R, K)).astype(np.float32)
    Dt = rng.standard_normal((m, K)).astype(np.float32)
    kk = rng.integers(0, 4, crd.shape).astype(np.int32)
    Cj = rng.standard_normal((m, L)).astype(np.float32)
    Dk = rng.standard_normal((4, L)).astype(np.float32)
    t = {k_: torch.from_numpy(x) for k_, x in dict(
        rows=rows, crd=crd, vals=vals, Cs=Cs, Dt=Dt, kk=kk, Cj=Cj,
        Dk=Dk).items()}
    rows_c = torch.from_numpy(np.minimum(rows, R - 1))
    before = dict(_build.LAUNCHES)
    per_piece = sddmm.sddmm_coo(rows_c, t["crd"], t["vals"], t["Cs"],
                                t["Dt"])
    shared = sddmm.sddmm_coo(rows_c, t["crd"], t["vals"], t["Cs"][0],
                             t["Dt"])
    A = spmttkrp.spmttkrp_coo(t["rows"], t["crd"], t["kk"], t["vals"],
                              t["Cj"], t["Dk"], R)
    assert _build.LAUNCHES == before          # no kernel ran on the CPU
    rc_ = np.minimum(rows, R - 1)
    for p in range(P):
        for Cp, got in ((Cs[p], per_piece[p]), (Cs[0], shared[p])):
            want = vals[p] * (Cp[rc_[p]] * Dt[crd[p]]).sum(1)
            np.testing.assert_allclose(_np(got), want, atol=1e-5)
        want = np.zeros((R, L), np.float32)
        for e in range(rows.shape[1]):
            if rows[p, e] < R:
                want[rows[p, e]] += vals[p, e] * Cj[crd[p, e]] * Dk[kk[p, e]]
        np.testing.assert_allclose(_np(A[p]), want, atol=1e-5)
    assert not A[1].any() and not per_piece[1].any()
