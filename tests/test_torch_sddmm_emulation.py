"""A numpy emulation of the index logic of sddmm_coo
(src/repro_torch/kernels/csrc/sddmm.cu), held against the kernel's plain
version, the JAX package's Pallas kernel ``sddmm_coo`` (interpret mode) and
its leaf ``leaf_sddmm_nnz``.

With K % 4 == 0 and aligned C and Dt, the group kernel: G lanes a position
(G = K / 4 rounded up to a power of two, at most 32), a warp per round of
32 * V positions (V = U / G when U > G, else 1) whose (row, col, val)
triples lane t loads for positions v * 32 + t; U = 4 steps of 32 / G
positions gathered at a time, the position of step s and group gid held
by lane (s % G) * S + gid in triple s / G; lane q of a group takes the
float4 at k = k0 + 4q of each 4G-float k-tile into its partial, a tree of
xor shuffles at offsets G/2 .. 1 sums the group, and lane t of triple v
takes step v * G + t / S's sum from lane (t % S) * G. Otherwise the scalar
kernel: 32 positions a warp, lane l summing k = l, l + 32, ..., then a
5-step xor tree. Both store out = vals * dot, lane l of warp w at
position w * 32 * V + v * 32 + l of each triple v it holds (V = 1 for the
scalar kernel); the stores are counted and each slot must get one. Products are fused into the adds (fma, emulated in
float64 and rounded once to float32); the plain version and the JAX
functions add in other orders and are held per entry at
1e-5 * scale + 1e-6, ``scale`` the same product on absolute values (dots
of up to 256 f32 terms).
"""
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels import sddmm as rsddmm

from repro_torch.kernels import _build, sddmm

WARP, U = 32, 4          # kWarp, kU in csrc/sddmm.cu
RTOL, ATOL = 1e-5, 1e-6


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def group_size(K):
    g = 1
    while g < WARP and 4 * g < K:
        g *= 2
    return g


def _xor_tree(x, width):
    """Each lane's sum over its ``width``-lane group, by xor shuffles at
    offsets width/2 .. 1 (x: (..., 32))."""
    lanes = np.arange(WARP)
    off = width // 2
    while off:
        x = (x + x[..., lanes ^ off]).astype(np.float32)
        off //= 2
    return x


def _triples(rows, cols, vals, n_c, m, span):
    """(r, c, v) per warp and lane slot, (P, warps, span): positions
    padded to whole warps; clamped indices, zeros past N."""
    P, N = rows.shape
    n_w = -(-N // span) if N else 0
    pad = n_w * span - N
    r = np.pad(np.clip(rows, 0, n_c - 1), ((0, 0), (0, pad)))
    c = np.pad(np.clip(cols, 0, m - 1), ((0, 0), (0, pad)))
    v = np.pad(vals, ((0, 0), (0, pad)))
    return tuple(x.reshape(P, n_w, span) for x in (r, c, v))


def emulate(rows, cols, vals, C, Dt, aligned=True):
    """out (P, N) as sddmm_coo's launch computes it, and the number of
    writes to each slot."""
    P, N = rows.shape
    K = Dt.shape[1]
    Cp = C if C.ndim == 3 else np.broadcast_to(C, (P,) + C.shape)
    n_c, m = Cp.shape[1], Dt.shape[0]
    pidx = np.arange(P)[:, None, None]
    lanes = np.arange(WARP)
    if K % 4 or not aligned:                     # the scalar kernel
        r, c, v = _triples(rows, cols, vals, n_c, m, WARP)
        part = np.zeros(r.shape + (WARP,), np.float32)   # (P, w, t, lane)
        for k0 in range(0, K, WARP):
            k = k0 + lanes
            ok = k < K
            kk = np.minimum(k, K - 1)
            a = np.where(ok, Cp[pidx[..., None], r[..., None], kk], 0)
            b = np.where(ok, Dt[c[..., None], kk], 0)
            part = np.where(ok, _fma(a, b, part), part)
        dot = _xor_tree(part, WARP)[..., 0]
        V, res = 1, (v * dot).astype(np.float32)[:, :, None]
    else:
        G = group_size(K)
        S = WARP // G
        V = U // G if U > G else 1
        r, c, v = _triples(rows, cols, vals, n_c, m, WARP * V)
        shape = r.shape[:2]
        r, c, v = (x.reshape(shape + (V, WARP)) for x in (r, c, v))
        gid, q = lanes // G, lanes % G
        mine = np.full(shape + (V, WARP), np.nan, np.float32)
        taken = np.zeros(shape + (V, WARP), np.int64)
        for s0 in range(0, V * G, U):
            parts = []
            for s in range(s0, s0 + U):
                src = (s % G) * S + gid
                cr = r[:, :, s // G, src]                # (P, w, 32)
                dc = c[:, :, s // G, src]
                part = np.zeros(shape + (WARP,), np.float32)
                for k0 in range(0, K, 4 * G):
                    k = k0 + 4 * q
                    ok = k < K
                    for i in range(4):
                        kk = np.minimum(k + i, K - 1)
                        a = np.where(ok, Cp[pidx, cr, kk], 0)
                        b = np.where(ok, Dt[dc, kk], 0)
                        part = np.where(ok, _fma(a, b, part), part)
                parts.append(_xor_tree(part, G))
            for u, s in enumerate(range(s0, s0 + U)):
                d = parts[u][..., (lanes % S) * G]
                take = lanes // S == s % G
                mine[:, :, s // G][..., take] = d[..., take]
                taken[:, :, s // G][..., take] += 1
        assert (taken == 1).all(), "a lane took two sums or none"
        res = (v * mine).astype(np.float32)
    return _store(res, N, V)


def _store(res, N, V):
    """The warps' stores: lane l of warp w stores its triple v's result
    (res: (P, warps, V, 32)) at e = w * 32 * V + v * 32 + l when e < N.
    Returns out (P, N; NaN where nothing was stored) and the stores to
    each slot."""
    P, n_w = res.shape[:2]
    w, v, lane = np.meshgrid(np.arange(n_w), np.arange(V), np.arange(WARP),
                             indexing="ij")
    e = w * WARP * V + v * WARP + lane
    keep = e < N
    out = np.full((P, N), np.nan, np.float32)
    writes = np.zeros((P, N), np.int64)
    for p in range(P):
        out[p, e[keep]] = res[p][keep]
        np.add.at(writes[p], e[keep], 1)
    return out, writes


def _check(rows, cols, vals, C, Dt, aligned=True):
    got, writes = emulate(rows, cols, vals, C, Dt, aligned)
    assert (writes == 1).all(), "a position written twice or never"
    T = torch.from_numpy
    before = dict(_build.LAUNCHES)
    plain = sddmm.sddmm_coo(T(rows), T(cols), T(vals), T(C), T(Dt)).numpy()
    assert _build.LAUNCHES == before                  # the CPU launches none
    scale = sddmm.sddmm_coo(T(rows), T(cols), T(np.abs(vals)),
                            T(np.abs(C)), T(np.abs(Dt))).numpy()
    tol = RTOL * scale + ATOL
    assert (np.abs(got - plain) <= tol).all()
    P, N = rows.shape
    n_c, m = C.shape[-2], Dt.shape[0]
    rc, cc = np.clip(rows, 0, n_c - 1), np.clip(cols, 0, m - 1)
    pad = -N % 128
    for p in range(P):
        Cl = C[p] if C.ndim == 3 else C
        leaf = np.asarray(rref.leaf_sddmm_nnz(rc[p], cc[p], vals[p], Cl,
                                              Dt.T))
        assert (np.abs(got[p] - leaf) <= tol[p]).all()
        if N:
            pallas = np.asarray(rsddmm.sddmm_coo(
                np.pad(rc[p], (0, pad)), np.pad(cc[p], (0, pad)),
                np.pad(vals[p], (0, pad)), Cl, Dt.T, interpret=True))[:N]
            assert (np.abs(got[p] - pallas) <= tol[p]).all()


def _operands(seed, P, N, n_c, m, K, shared):
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(-2, n_c + 2, (P, N)), axis=1).astype(np.int32)
    cols = rng.integers(-2, m + 2, (P, N)).astype(np.int32)
    vals = rng.standard_normal((P, N)).astype(np.float32)
    vals[:, N - N // 5:] = 0                      # a padded tail
    C = rng.standard_normal((n_c, K) if shared else (P, n_c, K)) \
        .astype(np.float32)
    Dt = rng.standard_normal((m, K)).astype(np.float32)
    return rows, cols, vals, C, Dt


@pytest.mark.parametrize("K", [1, 3, 4, 7, 8, 12, 16, 31, 32, 33, 64, 128,
                               130, 256])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-piece"])
def test_group_and_scalar_paths(K, shared):
    """Every lane-group size (G = 1, 2, 4, 8, 16, 32 at K = 4, 8, 16, 32,
    64, 128; K = 12 leaves a group's last lane idle, K = 256 takes two
    k-tiles) and the scalar kernel (K % 4 != 0), C shared or per piece;
    N = 1037 is no multiple of any round (32 * V positions a warp)."""
    _check(*_operands(K, 3, 1037, 41, 53, K, shared))


@pytest.mark.parametrize("N", [1, 5, 31, 33, 127, 129, 255, 257])
@pytest.mark.parametrize("K", [4, 8, 32])
def test_ragged_last_round(N, K):
    """A last warp cut anywhere inside its U steps: G = 1 (a round of 128
    positions), 2 (64) and 8 (32, two passes of 4 steps)."""
    _check(*_operands(N + K, 2, N, 17, 19, K, N % 2 == 0))


@pytest.mark.parametrize("K", [4, 32, 64])
def test_unaligned_base_takes_the_scalar_path(K):
    """A C or Dt that does not start on a 16-byte boundary (a view at a
    4-byte offset) goes through the scalar kernel, whose sums hold too."""
    _check(*_operands(K + 1, 2, 300, 23, 29, K, True), aligned=False)


def test_nonfinite_dot_and_zero_vals():
    """out = vals * dot exactly: a padded position (val 0) whose dot is inf
    gives NaN, as the plain version does; no position is skipped."""
    rows, cols, vals, C, Dt = _operands(5, 1, 70, 8, 9, 32, True)
    C[rows[0, 3].clip(0, 7), 0] = np.inf
    Dt[:, 0] = 1.0
    vals[0, 3] = 0.0
    with np.errstate(invalid="ignore"):
        got, writes = emulate(rows, cols, vals, C, Dt)
    assert (writes == 1).all()
    plain = sddmm.sddmm_coo(*(torch.from_numpy(x) for x in
                              (rows, cols, vals, C, Dt))).numpy()
    assert np.isnan(got[0, 3]) and np.isnan(plain[0, 3])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(plain))
