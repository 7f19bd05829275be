"""The port's 2-D machine grids against the JAX package's, cell by cell, and
the reference's grid invariants inside the port.

Census twins: the 48 2-D grid cells of tests/conformance.py ({spmv, spmm,
sddmm} × {csr, csc, bcsr, bcsc} × {rows, nnz} × {2x2, 4x2}), built from the
same numpy arrays in both packages (the statement code of
tests/test_torch_lower.py). ``cell_id``, ``leaf_name``, ``fallbacks``,
``comm.as_dict()`` with its ``axes``, the cold and warm ``CacheStats`` and
every array and meta entry of every shard must be equal; ``run()`` must be
allclose to the reference's and to both interpreters at 1e-3. Host
products (``GridPlan`` bounds, ``grid_axis_bytes``, the grid materializers'
arrays) must be equal exactly. The invariants of tests/test_grid_plan.py
(tiling, rebasing, 2x2 == 4x1 bit for bit on integer inputs, (P, 1) == the
1-D path, the SUMMA byte win, the nnz axis attribution) hold in the port."""
import zlib

import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import formats as RF
from repro.core import grid as RG
from repro.core import partition as RP
from repro.core.interp import interpret as r_interpret
from repro.core.lower import lower as r_lower

import repro_torch.core as tc
from repro_torch.core import formats as TF
from repro_torch.core import grid as TG
from repro_torch.core import partition as TP
from repro_torch.core.interp import interpret as t_interpret
from repro_torch.core.lower import lower as t_lower

from test_torch_lower import _arrays, _stmt

GRID_FORMATS = [
    ("csr", lambda F: F.CSR()),
    ("csc", lambda F: F.CSC()),
    ("bcsr", lambda F: F.BCSR((2, 2))),
    ("bcsc", lambda F: F.BCSC((2, 2))),
]
GRID_MESHES = [(2, 2), (4, 2)]


def _machine(pkg, mesh):
    return pkg.Machine(*[(n, s) for n, s in zip(("x", "y", "z"), mesh)])


def _schedule(pkg, stmt, machine, strategy, mesh, replicated):
    L = pkg.lower
    if replicated:
        return L.default_replicated_schedule(stmt, machine)
    if strategy == "nnz":
        return L.default_grid_nnz_schedule(stmt, machine)
    if len(mesh) > 2:
        return L.default_grid3_schedule(stmt, machine)
    return L.default_grid_schedule(stmt, machine)


def _lower_cold_warm(pkg, lower, stmt, strategy, mesh, replicated, **kw):
    machine = _machine(pkg, mesh)
    sched = _schedule(pkg, stmt, machine, strategy, mesh, replicated)
    pkg.clear_lowering_caches()
    return (lower(stmt, machine, schedule=sched, **kw),
            lower(stmt, machine, schedule=sched, **kw))


def _same_shards(got, want):
    """Every shard's kind, arrays and meta equal the reference's exactly."""
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = got[name], want[name]
        assert g.kind == w.kind and g.pieces == w.pieces, name
        assert g.meta == w.meta, name
        assert sorted(g.arrays) == sorted(w.arrays), name
        for key, x in w.arrays.items():
            y = g.arrays[key]
            assert y.dtype == np.asarray(x).dtype, (name, key)
            np.testing.assert_array_equal(y, np.asarray(x),
                                          err_msg=f"{name}.{key}")


def _dense(x):
    if isinstance(x, torch.Tensor):
        assert x.device.type == "cpu"
        return x.numpy()
    return x.to_dense() if hasattr(x, "to_dense") else np.asarray(x)


def check_grid_cell(expr, fmt_name, fm, strategy, mesh, replicated=False):
    """Lower one grid cell cold and warm in both packages and hold the port
    to the reference (the contract of test_torch_lower._check_cell); returns
    the port's warm kernel."""
    tag = "x".join(map(str, mesh)) + ("r" if replicated else "")
    cell_tag = f"{expr}/{fmt_name}/{strategy}/{tag}"
    rng = np.random.default_rng(zlib.crc32(cell_tag.encode()))
    arrays = _arrays(expr, rng, False)
    r_stmt = _stmt(rc, RF, expr, fm, *arrays)
    t_stmt = _stmt(tc, TF, expr, fm, *arrays)
    r_cold, r_warm = _lower_cold_warm(rc, r_lower, r_stmt, strategy, mesh,
                                      replicated)
    t_cold, t_warm = _lower_cold_warm(tc, t_lower, t_stmt, strategy, mesh,
                                      replicated, device="cpu")
    assert t_cold.cell_id() == r_cold.cell_id() == \
        f"{expr}/{fmt_name}/{strategy}/{tag}"
    assert t_cold.leaf_name == r_cold.leaf_name
    assert t_cold.fallbacks == r_cold.fallbacks == []
    assert t_cold.comm.as_dict() == r_cold.comm.as_dict()
    assert "axes" in t_cold.comm.as_dict()
    assert t_cold.cache.as_dict() == r_cold.cache.as_dict()
    assert t_warm.cache.as_dict() == r_warm.cache.as_dict()
    assert t_warm.cache.warm
    assert t_cold.explain().startswith(f"kernel {r_cold.cell_id()}")
    _same_shards(t_cold.shards, r_cold.shards)
    got, want = t_warm.run(), r_warm.run()
    if expr == "spadd3":
        # the union's stored coordinates, in the reference's storage order
        assert TF.format_key(got.format) == RF.format_key(want.format)
        for gl, wl in zip(got.levels, want.levels):
            for x, y in ((gl.pos, wl.pos), (gl.crd, wl.crd)):
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)
    if expr in ("sddmm", "spadd3"):
        assert isinstance(got, tc.Tensor)
    else:
        assert isinstance(got, torch.Tensor)
    got = _dense(got)
    np.testing.assert_allclose(got, _dense(want), atol=1e-3)
    np.testing.assert_allclose(got, t_interpret(t_stmt, device="cpu"),
                               atol=1e-3)
    np.testing.assert_allclose(got, r_interpret(r_stmt), atol=1e-3)
    return t_warm


@pytest.mark.parametrize("mesh", GRID_MESHES,
                         ids=[f"{p}x{q}" for p, q in GRID_MESHES])
@pytest.mark.parametrize("strategy", ["rows", "nnz"])
@pytest.mark.parametrize("fmt_name,fm", GRID_FORMATS,
                         ids=[f[0] for f in GRID_FORMATS])
@pytest.mark.parametrize("expr", ["spmv", "spmm", "sddmm"])
def test_grid_cell(expr, fmt_name, fm, strategy, mesh):
    k = check_grid_cell(expr, fmt_name, fm, strategy, mesh)
    assert k.strategy.is_grid and k.strategy.grid_shape == mesh
    if strategy == "rows":
        assert set(k.comm.axes) == {"x", "y"}
        assert k.comm.replicate_bytes == 0 and k.comm.reduce_bytes == 0


# ---------------------------------------------------------------------------
# Host products: plans, per-axis bytes and the materializers, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [(2, 2), (4, 2), (3, 1), (1, 3)],
                         ids=["2x2", "4x2", "3x1", "1x3"])
@pytest.mark.parametrize("fmt_name,fm", GRID_FORMATS,
                         ids=[f[0] for f in GRID_FORMATS])
@pytest.mark.parametrize("expr", ["spmv", "spmm", "sddmm"])
def test_grid_plan_and_axis_bytes_match_reference(expr, fmt_name, fm, mesh):
    rng = np.random.default_rng(zlib.crc32(f"{expr}{fmt_name}{mesh}".encode()))
    arrays = _arrays(expr, rng, False)
    out = []
    for pkg, F, G in ((rc, RF, RG), (tc, TF, TG)):
        stmt = _stmt(pkg, F, expr, fm, *arrays)
        strat = pkg.lower.default_grid_schedule(
            stmt, _machine(pkg, mesh)).strategy()
        gp = G.compute_grid_plan(stmt, strat)
        gp.validate(*stmt.sparse_accesses()[0].tensor.shape)
        out.append(((gp.axis_x, gp.axis_y, gp.P, gp.Q, gp.pieces,
                     gp.row_bounds.tolist(), gp.col_bounds.tolist()),
                    {n: a.as_dict() for n, a in
                     G.grid_axis_bytes(stmt, strat).items()},
                    {n: (p.pieces, p.grid, p.replicated,
                         [(lp.coord_bounds is None or lp.coord_bounds.tolist(),
                           lp.replicated) for lp in p.levels])
                     for n, p in G._grid_plans(stmt, strat, gp).items()}))
    assert out[1] == out[0]


def _int_sparse(rng, n, m, density=0.3):
    """Integer-valued: every f32 partial sum is exact, so sums taken in
    different orders agree bit for bit."""
    return (rng.integers(-3, 4, (n, m)) *
            (rng.random((n, m)) < density)).astype(np.float32)


@pytest.mark.parametrize("PQ", [(1, 1), (2, 3), (3, 2), (4, 4), (5, 1)],
                         ids=lambda pq: f"{pq[0]}x{pq[1]}")
@pytest.mark.parametrize("kind", ["csr", "csc", "bcsr", "bcsc", "empty"])
def test_grid_materializers_match_reference(kind, PQ):
    """materialize_csr_grid / materialize_bcsr_grid (row-major and
    transpose-walked, (2, 3) blocks, an all-zero operand, more windows than
    rows), materialize_dense_grid and materialize_dense_cols: every array
    and meta entry equals the reference's."""
    P, Q = PQ
    rng = np.random.default_rng(zlib.crc32(f"{kind}{PQ}".encode()))
    n, m = 23, 17
    d = np.zeros((n, m), np.float32) if kind == "empty" else \
        _int_sparse(rng, n, m)
    dense = rng.standard_normal((n, m)).astype(np.float32)
    got = []
    for pkg, F, Pm in ((rc, RF, RP), (tc, TF, TP)):
        fm = {"csr": F.CSR(), "csc": F.CSC(), "empty": F.CSR(),
              "bcsr": F.BCSR((2, 3)), "bcsc": F.BCSC((2, 3))}[kind]
        B = pkg.Tensor.from_dense("B", d, fm)
        if fm.is_blocked:
            rb = Pm.block_aligned_row_bounds(n, P, 2)
            cb = Pm.block_aligned_row_bounds(m, Q, 3)
        else:
            rb, cb = Pm.partition_by_bounds(n, P), Pm.partition_by_bounds(m, Q)
        part = Pm.partition_tensor_grid(B, rb, cb)
        sh = (Pm.materialize_bcsr_grid if fm.is_blocked
              else Pm.materialize_csr_grid)(B, part)
        D = pkg.Tensor.from_dense("D", dense)
        got.append({"tiles": sh, "dense_grid": Pm.materialize_dense_grid(
                        D, rb, cb),
                    "dense_cols": Pm.materialize_dense_cols(D, cb)})
        assert Pm.partition_fingerprint(part)[:4] == (P * Q, False, False,
                                                      (P, Q))
    _same_shards(got[1], got[0])


# ---------------------------------------------------------------------------
# The reference's grid invariants, inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,P,Q", [(1, 1, 1, 1), (7, 50, 3, 5),
                                     (50, 3, 5, 4), (23, 17, 4, 4),
                                     (2, 9, 5, 2)])
def test_tiling_covers_universe_exactly_once(n, m, P, Q):
    gp = TG.GridPlan(axis_x="x", axis_y="y",
                     row_bounds=TP.partition_by_bounds(n, P),
                     col_bounds=TP.partition_by_bounds(m, Q))
    gp.validate(n, m)
    hits = np.zeros((n, m), dtype=np.int64)
    for _, _, (rlo, rhi), (clo, chi) in gp.tile_windows():
        hits[rlo:rhi, clo:chi] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("n,m,P,Q,seed", [(2, 2, 1, 1, 0), (40, 9, 4, 3, 1),
                                          (13, 31, 2, 4, 2), (5, 5, 4, 4, 3)])
def test_blocked_grid_plan_covers_universe(n, m, P, Q, seed):
    """Block-aligned grid plans from the port's planner tile the universe
    exactly once, block snapping included."""
    rng = np.random.default_rng(seed)
    B = tc.Tensor.from_dense("B", _int_sparse(rng, n, m), TF.BCSR((2, 2)))
    c = tc.Tensor.from_dense("c", rng.standard_normal(m).astype(np.float32))
    stmt = tc.parse_tin("a(i) = B(i,j) * c(j)",
                        a=tc.Tensor.zeros_dense("a", (n,)), B=B, c=c)
    machine = tc.Machine(("x", P), ("y", Q))
    gp = TG.compute_grid_plan(
        stmt, tc.lower.default_grid_schedule(stmt, machine).strategy())
    gp.validate(n, m)
    hits = np.zeros((n, m), dtype=np.int64)
    for _, _, (rlo, rhi), (clo, chi) in gp.tile_windows():
        hits[rlo:rhi, clo:chi] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("P,Q,seed", [(1, 1, 0), (2, 3, 1), (4, 2, 2),
                                      (3, 4, 3)])
@pytest.mark.parametrize("fmt_name", ["csr", "csc"])
def test_csr_grid_rebase_roundtrip(fmt_name, P, Q, seed):
    rng = np.random.default_rng(seed)
    n, m = 23, 17
    dB = _int_sparse(rng, n, m)
    B = tc.Tensor.from_dense("B", dB, getattr(TF, fmt_name.upper())())
    sh = TP.materialize_csr_grid(B, TP.partition_tensor_grid(
        B, TP.partition_by_bounds(n, P), TP.partition_by_bounds(m, Q)))
    a = sh.arrays
    got = np.zeros((n, m), np.float32)
    for color in range(P * Q):
        p, q = divmod(color, Q)
        pos = a["pos1"][color].astype(np.int64)
        k = int(a["nnz_count"][color])
        rows = np.repeat(np.arange(pos.shape[0] - 1), np.diff(pos))[:k]
        got[rows + a["row_start"][p], a["crd1"][color, :k]
            + a["col_start"][q]] += a["vals"][color, :k]
        np.testing.assert_array_equal(a["vals"][color, :k],
                                      B.vals[a["val_idx"][color, :k]])
    np.testing.assert_array_equal(got, dB)


@pytest.mark.parametrize("P,Q,seed", [(1, 1, 0), (2, 3, 1), (3, 2, 2)])
def test_bcsr_grid_rebase_roundtrip(P, Q, seed):
    rng = np.random.default_rng(seed)
    n, m = 22, 18
    dB = _int_sparse(rng, n, m)
    B = tc.Tensor.from_dense("B", dB, TF.BCSR((2, 2)))
    sh = TP.materialize_bcsr_grid(B, TP.partition_tensor_grid(
        B, TP.block_aligned_row_bounds(n, P, 2),
        TP.block_aligned_row_bounds(m, Q, 2)))
    a = sh.arrays
    got = np.zeros((n, m), np.float32)
    for color in range(P * Q):
        p, q = divmod(color, Q)
        pos = a["pos1"][color].astype(np.int64)
        k = int(a["nnz_count"][color])
        brows = np.repeat(np.arange(pos.shape[0] - 1), np.diff(pos))[:k]
        for e in range(k):
            r0 = (brows[e] + a["brow_start"][p]) * 2
            c0 = (int(a["crd1"][color, e]) + a["bcol_start"][q]) * 2
            got[r0:r0 + 2, c0:c0 + 2] += a["vals"][color, e]
    np.testing.assert_array_equal(got, dB)


def _int_spmm(rng, fm, n=19, m=13, J=7):
    B = tc.Tensor.from_dense("B", _int_sparse(rng, n, m), fm)
    C = tc.Tensor.from_dense(
        "C", rng.integers(-3, 4, (m, J)).astype(np.float32))
    return tc.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                        A=tc.Tensor.zeros_dense("A", (n, J)), B=B, C=C)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("strategy", ["rows", "nnz"])
@pytest.mark.parametrize("fmt_name", ["csr", "bcsr"])
def test_grid_matches_flat_counterpart_bitwise(fmt_name, strategy, seed):
    """A 2x2 SpMM cell and its pieces-equal 4x1 twin sum in different
    orders; on integer inputs every f32 sum is exact, so the results must
    be IDENTICAL."""
    rng = np.random.default_rng(seed)
    stmt = _int_spmm(rng, TF.CSR() if fmt_name == "csr"
                     else TF.BCSR((2, 2)))
    M22, M4 = tc.Machine(("x", 2), ("y", 2)), tc.Machine(("x", 4))
    L = tc.lower
    if strategy == "rows":
        kg = t_lower(stmt, M22, L.default_grid_schedule(stmt, M22),
                     device="cpu")
        k1 = t_lower(stmt, M4, L.default_row_schedule(stmt, M4),
                     device="cpu")
    else:
        kg = t_lower(stmt, M22, L.default_grid_nnz_schedule(stmt, M22),
                     device="cpu")
        k1 = t_lower(stmt, M4, L.default_nnz_schedule(stmt, M4),
                     device="cpu")
    assert torch.equal(kg.run(), k1.run())


def test_grid_q1_equals_1d_path():
    """A (P, 1) grid is the 1-D row distribution: the same windows."""
    rng = np.random.default_rng(3)
    n, m = 19, 13
    B = tc.Tensor.from_dense("B", _int_sparse(rng, n, m), TF.CSR())
    c = tc.Tensor.from_dense("c", rng.integers(-3, 4, m).astype(np.float32))
    stmt = tc.parse_tin("a(i) = B(i,j) * c(j)",
                        a=tc.Tensor.zeros_dense("a", (n,)), B=B, c=c)
    M21, M2 = tc.Machine(("x", 2), ("y", 1)), tc.Machine(("x", 2))
    kg = t_lower(stmt, M21, tc.lower.default_grid_schedule(stmt, M21),
                 device="cpu")
    k1 = t_lower(stmt, M2, tc.lower.default_row_schedule(stmt, M2),
                 device="cpu")
    assert torch.equal(kg.run(), k1.run())


def test_2d_spmm_moves_fewer_bytes_than_1d():
    """At equal pieces, 2-D SpMM moves |C|(P-1) + |A|(Q-1) bytes against
    1-D's |C|(PQ-1), attributed per axis."""
    rng = np.random.default_rng(5)
    n, m, J = 48, 40, 16
    B = tc.Tensor.from_dense("B", _int_sparse(rng, n, m), TF.CSR())
    C = tc.Tensor.from_dense("C", rng.standard_normal((m, J))
                             .astype(np.float32))
    stmt = tc.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                        A=tc.Tensor.zeros_dense("A", (n, J)), B=B, C=C)
    M22, M4 = tc.Machine(("x", 2), ("y", 2)), tc.Machine(("x", 4))
    kg = t_lower(stmt, M22, tc.lower.default_grid_schedule(stmt, M22),
                 device="cpu")
    k1 = t_lower(stmt, M4, tc.lower.default_row_schedule(stmt, M4),
                 device="cpu")
    assert kg.comm.pieces == k1.comm.pieces == 4
    assert kg.comm.total_network_bytes() < k1.comm.total_network_bytes()
    assert kg.comm.axes["x"].broadcast_bytes > 0
    assert kg.comm.axes["x"].reduce_bytes == 0
    assert kg.comm.axes["y"].reduce_bytes > 0
    cm = kg.comm.as_dict()
    assert cm["axes"]["x"]["network_bytes"] + \
        cm["axes"]["y"]["network_bytes"] == cm["total_network_bytes"]


@pytest.mark.parametrize("expr", ["spmv", "spmm", "sddmm", "spadd3"])
def test_grid_nnz_comm_attribution_totals_match_flat(expr):
    """Grid nnz re-attributes the flat broadcast and reduce to the axes
    without changing the total, b·(PQ−1)."""
    rng = np.random.default_rng(6)
    arrays = _arrays(expr, rng, False)
    stmt = _stmt(tc, TF, expr, lambda F: F.CSR(), *arrays)
    M22, M4 = tc.Machine(("x", 2), ("y", 2)), tc.Machine(("x", 4))
    kg = t_lower(stmt, M22, tc.lower.default_grid_nnz_schedule(stmt, M22),
                 device="cpu")
    k1 = t_lower(stmt, M4, tc.lower.default_nnz_schedule(stmt, M4),
                 device="cpu")
    assert kg.comm.replicate_bytes == 0 and kg.comm.reduce_bytes == 0
    assert set(kg.comm.axes) == {"x", "y"}
    assert kg.comm.total_network_bytes() == k1.comm.total_network_bytes()
    assert kg.leaf_name == k1.leaf_name
