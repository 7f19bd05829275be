"""The port's order-3 machine grids against the JAX package's: SpMTTKRP on
P×Q×R bricks, SpAdd3 on the nested column split and the replicated 2.5-D
SpMM and SDDMM, then the reference's 2.5-D and brick invariants inside the
port.

Census twins: the 12 order-3 grid cells of tests/conformance.py (spmttkrp ×
{csf, dcsf, coo3} × {rows, nnz} × {2x2x2, 2x1x2}), its 4 SpAdd3 cells
({csr, csc} × {rows, nnz} on 2x2x2) and its 4 replicated cells ({spmm,
sddmm} × {csr, csc} on 2x2x2r), held by ``test_torch_grid.check_grid_cell``.
The brick and dense-grid materializers' arrays must equal the reference's
exactly."""
import zlib

import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import formats as RF
from repro.core import grid as RG
from repro.core import partition as RP

import repro_torch.core as tc
from repro_torch.core import formats as TF
from repro_torch.core import grid as TG
from repro_torch.core import partition as TP
from repro_torch.core.lower import lower as t_lower

from test_torch_grid import _int_sparse, _same_shards, check_grid_cell
from test_torch_lower import FORMATS_3D

GRID3_MESHES = [(2, 2, 2), (2, 1, 2)]
ROW_FORMATS = [("csr", lambda F: F.CSR()), ("csc", lambda F: F.CSC())]


@pytest.mark.parametrize("mesh", GRID3_MESHES,
                         ids=["x".join(map(str, m)) for m in GRID3_MESHES])
@pytest.mark.parametrize("strategy", ["rows", "nnz"])
@pytest.mark.parametrize("fmt_name,fm", FORMATS_3D,
                         ids=[f[0] for f in FORMATS_3D])
def test_grid3_cell(fmt_name, fm, strategy, mesh):
    k = check_grid_cell("spmttkrp", fmt_name, fm, strategy, mesh)
    assert k.strategy.is_grid and k.strategy.grid_shape == mesh
    if strategy == "rows":
        assert k.leaf_name == "spmttkrp_grid3_rows"
        assert set(k.comm.axes) == {"x", "y", "z"}
        assert k.comm.replicate_bytes == 0 and k.comm.reduce_bytes == 0


@pytest.mark.parametrize("strategy", ["rows", "nnz"])
@pytest.mark.parametrize("fmt_name,fm", ROW_FORMATS,
                         ids=[f[0] for f in ROW_FORMATS])
def test_spadd3_grid3_cell(fmt_name, fm, strategy):
    """rows rides the NESTED column split (Q·R joint windows, zero
    communication); nnz the flat 8-piece chunk union."""
    k = check_grid_cell("spadd3", fmt_name, fm, strategy, (2, 2, 2))
    if strategy == "rows":
        assert k.leaf_name == "spadd3_grid_rows"
        assert sum(a.network_bytes() for a in k.comm.axes.values()) == 0


@pytest.mark.parametrize("fmt_name,fm", ROW_FORMATS,
                         ids=[f[0] for f in ROW_FORMATS])
@pytest.mark.parametrize("expr", ["spmm", "sddmm"])
def test_replicated_cell(expr, fmt_name, fm):
    """The sparse operand keeps its (P, Q) tiles and is replicated along z:
    z pays the replica broadcast and the reduction rides only the axes
    replication leaves (y for SpMM's partials, z for SDDMM's split
    contraction)."""
    k = check_grid_cell(expr, fmt_name, fm, "rows", (2, 2, 2),
                        replicated=True)
    assert k.strategy.mesh_label == "2x2x2r"
    assert k.leaf_name == f"{expr}_grid_rep_rows"
    assert k.comm.axes["z"].broadcast_bytes > 0
    reduce_axis = "y" if expr == "spmm" else "z"
    for name, ax in k.comm.axes.items():
        assert (ax.reduce_bytes > 0) == (name == reduce_axis)


# ---------------------------------------------------------------------------
# Host products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("PQR", [(2, 2, 2), (2, 1, 2), (3, 2, 1), (1, 3, 4)],
                         ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("fmt_name", ["csf", "coo3"])
def test_brick_materializer_matches_reference(fmt_name, PQR):
    P, Q, R = PQR
    rng = np.random.default_rng(zlib.crc32(f"{fmt_name}{PQR}".encode()))
    dims = (16, 9, 7)
    d = ((rng.random(dims) < 0.12) * rng.integers(-3, 4, dims)
         ).astype(np.float32)
    d[3] = 0
    got = []
    for pkg, F, Pm in ((rc, RF, RP), (tc, TF, TP)):
        B = pkg.Tensor.from_dense("B", d, F.CSF(3) if fmt_name == "csf"
                                  else F.COO(3))
        part = Pm.partition_tensor_grid3(
            B, *(Pm.partition_by_bounds(n, g) for n, g in zip(dims, PQR)))
        got.append({"B": Pm.materialize_coo3_grid(B, part)})
    _same_shards(got[1], got[0])


def _int_spmm(rng, n, m, J, fm):
    dB = _int_sparse(rng, n, m)
    dC = rng.integers(-3, 4, (m, J)).astype(np.float32)
    stmt = tc.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                        A=tc.Tensor.zeros_dense("A", (n, J)),
                        B=tc.Tensor.from_dense("B", dB, fm),
                        C=tc.Tensor.from_dense("C", dC))
    return stmt, dB, dC


@pytest.mark.parametrize("n,m,J,P,Q,R,fmt_name,seed", [
    (8, 8, 2, 2, 1, 2, "csr", 0), (40, 31, 12, 3, 3, 3, "csc", 1),
    (19, 13, 7, 2, 2, 2, "csr", 2), (25, 40, 5, 3, 2, 3, "csc", 3)])
def test_replicated_bit_for_bit_vs_2d(n, m, J, P, Q, R, fmt_name, seed):
    """The z-slices are independent column lanes of the same contraction:
    on integer inputs the replicated plan equals its (P, Q) 2-D plan bit
    for bit, and both equal B @ C."""
    rng = np.random.default_rng(seed)
    stmt, dB, dC = _int_spmm(rng, n, m, J, getattr(TF, fmt_name.upper())())
    M3 = tc.Machine(("x", P), ("y", Q), ("z", R))
    k3 = t_lower(stmt, M3, tc.lower.default_replicated_schedule(stmt, M3),
                 device="cpu")
    M2 = tc.Machine(("x", P), ("y", Q))
    k2 = t_lower(stmt, M2, tc.lower.default_grid_schedule(stmt, M2),
                 device="cpu")
    got3, got2 = k3.run(), k2.run()
    assert torch.equal(got3, got2)
    np.testing.assert_array_equal(got3.numpy(), dB @ dC)


def test_replica_shares_shards_with_2d_plan():
    """The replicated plan's (P, Q) tiles are the 2-D plan's SHARD_CACHE
    entry, not a copy per z-layer."""
    rng = np.random.default_rng(3)
    stmt, _, _ = _int_spmm(rng, 30, 24, 8, TF.CSR())
    M2 = tc.Machine(("x", 2), ("y", 2))
    k2 = t_lower(stmt, M2, tc.lower.default_grid_schedule(stmt, M2),
                 device="cpu")
    misses = TP.SHARD_CACHE.stats["misses"]
    M3 = tc.Machine(("x", 2), ("y", 2), ("z", 2))
    k3 = t_lower(stmt, M3, tc.lower.default_replicated_schedule(stmt, M3),
                 device="cpu")
    for name in ("pos1", "crd1", "vals"):
        assert k3.shards["B"].arrays[name] is k2.shards["B"].arrays[name]
    assert TP.SHARD_CACHE.stats["misses"] > misses      # C regridded
    gp = TG.compute_grid_plan(stmt, k3.strategy)
    gp.validate(30, 24, n_dep=8)
    gp.validate_coverage(k3.plans["B"], (30, 24))


@pytest.mark.parametrize("n,m,d,P,Q,R", [(2, 2, 2, 1, 1, 1),
                                         (10, 7, 5, 4, 3, 2),
                                         (3, 40, 9, 2, 4, 3),
                                         (17, 2, 33, 3, 1, 4)])
def test_brick_tiling_covers_universe_exactly_once(n, m, d, P, Q, R):
    rng = np.random.default_rng(n * m * d)
    dB = ((rng.random((n, m, d)) < .2)
          * rng.standard_normal((n, m, d))).astype(np.float32)
    stmt = tc.parse_tin(
        "A(i,l) = B(i,j,k) * C(j,l) * D(k,l)",
        A=tc.Tensor.zeros_dense("A", (n, 3)),
        B=tc.Tensor.from_dense("B", dB, TF.COO(3)),
        C=tc.Tensor.from_dense("C", np.ones((m, 3), np.float32)),
        D=tc.Tensor.from_dense("D", np.ones((d, 3), np.float32)))
    M = tc.Machine(("x", P), ("y", Q), ("z", R))
    gp = TG.compute_grid_plan(
        stmt, tc.lower.default_grid3_schedule(stmt, M).strategy())
    gp.validate(n, m, n_dep=d)
    hits = np.zeros((n, m, d), np.int64)
    for _, _, _, rw, cw, dw in gp.tile_windows3():
        hits[rw[0]:rw[1], cw[0]:cw[1], dw[0]:dw[1]] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("expr", ["spmm", "sddmm"])
def test_replicated_axis_bytes_match_reference(expr):
    """grid_axis_bytes of the 2.5-D schedule, from the statement alone."""
    rng = np.random.default_rng(11)
    from test_torch_lower import _arrays, _stmt
    arrays = _arrays(expr, rng, False)
    out = []
    for pkg, F, G in ((rc, RF, RG), (tc, TF, TG)):
        stmt = _stmt(pkg, F, expr, lambda F: F.CSR(), *arrays)
        M = pkg.Machine(("x", 2), ("y", 3), ("z", 2))
        strat = pkg.lower.default_replicated_schedule(stmt, M).strategy()
        gp = G.compute_grid_plan(stmt, strat)
        out.append((gp.replicate, gp.row_bounds.tolist(),
                    gp.col_bounds.tolist(), gp.dep_bounds.tolist(),
                    {n: a.as_dict() for n, a in
                     G.grid_axis_bytes(stmt, strat).items()}))
    assert out[1] == out[0]


def test_replication_must_be_declared():
    """A 3-var schedule whose third variable misses the sparse operand is
    only legal with an explicit replicate([B], z)."""
    rng = np.random.default_rng(1)
    stmt, _, _ = _int_spmm(rng, 20, 16, 4, TF.CSR())
    M = tc.Machine(("x", 2), ("y", 2), ("z", 2))
    s = tc.lower.default_replicated_schedule(stmt, M)
    s._replicate.clear()
    with pytest.raises(ValueError, match="replicate"):
        t_lower(stmt, M, schedule=s, device="cpu")


def test_spadd3_grid_blocked_addends_raise():
    """The reference's grid union is scalar (blocked addends fail there);
    the port refuses them at lower time."""
    rng = np.random.default_rng(4)
    from test_torch_lower import _arrays, _stmt
    arrays = _arrays("spadd3", rng, False)
    stmt = _stmt(tc, TF, "spadd3", lambda F: F.BCSR((2, 2)), *arrays)
    M = tc.Machine(("x", 2), ("y", 2))
    with pytest.raises(NotImplementedError, match="blocked addends"):
        t_lower(stmt, M, tc.lower.default_grid_schedule(stmt, M),
                device="cpu")
