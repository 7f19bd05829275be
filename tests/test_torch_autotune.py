"""The port's layout tuner against the JAX package's, on the CPU: twins of
the 5 tests of tests/test_autotune.py.

``kernels/autotune.py`` keeps the reference's formulas and candidate
tuples; only the budget differs (the H100's opt-in shared memory per block
in place of TPU VMEM). Given the reference's 16 MiB budget, every
``TuneResult`` must equal the reference's field for field, and the
heavy-row split its arrays exactly."""
import dataclasses
import logging

import numpy as np
import pytest

import repro.core as rc
from repro.core import plan_search as RPS
from repro.data.spdata import powerlaw_matrix as r_powerlaw
from repro.data.spdata import uniform_sparse as r_uniform
from repro.kernels import autotune as RA

import repro_torch.core as tc
from repro_torch.core import plan_search as TPS
from repro_torch.data.spdata import powerlaw_matrix, uniform_sparse
from repro_torch.kernels import autotune as TA
from repro_torch.kernels import ops

REF_BUDGET = 16 * 2**20          # the reference's VMEM_BYTES


def _same(t, r):
    assert dataclasses.asdict(t) == dataclasses.asdict(r)


def _pos(t):
    return np.asarray(t.levels[1].pos)


def test_tuner_prefers_small_blocks_on_skew():
    skew = powerlaw_matrix("B", 2000, 2000, 8, seed=0)
    uni = uniform_sparse("B", (2000, 2000), 8 / 2000, seed=1)
    np.testing.assert_array_equal(_pos(skew),
                                  _pos(r_powerlaw("B", 2000, 2000, 8, seed=0)))
    np.testing.assert_array_equal(
        _pos(uni), _pos(r_uniform("B", (2000, 2000), 8 / 2000, seed=1)))
    t_skew, t_uni = TA.tune_ell(_pos(skew)), TA.tune_ell(_pos(uni))
    for pos, t in ((_pos(skew), t_skew), (_pos(uni), t_uni)):
        _same(TA.tune_ell(pos, smem_bytes=REF_BUDGET), RA.tune_ell(pos))
        _same(t, RA.tune_ell(pos))       # every candidate fits both budgets
    assert t_skew.feasible and t_uni.feasible
    assert t_skew.block_r <= t_uni.block_r
    assert t_skew.waste <= TA.ell_cost(_pos(skew), 32, 512).waste


def test_heavy_row_split_reduces_waste_and_stays_correct():
    rng = np.random.default_rng(2)
    B = powerlaw_matrix("B", 1500, 1500, 12, seed=3)
    pos, crd, vals = B.levels[1].pos, B.levels[1].crd, B.vals
    c = rng.standard_normal(1500).astype(np.float32)
    expected = B.to_dense() @ c

    got = TA.heavy_row_split(pos, crd, vals)
    want = RA.heavy_row_split(pos, crd, vals)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    (pos2, crd2, vals2), (tr, tc_, tv) = got
    assert TA.ell_cost(pos2, 8, 128).waste <= TA.ell_cost(pos, 8, 128).waste
    y_ell = ops.spmv(pos2, crd2, vals2, c, impl="torch", device="cpu")
    y_tail = np.zeros(1500, np.float32)
    if tr.size:
        np.add.at(y_tail, tr, tv * c[tc_])
    np.testing.assert_allclose(y_ell.numpy() + y_tail, expected, atol=1e-3,
                               rtol=1e-3)
    if tr.size:
        deg = np.diff(pos)
        assert deg[np.unique(tr)].min() > deg.mean()


def test_tuner_cost_monotone_in_padding():
    B = uniform_sparse("B", (512, 512), 0.02, seed=4)
    pos = _pos(B)
    r = TA.tune_ell(pos)
    _same(TA.tune_ell(pos, smem_bytes=REF_BUDGET), RA.tune_ell(pos))
    assert 0 <= r.waste < 1
    assert r.padded_nnz >= int(pos[-1])


def test_tuner_infeasible_fallback_is_explicit(caplog):
    """No candidate fits a 64-byte budget: the smallest tile comes back
    with feasible=False, fallback=True and a logged warning."""
    pos = _pos(uniform_sparse("B", (256, 256), 0.02, seed=5))
    with caplog.at_level(logging.WARNING, logger="repro_torch.kernels.autotune"):
        r = TA.tune_ell(pos, smem_bytes=64)
    _same(r, RA.tune_ell(pos, vmem_bytes=64))
    assert not r.feasible and r.fallback
    assert (r.block_r, r.block_n) == (min(TA.DEFAULT_BLOCK_R),
                                      min(TA.DEFAULT_BLOCK_N))
    assert any(rec.name == "repro_torch.kernels.autotune"
               and "fits shared memory" in rec.message
               for rec in caplog.records)
    ok = TA.tune_ell(pos)
    assert ok.feasible and not ok.fallback
    assert (TA.DEFAULT_BLOCK_R, TA.DEFAULT_BLOCK_N, TA.DEFAULT_BLOCK_GRID_R,
            TA.DEFAULT_BLOCK_GRID_N) == (
        RA.DEFAULT_BLOCK_R, RA.DEFAULT_BLOCK_N, RA.DEFAULT_BLOCK_GRID_R,
        RA.DEFAULT_BLOCK_GRID_N)


def test_planner_skips_infeasible_tile():
    """An infeasible blocked tune yields points with NO tile; a feasible
    one pins its tile on every point, as in the reference."""
    B = powerlaw_matrix("B", 32, 32, 4, seed=6)
    rng = np.random.default_rng(7)
    c = tc.Tensor.from_dense("c", rng.standard_normal(32).astype(np.float32))
    stmt = tc.parse_tin("a(i) = B(i,j) * c(j)",
                        a=tc.Tensor.zeros_dense("a", (32,)), B=B, c=c)
    m = tc.Machine(("x", 4))
    r_stmt = rc.parse_tin(
        "a(i) = B(i,j) * c(j)", a=rc.Tensor.zeros_dense("a", (32,)),
        B=rc.Tensor.from_dense("B", B.to_dense(), rc.CSR()),
        c=rc.Tensor.from_dense("c", c.to_dense()))
    for fallback, want in ((True, None), (False, (4, 16))):
        tile = TA.TuneResult(*want or (2, 8), 0, 0.0, 0.0,
                             feasible=not fallback, fallback=fallback)
        stats = TPS.StructStats(entries=10, n0=4, deg=np.ones(4, np.int64),
                                entry_elems=4, root_tracks_dim0=True,
                                tile=tile)
        pts = TPS.enumerate_points(stmt, m, stats)
        assert pts and all(p.tile == want for p in pts)
        r_stats = RPS.StructStats(**{**dataclasses.asdict(stats),
                                     "tile": RA.TuneResult(
                                         **dataclasses.asdict(tile))})
        assert [p.label for p in pts] == [
            p.label for p in RPS.enumerate_points(
                r_stmt, rc.Machine(("x", 4)), r_stats)]


def test_smem_budget_is_the_h100_opt_in():
    """The port's one budget is the H100's opt-in shared memory per block
    (227 KiB), not TPU VMEM; no TPU constant lives in the module."""
    assert TA.SMEM_BYTES == 227 * 1024
    assert not hasattr(TA, "VMEM_BYTES")
    with pytest.raises(TypeError):
        TA.tune_ell(np.array([0, 1]), vmem_bytes=1)
