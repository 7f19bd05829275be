"""The port's autoscheduler against the JAX package's, on the CPU: twins of
the 14 tests of tests/test_plan_search.py.

Both packages get the same numpy arrays. The port is given the reference's
constants (``REF_HW``, the TPU v5e roofline of the reference's
``launch/roofline.py``, and its 16 MiB tile budget) through the
``_reference_constants`` fixture, and then every host product must equal
the reference's: structural stats, tuned tiles, the candidate labels and
their order, ``_tuned_key``, the winner and its ``candidates`` list, and
``CacheStats``; ``est_cost_s`` at rtol 1e-9 (numpy in both). The winner's
``run()`` must be allclose to the reference's at the conformance
tolerance (1e-3). As in the reference, ``refine_top_k=0`` ranks by the
model alone; one case measures its top 2 on the CPU. Under the port's
own H100 constants (``DEFAULT_HW``) the structural decisions of the two
``test_model_picks_*`` tests hold, and every conformance cell's model
order is the reference's."""
import dataclasses
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import conformance
import repro.core as rc
from repro.core import formats as RF
from repro.core import plan_search as RPS
from repro.core.interp import interpret as r_interpret
from repro.core.lower import lower as r_lower

import repro_torch.core as tc
from repro_torch.core import formats as TF
from repro_torch.core import plan_search as TPS
from repro_torch.core.interp import interpret as t_interpret
from repro_torch.core.lower import lower as t_lower
from repro_torch.launch.roofline import DEFAULT_HW, HardwareModel

REF_HW = HardwareModel(197e12, 819e9, 50e9)     # the reference's constants
REF_TILE_BUDGET = 16 * 2**20                     # the reference's VMEM bytes
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _reference_constants(monkeypatch):
    """Rank by the cost model alone in both packages, and give the port the
    reference's roofline constants and tile budget."""
    monkeypatch.setattr(RPS, "DEFAULT_CONFIG", RPS.SearchConfig(0))
    monkeypatch.setattr(TPS, "DEFAULT_CONFIG", TPS.SearchConfig(0))
    search, tune = TPS.search, TPS.tune_block_ell
    monkeypatch.setattr(TPS, "search", lambda *a, **kw: search(
        *a, **{"hw": REF_HW, **kw}))
    monkeypatch.setattr(TPS, "tune_block_ell", lambda *a, **kw: tune(
        *a, **{"smem_bytes": REF_TILE_BUDGET, **kw}))
    rc.clear_lowering_caches()
    tc.clear_lowering_caches()
    yield


# ---------------------------------------------------------------------------
# Host products held equal
# ---------------------------------------------------------------------------

def _same_stats(t, r):
    assert (t.entries, t.n0, t.entry_elems, t.root_tracks_dim0) == \
        (r.entries, r.n0, r.entry_elems, r.root_tracks_dim0)
    np.testing.assert_array_equal(t.deg, r.deg)
    assert t.imbalance == r.imbalance
    assert (t.tile is None) == (r.tile is None)
    if t.tile is not None:
        assert dataclasses.asdict(t.tile) == dataclasses.asdict(r.tile)


def _same_point(t, r):
    assert (t.label, t.space, t.grid, t.tile, t.replicated, t.plan_key,
            t.canonical_grid) == (r.label, r.space, r.grid, r.tile,
                                  r.replicated, r.plan_key, r.canonical_grid)
    np.testing.assert_allclose(t.est_cost_s, r.est_cost_s, rtol=1e-9)


def _same_winner(t, r):
    _same_point(t, r)
    assert [c["label"] for c in t.candidates] == \
        [c["label"] for c in r.candidates]
    np.testing.assert_allclose([c["est_cost_s"] for c in t.candidates],
                               [c["est_cost_s"] for c in r.candidates],
                               rtol=1e-9)
    assert [c["measured_s"] for c in t.candidates] == \
        [c["measured_s"] for c in r.candidates]


def _same_scoring(t_stmt, r_stmt, t_m, r_m):
    """Stats, points in enumeration order and every estimate, equal."""
    ts, rs = TPS.structural_stats(t_stmt), RPS.structural_stats(r_stmt)
    _same_stats(ts, rs)
    tp, rp = (TPS.enumerate_points(t_stmt, t_m, ts),
              RPS.enumerate_points(r_stmt, r_m, rs))
    assert [p.label for p in tp] == [p.label for p in rp]
    for a, b in zip(tp, rp):
        a.est_cost_s = TPS.estimate(t_stmt, a, ts, REF_HW)
        b.est_cost_s = RPS.estimate(r_stmt, b, rs)
        _same_point(a, b)
    return tp


def _np(x):
    if isinstance(x, torch.Tensor):
        assert x.device.type == "cpu"
        return x.numpy()
    if hasattr(x, "to_dense"):
        return np.asarray(x.to_dense())
    return np.asarray(x)


def _lower_both(t_stmt, r_stmt, t_m, r_m):
    """Lower ``schedule="auto"`` in both packages and hold the port's
    kernel to the reference's. Returns (port kernel, reference kernel)."""
    r_k = r_lower(r_stmt, r_m, schedule="auto")
    t_k = t_lower(t_stmt, t_m, schedule="auto", **CPU)
    assert (t_k.tuned is None) == (r_k.tuned is None)
    if r_k.tuned is not None:
        _same_winner(t_k.tuned, r_k.tuned)
    assert t_k.cell_id() == r_k.cell_id()
    assert t_k.leaf_name == r_k.leaf_name
    assert t_k.strategy.tile == r_k.strategy.tile
    assert t_k.cache.as_dict() == r_k.cache.as_dict()
    assert TPS._tuned_key(t_stmt, t_m, None) == \
        RPS._tuned_key(r_stmt, r_m, None)
    return t_k, r_k


# ---------------------------------------------------------------------------
# Structural inputs with a KNOWN right answer (the reference's statements,
# over either package)
# ---------------------------------------------------------------------------

def _spmv(pkg, B):
    rng = np.random.default_rng(0)
    c = pkg.Tensor.from_dense(
        "c", rng.standard_normal(B.shape[1]).astype(np.float32))
    return pkg.parse_tin("a(i) = B(i,j) * c(j)",
                         a=pkg.Tensor.zeros_dense("a", (B.shape[0],)), B=B,
                         c=c)


def _skewed_csr(pkg, F, n=1000, m=100, heavy=100):
    rows = np.concatenate([np.repeat(np.arange(heavy), m),
                           np.arange(heavy, n)])
    cols = np.concatenate([np.tile(np.arange(m), heavy),
                           np.arange(n - heavy) % m])
    coords = np.stack([rows, cols], axis=1)
    vals = np.random.default_rng(2).standard_normal(
        rows.size).astype(np.float32)
    return pkg.Tensor.from_coo("B", (n, m), coords, vals, F.CSR())


def _uniform_csr(pkg, F, n=1000, m=100, deg=8):
    rows = np.repeat(np.arange(n), deg)
    cols = (np.tile(np.arange(deg), n) * (m // deg)) % m
    coords = np.stack([rows, cols], axis=1)
    vals = np.random.default_rng(3).standard_normal(
        rows.size).astype(np.float32)
    return pkg.Tensor.from_coo("B", (n, m), coords, vals, F.CSR())


def _pair(build, *args, **kw):
    """(port statement, reference statement) from the same arrays."""
    return build(tc, TF, *args, **kw), build(rc, RF, *args, **kw)


def _spmv_of(csr):
    return lambda pkg, F, **kw: _spmv(pkg, csr(pkg, F, **kw))


M4 = (tc.Machine(("x", 4)), rc.Machine(("x", 4)))
M8 = (tc.Machine(("x", 8)), rc.Machine(("x", 8)))


def _search_both(t_stmt, r_stmt, machines, hw=REF_HW):
    t_m, r_m = machines
    t_w = TPS.search(t_stmt, t_m, config=TPS.SearchConfig(0), hw=hw, **CPU)
    r_w = RPS.search(r_stmt, r_m, config=RPS.SearchConfig(0))
    return t_w, r_w


@settings(max_examples=8, deadline=None)
@given(heavy=st.integers(40, 160))
def test_model_picks_nnz_on_skewed_rows(heavy):
    t_w, r_w = _search_both(*_pair(_spmv_of(_skewed_csr), heavy=heavy), M4)
    _same_winner(t_w, r_w)
    assert t_w.space == "nnz" and t_w.grid == (4, 1)


@settings(max_examples=8, deadline=None)
@given(deg=st.integers(3, 16))
def test_model_picks_rows_on_uniform(deg):
    t_w, r_w = _search_both(*_pair(_spmv_of(_uniform_csr), deg=deg), M4)
    _same_winner(t_w, r_w)
    assert t_w.space == "universe"


@settings(max_examples=8, deadline=None)
@given(heavy=st.integers(40, 160))
def test_h100_model_picks_nnz_on_skewed_rows(heavy):
    """The same structural decision under the port's H100 constants."""
    t_stmt = _spmv(tc, _skewed_csr(tc, TF, heavy=heavy))
    w = TPS.search(t_stmt, M4[0], config=TPS.SearchConfig(0), hw=DEFAULT_HW,
                   **CPU)
    assert w.space == "nnz" and w.grid == (4, 1)


@settings(max_examples=8, deadline=None)
@given(deg=st.integers(3, 16))
def test_h100_model_picks_rows_on_uniform(deg):
    t_stmt = _spmv(tc, _uniform_csr(tc, TF, deg=deg))
    w = TPS.search(t_stmt, M4[0], config=TPS.SearchConfig(0), hw=DEFAULT_HW,
                   **CPU)
    assert w.space == "universe"


def test_estimates_rank_both_regimes():
    t_stmt, r_stmt = _pair(_spmv_of(_skewed_csr))
    costs = {p.label: p.est_cost_s
             for p in _same_scoring(t_stmt, r_stmt, *M4)}
    assert costs["nnz/4x1"] < min(c for l, c in costs.items()
                                  if l != "nnz/4x1")
    t_stmt, r_stmt = _pair(_spmv_of(_uniform_csr))
    costs = {p.label: p.est_cost_s
             for p in _same_scoring(t_stmt, r_stmt, *M4)}
    assert costs["rows/4x1"] < costs["nnz/4x1"]


# ---------------------------------------------------------------------------
# The tuned-plan cache
# ---------------------------------------------------------------------------

def _small_spmv(pkg, F, fm=lambda F: F.CSR(), seed=11):
    rng = np.random.default_rng(seed)
    d = ((rng.random((19, 13)) < 0.3) *
         rng.standard_normal((19, 13))).astype(np.float32)
    d[3] = 0                                                    # empty row
    B = pkg.Tensor.from_dense("B", d, fm(F))
    c = pkg.Tensor.from_dense("c", rng.standard_normal(13).astype(np.float32))
    return pkg.parse_tin("a(i) = B(i,j) * c(j)",
                         a=pkg.Tensor.zeros_dense("a", (19,)), B=B, c=c)


def test_auto_cold_then_warm_skips_search(monkeypatch):
    t_stmt, r_stmt = _pair(_small_spmv)
    t1, r1 = _lower_both(t_stmt, r_stmt, *M4)
    assert t1.tuned is not None
    assert t1.cache.tuned_misses == 1 and t1.cache.tuned_hits == 0
    assert not t1.cache.warm
    np.testing.assert_allclose(_np(t1.run()), np.asarray(r1.run()),
                               atol=1e-3)
    np.testing.assert_allclose(_np(t1.run()), r_interpret(r_stmt), atol=1e-3)
    for PS in (TPS, RPS):
        monkeypatch.setattr(
            PS, "search",
            lambda *a, **kw: pytest.fail("warm re-lower must skip the search"))
    t2, r2 = _lower_both(t_stmt, r_stmt, *M4)
    assert t2.cache.tuned_hits == 1 and t2.cache.tuned_misses == 0
    assert t2.cache.warm
    assert t2.tuned is t1.tuned          # the memoized point itself
    assert torch.equal(t2.run(), t1.run())


def test_auto_invalidates_on_inplace_mutation():
    t_stmt, r_stmt = _pair(_small_spmv)
    t1, r1 = _lower_both(t_stmt, r_stmt, *M4)
    y1 = _np(t1.run())
    for stmt in (t_stmt, r_stmt):
        B = stmt.rhs.accesses()[0].tensor
        B.vals[:] = B.vals * 5.0
    t2, r2 = _lower_both(t_stmt, r_stmt, *M4)
    assert t2.cache.tuned_misses == 1 and not t2.cache.warm
    np.testing.assert_allclose(_np(t2.run()), 5.0 * y1, atol=1e-3)
    np.testing.assert_allclose(_np(t2.run()), np.asarray(r2.run()),
                               atol=1e-3)


def test_auto_blocked_operand_carries_tuned_tile():
    """The winner carries the tuned (block_R, block_nb) tile and the built
    schedule threads it to the strategy (plan provenance in the port)."""
    t_stmt, r_stmt = _pair(_small_spmv, fm=lambda F: F.BCSR((2, 2)))
    _same_stats(TPS.structural_stats(t_stmt), RPS.structural_stats(r_stmt))
    t_k, r_k = _lower_both(t_stmt, r_stmt, *M4)
    assert t_k.tuned is not None and t_k.tuned.tile is not None
    assert t_k.strategy.tile == t_k.tuned.tile == r_k.tuned.tile
    np.testing.assert_allclose(_np(t_k.run()),
                               t_interpret(t_stmt, device="cpu"), atol=1e-3)
    np.testing.assert_allclose(_np(t_k.run()), np.asarray(r_k.run()),
                               atol=1e-3)


def test_auto_unknown_string_rejected():
    t_stmt, r_stmt = _pair(_small_spmv)
    with pytest.raises(ValueError, match="unknown schedule string"):
        r_lower(r_stmt, M4[1], schedule="fast")
    with pytest.raises(ValueError, match="unknown schedule string"):
        t_lower(t_stmt, M4[0], schedule="fast", **CPU)


def test_tuned_cache_capacity_bound():
    """The tuned-plan cache is a bounded LRU like every other cache, and
    keeps the reference's keys."""
    olds = (TPS._TUNED_PLAN_CACHE.capacity, RPS._TUNED_PLAN_CACHE.capacity)
    try:
        TPS.set_tuned_plan_cache_capacity(1)
        RPS.set_tuned_plan_cache_capacity(1)
        ev0 = TPS.TUNED_PLAN_CACHE_STATS["evictions"]
        for seed in (11, 12, 13):
            _lower_both(*_pair(_small_spmv, seed=seed), *M4)
        assert len(TPS._TUNED_PLAN_CACHE) <= 1
        assert TPS.TUNED_PLAN_CACHE_STATS["evictions"] > ev0
        assert [k for k, _ in TPS.export_tuned_entries()] == \
            [k for k, _ in RPS.export_tuned_entries()]
    finally:
        TPS.set_tuned_plan_cache_capacity(olds[0])
        RPS.set_tuned_plan_cache_capacity(olds[1])


def test_auto_refines_top_k_on_cpu(monkeypatch):
    """refine_top_k=2: the model's top 2 are lowered and timed on the CPU,
    the rest keep ``measured_s`` None; the measured minimum wins, in the
    reference's model order, and its run() has the bits of a hand lower of
    ``winner.build()``."""
    monkeypatch.setattr(TPS, "DEFAULT_CONFIG", TPS.SearchConfig(2))
    t_stmt, r_stmt = _pair(_small_spmv)
    k = t_lower(t_stmt, M4[0], schedule="auto", **CPU)
    r_w = RPS.search(r_stmt, M4[1], config=RPS.SearchConfig(0))
    w = k.tuned
    assert [c["label"] for c in w.candidates] == \
        [c["label"] for c in r_w.candidates]
    measured = [c for c in w.candidates if c["measured_s"] is not None]
    assert [c["label"] for c in measured] == \
        [c["label"] for c in w.candidates[:2]]
    assert all(c["measured_s"] > 0 for c in measured)
    assert w.label == min(measured, key=lambda c: c["measured_s"])["label"]
    assert w.measured_s is not None and "measured=" in k.explain()
    sched, m = w.build(t_stmt, M4[0])
    hand = t_lower(t_stmt, m, schedule=sched, **CPU)
    assert hand.cell_id() == k.cell_id()
    assert torch.equal(hand.run(), k.run())


# ---------------------------------------------------------------------------
# Auto × the conformance matrix, both packages over the same operands
# ---------------------------------------------------------------------------

# The port's constructor of each conformance format, by its name there.
PORT_FORMATS = {
    "csr": TF.CSR, "csc": TF.CSC, "dcsr": TF.DCSR,
    "coo": lambda: TF.COO(2),
    "bcsr": lambda: TF.BCSR((2, 2)), "bcsc": lambda: TF.BCSC((2, 2)),
    "csf": lambda: TF.CSF(3), "dcsf": lambda: TF.DCSF(3),
    "coo3": lambda: TF.COO(3),
}


def _conformance_pair(expr, fmt_name, fmt_ctor, monkeypatch):
    """(port, reference) statements of one conformance cell: the
    reference's own statement code, run again from the same seed over the
    port's classes, so both draw the same arrays."""
    seed = zlib.crc32(f"auto/{expr}/{fmt_name}".encode())
    r_stmt = conformance._build_stmt(expr, fmt_ctor(),
                                     np.random.default_rng(seed))
    with monkeypatch.context() as mp:
        mp.setattr(conformance, "rc", tc)
        mp.setattr(conformance, "F", TF)
        mp.setattr(conformance, "Tensor", tc.Tensor)
        t_stmt = conformance._build_stmt(expr, PORT_FORMATS[fmt_name](),
                                         np.random.default_rng(seed))
    assert t_stmt.signature() == r_stmt.signature()
    for t_acc, r_acc in zip(t_stmt.accesses(), r_stmt.accesses()):
        assert t_acc.tensor.fingerprint() == r_acc.tensor.fingerprint()
    return t_stmt, r_stmt


def _check_auto_cell(expr, fmt_name, fmt_ctor, monkeypatch):
    t_stmt, r_stmt = _conformance_pair(expr, fmt_name, fmt_ctor, monkeypatch)
    t_k, r_k = _lower_both(t_stmt, r_stmt, *M4)
    assert t_k.tuned is not None, f"auto cell {expr}/{fmt_name} unplanned"
    got, want = _np(t_k.run()), _np(r_k.run())
    np.testing.assert_allclose(got, want, atol=1e-3,
                               err_msg=f"auto cell {t_k.cell_id()}")
    np.testing.assert_allclose(got, r_interpret(r_stmt), atol=1e-3,
                               err_msg=f"auto cell {t_k.cell_id()}")


@pytest.mark.parametrize("fmt_name,fmt_ctor", conformance.FORMATS_2D,
                         ids=[f[0] for f in conformance.FORMATS_2D])
@pytest.mark.parametrize("expr", conformance.EXPRESSIONS_2D)
def test_auto_matrix_2d(expr, fmt_name, fmt_ctor, monkeypatch):
    _check_auto_cell(expr, fmt_name, fmt_ctor, monkeypatch)


@pytest.mark.parametrize("fmt_name,fmt_ctor", conformance.FORMATS_3D,
                         ids=[f[0] for f in conformance.FORMATS_3D])
@pytest.mark.parametrize("expr", conformance.EXPRESSIONS_3D)
def test_auto_matrix_3d(expr, fmt_name, fmt_ctor, monkeypatch):
    _check_auto_cell(expr, fmt_name, fmt_ctor, monkeypatch)


_CENSUS_CELLS = (
    [(e, *f) for e in conformance.EXPRESSIONS_2D
     for f in conformance.FORMATS_2D]
    + [(e, *f) for e in conformance.EXPRESSIONS_3D
       for f in conformance.FORMATS_3D])


@pytest.mark.parametrize("expr,fmt_name,fmt_ctor", _CENSUS_CELLS,
                         ids=[f"{e}-{f}" for e, f, _ in _CENSUS_CELLS])
def test_h100_model_order_on_the_census(expr, fmt_name, fmt_ctor,
                                        monkeypatch):
    """Under the port's own H100 constants the model ranks every
    conformance cell's candidates, on 4 and on 8 pieces, in the order the
    reference's model gives them with its TPU constants (a finding that
    PERF.md records; the model's ratios, not its constants, decide)."""
    t_stmt, r_stmt = _conformance_pair(expr, fmt_name, fmt_ctor, monkeypatch)
    for t_m, r_m in (M4, M8):
        t_w, r_w = _search_both(t_stmt, r_stmt, (t_m, r_m), hw=DEFAULT_HW)
        assert [c["label"] for c in t_w.candidates] == \
            [c["label"] for c in r_w.candidates]


# ---------------------------------------------------------------------------
# Replicated candidates + canonical-key dedupe
# ---------------------------------------------------------------------------

def _wide_spmm(pkg, F, n=200, m=200, J=64, density=0.02, seed=0):
    rng = np.random.default_rng(seed)
    dB = ((rng.random((n, m)) < density) *
          rng.standard_normal((n, m))).astype(np.float32)
    B = pkg.Tensor.from_dense("B", dB, F.CSR())
    C = pkg.Tensor.from_dense(
        "C", rng.standard_normal((m, J)).astype(np.float32))
    return pkg.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                         A=pkg.Tensor.zeros_dense("A", (n, J)), B=B, C=C)


def test_enumeration_dedupes_canonical_plans():
    t_stmt, r_stmt = _pair(_wide_spmm)
    pts = _same_scoring(t_stmt, r_stmt, *M8)
    keys = [p.plan_key for p in pts]
    assert len(keys) == len(set(keys)), "duplicate canonical plans enumerated"
    assert any(p.replicated for p in pts)
    for p in pts:
        if p.replicated:
            assert p.grid[2] >= 2
    assert {"rows/8x1", "nnz/8x1"} <= {p.label for p in pts}


def test_replicated_point_label_and_machine():
    for PS, core in ((TPS, tc), (RPS, rc)):
        p = PS.SchedulePoint("universe", (2, 2, 2), None, replicated=True)
        assert p.label == "rows/2x2x2r"
        m = p.machine_for(core.Machine(("x", 8)))
        assert [(d.name, d.size) for d in m.dims] == \
            [("x", 2), ("y", 2), ("z", 2)]
        q = PS.SchedulePoint("universe", (4, 2, 1), None)
        assert q.plan_key == PS.SchedulePoint("universe", (4, 2),
                                              None).plan_key


def test_auto_picks_replicated_when_bytes_favor_it():
    t_stmt, r_stmt = _pair(_wide_spmm)
    t_w, r_w = _search_both(t_stmt, r_stmt, M8)
    _same_winner(t_w, r_w)
    assert t_w.replicated, t_w.label
    tc.clear_lowering_caches()
    rc.clear_lowering_caches()
    t_k, r_k = _lower_both(t_stmt, r_stmt, *M8)
    assert t_k.tuned.replicated
    assert t_k.leaf_name == "spmm_grid_rep_rows"
    assert t_k.strategy.mesh_label.endswith("r")
    dB = t_stmt.rhs.accesses()[0].tensor.to_dense()
    dC = t_stmt.rhs.accesses()[1].tensor.to_dense()
    np.testing.assert_allclose(_np(t_k.run()), dB @ dC, atol=1e-3)
    np.testing.assert_allclose(_np(t_k.run()), np.asarray(r_k.run()),
                               atol=1e-3)


def test_auto_still_picks_nnz_on_skewed_rows_with_replication_enabled():
    def skewed_spmm(pkg, F):
        B = _skewed_csr(pkg, F)
        rng = np.random.default_rng(5)
        C = pkg.Tensor.from_dense(
            "C", rng.standard_normal((B.shape[1], 4)).astype(np.float32))
        return pkg.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                             A=pkg.Tensor.zeros_dense("A", (B.shape[0], 4)),
                             B=B, C=C)
    t_w, r_w = _search_both(*_pair(skewed_spmm), M4)
    _same_winner(t_w, r_w)
    assert t_w.space == "nnz", t_w.label
