"""The port's re-plan fast path against the JAX package's, on the CPU: twins
of the 16 tests of tests/test_replan_cache.py.

Fingerprinted shard, plan, runner and conversion caches; straggler-weighted
block splits; LRU bounds and eviction (``set_shard_cache_capacity``,
``set_runner_cache_capacity``); content-fingerprint invalidation (new
tensors and in-place mutation); the per-lower hit and miss counters on
``LoweredKernel.cache``; the executor's runner cache on a one-piece
machine. Each case that lowers does so in both packages over the same
numpy arrays: the cache counters, the split bounds and ``cell_id`` must
equal the reference's, and ``run()`` must be allclose to the reference's
and to the interpreter at the reference's tolerances."""
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import formats as RF
from repro.core import partition as RP
from repro.core.interp import interpret as r_interpret
from repro.core.lower import lower as r_lower
from repro.runtime.fault import StragglerMitigator as RStraggler

import repro_torch.core as tc
import repro_torch.core.lower as TL
from repro_torch.core import formats as TF
from repro_torch.core import partition as TP
from repro_torch.core.cache import LRUCache
from repro_torch.core.interp import interpret as t_interpret
from repro_torch.runtime.fault import StragglerMitigator

N, M_COLS = 19, 13
CPU = {"device": "cpu"}
PKGS = ((tc, TF, TL.lower, CPU), (rc, RF, r_lower, {}))


def _sparse(rng, density=0.25):
    d = ((rng.random((N, M_COLS)) < density) *
         rng.standard_normal((N, M_COLS))).astype(np.float32)
    d[rng.integers(0, N)] = 0                                    # empty row
    return d


def _spmv_stmt(pkg, F, dB, fm, seed=1):
    rng = np.random.default_rng(seed)
    B = pkg.Tensor.from_dense("B", dB, fm(F))
    c = pkg.Tensor.from_dense(
        "c", rng.standard_normal(M_COLS).astype(np.float32))
    return pkg.parse_tin("a(i) = B(i,j) * c(j)",
                         a=pkg.Tensor.zeros_dense("a", (N,)), B=B, c=c)


def _np(x):
    if isinstance(x, torch.Tensor):
        assert x.device.type == "cpu"
        return x.numpy()
    return np.asarray(x.to_dense() if hasattr(x, "to_dense") else x)


def _sched(pkg, strategy, stmt, machine):
    return (pkg.lower.default_row_schedule if strategy == "rows"
            else pkg.lower.default_nnz_schedule)(stmt, machine)


def _clear_both():
    tc.clear_lowering_caches()
    rc.clear_lowering_caches()


def _m4(pkg):
    return pkg.Machine(("x", 4))


def _bdcsr(F):
    """Blocked DCSR: a compressed-root block grid, a conversion fallback."""
    return F.Format((F.Compressed, F.Compressed), block_shape=(2, 2))


# ---------------------------------------------------------------------------
# Straggler-weighted block splits
# ---------------------------------------------------------------------------

def test_weighted_block_nonzero_splits():
    rng = np.random.default_rng(3)
    dB = _sparse(rng, 0.4)
    B = tc.Tensor.from_dense("B", dB, TF.BCSR((2, 2)))
    mit = StragglerMitigator(4, report_budget=1)
    mit.report_slow(2)
    rmit = RStraggler(4, report_budget=1)
    rmit.report_slow(2)
    np.testing.assert_array_equal(mit.weights, rmit.weights)
    part = TP.partition_tensor_block_nonzeros(B, 4, weights=mit.weights)
    want = RP.partition_tensor_block_nonzeros(
        rc.Tensor.from_dense("B", dB, RF.BCSR((2, 2))), 4,
        weights=rmit.weights)
    np.testing.assert_array_equal(part.vals_bounds, want.vals_bounds)
    counts = part.vals_bounds[:, 1] - part.vals_bounds[:, 0]
    assert counts.sum() == (B.levels[1].nnz or 0)
    assert counts[2] < counts[0]
    equal = TP.partition_tensor_block_nonzeros(B, 4)
    eq_counts = equal.vals_bounds[:, 1] - equal.vals_bounds[:, 0]
    assert not np.array_equal(counts, eq_counts)


@pytest.mark.parametrize("expr", ["spmv", "spmm"])
def test_weighted_block_replan_matches_oracle(expr):
    rng = np.random.default_rng(7)
    dB = _sparse(rng, 0.4)
    dense = rng.standard_normal(
        (M_COLS,) if expr == "spmv" else (M_COLS, 7)).astype(np.float32)
    mit = StragglerMitigator(4, report_budget=1)
    mit.report_slow(1)
    out = []
    _clear_both()
    for pkg, F, lower, kw in PKGS:
        B = pkg.Tensor.from_dense("B", dB, F.BCSR((2, 2)))
        if expr == "spmv":
            stmt = pkg.parse_tin(
                "a(i) = B(i,j) * c(j)", a=pkg.Tensor.zeros_dense("a", (N,)),
                B=B, c=pkg.Tensor.from_dense("c", dense))
        else:
            stmt = pkg.parse_tin(
                "A(i,j) = B(i,k) * C(k,j)",
                A=pkg.Tensor.zeros_dense("A", (N, 7)), B=B,
                C=pkg.Tensor.from_dense("C", dense))
        sched = _sched(pkg, "nnz", stmt, _m4(pkg))
        k0 = lower(stmt, _m4(pkg), schedule=sched, **kw)
        k1 = lower(stmt, _m4(pkg), schedule=sched, weights=mit.weights, **kw)
        out.append((k0, k1, stmt))
    (t0, t1, t_stmt), (r0, r1, r_stmt) = out
    assert t1.leaf_name == r1.leaf_name and t1.leaf_name.startswith("bcsr_")
    assert not np.array_equal(t0.plans["B"].vals_bounds,
                              t1.plans["B"].vals_bounds)
    np.testing.assert_array_equal(t1.plans["B"].vals_bounds,
                                  r1.plans["B"].vals_bounds)
    assert t1.cache.shard_hits >= 1
    assert (t0.cache.as_dict(), t1.cache.as_dict()) == \
        (r0.cache.as_dict(), r1.cache.as_dict())
    want = t_interpret(t_stmt, device="cpu")
    for k, r in ((t0, r0), (t1, r1)):
        np.testing.assert_allclose(_np(k.run()), want, atol=1e-3)
        np.testing.assert_allclose(_np(k.run()), np.asarray(r.run()),
                                   atol=1e-3)


# ---------------------------------------------------------------------------
# Bounded caches + per-lower hit/miss counters
# ---------------------------------------------------------------------------

def test_cache_hit_counters_on_kernel():
    rng = np.random.default_rng(11)
    dB = _sparse(rng)
    ks = []
    for pkg, F, lower, kw in PKGS:
        stmt = _spmv_stmt(pkg, F, dB, lambda F: F.CSR())
        pkg.clear_lowering_caches()
        ks.append((lower(stmt, _m4(pkg), **kw), lower(stmt, _m4(pkg), **kw)))
    (t1, t2), (r1, r2) = ks
    assert t1.cache.plan_misses == 1 and t1.cache.plan_hits == 0
    assert t1.cache.shard_misses == 3          # B, c, and the dense output
    assert t1.cache.runner_misses == 1
    assert not t1.cache.warm
    assert t2.cache.warm
    assert (t2.cache.plan_hits, t2.cache.shard_hits,
            t2.cache.runner_hits) == (1, 3, 1)
    assert t1.cache.as_dict() == r1.cache.as_dict()
    assert t2.cache.as_dict() == r2.cache.as_dict()
    assert torch.equal(t2.run(), t1.run())
    np.testing.assert_allclose(_np(t2.run()), np.asarray(r2.run()),
                               atol=1e-5)


def test_lru_cache_none_value_hits():
    """A factory that returns None caches None: one miss, then hits (the
    tuned-plan cache stores None winners)."""
    cache = LRUCache(capacity=4)
    calls = []

    def factory():
        calls.append(1)
        return None

    for _ in range(3):
        assert cache.get_or_build("k", factory) is None
    assert len(calls) == 1
    assert cache.stats["misses"] == 1 and cache.stats["hits"] == 2
    assert "k" in cache


def test_shard_cache_lru_eviction():
    old_cap = TP.SHARD_CACHE.capacity
    rng = np.random.default_rng(13)
    stmts = [_spmv_stmt(tc, TF, _sparse(rng), lambda F: F.CSR(), seed=s)
             for s in range(3)]
    try:
        tc.clear_lowering_caches()
        TP.set_shard_cache_capacity(2)
        ev0 = TP.SHARD_CACHE_STATS["evictions"]
        results = [TL.lower(s, _m4(tc), **CPU).run() for s in stmts]
        assert len(TP.SHARD_CACHE) <= 2
        assert TP.SHARD_CACHE_STATS["evictions"] > ev0
        again = TL.lower(stmts[0], _m4(tc), **CPU)
        assert again.cache.shard_misses >= 1
        assert torch.equal(again.run(), results[0])
    finally:
        TP.set_shard_cache_capacity(old_cap)


def test_runner_cache_lru_eviction():
    old_cap = TL._RUNNER_CACHE.capacity
    rng = np.random.default_rng(17)
    dB = _sparse(rng)
    stmt = _spmv_stmt(tc, TF, dB, lambda F: F.CSR())
    r_stmt = _spmv_stmt(rc, RF, dB, lambda F: F.CSR())
    try:
        tc.clear_lowering_caches()
        TL.set_runner_cache_capacity(1)
        ev0 = TL.RUNNER_CACHE_STATS["evictions"]
        TL.lower(stmt, _m4(tc), **CPU)                         # spmv runner
        TL.lower(stmt, _m4(tc), schedule=TL.default_nnz_schedule(
            stmt, _m4(tc)), **CPU)                              # evicts it
        assert len(TL._RUNNER_CACHE) == 1
        assert TL.RUNNER_CACHE_STATS["evictions"] > ev0
        k = TL.lower(stmt, _m4(tc), **CPU)       # rebuilds the evicted runner
        assert k.cache.runner_misses == 1
        np.testing.assert_allclose(_np(k.run()), r_interpret(r_stmt),
                                   atol=1e-4)
    finally:
        TL.set_runner_cache_capacity(old_cap)


def test_plan_memo_differential():
    """A memoized plan is exactly the plan a fresh partitioning walk gives,
    and the reference's."""
    rng = np.random.default_rng(19)
    dB = _sparse(rng)
    stmt = _spmv_stmt(tc, TF, dB, lambda F: F.DCSR())
    tc.clear_lowering_caches()
    TL.lower(stmt, _m4(tc), **CPU)
    k_memo = TL.lower(stmt, _m4(tc), **CPU)
    assert k_memo.cache.plan_hits == 1
    tc.clear_lowering_caches()
    k_fresh = TL.lower(stmt, _m4(tc), **CPU)
    assert set(k_memo.plans) == set(k_fresh.plans)
    for name in k_memo.plans:
        assert TL._plans_equal(k_memo.plans[name], k_fresh.plans[name]), name
    r_k = r_lower(_spmv_stmt(rc, RF, dB, lambda F: F.DCSR()), _m4(rc))
    assert set(r_k.plans) == set(k_memo.plans)
    for name, p in r_k.plans.items():
        for attr in ("vals_bounds",):
            np.testing.assert_array_equal(getattr(k_memo.plans[name], attr),
                                          getattr(p, attr))


# ---------------------------------------------------------------------------
# Invalidation: same shape, different content must re-pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt_name,fm,strategy", [
    ("csr", lambda F: F.CSR(), "rows"),
    ("csr", lambda F: F.CSR(), "nnz"),
    ("coo", lambda F: F.COO(2), "nnz"),
    ("bcsr", lambda F: F.BCSR((2, 2)), "rows"),
    ("bcsr", lambda F: F.BCSR((2, 2)), "nnz"),
], ids=["csr-rows", "csr-nnz", "coo-nnz", "bcsr-rows", "bcsr-nnz"])
def test_invalidation_value_change(fmt_name, fm, strategy):
    rng = np.random.default_rng(23)
    dB = _sparse(rng)
    out = []
    for pkg, F, lower, kw in PKGS:
        pkg.clear_lowering_caches()
        stmt1 = _spmv_stmt(pkg, F, dB, fm, seed=29)
        k1 = lower(stmt1, _m4(pkg), schedule=_sched(pkg, strategy, stmt1,
                                                    _m4(pkg)), **kw)
        stmt2 = _spmv_stmt(pkg, F, dB * 3.0, fm, seed=29)
        k2 = lower(stmt2, _m4(pkg), schedule=_sched(pkg, strategy, stmt2,
                                                    _m4(pkg)), **kw)
        out.append((k1, k2, stmt2))
    (t1, t2, t_stmt2), (r1, r2, _) = out
    assert t2.cache.shard_misses >= 1            # B re-packed, not stale
    assert t2.cache.shard_hits >= 1              # identical c reused
    assert (t1.cache.as_dict(), t2.cache.as_dict()) == \
        (r1.cache.as_dict(), r2.cache.as_dict())
    y1, y2 = _np(t1.run()), _np(t2.run())
    np.testing.assert_allclose(y2, t_interpret(t_stmt2, device="cpu"),
                               atol=1e-3)
    np.testing.assert_allclose(y2, 3.0 * y1, atol=1e-3)
    np.testing.assert_allclose(y2, np.asarray(r2.run()), atol=1e-3)


def test_invalidation_dense_and_replicated():
    rng = np.random.default_rng(31)
    dB = _sparse(rng)
    dC = rng.standard_normal((M_COLS, 7)).astype(np.float32)

    def mk(pkg, F, dCmat):
        B = pkg.Tensor.from_dense("B", dB, F.CSR())
        C = pkg.Tensor.from_dense("C", dCmat)
        return pkg.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                             A=pkg.Tensor.zeros_dense("A", (N, 7)), B=B, C=C)

    out = []
    for pkg, F, lower, kw in PKGS:
        pkg.clear_lowering_caches()
        k1 = lower(mk(pkg, F, dC), _m4(pkg), **kw)
        k2 = lower(mk(pkg, F, dC * -2.0), _m4(pkg), **kw)
        out.append((k1, k2))
    (t1, t2), (r1, r2) = out
    assert t2.cache.shard_misses >= 1            # replicated C re-packed
    assert t2.cache.as_dict() == r2.cache.as_dict()
    np.testing.assert_allclose(_np(t2.run()), dB @ (dC * -2.0), atol=1e-3)
    np.testing.assert_allclose(_np(t1.run()), dB @ dC, atol=1e-3)


def test_invalidation_inplace_mutation():
    rng = np.random.default_rng(37)
    dB = _sparse(rng)
    out = []
    for pkg, F, lower, kw in PKGS:
        stmt = _spmv_stmt(pkg, F, dB, lambda F: F.CSR())
        B = stmt.rhs.accesses()[0].tensor
        pkg.clear_lowering_caches()
        y1 = _np(lower(stmt, _m4(pkg), **kw).run())
        B.vals[:] = B.vals * 5.0
        out.append((y1, lower(stmt, _m4(pkg), **kw)))
    (y1, t2), (_, r2) = out
    assert not t2.cache.warm and t2.cache.shard_misses >= 1
    assert t2.cache.as_dict() == r2.cache.as_dict()
    np.testing.assert_allclose(_np(t2.run()), 5.0 * y1, atol=1e-3)


def test_plan_cache_rebinds_current_tensors():
    """A memoized plan must not pin stale tensor objects: the plan-key hit
    serves the fresh tensor's data, not the mutated original's."""
    rng = np.random.default_rng(47)
    dB = _sparse(rng)
    out = []
    for pkg, F, lower, kw in PKGS:
        stmt1 = _spmv_stmt(pkg, F, dB, lambda F: F.CSR(), seed=53)
        pkg.clear_lowering_caches()
        y1 = _np(lower(stmt1, _m4(pkg), **kw).run())
        B1 = stmt1.rhs.accesses()[0].tensor
        B1.vals[:] = B1.vals * -9.0          # corrupt the pinned object
        stmt2 = _spmv_stmt(pkg, F, dB, lambda F: F.CSR(), seed=53)
        out.append((y1, lower(stmt2, _m4(pkg), **kw), stmt2))
    (y1, t2, t_stmt2), (_, r2, _) = out
    assert t2.cache.plan_hits == 1
    assert t2.cache.as_dict() == r2.cache.as_dict()
    np.testing.assert_allclose(_np(t2.run()), y1, atol=1e-5)
    np.testing.assert_allclose(_np(t2.run()),
                               t_interpret(t_stmt2, device="cpu"), atol=1e-3)


def test_spadd3_weighted_replan_reslices_cached_stream():
    rng = np.random.default_rng(41)
    ds = (_sparse(rng), _sparse(rng, 0.15), _sparse(rng, 0.1))
    w = np.array([1.0, 1.0, 0.25, 1.0])
    out = []
    for (pkg, F, lower, kw), P in ((PKGS[0], TP), (PKGS[1], RP)):
        Bt, Ct, Dt = (pkg.Tensor.from_dense(n, d, F.CSR())
                      for n, d in zip("BCD", ds))
        A = pkg.Tensor.from_dense("A", np.zeros((N, M_COLS), np.float32),
                                  F.CSR())
        stmt = pkg.parse_tin("A(i,j) = B(i,j) + C(i,j) + D(i,j)",
                             A=A, B=Bt, C=Ct, D=Dt)
        sched = pkg.lower.default_nnz_schedule(stmt, _m4(pkg))
        pkg.clear_lowering_caches()
        lower(stmt, _m4(pkg), schedule=sched, **kw)
        P.ADD_STREAM_STATS.update(hits=0, misses=0)
        src_hits0 = P.SHARD_CACHE_STATS["hits"]
        k = lower(stmt, _m4(pkg), schedule=sched, weights=w, **kw)
        out.append((k, dict(P.ADD_STREAM_STATS),
                    P.SHARD_CACHE_STATS["hits"] > src_hits0))
    (t_k, t_add, t_hit), (r_k, r_add, r_hit) = out
    assert t_add == r_add and t_add["misses"] == 1  # new bounds: re-cut
    assert t_hit and r_hit                           # stream itself reused
    counts = t_k.shards["_addstream"].arrays["nnz_count"]
    np.testing.assert_array_equal(
        counts, r_k.shards["_addstream"].arrays["nnz_count"])
    assert counts[2] < counts[0]                     # weighted chunks
    assert t_k.cache.as_dict() == r_k.cache.as_dict()
    np.testing.assert_allclose(t_k.run().to_dense(), sum(ds), atol=1e-4)


# ---------------------------------------------------------------------------
# The executor's runner cache (distributed/executor.py)
# ---------------------------------------------------------------------------

def test_spmd_runner_cache_reuse():
    from repro_torch.distributed import executor
    rng = np.random.default_rng(43)
    dB = _sparse(rng)
    stmt = _spmv_stmt(tc, TF, dB, lambda F: F.CSR())
    machine = tc.Machine(("x", 1))       # one piece: the calling process
    executor.clear_spmd_cache()
    k1 = TL.lower(stmt, machine, **CPU)
    y1 = executor.to_spmd(k1)()
    misses1 = executor.SPMD_RUN_STATS["misses"]
    k2 = TL.lower(stmt, machine, **CPU)  # warm re-lower ...
    y2 = executor.to_spmd(k2)()          # ... reuses the built runner
    assert executor.SPMD_RUN_STATS["misses"] == misses1
    assert executor.SPMD_RUN_STATS["hits"] >= 1
    assert torch.equal(y1, y2)
    cv = np.asarray(stmt.rhs.accesses()[1].tensor.to_dense())
    np.testing.assert_allclose(_np(y1), dB @ cv, atol=1e-4)


# ---------------------------------------------------------------------------
# Converted-tensor cache: the compressed-root block grid still converts
# ---------------------------------------------------------------------------

def test_direct_cells_never_convert():
    rng = np.random.default_rng(17)
    dB = _sparse(rng)
    stmt = _spmv_stmt(tc, TF, dB, lambda F: F.CSC())
    tc.clear_lowering_caches()
    k = TL.lower(stmt, _m4(tc), schedule=TL.default_row_schedule(
        stmt, _m4(tc)), **CPU)
    assert k.fallbacks == []
    assert k.cache.convert_misses == 0 and k.cache.convert_hits == 0
    np.testing.assert_allclose(
        _np(k.run()), r_interpret(_spmv_stmt(rc, RF, dB, lambda F: F.CSC())),
        atol=1e-4)


def test_convert_cache_warm_fallback_lower():
    rng = np.random.default_rng(17)
    dB = _sparse(rng)
    out = []
    for pkg, F, lower, kw in PKGS:
        stmt = _spmv_stmt(pkg, F, dB, _bdcsr)
        sched = pkg.lower.default_row_schedule(stmt, _m4(pkg))
        pkg.clear_lowering_caches()
        out.append((lower(stmt, _m4(pkg), schedule=sched, **kw),
                    lower(stmt, _m4(pkg), schedule=sched, **kw)))
    (t1, t2), (r1, r2) = out
    assert t1.fallbacks == r1.fallbacks and t1.fallbacks
    assert t1.cache.convert_misses == 1 and t1.cache.convert_hits == 0
    assert not t1.cache.warm
    assert t2.fallbacks == t1.fallbacks
    assert t2.cache.convert_hits == 1 and t2.cache.convert_misses == 0
    assert t2.cache.warm
    assert (t1.cache.as_dict(), t2.cache.as_dict()) == \
        (r1.cache.as_dict(), r2.cache.as_dict())
    assert torch.equal(t2.run(), t1.run())
    np.testing.assert_allclose(_np(t2.run()), np.asarray(r2.run()),
                               atol=1e-5)


def test_convert_cache_invalidation_on_mutation():
    rng = np.random.default_rng(18)
    dB = _sparse(rng)
    stmt = _spmv_stmt(tc, TF, dB, _bdcsr)
    sched = TL.default_row_schedule(stmt, _m4(tc))
    tc.clear_lowering_caches()
    k1 = TL.lower(stmt, _m4(tc), schedule=sched, **CPU)
    y1 = _np(k1.run())
    B = stmt.rhs.accesses()[0].tensor
    B.vals[:] = B.vals * 2.0
    k2 = TL.lower(stmt, _m4(tc), schedule=sched, **CPU)
    assert k2.cache.convert_misses == 1
    np.testing.assert_allclose(_np(k2.run()), y1 * 2.0, atol=1e-5)
