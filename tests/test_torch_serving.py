"""The port's serving fast path against the JAX package's, on the CPU
(twins of tests/test_serving.py's batching, rebind and server tests and of
tests/test_sparse_attention.py): ``rebind_dense``, ``BatchedKernel`` /
``lower_batched``, ``SparseKernelServer``, the band-decode and MoE-combine
statements (``band_plan``, ``band_decode_kernel``, ``dispatch_tensor``,
``combine_kernel``) and ``block_sparse_attention``.

On integer-valued operands ``run_many`` must be the per-request loop, the
reference's ``run_many`` and the exact product bit for bit, warm buckets
must build no runner, and the masks and dispatch matrices must have the
reference's levels. ``block_sparse_attention`` is held to the reference's
and to a dense windowed attention at 1e-4. ``BatchedKernel(mesh=...)``
runs in a 4-rank gloo group spawned through tests/test_torch_spmd.py's
harness (``serve_rank_main``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as rc
from repro.core import lower as RL
from repro.core.cache import batch_bucket as r_batch_bucket
from repro.launch.serve import SparseKernelServer as RServer
from repro.models import moe as RM
from repro.models import sparse_attention as RSA

import repro_torch.core as tc
from repro_torch.core import lower as TL
from repro_torch.core.cache import BATCH_BUCKETS, batch_bucket
from repro_torch.core.partition import (partition_by_bounds,
                                        partition_tensor_rows)
from repro_torch.launch.serve import SparseKernelServer
from repro_torch.models import moe as TM
from repro_torch.models import sparse_attention as TSA
from repro_torch.runtime import telemetry

from test_torch_spmd import serve_rank_main, spawn_ranks


def _int_sparse(rng, n, m, density=0.15):
    return (rng.integers(-3, 4, (n, m)) *
            (rng.random((n, m)) < density)).astype(np.float32)


def _spmv_stmt(core, dB, fmt=None):
    n, m = dB.shape
    return core.parse_tin("a(i) = B(i,j) * c(j)",
                          a=core.Tensor.zeros_dense("a", (n,)),
                          B=core.Tensor.from_dense("B", dB.copy(),
                                                   fmt or core.CSR()),
                          c=core.Tensor.zeros_dense("c", (m,)))


def _levels_equal(a, b):
    assert a.shape == b.shape
    assert np.array_equal(a.vals, b.vals) and a.vals.dtype == b.vals.dtype
    for x, y in zip(a.levels, b.levels):
        for u, v in ((x.pos, y.pos), (x.crd, y.crd)):
            assert (u is None) == (v is None)
            if u is not None:
                assert np.array_equal(u, v) and u.dtype == v.dtype


# --- batch_bucket -----------------------------------------------------------

def test_batch_bucket():
    assert batch_bucket(1) == 1 and batch_bucket(3) == 4
    assert batch_bucket(8) == 8 and batch_bucket(9) == 16
    assert batch_bucket(max(BATCH_BUCKETS) + 1) == 2 * max(BATCH_BUCKETS)
    for n in range(1, 200, 7):
        assert batch_bucket(n) == r_batch_bucket(n)
        assert batch_bucket(n, (3, 5)) == r_batch_bucket(n, (3, 5))
    with pytest.raises(ValueError):
        batch_bucket(0)


# --- run_many against the loop and the reference ---------------------------

_RUN_MANY = [(f, s) for f in ("csr", "bcsr") for s in ("rows", "nnz", "grid")]


@pytest.mark.parametrize("fmt_name,sched", _RUN_MANY)
def test_run_many_matches_loop_and_reference(fmt_name, sched):
    rng = np.random.default_rng(3)
    n, m = 96, 80
    dB = _int_sparse(rng, n, m)
    reqs = [rng.integers(-3, 4, m).astype(np.float32) for _ in range(8)]
    outs = {}
    for core, L, kw in ((tc, TL, {"device": "cpu"}), (rc, RL, {})):
        fmt = core.CSR() if fmt_name == "csr" else core.BCSR((4, 4))
        if sched == "grid":
            machine = core.Machine(("x", 2), ("y", 2))
            schedule = L.default_grid_schedule
        else:
            machine = core.Machine(("x", 4))
            schedule = L.default_nnz_schedule if sched == "nnz" else None
        if core is rc and fmt_name == "bcsr" and sched == "grid":
            continue    # the reference has no blocked grid SpMM for it
        bk = L.lower_batched(_spmv_stmt(core, dB, fmt), machine, batch=8,
                             schedule=schedule, **kw)
        outs[core] = (bk, bk.run_many(reqs))
    bk, batch = outs[tc]
    loop = [bk.run_many([r])[0] for r in reqs]
    for i, (r, yb, yl) in enumerate(zip(reqs, batch, loop)):
        assert yb.device == torch.device("cpu") and yb.shape == (n,)
        assert torch.equal(yb, yl)
        assert np.array_equal(yb.numpy(), dB @ r)
        if rc in outs:
            assert np.array_equal(yb.numpy(),
                                  np.asarray(outs[rc][1][i]).ravel())
    if rc in outs:
        assert bk._entries[8].kernel.leaf_name == \
            outs[rc][0]._entries[8].kernel.leaf_name


def test_run_many_spmm_panels():
    """Per-request fixed-width panels (jw > 1) stack into one wider SpMM."""
    rng = np.random.default_rng(4)
    n, m, jw = 64, 48, 3
    dB = _int_sparse(rng, n, m)
    reqs = [rng.integers(-3, 4, (m, jw)).astype(np.float32)
            for _ in range(4)]
    outs = {}
    for core, L, kw in ((tc, TL, {"device": "cpu"}), (rc, RL, {})):
        stmt = core.parse_tin(
            "A(i,j) = B(i,k) * C(k,j)",
            A=core.Tensor.zeros_dense("A", (n, jw)),
            B=core.Tensor.from_dense("B", dB.copy(), core.CSR()),
            C=core.Tensor.zeros_dense("C", (m, jw)))
        outs[core] = L.lower_batched(stmt, core.Machine(("x", 4)), batch=4,
                                     **kw).run_many(reqs)
    for r, y, w in zip(reqs, outs[tc], outs[rc]):
        assert y.shape == (n, jw)
        assert np.array_equal(y.numpy(), dB @ r)
        assert np.array_equal(y.numpy(), np.asarray(w))


def test_mixed_batch_sizes_bounded_recompiles():
    rng = np.random.default_rng(5)
    n, m = 96, 80
    dB = _int_sparse(rng, n, m)
    bk = TL.lower_batched(_spmv_stmt(tc, dB), tc.Machine(("x", 4)), batch=8,
                          device="cpu")
    reqs = [rng.integers(-3, 4, m).astype(np.float32) for _ in range(8)]
    for size in (8, 1, 2, 4):
        bk.run_many(reqs[:size])
    before = dict(TL.RUNNER_CACHE_STATS)
    plans = dict(TL.PLAN_CACHE_STATS)
    for size in (2, 3, 5, 6, 7, 8, 1, 4):
        outs = bk.run_many(reqs[:size])
        assert len(outs) == size
        for r, y in zip(reqs, outs):
            assert np.array_equal(y.numpy(), dB @ r)
    assert TL.RUNNER_CACHE_STATS["misses"] == before["misses"]
    assert TL.RUNNER_CACHE_STATS["hits"] > before["hits"]
    assert TL.PLAN_CACHE_STATS == plans         # no re-plan, no lookups
    assert sorted(bk._entries) == [1, 2, 4, 8]
    assert "bucket 8: leaf=spmm_rows pieces=4" in bk.explain()


def test_run_many_records_batch_metrics():
    rng = np.random.default_rng(12)
    dB = _int_sparse(rng, 32, 24)
    bk = TL.lower_batched(_spmv_stmt(tc, dB), tc.Machine(("x", 2)), batch=4,
                          device="cpu")
    telemetry.METRICS.clear()
    bk.run_many([np.ones(24, np.float32)] * 3)
    snap = telemetry.METRICS.snapshot()
    assert snap["counters"]["serve.requests"] == 3
    assert snap["counters"]["serve.batches"] == 1
    assert snap["counters"]["serve.h2d_bytes"] == 24 * 4 * 4
    assert snap["histograms"]["serve.batch.occupancy"]["mean"] == 0.75
    assert snap["histograms"]["serve.batch.padded_slot_waste"]["mean"] == \
        0.25
    telemetry.METRICS.clear()


def test_rebind_dense_rejects_sparse_and_unknown():
    rng = np.random.default_rng(6)
    dB = _int_sparse(rng, 32, 24)
    c2 = rng.integers(-3, 4, 24).astype(np.float32)
    errs = {}
    for core, L, kw in ((tc, TL, {"device": "cpu"}), (rc, RL, {})):
        stmt = _spmv_stmt(core, dB)
        k = L.lower(stmt, core.Machine(("x", 2)), **kw)
        with pytest.raises(ValueError) as e1:
            L.rebind_dense(k, {"B": core.Tensor.from_dense(
                "B", dB.copy(), core.CSR())})
        with pytest.raises(KeyError) as e2:
            L.rebind_dense(k, {"nope": core.Tensor.zeros_dense("nope",
                                                               (24,))})
        errs[core] = (str(e1.value), str(e2.value))
        k2 = L.rebind_dense(k, {"c": core.Tensor.from_dense("c", c2)})
        assert np.array_equal(np.asarray(k2.run()).ravel(), dB @ c2)
        assert k2.comm.as_dict() == k.comm.as_dict()
    assert errs[tc] == errs[rc]


@pytest.mark.parametrize("sched", ["rows", "nnz", "grid"])
def test_rebind_dense_keeps_the_plan(sched):
    """A rebind re-packs only the dense operand: the sparse shards (and
    their device copies) are the kernel's own, no plan is looked up and
    the runner is a cache hit."""
    rng = np.random.default_rng(13)
    dB, dC = _int_sparse(rng, 40, 32), rng.integers(-3, 4, (32, 5))
    stmt = tc.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                        A=tc.Tensor.zeros_dense("A", (40, 5)),
                        B=tc.Tensor.from_dense("B", dB, tc.CSR()),
                        C=tc.Tensor.from_dense("C", dC.astype(np.float32)))
    machine = (tc.Machine(("x", 2), ("y", 2)) if sched == "grid"
               else tc.Machine(("x", 4)))
    schedule = {"rows": TL.default_row_schedule,
                "nnz": TL.default_nnz_schedule,
                "grid": TL.default_grid_schedule}[sched](stmt, machine)
    k = TL.lower(stmt, machine, schedule=schedule, device="cpu")
    plans, runners = dict(TL.PLAN_CACHE_STATS), dict(TL.RUNNER_CACHE_STATS)
    C2 = rng.integers(-3, 4, (32, 5)).astype(np.float32)
    k2 = TL.rebind_dense(k, {"C": tc.Tensor.from_dense("C", C2)})
    assert TL.PLAN_CACHE_STATS == plans
    assert TL.RUNNER_CACHE_STATS["misses"] == runners["misses"]
    assert k2.shards["B"] is k.shards["B"] and k2.leaf_name == k.leaf_name
    assert np.array_equal(k2.run().numpy(), dB @ C2)
    assert np.array_equal(k.run().numpy(), dB @ dC)


def test_lower_batched_rejects_other_statements():
    msgs = []
    for core, L, kw in ((tc, TL, {"device": "cpu"}), (rc, RL, {})):
        d = np.eye(6, dtype=np.float32)
        stmt = core.parse_tin(
            "A(i,j) = B(i,j) * C(i,k) * D(k,j)",
            A=core.Tensor.from_dense("A", d, core.CSR()),
            B=core.Tensor.from_dense("B", d, core.CSR()),
            C=core.Tensor.from_dense("C", d), D=core.Tensor.from_dense("D",
                                                                       d))
        with pytest.raises(NotImplementedError) as e:
            L.lower_batched(stmt, core.Machine(("x", 2)), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# --- the serving loop -------------------------------------------------------

def test_sparse_kernel_server_queue_and_slo():
    rng = np.random.default_rng(10)
    n, m = 96, 80
    dB = _int_sparse(rng, n, m)
    telemetry.METRICS.clear()
    srv = SparseKernelServer(_spmv_stmt(tc, dB), tc.Machine(("x", 4)),
                             max_batch=4, slo_ms=60_000.0, device="cpu")
    ref = RServer(_spmv_stmt(rc, dB), rc.Machine(("x", 4)), max_batch=4,
                  slo_ms=60_000.0)
    rids, rhss = [], []
    for _ in range(10):
        rhs = rng.integers(-3, 4, m).astype(np.float32)
        rids.append(srv.submit(rhs))
        ref.submit(rhs)
        rhss.append(rhs)
    assert srv.step() == 4 and ref.step() == 4
    assert srv.drain() == 6 and ref.drain() == 6
    for rid, rhs in zip(rids, rhss):
        y = srv.result(rid)
        assert np.array_equal(y.numpy(), dB @ rhs)
        assert np.array_equal(y.numpy(), np.asarray(ref.result(rid)).ravel())
    st = srv.stats()
    assert st["served"] == 10 == ref.stats()["served"]
    assert st["p50_ms"] <= st["p99_ms"] <= st["max_ms"]
    assert st["slo_attainment"] == 1.0 and st["slo_ms"] == 60_000.0
    snap = telemetry.METRICS.snapshot()
    assert "serve.latency_ms" in snap["histograms"]
    assert snap["gauges"]["serve.queue_depth"] == 0
    assert snap["counters"]["serve.batches"] == 3
    assert srv.step() == 0


def test_sparse_kernel_server_counts_slo_violations():
    rng = np.random.default_rng(14)
    dB = _int_sparse(rng, 32, 24)
    telemetry.METRICS.clear()
    srv = SparseKernelServer(_spmv_stmt(tc, dB), tc.Machine(("x", 2)),
                             max_batch=2, slo_ms=0.0, device="cpu")
    assert srv.stats() == {"served": 0}
    for _ in range(3):
        srv.submit(np.ones(24, np.float32))
    srv.drain()
    assert srv.stats()["slo_attainment"] == 0.0
    assert telemetry.METRICS.snapshot()["counters"][
        "serve.slo_violations"] == 3


# --- the band-decode and MoE-combine statements -----------------------------

def test_band_decode_and_moe_combine_as_reference():
    rng = np.random.default_rng(11)
    bk = TSA.band_decode_kernel(256, 16, 64, tc.Machine(("x", 4)), batch=4,
                                device="cpu")
    rbk = RSA.band_decode_kernel(256, 16, 64, rc.Machine(("x", 4)), batch=4)
    mask = TSA.band_plan(256, 16, 64).to_dense()
    nq = mask.shape[0]
    reqs = [rng.integers(-3, 4, nq).astype(np.float32) for _ in range(4)]
    for r, y, w in zip(reqs, bk.run_many(reqs), rbk.run_many(reqs)):
        assert np.array_equal(y.numpy(), mask @ r)
        assert np.array_equal(y.numpy(), np.asarray(w).ravel())

    N, E, topk = 48, 8, 2
    tope = np.stack([rng.choice(E, topk, replace=False) for _ in range(N)])
    topw = rng.integers(1, 4, (N, topk)).astype(np.float32)
    disp = TM.dispatch_tensor(tope, topw, E)
    _levels_equal(disp, RM.dispatch_tensor(tope, topw, E))
    ck = TM.combine_kernel(disp, tc.Machine(("x", 4)), batch=4,
                           device="cpu")
    rck = RM.combine_kernel(RM.dispatch_tensor(tope, topw, E),
                            rc.Machine(("x", 4)), batch=4)
    dd = disp.to_dense()
    cols = [rng.integers(-3, 4, E).astype(np.float32) for _ in range(3)]
    for c, y, w in zip(cols, ck.run_many(cols), rck.run_many(cols)):
        assert np.array_equal(y.numpy(), dd @ c)
        assert np.array_equal(y.numpy(), np.asarray(w).ravel())


@pytest.mark.parametrize("N,E,topk", [(1, 4, 1), (64, 64, 8), (37, 5, 5)])
def test_dispatch_tensor_as_reference(N, E, topk):
    rng = np.random.default_rng(N + E)
    tope = np.argsort(-rng.random((N, E)), axis=1)[:, :topk]
    topw = rng.random((N, topk))
    disp = TM.dispatch_tensor(tope, topw, E, name="d")
    _levels_equal(disp, RM.dispatch_tensor(tope, topw, E, name="d"))
    assert disp.name == "d" and disp.nnz == N * topk
    np.testing.assert_array_equal(
        disp.to_dense()[np.arange(N)[:, None], tope],
        topw.astype(np.float32))


def test_dispatch_tensor_merges_duplicate_experts():
    tope = np.array([[1, 1], [0, 2]])
    topw = np.array([[0.25, 0.5], [1.0, 2.0]], np.float32)
    got, want = (M.dispatch_tensor(tope, topw, 3) for M in (TM, RM))
    _levels_equal(got, want)
    assert got.to_dense()[0, 1] == 0.75


# --- block-sparse attention -------------------------------------------------

def _dense_windowed(q, k, v, window):
    S, hd = q.shape[1], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / hd ** 0.5
    pos = torch.arange(S)
    m = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                          - window)
    w = torch.softmax(scores.masked_fill(~m[None, None], -1e30), -1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


@pytest.mark.parametrize("S,qb,window", [(256, 64, 128), (512, 128, 256),
                                         (300, 64, 100)])
def test_band_matches_dense_window_and_reference(S, qb, window):
    rng = np.random.default_rng(S)
    q, k, v = (rng.standard_normal((2, S, 2, 16)).astype(np.float32)
               for _ in range(3))
    idx = TSA.mask_to_ell(TSA.band_plan(S, qb, window), device="cpu")
    out = TSA.block_sparse_attention(*map(torch.from_numpy, (q, k, v)), idx,
                                     qb, window=window)
    ref = RSA.block_sparse_attention(*map(jnp.asarray, (q, k, v)),
                                     RSA.mask_to_ell(RSA.band_plan(S, qb,
                                                                   window)),
                                     qb, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    dense = _dense_windowed(*map(torch.from_numpy, (q, k, v)), window)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0),
                                           (False, 40)])
def test_block_sparse_attention_other_masks_as_reference(causal, window):
    """An arbitrary (non-band) block mask with padding slots, causal or
    not, with or without a window."""
    rng = np.random.default_rng(int(causal) * 10 + window)
    S, qb = 150, 32
    q, k, v = (rng.standard_normal((1, S, 3, 8)).astype(np.float32)
               for _ in range(3))
    nq = -(-S // qb)
    idx = np.full((nq, 3), -1, np.int32)
    for i in range(nq):
        picks = sorted(set(rng.integers(0, nq, 2).tolist()) | {i})
        idx[i, :len(picks)] = picks
    out = TSA.block_sparse_attention(*map(torch.from_numpy, (q, k, v)),
                                     torch.from_numpy(idx), qb,
                                     causal=causal, window=window)
    ref = RSA.block_sparse_attention(*map(jnp.asarray, (q, k, v)),
                                     jnp.asarray(idx), qb, causal=causal,
                                     window=window)
    assert out.shape == (1, S, 3, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_block_sparse_attention_keeps_bf16():
    S, qb = 64, 16
    q = torch.randn(1, S, 2, 8, dtype=torch.bfloat16)
    idx = TSA.mask_to_ell(TSA.band_plan(S, qb, 32), device="cpu")
    out = TSA.block_sparse_attention(q, q, q, idx, qb, window=32)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


@pytest.mark.parametrize("S,qb,window", [(4096, 128, 256), (1000, 64, 300),
                                         (64, 128, 64)])
def test_band_plan_and_ell_as_reference(S, qb, window):
    got, want = TSA.band_plan(S, qb, window), RSA.band_plan(S, qb, window)
    _levels_equal(got, want)
    ell = TSA.mask_to_ell(got, device="cpu")
    assert ell.dtype == torch.int32
    assert np.array_equal(ell.numpy(), np.asarray(RSA.mask_to_ell(want)))


def test_band_plan_nnz_scales_with_window():
    m1 = TSA.band_plan(4096, 128, 256)
    m2 = TSA.band_plan(4096, 128, 1024)
    assert m1.nnz < m2.nnz
    assert m2.nnz <= (4096 // 128) * (1024 // 128 + 2)


def test_mask_is_paper_format():
    """The mask is a genuine core CSR tensor — partitionable like any
    sparse tensor in the system."""
    m = TSA.band_plan(2048, 128, 512)
    part = partition_tensor_rows(m, partition_by_bounds(m.shape[0], 4))
    assert part.vals_bounds[-1, 1] == m.nnz


def test_serving_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    machine = tc.Machine(("x", 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSA.band_decode_kernel(64, 16, 32, machine)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSA.mask_to_ell(TSA.band_plan(64, 16, 32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseKernelServer(_spmv_stmt(tc, np.eye(4, dtype=np.float32)),
                           machine)


# --- BatchedKernel over a mesh: a 4-rank gloo group --------------------------

def test_batched_kernel_mesh_on_ranks(tmp_path):
    rng = np.random.default_rng(15)
    n, m = 64, 48
    data = tmp_path / "serve.npz"
    np.savez(data, B=_int_sparse(rng, n, m),
             R=rng.integers(-3, 4, (8, m)).astype(np.float32))
    statuses = spawn_ranks(4, ["rows", "nnz", "grid"], data, str(tmp_path),
                           target=serve_rank_main)
    for s in statuses:
        assert s["bits"] == {"rows": True, "nnz": True, "grid": True}, s
        assert s["exact"] == {"rows": True, "nnz": True, "grid": True}, s
        assert s["leaves"] == {"rows": "spmm_rows", "nnz": "spmm_nnz",
                               "grid": "spmm_grid_rows"}
