"""The port's runtime against the JAX package's, on the CPU: elastic
re-lowering, the elastic materializers, sparse checkpoints, the fault
harness and fault-injected recovery (twins of tests/test_elastic_recovery.py
and of the checkpoint, fault and resize tests of tests/test_runtime.py).

Both packages build their statements from the same numpy arrays.
``elastic_row_bounds``, ``relower``'s partitions and bounds, ``CacheStats``
(with ``shard_reuse``), ``CommStats``, ``cell_id``, checkpoint leaf names
and order, the fault harness's draws and ``RecoveryReport``'s non-time
fields must be equal; on integer-valued operands the results and the
recovered ``state`` must be equal bit for bit. Inside the port, an elastic
lower has the plain lower's shard arrays, meta and ``run()`` bits for every
format family × expression × strategy, and recovery gives the unfaulted
run's bits. The injected straggler sleeps are 1 s, twenty times the
reference's 0.05 s, and the loops that inject them run with one torch
thread: the watchdog flags a step above 4× the median step time, and with
six test workers on a few cores a step of these tiny kernels took up to
0.5 s with a thread per core."""
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as rc
from repro.core import lower as RL
from repro.core import partition as RP
from repro.runtime import checkpoint as RCK
from repro.runtime import elastic as RE
from repro.runtime import fault as RFT

import repro_torch.core as tc
from repro_torch.core import lower as TL
from repro_torch.core import partition as TP
from repro_torch.distributed.mesh import resize_machine, shrink_machine
from repro_torch.kernels import _build
from repro_torch.runtime import checkpoint as TCK
from repro_torch.runtime import elastic as TE
from repro_torch.runtime import fault as TFT

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

STRAGGLER_S = 1.0


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for a recovery loop with injected stragglers:
    six test workers with a thread per core each stretch a step of these
    tiny kernels to tenths of a second, against which a straggler's sleep
    no longer stands out (the watchdog flags a step above 4x the median)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

FAMILIES = {
    "csr": lambda F: F.CSR(),
    "dcsr": lambda F: F.DCSR(),
    "csc": lambda F: F.CSC(),
    "coo": lambda F: F.COO(2),
    "bcsr": lambda F: F.BCSR((8, 8)),
    "bcsc": lambda F: F.BCSC((8, 8)),
}
FAMILIES_3D = {"csf": lambda F: F.CSF(3), "dcsf": lambda F: F.DCSF(3),
               "coo3": lambda F: F.COO(3)}


def _int_sparse(rng, shape, density=0.3):
    """Integer-valued sparse array: every partial sum is exact in f32, so
    differently ordered reductions agree bit for bit."""
    return (rng.integers(-3, 4, shape) *
            (rng.random(shape) < density)).astype(np.float32)


def _ints(rng, shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


def _spmm(core, dB, dC, fam="csr"):
    T = core.Tensor
    n, m = dB.shape
    return core.parse_tin(
        "A(i,j) = B(i,k) * C(k,j)", A=T.zeros_dense("A", (n, dC.shape[1])),
        B=T.from_dense("B", dB.copy(), FAMILIES[fam](core.formats)),
        C=T.from_dense("C", dC.copy()))


def _spmv(core, dB, dc, fam="csr"):
    T = core.Tensor
    return core.parse_tin(
        "a(i) = B(i,j) * c(j)", a=T.zeros_dense("a", (dB.shape[0],)),
        B=T.from_dense("B", dB.copy(), FAMILIES[fam](core.formats)),
        c=T.from_dense("c", dc.copy()))


def _statements(core, fam, seed):
    """The 1-D statements over the same integer operands: SpMV, SpMM,
    SDDMM, SpAdd3 and, for the order-3 families, SpTTV and SpMTTKRP."""
    rng = np.random.default_rng(seed)
    T = core.Tensor
    n, m, K = 24, 20, 5
    if fam in FAMILIES_3D:
        fm = FAMILIES_3D[fam](core.formats)
        B3 = T.from_dense("B", _int_sparse(rng, (9, 7, 6)), fm)
        return {
            "spttv": core.parse_tin(
                "A(i,j) = B(i,j,k) * c(k)",
                A=T.from_coo("A", (9, 7), np.zeros((0, 2)),
                             np.zeros(0, np.float32), core.CSR()),
                B=B3, c=T.from_dense("c", _ints(rng, 6))),
            "spmttkrp": core.parse_tin(
                "A(i,l) = B(i,j,k) * C(j,l) * D(k,l)",
                A=T.zeros_dense("A", (9, 4)), B=B3,
                C=T.from_dense("C", _ints(rng, (7, 4))),
                D=T.from_dense("D", _ints(rng, (6, 4))))}
    fm = FAMILIES[fam](core.formats)
    B = T.from_dense("B", _int_sparse(rng, (n, m)), fm)
    return {
        "spmv": core.parse_tin("a(i) = B(i,j) * c(j)",
                               a=T.zeros_dense("a", (n,)), B=B,
                               c=T.from_dense("c", _ints(rng, m))),
        "spmm": core.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                               A=T.zeros_dense("A", (n, 3)), B=B,
                               C=T.from_dense("C", _ints(rng, (m, 3)))),
        "sddmm": core.parse_tin(
            "A(i,j) = B(i,j) * C(i,k) * D(k,j)",
            A=T("A", B.shape, B.format, B.levels, np.ones_like(B.vals)),
            B=B, C=T.from_dense("C", _ints(rng, (n, K))),
            D=T.from_dense("D", _ints(rng, (K, m)))),
        "spadd3": core.parse_tin(
            "A(i,j) = B(i,j) + C(i,j) + D(i,j)",
            A=T.from_coo("A", (n, m), np.zeros((0, 2)),
                         np.zeros(0, np.float32), core.CSR()),
            B=B, C=T.from_dense("C", _int_sparse(rng, (n, m)), fm),
            D=T.from_dense("D", _int_sparse(rng, (n, m)), fm))}


def _dense(out) -> np.ndarray:
    if torch.is_tensor(out):
        return out.numpy()
    if isinstance(out, np.ndarray):
        return out
    return out.to_dense()


def _eq(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b))


def _same_plans(tp, rp):
    assert sorted(tp) == sorted(rp)
    for name in rp:
        a, b = tp[name], rp[name]
        assert (a.pieces, a.replicated) == (b.pieces, b.replicated), name
        assert len(a.levels) == len(b.levels), name
        for la, lb in zip(a.levels, b.levels):
            assert _eq(la.coord_bounds, lb.coord_bounds), name
            assert _eq(la.pos_bounds, lb.pos_bounds), name
        assert _eq(a.vals_bounds, b.vals_bounds), name
        assert _eq(a.root_coord_bounds, b.root_coord_bounds), name


def _same_shards(a, b, where):
    assert a.kind == b.kind and a.pieces == b.pieces, where
    assert a.meta == b.meta, where
    assert sorted(a.arrays) == sorted(b.arrays), where
    for x in b.arrays:
        assert a.arrays[x].dtype == b.arrays[x].dtype, (where, x)
        assert np.array_equal(a.arrays[x], b.arrays[x]), (where, x)


# ---------------------------------------------------------------------------
# Migration bounds
# ---------------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(n=st.integers(4, 200), P=st.integers(2, 8), seed=st.integers(0, 99))
def test_elastic_bounds_cover_and_preserve(n, P, seed):
    rng = np.random.default_rng(seed)
    b = TP.partition_by_bounds(n, P)
    dead = int(rng.integers(0, P))
    keep = TP.elastic_row_bounds(b, dead)
    assert np.array_equal(keep, RP.elastic_row_bounds(b, dead))
    assert keep.shape == (P - 1, 2)
    assert keep[0, 0] == 0 and keep[-1, 1] == n
    assert np.array_equal(keep[1:, 0], keep[:-1, 1])
    orig = {(int(lo), int(hi)) for lo, hi in b}
    assert sum((int(lo), int(hi)) in orig for lo, hi in keep) >= P - 2


def test_elastic_bounds_reject_as_reference():
    b = TP.partition_by_bounds(10, 3)
    for args in ((b, 3), (b, -1), (b[:1], 0)):
        with pytest.raises(ValueError) as te:
            TP.elastic_row_bounds(*args)
        with pytest.raises(ValueError) as re_:
            RP.elastic_row_bounds(*args)
        assert str(te.value) == str(re_.value)


# ---------------------------------------------------------------------------
# The elastic materializers against the reference's
# ---------------------------------------------------------------------------

_MAT = [(kind, fam) for kind in ("rows", "nnz") for fam in FAMILIES]


@pytest.mark.parametrize("kind,fam", _MAT, ids=lambda x: str(x))
def test_materialize_pieces_as_reference(kind, fam):
    """Per-piece shards stacked by the port equal the reference's, on an
    equal split and on migration bounds (a merged window)."""
    rng = np.random.default_rng(hash((kind, fam)) % 1000)
    dB = _int_sparse(rng, (40, 32))
    out = {}
    for core, P in ((rc, RP), (tc, TP)):
        B = core.Tensor.from_dense("B", dB, FAMILIES[fam](core.formats))
        blocked = B.format.is_blocked
        res = []
        for pieces, dead in ((4, None), (3, 1)):
            if kind == "rows":
                bounds = (P.block_aligned_row_bounds(40, 4, 8) if blocked
                          else P.partition_by_bounds(40, 4))
                if dead is not None:
                    bounds = P.elastic_row_bounds(bounds, dead)
                part = P.partition_tensor_rows(B, bounds)
                mkind = "bcsr_rows" if blocked else "csr_rows"
            else:
                init = P.partition_tensor_nonzeros(B, 4).vals_bounds
                if dead is not None:
                    init = P.elastic_row_bounds(init, dead)
                part = P.partition_tensor_nonzeros(B, pieces,
                                                   init_bounds=init)
                mkind = "bcsr_nnz" if blocked else "coo_nnz"
            res.append(P.materialize_pieces(mkind, B, part))
        out[core] = res
    for a, b in zip(out[tc], out[rc]):
        _same_shards(a, b, (kind, fam))


def test_dense_and_replicated_elastic_as_reference():
    rng = np.random.default_rng(3)
    dC = _ints(rng, (30, 5))
    bounds = TP.elastic_row_bounds(TP.partition_by_bounds(30, 4), 2)
    got, want = [], []
    for core, P, sink in ((tc, TP, got), (rc, RP, want)):
        C = core.Tensor.from_dense("C", dC)
        sink.append(P.materialize_dense_rows_pieces(C, bounds))
        sink.append(P.materialize_replicated_elastic(C, 3))
    for a, b in zip(got, want):
        _same_shards(a, b, a.kind)
    # every resize of a replicated operand is a hit, device copies included
    TP.clear_shard_cache()
    C = tc.Tensor.from_dense("C", dC)
    r4 = TP.materialize_replicated_elastic(C, 4)
    hits = TP.SHARD_CACHE_STATS["hits"]
    r3 = TP.materialize_replicated_elastic(C, 3)
    assert TP.SHARD_CACHE_STATS["hits"] == hits + 1
    assert r3.pieces == 3 and r3.device_arrays is r4.device_arrays


# ---------------------------------------------------------------------------
# Elastic lower == plain lower, inside the port
# ---------------------------------------------------------------------------

_ELASTIC_CELLS = [(fam, expr, space)
                  for fam in list(FAMILIES) + list(FAMILIES_3D)
                  for expr in (("spttv", "spmttkrp") if fam in FAMILIES_3D
                               else ("spmv", "spmm", "sddmm", "spadd3"))
                  for space in ("rows", "nnz")]


@pytest.mark.parametrize("fam,expr,space", _ELASTIC_CELLS,
                         ids=lambda x: str(x))
def test_elastic_lower_equals_plain(fam, expr, space):
    """An elastic lower packs every shard per color and stacks them: the
    arrays, the meta and the run() bits must be the plain lower's, on the
    equal split and on migration bounds at P = 3."""
    stmt = _statements(tc, fam, seed=len(fam) * 7 + len(expr))[expr]
    M4, M3 = tc.Machine(("x", 4)), tc.Machine(("x", 3))

    def sched(m):
        return TL.default_nnz_schedule(stmt, m) if space == "nnz" else None

    TL.clear_lowering_caches()
    k = TL.lower(stmt, M4, schedule=sched(M4), elastic=True, device="cpu")
    p = TL.lower(stmt, M4, schedule=sched(M4), device="cpu")
    assert k.leaf_name == p.leaf_name
    assert sorted(k.shards) == sorted(p.shards)
    for name in p.shards:
        _same_shards(k.shards[name], p.shards[name], name)
    assert np.array_equal(_dense(k.run()), _dense(p.run()))
    init = TL._elastic_init_bounds(k)
    if init is None:            # spadd3/nnz: independent per-operand splits
        assert (expr, space) == ("spadd3", "nnz")
        return
    merged = TP.elastic_row_bounds(init, 1)
    k3 = TL.lower(stmt, M3, schedule=sched(M3), elastic=True,
                  init_bounds=merged, device="cpu")
    p3 = TL.lower(stmt, M3, schedule=sched(M3), init_bounds=merged,
                  device="cpu")
    for name in p3.shards:
        _same_shards(k3.shards[name], p3.shards[name], name)
    assert np.array_equal(_dense(k3.run()), _dense(p.run()))


# ---------------------------------------------------------------------------
# relower against the reference: partitions, bounds, caches, bits
# ---------------------------------------------------------------------------

_RELOWER = [(fam, space, dead) for fam in FAMILIES
            for space in ("rows", "nnz") for dead in (0, 1, 3)]


@pytest.mark.parametrize("fam,space,dead", _RELOWER, ids=lambda x: str(x))
def test_relower_as_reference(fam, space, dead):
    rng = np.random.default_rng(len(fam) * 31 + dead)
    dB, dC = _int_sparse(rng, (48, 40)), _ints(rng, (40, 8))
    res = {}
    for core, L, kw in ((rc, RL, {}), (tc, TL, {"device": "cpu"})):
        stmt = _spmm(core, dB, dC, fam)
        M4, M3 = core.Machine(("x", 4)), core.Machine(("x", 3))
        sched = L.default_nnz_schedule(stmt, M4) if space == "nnz" else None
        L.clear_lowering_caches()
        k4 = L.lower(stmt, M4, schedule=sched, elastic=True, **kw)
        k3 = L.relower(k4, M3, dead=dead)
        res[core] = (k4, k3, M3, _dense(np.asarray(k3.run()))
                     if core is rc else _dense(k3.run()))
    rk4, rk3, _, rout = res[rc]
    tk4, tk3, M3, tout = res[tc]
    assert np.array_equal(tout, rout)
    _same_plans(tk3.plans, rk3.plans)
    assert tk3.cache.as_dict() == rk3.cache.as_dict()
    assert tk3.cache.shard_reuse == rk3.cache.shard_reuse >= 0.5
    assert tk3.comm.as_dict() == rk3.comm.as_dict()
    assert tk3.cell_id() == rk3.cell_id() and tk3.machine is M3
    assert tk3.strategy.pieces == 3 and tk3.device == torch.device("cpu")
    # inside the port: a fresh equal-split lower on P = 3 and the P = 4 run
    stmt = tk4.stmt
    sched3 = TL.default_nnz_schedule(stmt, M3) if space == "nnz" else None
    fresh = TL.lower(stmt, M3, schedule=sched3, device="cpu")
    assert np.array_equal(tout, fresh.run().numpy())
    assert np.array_equal(tout, tk4.run().numpy())


def test_relower_regrid_and_weights_as_reference():
    """Mesh-as-data beyond shrinking: re-factorize 1-D → 2-D, and re-plan
    in place with straggler weights through the same entry point."""
    rng = np.random.default_rng(7)
    dB, dC = _int_sparse(rng, (48, 40)), _ints(rng, (40, 8))
    w = np.array([0.5, 1.0, 1.5, 1.0])
    out = {}
    for core, L, kw in ((rc, RL, {}), (tc, TL, {"device": "cpu"})):
        stmt = _spmm(core, dB, dC)
        M4 = core.Machine(("x", 4))
        M22 = core.Machine(("x", 2), ("y", 2))
        L.clear_lowering_caches()
        k4 = L.lower(stmt, M4, elastic=True, **kw)
        k22 = L.relower(k4, M22)
        kn = L.lower(stmt, M4, schedule=L.default_nnz_schedule(stmt, M4),
                     elastic=True, **kw)
        kw_ = L.relower(kn, M4, weights=w)
        out[core] = (k4, k22, kw_)
    (r4, r22, rw), (t4, t22, tw) = out[rc], out[tc]
    ref = t4.run().numpy()
    assert np.array_equal(ref, np.asarray(r4.run()))
    assert t22.strategy.is_grid and t22.leaf_name == r22.leaf_name
    assert tuple(d.size for d in t22.strategy.machine_dims) == (2, 2)
    assert np.array_equal(t22.run().numpy(), ref)
    assert np.array_equal(tw.run().numpy(), ref)
    _same_plans(t22.plans, r22.plans)
    _same_plans(tw.plans, rw.plans)
    assert tw.cache.as_dict() == rw.cache.as_dict()
    assert t22.comm.as_dict() == r22.comm.as_dict()


def test_rebuild_schedule_matches_strategy_family():
    rng = np.random.default_rng(11)
    dB, dC = _int_sparse(rng, (48, 40)), _ints(rng, (40, 8))
    for core, L, kw in ((rc, RL, {}), (tc, TL, {"device": "cpu"})):
        stmt = _spmm(core, dB, dC)
        M4 = core.Machine(("x", 4))
        k = L.lower(stmt, M4, schedule=L.default_nnz_schedule(stmt, M4),
                    **kw)
        s = L.rebuild_schedule(stmt, core.Machine(("x", 3)), k.strategy)
        assert s.strategy().space == "nnz" and s.strategy().pieces == 3
        k2 = L.lower(stmt, M4, **kw)
        s2 = L.rebuild_schedule(stmt, core.Machine(("x", 2), ("y", 2)),
                                k2.strategy)
        assert s2.strategy().is_grid and s2.strategy().pieces == 4
        s3 = L.rebuild_schedule(
            stmt, core.Machine(("x", 2), ("y", 2), ("z", 2)), k2.strategy)
        assert len(s3.strategy().machine_dims) == 3


def test_cache_stats_shard_reuse():
    cs = TL.CacheStats(shard_hits=3, shard_misses=1)
    assert cs.shard_reuse == 0.75 == RL.CacheStats(
        shard_hits=3, shard_misses=1).shard_reuse
    assert TL.CacheStats().shard_reuse == 0.0


# ---------------------------------------------------------------------------
# Checkpoints: leaf names and order, manifests, round trips
# ---------------------------------------------------------------------------

_TREES = [
    {"a": {"b": 1}, "a/b": 2, "c": [3, 4]},
    {"z": np.arange(3), "a": (np.float32(1.5), None, [np.ones(2)]),
     "m": {"y": 2, "x": {"q": np.zeros((2, 2))}}},
    [np.arange(4), {"k": 7, "j": (1, 2)}],
    np.arange(5),
]


@pytest.mark.parametrize("tree", _TREES, ids=range(len(_TREES)))
def test_flatten_with_names_as_reference(tree):
    got = TCK._flatten_with_names(tree)
    want = RCK._flatten_with_names(tree)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_flatten_with_names_uniquifies_collisions():
    names = [n for n, _ in TCK._flatten_with_names(_TREES[0])]
    assert len(names) == len(set(names))
    assert sum(n.startswith("a/b") for n in names) == 2


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_sparse_checkpoint_roundtrip_as_reference(fam, tmp_path):
    rng = np.random.default_rng(len(fam))
    dB, dC = _int_sparse(rng, (40, 32)), _ints(rng, (32, 4))
    manifests = {}
    for core, CK in ((rc, RCK), (tc, TCK)):
        stmt = _spmm(core, dB, dC, fam)
        tensors = {a.tensor.name: a.tensor for a in stmt.accesses()}
        B = tensors["B"]
        fp0 = B.fingerprint()
        d = tmp_path / core.__name__
        ck = CK.SparseCheckpoint(str(d), keep=2, process_index=0)
        acc = np.arange(6, dtype=np.float32)
        ck.save(1, tensors, {"state": acc}, blocking=True)
        assert ck.stale_operands(tensors) == []
        B.vals.reshape(-1)[0] += 3.0
        assert ck.stale_operands(tensors) == ["B"]
        step, extra, info = ck.restore(tensors, {"state": acc})
        assert step == 1 and np.array_equal(extra["state"], acc)
        assert info["restored"] == ["B"] and "C" in info["reused"]
        assert B.fingerprint() == fp0 and ck.stale_operands(tensors) == []
        manifests[core] = (json.loads(
            (d / "step_00000001" / "manifest_p0.json").read_text()), info)
    (tm, tinfo), (rm, rinfo) = manifests[tc], manifests[rc]
    # names, files, shapes and dtypes; the reference's tuned leaf pickles
    # its (here empty) tuned-plan list, the port's is empty
    assert [l for l in tm["leaves"] if l["name"] != "tuned"] == \
        [l for l in rm["leaves"] if l["name"] != "tuned"]
    assert [(l["name"], l["file"]) for l in tm["leaves"]] == \
        [(l["name"], l["file"]) for l in rm["leaves"]]
    assert tinfo == rinfo                     # tuned_imported 0 on both


def test_sparse_checkpoint_tuned_leaf_is_empty(tmp_path):
    """The port has no tuned-plan cache (the autoscheduler is ROADMAP
    Queue 1 item 7): the snapshot's ``tuned`` leaf is empty."""
    B = tc.Tensor.from_dense("B", np.eye(4, dtype=np.float32), tc.CSR())
    ck = TCK.SparseCheckpoint(str(tmp_path), process_index=0)
    ck.save(3, {"B": B})
    m = json.loads((tmp_path / "step_00000003" / "manifest_p0.json")
                   .read_text())
    tuned = [leaf for leaf in m["leaves"] if leaf["name"] == "tuned"]
    assert tuned and tuned[0]["shape"] == [0]
    assert ck.restore({"B": B})[2]["tuned_imported"] == 0


def test_checkpoint_roundtrip_with_tensors(tmp_path):
    """Tensor leaves are copied to the host explicitly and come back as
    host arrays; the manifest names them as the reference names the same
    tree of arrays."""
    mgr = TCK.CheckpointManager(str(tmp_path), process_index=0)
    state = {"params": {"w": torch.arange(8.0)}, "step": 7,
             "cursor": {"step": 7, "shard": 0, "n_shards": 1, "seed": 0}}
    mgr.save(7, state, blocking=True)
    step, restored = mgr.restore(state)
    assert step == 7
    assert np.allclose(restored["params"]["w"], np.arange(8.0))
    assert isinstance(restored["params"]["w"], np.ndarray)
    assert int(restored["step"]) == 7
    ref = RCK.CheckpointManager(str(tmp_path / "ref"), process_index=0)
    ref.save(7, {"params": {"w": np.arange(8.0, dtype=np.float32)},
                 "step": 7, "cursor": state["cursor"]}, blocking=True)
    names = [json.loads((d / "step_00000007" / "manifest_p0.json")
                        .read_text())["leaves"] for d in
             (tmp_path, tmp_path / "ref")]
    assert names[0] == names[1]


def test_checkpoint_async_and_gc(tmp_path):
    mgr = TCK.CheckpointManager(str(tmp_path), keep=2, process_index=0)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.full((4,), float(s))})
    mgr.wait()
    assert mgr.latest_step() == 4
    assert len(sorted(p.name for p in tmp_path.glob("step_*"))) == 2
    assert np.array_equal(mgr.restore({"x": 0})[1]["x"], np.full(4, 4.0))


def test_checkpoint_atomic_no_partial(tmp_path):
    mgr = TCK.CheckpointManager(str(tmp_path), process_index=0)
    (tmp_path / "step_00000009.tmp").mkdir()
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": 0})


def test_restore_sweeps_orphan_tmp_dirs(tmp_path):
    mgr = TCK.CheckpointManager(str(tmp_path), keep=3, process_index=0)
    mgr.save(1, {"x": np.arange(4)}, blocking=True)
    orphan = tmp_path / "step_00000007.tmp"
    orphan.mkdir()
    (orphan / "leaf_00000_p0.npy").write_bytes(b"garbage")
    step, got = mgr.restore({"x": np.zeros(4, dtype=np.int64)})
    assert step == 1 and np.array_equal(got["x"], np.arange(4))
    assert not orphan.exists()
    assert (tmp_path / "step_00000001").exists()


def test_checkpoint_process_index_defaults_to_zero(tmp_path):
    assert TCK.CheckpointManager(str(tmp_path)).proc == 0


# ---------------------------------------------------------------------------
# The fault harness against the reference's
# ---------------------------------------------------------------------------

def test_restart_backoff_jitter_as_reference():
    def sleeps_of(R):
        p = R.RestartPolicy(max_restarts=6, backoff_s=1.0,
                            backoff_factor=2.0, jitter=0.5, seed=42)
        sleeps, calls = [], {"n": 0}

        def boom():
            calls["n"] += 1
            if calls["n"] <= 4:
                raise RuntimeError("boom")

        p.run_with_restarts(boom, sleep=lambda s: sleeps.append(s))
        return sleeps

    got = sleeps_of(TFT)
    assert got == sleeps_of(RFT) and len(got) == 4
    for s, nominal in zip(got, (1.0, 2.0, 4.0, 8.0)):
        assert 0.5 * nominal <= s <= 1.5 * nominal
    assert len(set(got)) == len(got)
    z, calls = [], {"n": 0}

    def boom():
        calls["n"] += 1
        if calls["n"] <= 4:
            raise RuntimeError("boom")

    TFT.RestartPolicy(backoff_s=0.0, jitter=0.9, seed=1).run_with_restarts(
        boom, sleep=lambda s: z.append(s))
    assert z == [0.0] * 4


def test_restart_policy_retries_then_succeeds():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("node lost")

    restarts = TFT.RestartPolicy(max_restarts=5, backoff_s=0.0) \
        .run_with_restarts(flaky, sleep=lambda s: None)
    assert restarts == 2 and calls["n"] == 3


def test_restart_policy_budget_exhausted():
    def always_fails():
        raise RuntimeError("dead")

    with pytest.raises(RuntimeError):
        TFT.RestartPolicy(max_restarts=2, backoff_s=0.0).run_with_restarts(
            always_fails, sleep=lambda s: None)


def test_watchdog_warmup_suppresses_early_flags():
    wd = TFT.StepWatchdog(threshold=1.01, warmup=3)
    for dt in (0.001, 0.5, 0.9):
        wd.start()
        wd._t0 -= dt
        assert wd.stop() is False
    wd.start()
    wd._t0 -= 50.0
    assert wd.stop() is True


def test_watchdog_flags_stragglers():
    wd = TFT.StepWatchdog(threshold=2.0)
    for dt in [0.1] * 10:
        wd.times.append(dt)
    wd._t0 = time.monotonic() - 1.0
    assert wd.stop() is True
    wd._t0 = time.monotonic() - 0.1
    assert wd.stop() is False
    assert wd.straggler_steps == [1]


def test_straggler_mitigator_as_reference():
    got, want = TFT.StragglerMitigator(4, report_budget=2), \
        RFT.StragglerMitigator(4, report_budget=2)
    for shard in (1, 1, 3, 1, 3):
        assert got.report_slow(shard) == want.report_slow(shard)
    assert np.array_equal(got.weights, want.weights)
    b = got.weighted_nonzero_bounds(1000)
    assert np.array_equal(b, want.weighted_nonzero_bounds(1000))
    counts = b[:, 1] - b[:, 0]
    assert counts.sum() == 1000 and counts[1] < counts[0]
    assert b[0, 0] == 0 and np.all(b[1:, 0] == b[:-1, 1])


def test_fault_injector_as_reference():
    """The same events fire at the same steps, corrupt the same stored
    value, and log the same trace."""
    def drive(core, FT):
        B = core.Tensor.from_dense(
            "B", _int_sparse(np.random.default_rng(2), (16, 12)), core.CSR())
        inj = FT.FaultInjector(
            [FT.FaultEvent(step=1, kind="corrupt", tensor="B"),
             FT.FaultEvent(step=2, kind="straggler", piece=3,
                           slowdown_s=0.25),
             FT.FaultEvent(step=2, kind="straggler", piece=1,
                           slowdown_s=0.5, once=False),
             FT.FaultEvent(step=4, kind="device_loss", piece=2)], seed=5)
        trace = []
        for step in (0, 1, 2, 2, 3, 4, 4):
            try:
                trace.append((inj.before_step(step, {"B": B}),
                              inj.slow_piece))
            except FT.DeviceLoss as e:
                trace.append(("loss", e.piece, e.step, str(e)))
        with pytest.raises(KeyError):
            FT.FaultInjector([FT.FaultEvent(step=0, kind="corrupt",
                                            tensor="Q")]).before_step(0, {})
        with pytest.raises(ValueError):
            FT.FaultInjector([FT.FaultEvent(step=0, kind="melt")]) \
                .before_step(0, {})
        return trace, inj.log, B.vals.copy()

    got, want = drive(tc, TFT), drive(rc, RFT)
    assert got[0] == want[0] and got[1] == want[1]
    assert np.array_equal(got[2], want[2])


def test_elastic_resize_plan_as_reference():
    for args in (((16, 16), 256, 16), ((16, 16), 192, 16),
                 ((16, 16), 8, 16), ((4, 2), 7, 2)):
        assert TE.plan_resize(*args) == RE.plan_resize(*args)
    assert TE.plan_resize((16, 16), 192, 16) == (8, 16)
    assert TE.plan_resize((16, 16), 8, 16) is None
    for b, dp in ((256, 8), (256, 6), (10, 0)):
        assert TE.valid_resize(b, dp) == RE.valid_resize(b, dp)


def test_machine_resize_helpers():
    M = tc.Machine(("x", 4), ("y", 2))
    assert [d.size for d in shrink_machine(M).dims] == [3, 2]
    assert [d.size for d in shrink_machine(M, "y").dims] == [4, 1]
    assert [d.size for d in resize_machine(M, "y", 5).dims] == [4, 5]
    with pytest.raises(ValueError):
        shrink_machine(tc.Machine(("x", 1)))
    with pytest.raises(ValueError):
        resize_machine(M, "z", 2)


# ---------------------------------------------------------------------------
# Fault-injected recovery against the reference's, bit for bit
# ---------------------------------------------------------------------------

_REPORT_FIELDS = ("steps", "restarts", "replans", "faults", "healed",
                  "restored_step", "shard_reuse", "initial_pieces",
                  "final_pieces")


def _recover(core, mk, steps, events, tmp, schedule=None, mitigator=None,
             every=1):
    """(state, report) of the unfaulted-then-faulted pair of one package,
    each from cold caches; the port's state comes back on the CPU."""
    L, E, FT = ((RL, RE, RFT) if core is rc else (TL, TE, TFT))
    kw = {} if core is rc else {"device": "cpu"}
    out = []
    for faulted in (False, True):
        stmt = mk(core)
        M4 = core.Machine(("x", 4))
        L.clear_lowering_caches()
        sched = schedule(L, stmt, M4) if schedule else None
        mit = mitigator(FT) if (faulted and mitigator) else None
        state, rep = E.run_with_recovery(
            stmt, M4, steps, ckpt_dir=tempfile.mkdtemp(dir=tmp),
            schedule=sched, checkpoint_every=every, mitigator=mit,
            injector=FT.FaultInjector(events(FT)) if faulted else None, **kw)
        out.append((np.asarray(state) if core is rc else state.numpy(), rep))
    return out


def _check_recovery(tmp, mk, steps, events, **kw):
    (rref, rrep0), (rstate, rrep) = _recover(rc, mk, steps, events, tmp,
                                             **kw)
    (tref, trep0), (tstate, trep) = _recover(tc, mk, steps, events, tmp,
                                             **kw)
    assert np.array_equal(tref, rref) and np.array_equal(tstate, rstate)
    assert np.array_equal(tstate, tref)           # recovery == unfaulted
    for f in _REPORT_FIELDS:
        assert getattr(trep, f) == getattr(rrep, f), f
        assert getattr(trep0, f) == getattr(rrep0, f), f
    split = trep.restore_s + trep.replan_s + trep.rejit_s
    assert abs(split - trep.recovery_s) < 1e-9
    return trep


def _mk_spmm(seed, fam="csr"):
    rng = np.random.default_rng(seed)
    dB, dC = _int_sparse(rng, (48, 40)), _ints(rng, (40, 8))
    return lambda core: _spmm(core, dB, dC, fam)


@pytest.mark.parametrize("fault_step,piece", [(1, 0), (2, 3), (4, 1),
                                              (3, 2)])
def test_device_loss_recovers_as_reference(fault_step, piece, tmp_path):
    rep = _check_recovery(
        tmp_path, _mk_spmm(fault_step * 10 + piece), 6,
        lambda FT: [FT.FaultEvent(step=fault_step, kind="device_loss",
                                  piece=piece)])
    assert rep.restarts == 1 and rep.final_pieces == 3
    assert rep.shard_reuse >= 0.5
    assert rep.faults == [f"device_loss:{piece}@{fault_step}"]
    assert rep.restored_step is not None and rep.restored_step <= fault_step


def test_corruption_heals_and_matches(tmp_path):
    rep = _check_recovery(
        tmp_path, _mk_spmm(5), 6,
        lambda FT: [FT.FaultEvent(step=2, kind="corrupt", tensor="B")])
    assert rep.healed == ["B"] and rep.restarts == 0
    assert rep.final_pieces == 4


@pytest.mark.parametrize("expr,fam", [("spmv", "csr"), ("spmv", "bcsr"),
                                      ("spmm", "dcsr")])
def test_loss_then_corruption_as_reference(expr, fam, tmp_path):
    """The chip script's recovery schedule at a small size: a device loss
    at step 3, then B corrupted at step 5, checkpoints every step (every 4
    for SpMM, so the loss replays three steps)."""
    rng = np.random.default_rng(len(expr) + len(fam))
    dB = _int_sparse(rng, (48, 40))
    dc = _ints(rng, (40,) if expr == "spmv" else (40, 4))

    def mk(core):
        return (_spmv if expr == "spmv" else _spmm)(core, dB, dc, fam)

    rep = _check_recovery(
        tmp_path, mk, 8,
        lambda FT: [FT.FaultEvent(step=3, kind="device_loss", piece=1),
                    FT.FaultEvent(step=5, kind="corrupt", tensor="B")],
        every=4 if expr == "spmm" else 1)
    assert rep.restarts == 1 and rep.final_pieces == 3
    assert rep.healed == ["B"] and rep.shard_reuse >= 0.5
    assert rep.restored_step == (0 if expr == "spmm" else 3)


def test_straggler_triggers_weighted_replan(tmp_path, one_torch_thread):
    rep = _check_recovery(
        tmp_path, _mk_spmm(6), 8,
        lambda FT: [FT.FaultEvent(step=s, kind="straggler", piece=2,
                                  slowdown_s=STRAGGLER_S) for s in (3, 4, 5)],
        schedule=lambda L, stmt, m: L.default_nnz_schedule(stmt, m),
        mitigator=lambda FT: FT.StragglerMitigator(4, report_budget=2))
    assert rep.replans >= 1


def test_recovery_state_stays_on_the_kernels_device(tmp_path):
    """The accumulator is a tensor on the kernel's device; checkpoints hold
    it as a host array."""
    state, rep = TE.run_with_recovery(_mk_spmm(8)(tc), tc.Machine(("x", 2)),
                                      3, ckpt_dir=str(tmp_path),
                                      device="cpu")
    assert torch.is_tensor(state) and state.device == torch.device("cpu")
    step, extra, _ = TCK.SparseCheckpoint(str(tmp_path)).restore(
        {}, {"state": state})
    assert step == 3 and isinstance(extra["state"], np.ndarray)
    assert np.array_equal(extra["state"], state.numpy())


def test_recovery_entry_point_needs_a_card_unless_asked(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.run_with_recovery(_mk_spmm(9)(tc), tc.Machine(("x", 2)), 2,
                             ckpt_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# The chip script's path 4h, rehearsed at a small size
# ---------------------------------------------------------------------------

def test_chip_smoke_runtime_path_on_cpu(tmp_path, capfd,
                                        one_torch_thread):
    """Path 4h on the CPU: the three recovery cells (bits of the unfaulted
    run, one restart to 3 pieces, B healed, reuse >= 0.5 on the rows
    cells, the nnz cell's straggler re-plan), the ledger over every cell
    the other paths lower, the validated trace, both serving schedules
    (no runner built after warm, run_many == the loop) and the band and
    MoE statements; no kernel launches."""
    before = dict(_build.LAUNCHES)
    data = chip_smoke.make_inputs(256, 4, 8, seed=0, dims3=(64, 16, 16),
                                  rank=4)
    data["add"] = chip_smoke.add_operands(256, 0, data["B"])
    data["dense"] = chip_smoke.add_operands(64, 0)
    data["grid"] = chip_smoke.grid_operands(data, 64, 0)
    kernels = []
    for cells in chip_smoke.PATH_CELLS.values():
        recs, _ = chip_smoke.run_slice(data, cells, 4, "cpu", reps=1)
        kernels += [r["kernel"] for r in recs.values() if r["kernel"]]
    # straggler sleeps of 1 s and 4 s: the second must exceed twice the
    # first plus the steps' own times
    runtime, serving = chip_smoke.runtime_path(
        data, kernels, torch.device("cpu"), stragglers=((1, 1.0), (2, 4.0)),
        ckpt_root=tmp_path / "recovery", trace_path=tmp_path / "TRACE.json")
    assert runtime == {} and serving == {} and _build.LAUNCHES == before
    out = capfd.readouterr().out
    rec = [l for l in out.splitlines() if l.startswith("[recovery] ")]
    assert len(rec) == len(chip_smoke.RUNTIME_CELLS)
    assert all("restarts=1" in l and "final_pieces=3" in l for l in rec)
    assert "replans=1" in rec[1]
    ledger = next(l for l in out.splitlines() if l.startswith("[ledger] "))
    assert f"cells={len(kernels)} " in ledger and "ok=True" in ledger
    assert "execute_piece=" in out
    serve = [l for l in out.splitlines() if l.startswith("[serve] ")]
    assert len(serve) == 2 and all("bits_equal_loop=True" in l
                                   and "requests=64" in l for l in serve)
    assert "[band] " in out and "[moe] " in out
    assert not (tmp_path / "recovery").exists()
