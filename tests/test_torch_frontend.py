"""The port's host-side front end against the JAX package's: parsed
statements, format keys, storage, fingerprints, level walks, partitions and
materialized shards must be equal, not close. Same inputs in both packages,
made from numpy seeds."""
import dataclasses
import zlib

import numpy as np
import pytest

import repro.core as rc
from repro.core import cache as RCache
from repro.core import formats as RF
from repro.core import partition as RP
from repro.core.interp import interpret as r_interpret
from repro.data import spdata as r_spdata

import repro_torch.core as tc
from repro_torch.core import cache as TCache
from repro_torch.core import formats as TF
from repro_torch.core import partition as TP
from repro_torch.core.interp import interpret as t_interpret
from repro_torch.data import spdata as t_spdata
from repro_torch.runtime import telemetry as TT

FORMATS = [
    ("csr", lambda F: F.CSR(), 2),
    ("csc", lambda F: F.CSC(), 2),
    ("dcsr", lambda F: F.DCSR(), 2),
    ("coo", lambda F: F.COO(2), 2),
    ("csf", lambda F: F.CSF(3), 3),
]
IDS = [f[0] for f in FORMATS]


def _dense(name, order):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    shape = (19, 13) if order == 2 else (7, 5, 6)
    d = ((rng.random(shape) < 0.25)
         * rng.standard_normal(shape)).astype(np.float32)
    d[rng.integers(0, shape[0])] = 0                    # empty row / slice
    d[rng.integers(0, shape[0])] = rng.standard_normal(shape[1:])  # skew
    return d


def _pair(name, ctor, order):
    d = _dense(name, order)
    return (rc.Tensor.from_dense("B", d, ctor(RF)),
            tc.Tensor.from_dense("B", d, ctor(TF)), d)


def _storage(t):
    return ([(None if ld.pos is None else ld.pos.tolist(),
              None if ld.crd is None else ld.crd.tolist())
             for ld in t.levels], t.vals.tolist())


def _fields(obj):
    """A dataclass as plain, comparable values (arrays to lists, nested
    partitions recursed, tensors dropped: they differ by package)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name == "tensor":
            continue
        if isinstance(v, np.ndarray):
            v = (str(v.dtype), v.tolist())
        elif isinstance(v, list):
            v = [_fields(x) if dataclasses.is_dataclass(x) else x for x in v]
        out[f.name] = v
    return out


def _shards(sh):
    return (sh.kind, sh.pieces, sh.meta,
            {k: (str(a.dtype), a.shape, a.tolist())
             for k, a in sh.arrays.items()})


STATEMENTS = [
    ("a(i) = B(i,j) * c(j)", {"a": (4,), "B": (4, 5), "c": (5,)}),
    ("A(i,j) = B(i,k) * C(k,j)", {"A": (4, 3), "B": (4, 5), "C": (5, 3)}),
    ("A(i,j) = B(i,j) * C(i,k) * D(k,j)",
     {"A": (4, 5), "B": (4, 5), "C": (4, 2), "D": (2, 5)}),
    ("A(i,l) = B(i,j,k) * C(j,l) * D(k,l)",
     {"A": (4, 3), "B": (4, 5, 6), "C": (5, 3), "D": (6, 3)}),
]


@pytest.mark.parametrize("src,shapes", STATEMENTS,
                         ids=[s[0] for s in STATEMENTS])
def test_parse_tin_signature(src, shapes):
    rng = np.random.default_rng(1)
    dense = {k: (rng.random(s) < 0.5).astype(np.float32)
             for k, s in shapes.items()}
    sparse = {"B"} | ({"A"} if "B(i,j) *" in src else set())
    stmts = []
    for pkg, F in ((rc, RF), (tc, TF)):
        tensors = {}
        for k, d in dense.items():
            fm = (F.CSR() if d.ndim == 2 else F.CSF(3)) if k in sparse \
                else None
            tensors[k] = pkg.Tensor.from_dense(k, d, fm)
        stmts.append(pkg.parse_tin(src, **tensors))
    r, t = stmts
    assert t.signature() == r.signature()
    assert [v.name for v in t.result_vars] == [v.name for v in r.result_vars]


@pytest.mark.parametrize("name,ctor,order", FORMATS, ids=IDS)
def test_storage_fingerprint_and_walks(name, ctor, order):
    r, t, d = _pair(name, ctor, order)
    assert TF.format_key(t.format) == RF.format_key(r.format)
    assert _storage(t) == _storage(r)
    assert t.fingerprint() == r.fingerprint()
    np.testing.assert_array_equal(t.to_dense(), d)
    for walk in ("walk", "row_walk"):
        rw, tw = getattr(r.level_tree(), walk)(), \
            getattr(t.level_tree(), walk)()
        assert tw.ordered == rw.ordered
        np.testing.assert_array_equal(tw.perm, rw.perm)
        np.testing.assert_array_equal(tw.coords, rw.coords)


@pytest.mark.parametrize("name,ctor,order", FORMATS, ids=IDS)
def test_from_storage_round_trip(name, ctor, order):
    r, _, d = _pair(name, ctor, order)
    levels = [(ld.pos, ld.crd) for ld in r.levels]
    t = tc.Tensor.from_storage("B", r.shape, RF.format_key(r.format), levels,
                               r.vals)
    assert t.fingerprint() == r.fingerprint()
    assert _storage(t) == _storage(r)
    np.testing.assert_array_equal(t.to_dense(), d)


@pytest.mark.parametrize("pieces", [2, 4])
@pytest.mark.parametrize("name,ctor,order", FORMATS, ids=IDS)
def test_partitions_and_shards(name, ctor, order, pieces):
    r, t, _ = _pair(name, ctor, order)
    bounds = RP.partition_by_bounds(r.shape[0], pieces)
    np.testing.assert_array_equal(TP.partition_by_bounds(r.shape[0], pieces),
                                  bounds)
    rp, tp = RP.partition_tensor_rows(r, bounds), \
        TP.partition_tensor_rows(t, bounds)
    assert _fields(tp) == _fields(rp)
    assert _shards(TP.materialize_csr_rows(t, tp)) == \
        _shards(RP.materialize_csr_rows(r, rp))
    rn, tn = RP.partition_tensor_nonzeros(r, pieces), \
        TP.partition_tensor_nonzeros(t, pieces)
    assert _fields(tn) == _fields(rn)
    assert _shards(TP.materialize_coo_nnz(t, tn)) == \
        _shards(RP.materialize_coo_nnz(r, rn))
    w = np.arange(1, pieces + 1, dtype=np.float64)
    assert _fields(TP.partition_tensor_nonzeros(t, pieces, w)) == \
        _fields(RP.partition_tensor_nonzeros(r, pieces, w))


BLOCKED = [
    ("bcsr22", lambda F: F.BCSR((2, 2))),
    ("bcsr34", lambda F: F.BCSR((3, 4))),
    ("bcsc22", lambda F: F.BCSC((2, 2))),
    ("bcsc41", lambda F: F.BCSC((4, 1))),
]


@pytest.mark.parametrize("name,ctor", BLOCKED, ids=[b[0] for b in BLOCKED])
def test_blocked_storage_round_trip(name, ctor):
    """BCSR and BCSC (block shapes that do not divide 19 x 13) rebuilt from
    their storage arrays: the same fingerprint, storage and dense image."""
    d = _dense(name, 2)
    r, t = (pkg.Tensor.from_dense("B", d, ctor(F))
            for pkg, F in ((rc, RF), (tc, TF)))
    assert t.fingerprint() == r.fingerprint()
    assert _storage(t) == _storage(r)
    levels = [(ld.pos, ld.crd) for ld in r.levels]
    back = tc.Tensor.from_storage("B", r.shape, RF.format_key(r.format),
                                  levels, r.vals)
    assert back.format == ctor(TF)
    assert back.fingerprint() == r.fingerprint()
    assert [ld.size for ld in back.levels] == [ld.size for ld in r.levels]
    np.testing.assert_array_equal(back.to_dense(), d)
    with pytest.raises(ValueError, match="block_shape"):
        TF.format_from_key(RF.format_key(r.format))


@pytest.mark.parametrize("pieces", [2, 4])
@pytest.mark.parametrize("name,ctor", BLOCKED, ids=[b[0] for b in BLOCKED])
def test_blocked_partitions_and_shards(name, ctor, pieces):
    """Block-aligned row bounds, the block-row partitions (BCSC through the
    blocked transpose walk), their materialized shards and the stored-block
    nnz partitions equal the reference's."""
    d = _dense(name, 2)
    r, t = (pkg.Tensor.from_dense("B", d, ctor(F))
            for pkg, F in ((rc, RF), (tc, TF)))
    br = r.format.block_shape[0]
    for n in (r.shape[0], 1, 40):
        np.testing.assert_array_equal(
            TP.block_aligned_row_bounds(n, pieces, br),
            RP.block_aligned_row_bounds(n, pieces, br))
    for bounds in (RP.block_aligned_row_bounds(r.shape[0], pieces, br),
                   RP.partition_by_bounds(r.shape[0], pieces)):
        rp, tp = RP.partition_tensor_rows(r, bounds), \
            TP.partition_tensor_rows(t, bounds)
        assert _fields(tp) == _fields(rp)
        assert _shards(TP.materialize_bcsr_rows(t, tp)) == \
            _shards(RP.materialize_bcsr_rows(r, rp))
    w = np.arange(1, pieces + 1, dtype=np.float64)
    for weights in (None, w):
        assert _fields(TP.partition_tensor_nonzeros(t, pieces, weights)) == \
            _fields(RP.partition_tensor_nonzeros(r, pieces, weights))


@pytest.mark.parametrize("ctor", [lambda F: F.CSR(), lambda F: F.CSC(),
                                  lambda F: F.COO(2),
                                  lambda F: F.BCSR((2, 2)),
                                  lambda F: F.BCSC((3, 2))],
                         ids=["csr", "csc", "coo", "bcsr", "bcsc"])
def test_add_stream_matches_reference(ctor):
    """The SpAdd nnz strategy's shards: the concatenated entry (or block)
    stream cut into equal or weighted chunks; arrays, meta and the
    ADD_STREAM_STATS hit/miss counts equal the reference's."""
    ds = [_dense(k, 2) for k in ("b", "c", "d")]
    out = []
    for pkg, F, P in ((rc, RF, RP), (tc, TF, TP)):
        ts = [pkg.Tensor.from_dense(k, d, ctor(F))
              for k, d in zip("BCD", ds)]
        P.clear_shard_cache()
        before = dict(P.ADD_STREAM_STATS)
        shards = [_shards(P.materialize_add_stream(ts, pieces, w))
                  for pieces, w in ((3, None), (3, None),
                                    (4, np.array([1.0, 2.0, 0.5, 3.0])))]
        stats = {k: P.ADD_STREAM_STATS[k] - before[k] for k in before}
        out.append((shards, stats))
    assert out[1] == out[0]
    assert out[0][1] == {"hits": 1, "misses": 2}


def test_convert_cache_and_counters():
    r, t, _ = _pair("csc", FORMATS[1][1], 2)
    TP.clear_convert_cache()
    before = dict(TP.CONVERT_CACHE_STATS)
    out = TP.convert_tensor_cached(t, TF.CSR())
    again = TP.convert_tensor_cached(t, TF.CSR())
    assert again is out
    assert TP.CONVERT_CACHE_STATS["misses"] - before["misses"] == 1
    assert TP.CONVERT_CACHE_STATS["hits"] - before["hits"] == 1
    assert _storage(out) == _storage(r.to_format(RF.CSR()))


def test_lru_cache_and_batch_buckets():
    c = TCache.LRUCache(capacity=2)
    c.put("a", 1)
    c.put("b", None)
    assert c.get_or_build("b", lambda: 7) is None
    c.put("c", 3)
    assert "a" not in c and c.stats == {"hits": 1, "misses": 0,
                                        "evictions": 1}
    for n in (1, 3, 9, 64, 65, 1000):
        assert TCache.batch_bucket(n) == RCache.batch_bucket(n)


@pytest.mark.parametrize("seed", [0, 3])
def test_generators_match_reference(seed):
    r = r_spdata.powerlaw_matrix("B", 300, 200, 6, seed=seed)
    t = t_spdata.powerlaw_matrix("B", 300, 200, 6, seed=seed)
    assert t.fingerprint() == r.fingerprint()
    r = r_spdata.uniform_sparse("U", (40, 30), 0.1, seed=seed)
    t = t_spdata.uniform_sparse("U", (40, 30), 0.1, seed=seed)
    assert t.fingerprint() == r.fingerprint()


@pytest.mark.parametrize("seed", [0, 3])
def test_powerlaw_tensor3_matches_reference(seed):
    """Entry for entry: the same CSF levels and values from the same seed."""
    r = r_spdata.powerlaw_tensor3("B", (300, 40, 50), avg_nnz_per_slice=6,
                                  seed=seed)
    t = t_spdata.powerlaw_tensor3("B", (300, 40, 50), avg_nnz_per_slice=6,
                                  seed=seed)
    assert t.fingerprint() == r.fingerprint()
    np.testing.assert_array_equal(t.coords(), r.coords())
    np.testing.assert_array_equal(t.vals, r.vals)
    assert t.nnz == r.nnz > 300


@pytest.mark.parametrize("name,ctor,order", FORMATS[:4], ids=IDS[:4])
def test_interp_matches_reference(name, ctor, order):
    rng = np.random.default_rng(7)
    d = _dense(name, order)
    C = rng.standard_normal((d.shape[1], 3)).astype(np.float32)
    out = []
    for pkg, F in ((rc, RF), (tc, TF)):
        stmt = pkg.parse_tin(
            "A(i,j) = B(i,k) * C(k,j)",
            A=pkg.Tensor.zeros_dense("A", (d.shape[0], 3)),
            B=pkg.Tensor.from_dense("B", d, ctor(F)),
            C=pkg.Tensor.from_dense("C", C))
        out.append(r_interpret(stmt) if pkg is rc
                   else t_interpret(stmt, device="cpu"))
    np.testing.assert_allclose(out[1], out[0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out[1], d @ C, atol=1e-4, rtol=1e-4)


def test_tracer_records_the_lower_taxonomy():
    d = _dense("csr", 2)
    stmt = tc.parse_tin("a(i) = B(i,j) * c(j)",
                        a=tc.Tensor.zeros_dense("a", (d.shape[0],)),
                        B=tc.Tensor.from_dense("B", d, TF.CSR()),
                        c=tc.Tensor.from_dense(
                            "c", np.ones(d.shape[1], np.float32)))
    tc.clear_lowering_caches()
    TT.TRACER.clear()
    TT.TRACER.enable()
    try:
        tc.lower_stmt(stmt, tc.Machine(("x", 2)), device="cpu")
    finally:
        TT.TRACER.disable()
    names = {e["name"] for e in TT.TRACER.spans()}
    TT.TRACER.clear()
    assert {"lower", "lower.plan", "lower.materialize", "lower.emit",
            "lower.jit", "partition.materialize"} <= names
    snap = TT.METRICS.snapshot()
    assert snap["counters"]["lower.count"] >= 1
    assert {"plan", "runner", "shard", "convert"} <= set(snap["caches"])
