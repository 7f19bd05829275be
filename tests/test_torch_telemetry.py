"""The port's telemetry against the JAX package's, on the CPU (twins of
tests/test_telemetry.py): the span tracer and its Chrome export, the
autoscheduler's scored candidates in ``explain()`` and its
``tuned_plan`` cache source, the metrics snapshot and its markdown
render, the byte-ledger
verifier (its reports must equal the reference's for the same statement,
schedule and machine, over the 1-D census cells and the grids),
``profile_pieces`` feeding a weighted re-plan, the logger hierarchy, the
smoke trace and its CLI, and the span-derived recovery report. The
straggler sleeps are 1 s, twenty times the reference's, and that loop runs
with one torch thread, so that a slow step stays above 4× the median step
time on a host running six test workers."""
import json
import logging
import os
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import formats as RF
from repro.core import lower as RL
from repro.launch import report as RR
from repro.runtime import telemetry as RT

import repro_torch.core as tc
from repro_torch.core import formats as TF
from repro_torch.core import lower as TL
from repro_torch.core.interp import interpret
from repro_torch.distributed.executor import profile_pieces
from repro_torch.launch.report import _fmt_bytes, telemetry_table
from repro_torch.runtime import telemetry
from repro_torch.runtime.elastic import run_with_recovery
from repro_torch.runtime.fault import (FaultEvent, FaultInjector,
                                       StragglerMitigator)

from test_torch_lower import CELLS, _arrays, _stmt

ROOT = Path(__file__).resolve().parents[1]
M4 = tc.Machine(("x", 4))
M22 = tc.Machine(("x", 2), ("y", 2))
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


def _sparse(rng, n, m, density=0.25, ints=False):
    mask = rng.random((n, m)) < density
    v = (rng.integers(-3, 4, (n, m)).astype(np.float32) if ints
         else rng.standard_normal((n, m)).astype(np.float32))
    d = (mask * v).astype(np.float32)
    d[rng.integers(0, n)] = 0                                   # empty row
    return d


def _spmv(core=tc, fm=None, n=19, m=13, seed=1):
    rng = np.random.default_rng(seed)
    B = core.Tensor.from_dense("B", _sparse(rng, n, m),
                               fm if fm is not None else core.CSR())
    c = core.Tensor.from_dense("c", rng.standard_normal(m).astype(np.float32))
    return core.parse_tin("a(i) = B(i,j) * c(j)",
                          a=core.Tensor.zeros_dense("a", (n,)), B=B, c=c)


def _spmm(core=tc, n=48, m=40, j=8, seed=2, fm=None):
    rng = np.random.default_rng(seed)
    B = core.Tensor.from_dense("B", _sparse(rng, n, m),
                               fm if fm is not None else core.CSR())
    C = core.Tensor.from_dense(
        "C", rng.standard_normal((m, j)).astype(np.float32))
    return core.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                          A=core.Tensor.zeros_dense("A", (n, j)), B=B, C=C)


# ---------------------------------------------------------------------------
# Tracer core: nesting, threads, Chrome export round-trip
# ---------------------------------------------------------------------------

def test_span_nesting_and_chrome_roundtrip(tmp_path):
    tr = telemetry.Tracer(enabled=True)
    with tr.span("outer", who="test"):
        with tr.span("inner.a", k=1, arr=np.int64(3), t=(1, 2)):
            pass
        with tr.span("inner.b"):
            with tr.span("leaf"):
                pass
        tr.instant("tick", n=7)

    def worker():
        with tr.span("thread.root"):
            pass

    t = threading.Thread(target=worker)
    t.start()
    t.join()

    path = str(tmp_path / "sub" / "trace.json")
    assert tr.export_chrome(path) == path
    counts = telemetry.validate_chrome_trace(
        path, require=("outer", "inner.a", "inner.b", "leaf",
                       "tick", "thread.root"))
    assert counts["outer"] == 1 and counts["tick"] == 1
    # the reference's validator takes the port's trace as it is
    assert RT.validate_chrome_trace(path) == counts
    payload = json.load(open(path))
    ev = {e["name"]: e for e in payload["traceEvents"]}
    assert ev["inner.a"]["args"]["arr"] == 3
    assert ev["inner.a"]["args"]["t"] == [1, 2]
    assert ev["inner.a"]["args"]["parent_id"] == ev["outer"]["args"][
        "span_id"]
    assert ev["tick"]["ph"] == "i" and ev["outer"]["ph"] == "X"

    roots = tr.call_tree()
    assert {r["name"] for r in roots} == {"outer", "thread.root"}
    outer = next(r for r in roots if r["name"] == "outer")
    assert {c["name"] for c in outer["children"]} == {"inner.a", "inner.b"}
    inner_b = next(c for c in outer["children"] if c["name"] == "inner.b")
    assert [c["name"] for c in inner_b["children"]] == ["leaf"]
    assert outer["args"] == {"who": "test"}
    assert outer["dur_us"] >= inner_b["dur_us"] >= inner_b["children"][0][
        "dur_us"]


def test_validate_chrome_trace_rejects_bad_traces(tmp_path):
    bad = [{"nope": []}, {"traceEvents": []},
           {"traceEvents": [{"name": "x", "ph": "B", "ts": 0, "pid": 1,
                             "tid": 1}]},
           {"traceEvents": [{"name": "x", "ph": "X", "ts": 0, "pid": 1,
                             "tid": 1, "dur": -1}]}]
    for i, payload in enumerate(bad):
        p = tmp_path / f"bad{i}.json"
        p.write_text(json.dumps(payload))
        with pytest.raises(AssertionError):
            telemetry.validate_chrome_trace(str(p))
    p = tmp_path / "ok.json"
    p.write_text(json.dumps({"traceEvents": [
        {"name": "x", "ph": "i", "ts": 0, "pid": 1, "tid": 1}]}))
    with pytest.raises(AssertionError, match="missing"):
        telemetry.validate_chrome_trace(str(p), require=("y",))


def test_disabled_tracer_is_noop_and_cheap():
    tr = telemetry.Tracer(enabled=False)
    with tr.span("never", big=list(range(100))) as sp:
        sp.set(late=1)
    tr.instant("never.i")
    assert tr.spans() == []
    assert tr.span("a") is tr.span("b")

    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with tr.span("x", a=1):
            pass
    unit = (time.perf_counter() - t0) / n
    assert unit < 20e-6


def test_disabled_tracer_no_measurable_warm_relower_overhead():
    stmt = _spmv()
    TL.clear_lowering_caches()
    assert not telemetry.TRACER.enabled
    TL.lower(stmt, M4, device="cpu")

    t0 = time.perf_counter()
    k = TL.lower(stmt, M4, device="cpu")
    warm_s = time.perf_counter() - t0
    assert k.cache.warm

    telemetry.TRACER.clear()
    telemetry.TRACER.enable()
    try:
        TL.lower(stmt, M4, device="cpu")
        n_events = len(telemetry.TRACER.spans())
    finally:
        telemetry.TRACER.disable()
        telemetry.TRACER.clear()
    assert n_events > 0

    tr = telemetry.Tracer(enabled=False)
    reps = 5000
    t0 = time.perf_counter()
    for _ in range(reps):
        with tr.span("x", a=1):
            pass
    unit = (time.perf_counter() - t0) / reps
    assert n_events * unit < max(warm_s, 1e-4) * 0.05


# ---------------------------------------------------------------------------
# The smoke trace, in process and through the CLI
# ---------------------------------------------------------------------------

def test_smoke_trace_grid_spmm(tmp_path):
    path = str(tmp_path / "TRACE_smoke.json")
    counts = telemetry.smoke_trace(path, n=128, m=128, j=8, device="cpu")
    for name in ("lower", "lower.plan", "lower.materialize", "lower.jit",
                 "lower.emit", "execute", "execute.piece"):
        assert counts.get(name, 0) >= 1, f"missing span {name}"
    assert counts["execute.piece"] >= 4
    roots = telemetry.TRACER.call_tree()
    lower_roots = [r for r in roots if r["name"] == "lower"]
    assert lower_roots
    kids = {c["name"] for r in lower_roots for c in r["children"]}
    assert {"lower.plan", "lower.materialize", "lower.emit"} <= kids
    telemetry.TRACER.clear()


def test_smoke_trace_needs_a_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        telemetry.smoke_trace(str(tmp_path / "t.json"), n=64, m=64, j=4)
    telemetry.TRACER.clear()


def test_telemetry_cli_smoke_and_validate(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = tmp_path / "T.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.runtime.telemetry", "--smoke",
         "--device", "cpu", "--out", str(out)], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert f"wrote {out}" in run.stdout
    counts = json.loads(run.stdout.split("\n", 1)[1])
    assert counts["execute.piece"] >= 4 and counts["lower"] >= 1
    val = subprocess.run(
        [sys.executable, "-m", "repro_torch.runtime.telemetry",
         "--validate", str(out)], env=env, capture_output=True, text=True,
        timeout=120)
    assert val.returncode == 0 and json.loads(val.stdout) == counts
    none = subprocess.run(
        [sys.executable, "-m", "repro_torch.runtime.telemetry"], env=env,
        capture_output=True, text=True, timeout=120)
    assert none.returncode == 2


# ---------------------------------------------------------------------------
# Byte-ledger verification: model vs recorded CommStats, as the reference
# ---------------------------------------------------------------------------

def _both(expr, fmt_name, fm, strategy, machine_dims, seed_tag):
    """(port kernel, reference kernel) of one cell over the same arrays."""
    rng = np.random.default_rng(zlib.crc32(seed_tag.encode()))
    arrays = _arrays(expr, rng, False)
    out = []
    for core, F, kw in ((tc, TF, {"device": "cpu"}), (rc, RF, {})):
        stmt = _stmt(core, F, expr, fm, *arrays)
        machine = core.Machine(*zip("xyz", machine_dims))
        L = core.lower
        sched = {"rows": L.default_row_schedule,
                 "nnz": L.default_nnz_schedule,
                 "grid": L.default_grid_schedule,
                 "grid_nnz": L.default_grid_nnz_schedule}[strategy](
            stmt, machine)
        L.clear_lowering_caches()
        out.append(L.lower(stmt, machine, schedule=sched, **kw))
    return out


_LEDGER_CELLS = ([(e, f, fm, s, (4,)) for e, f, fm in CELLS
                  for s in ("rows", "nnz")]
                 + [(e, "csr", lambda F: F.CSR(), s, (2, 2))
                    for e in ("spmv", "spmm", "sddmm")
                    for s in ("grid", "grid_nnz") if (e, s) !=
                    ("sddmm", "grid_nnz")])


@pytest.mark.parametrize(
    "expr,fmt_name,fm,strategy,dims", _LEDGER_CELLS,
    ids=[f"{c[0]}-{c[1]}-{c[3]}-{'x'.join(map(str, c[4]))}"
         for c in _LEDGER_CELLS])
def test_byte_ledger_as_reference(expr, fmt_name, fm, strategy, dims):
    tk, rk = _both(expr, fmt_name, fm, strategy, dims,
                   f"{expr}/{fmt_name}/{strategy}/{dims}")
    got = telemetry.verify_byte_ledger(tk)
    assert got["ok"] and got["checks"]
    assert got == RT.verify_byte_ledger(rk)


@pytest.mark.parametrize("mk, sched", [
    (lambda: _spmv(fm=tc.CSR()), TL.default_row_schedule),
    (lambda: _spmv(fm=tc.CSC()), TL.default_nnz_schedule),
    (lambda: _spmm(), TL.default_nnz_schedule),
    (lambda: _spmm(), TL.default_grid_schedule),
], ids=["rows", "csc-nnz", "nnz", "grid"])
def test_byte_ledger_agrees(mk, sched):
    stmt = mk()
    machine = M22 if sched is TL.default_grid_schedule else M4
    TL.clear_lowering_caches()
    k = TL.lower(stmt, machine, schedule=sched(stmt, machine), device="cpu")
    rep = telemetry.verify_byte_ledger(k)
    assert rep["ok"] and rep["checks"]
    np.testing.assert_allclose(k.run().numpy(), interpret(stmt, device="cpu"),
                               atol=1e-3)


@pytest.mark.parametrize("blocked", [False, True])
def test_byte_ledger_spadd3_nnz(blocked):
    n, m = 24, 20
    reports = []
    for core, kw in ((tc, {"device": "cpu"}), (rc, {})):
        fm = core.BCSR((4, 4)) if blocked else core.CSR()

        def mk(name, seed):
            return core.Tensor.from_dense(
                name, _sparse(np.random.default_rng(seed), n, m), fm)

        stmt = core.parse_tin(
            "A(i,j) = B(i,j) + C(i,j) + D(i,j)",
            A=core.Tensor.zeros_dense("A", (n, m)),
            B=mk("B", 1), C=mk("C", 2), D=mk("D", 3))
        L = core.lower
        L.clear_lowering_caches()
        machine = core.Machine(("x", 4))
        k = L.lower(stmt, machine,
                    schedule=L.default_nnz_schedule(stmt, machine), **kw)
        reports.append((RT if core is rc else telemetry)
                       .verify_byte_ledger(k))
    assert reports[0]["ok"] and reports[0] == reports[1]


def test_byte_ledger_catches_tampering():
    stmt = _spmv()
    TL.clear_lowering_caches()
    k = TL.lower(stmt, M4, schedule=TL.default_row_schedule(stmt, M4),
                 device="cpu")
    telemetry.verify_byte_ledger(k)
    k.comm.replicate_bytes += 1
    with pytest.raises(AssertionError, match="byte-ledger mismatch"):
        telemetry.verify_byte_ledger(k)
    g = TL.lower(_spmm(), M22, schedule=TL.default_grid_schedule(_spmm(),
                                                                 M22),
                 device="cpu")
    g.comm.axes["y"].reduce_bytes += 4
    with pytest.raises(AssertionError, match=r"reduce\[y\]"):
        telemetry.verify_byte_ledger(g)


# ---------------------------------------------------------------------------
# Per-piece kernel profiling -> skew -> weighted re-plan
# ---------------------------------------------------------------------------

def test_profile_pieces_feeds_weighted_replan():
    stmt = _spmm()
    TL.clear_lowering_caches()
    telemetry.METRICS.clear()
    k = TL.lower(stmt, M4, schedule=TL.default_nnz_schedule(stmt, M4),
                 device="cpu")
    ref = k.run().numpy()
    prof = profile_pieces(k, iters=2, warmup=1)
    assert prof.leaf_name == k.leaf_name
    assert prof.seconds.shape == (k.strategy.pieces,)
    assert np.all(prof.seconds > 0) and prof.skew() >= 1.0
    w = prof.replan_weights()
    assert w.shape == prof.seconds.shape
    assert abs(w.mean() - 1.0) < 1e-6
    assert np.argmin(w) == np.argmax(prof.seconds)
    k2 = TL.relower(k, M4, weights=w)
    np.testing.assert_allclose(k2.run().numpy(), ref, atol=1e-4)
    snap = telemetry.METRICS.snapshot()
    h = snap["histograms"]["executor.piece_seconds"]
    assert h["count"] == k.strategy.pieces
    assert snap["gauges"]["executor.piece_skew"] == pytest.approx(
        prof.skew())


def test_profile_pieces_grid_leaf():
    stmt = _spmm()
    TL.clear_lowering_caches()
    k = TL.lower(stmt, M22, schedule=TL.default_grid_schedule(stmt, M22),
                 device="cpu")
    prof = profile_pieces(k, iters=1, warmup=1)
    assert prof.seconds.shape == (k.strategy.pieces,)
    assert not prof.stragglers(threshold=1e9)


# ---------------------------------------------------------------------------
# Metrics registry, snapshot render, logging namespaces
# ---------------------------------------------------------------------------

def test_metrics_snapshot_and_render():
    stmt = _spmv()
    TL.clear_lowering_caches()
    telemetry.METRICS.clear()
    TL.lower(stmt, M4, device="cpu")
    TL.lower(stmt, M4, device="cpu")
    telemetry.METRICS.observe("serve.latency_ms", 2.5)
    telemetry.METRICS.gauge("serve.queue_depth", 3)
    snap = telemetry.METRICS.snapshot()
    assert snap["counters"]["lower.count"] == 2
    assert snap["counters"]["lower.warm_count"] >= 1
    assert snap["counters"]["comm.network_bytes"] > 0
    assert snap["caches"]["plan"]["hits"] >= 1
    assert "add_stream" in snap["caches"]
    md = telemetry_table(snap)
    assert "### Caches" in md and "lower.count" in md
    assert md == RR.telemetry_table(snap)
    assert telemetry_table({}) == "(empty telemetry snapshot)"
    telemetry.METRICS.clear()
    assert telemetry.METRICS.snapshot()["counters"] == {}


def test_explain_lists_scored_candidates():
    """``schedule="auto"`` with the default search (the H100 constants, the
    model's top 3 measured, here on the CPU): ``explain()`` names the
    winner and lists every candidate, the reference's, with the winner
    marked; a hand-picked schedule says so instead."""
    from repro.core import plan_search as RPS
    stmt = _spmv()
    TL.clear_lowering_caches()
    k = TL.lower(stmt, M4, schedule="auto", device="cpu")
    assert k.tuned is not None and k.tuned.candidates
    assert len(k.tuned.candidates) >= 2
    txt = k.explain()
    assert "autoscheduler winner" in txt and "<- winner" in txt
    assert txt.count("<- winner") == 1
    for c in k.tuned.candidates:
        assert c["label"] in txt
    measured = [c for c in k.tuned.candidates if c["measured_s"] is not None]
    assert len(measured) == min(3, len(k.tuned.candidates))
    r_stmt = _spmv(rc)
    want = RPS.search(r_stmt, rc.Machine(("x", 4)),
                      config=RPS.SearchConfig(refine_top_k=0))
    assert sorted(c["label"] for c in k.tuned.candidates) == \
        sorted(c["label"] for c in want.candidates)
    k2 = TL.lower(stmt, M4, schedule=TL.default_row_schedule(stmt, M4),
                  device="cpu")
    assert "hand-picked schedule" in k2.explain()
    assert "comm:" in k2.explain()
    snap = telemetry.METRICS.snapshot()
    assert snap["caches"]["tuned_plan"]["misses"] >= 1


@pytest.mark.parametrize("n", [0, 17, 1023, 1024, 5 << 20, 3 << 30,
                               7 << 42, -2048])
def test_fmt_bytes_as_reference(n):
    assert _fmt_bytes(n) == RR._fmt_bytes(n)


def test_report_cli_renders_a_snapshot(tmp_path):
    p = tmp_path / "snap.json"
    snap = {"counters": {"comm.reduce_bytes": 4096, "lower.count": 2}}
    p.write_text(json.dumps({"telemetry": snap}))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report", "--telemetry",
         str(p)], env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0
    assert run.stdout.strip() == telemetry_table(snap).strip()


def test_logger_namespaces_and_configure_logging():
    from repro_torch.core import plan_search as PS
    assert TL.log.name == "repro_torch.core.lower"
    assert PS.log.name == "repro_torch.core.plan_search"
    root = telemetry.configure_logging(logging.DEBUG)
    assert root.name == "repro_torch" and root.level == logging.DEBUG
    assert root.handlers
    n = len(root.handlers)
    telemetry.configure_logging(logging.INFO)
    assert len(root.handlers) == n
    assert TL.log.getEffectiveLevel() == logging.INFO
    root.setLevel(logging.NOTSET)


# ---------------------------------------------------------------------------
# Recovery: span-derived report — splits sum exactly to recovery_s
# ---------------------------------------------------------------------------

def test_recovery_report_splits_sum_exactly(tmp_path_factory,
                                            one_torch_thread):
    rng = np.random.default_rng(9)
    dB = _sparse(rng, 48, 40, ints=True)
    dC = rng.integers(-3, 4, (40, 8)).astype(np.float32)

    def mkstmt():
        B = tc.Tensor.from_dense("B", dB.copy(), tc.CSR())
        C = tc.Tensor.from_dense("C", dC.copy())
        return tc.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                            A=tc.Tensor.zeros_dense("A", (48, 8)), B=B, C=C)

    s0 = mkstmt()
    TL.clear_lowering_caches()
    ref, _ = run_with_recovery(s0, M4, 8,
                               ckpt_dir=str(tmp_path_factory.mktemp("r")),
                               schedule=TL.default_nnz_schedule(s0, M4),
                               device="cpu")
    TL.clear_lowering_caches()
    s1 = mkstmt()
    inj = FaultInjector(
        [FaultEvent(step=s, kind="straggler", piece=2,
                    slowdown_s=STRAGGLER_S) for s in (2, 3, 4)]
        + [FaultEvent(step=6, kind="device_loss", piece=1)])
    mit = StragglerMitigator(4, report_budget=2)
    tr = telemetry.TRACER
    tr.clear()
    tr.enable()
    try:
        state, rep = run_with_recovery(
            s1, M4, 8, ckpt_dir=str(tmp_path_factory.mktemp("f")),
            schedule=TL.default_nnz_schedule(s1, M4), injector=inj,
            mitigator=mit, device="cpu")
        names = {e["name"] for e in tr.spans()}
    finally:
        tr.disable()
        tr.clear()
    assert torch.equal(state, ref)
    assert rep.replans >= 1 and rep.restarts == 1
    assert rep.recovery_s > 0
    split_sum = rep.restore_s + rep.replan_s + rep.rejit_s
    assert abs(split_sum - rep.recovery_s) < 1e-9
    assert rep.restore_s > 0 and rep.replan_s > 0 and rep.rejit_s > 0
    # the phases are on the global tracer too when it is on
    assert {"recovery.restore", "recovery.replan",
            "recovery.rejit"} <= names
