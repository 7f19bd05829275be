"""The port's lowering against the JAX package's, cell by cell.

Cells: {spmv, spmm, sddmm, spadd3} × {csr, csc, dcsr, coo, bcsr, bcsc} and
{spttv, spmttkrp} × {csf, dcsf, coo3}, each × {rows, nnz} × pieces {2, 4},
plus the all-zero operand cells and the blocked cells of SpMV, SpMM and
SDDMM with non-square (4, 8) blocks. The statement is built from the same
numpy arrays in both
packages (the statement code of tests/conformance.py and, for SpTTV, of
tests/test_lower.py::test_spttv, copied here: importing conformance would
register its census a second time).
``cell_id``, ``leaf_name``, ``fallbacks``, the ``CommStats`` ledger and the
cache counters of a cold and a warm lower must be equal (for SpAdd3 also the
``ADD_STREAM_STATS`` counts and the output's format and stored coordinates);
``run()`` (densified for the sparse outputs of SpAdd3, SDDMM and SpTTV) must
be allclose to the reference's and to both interpreters at 1e-3."""
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import formats as RF
from repro.core import partition as RP
from repro.core.tensor import LevelData as RLevelData
from repro.core.interp import interpret as r_interpret
from repro.core.lower import lower as r_lower

import repro_torch.core as tc
from repro_torch.core import formats as TF
from repro_torch.core import partition as TP
from repro_torch.core.interp import interpret as t_interpret
from repro_torch.core.lower import lower as t_lower
from repro_torch.kernels import _build

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

FORMATS = [
    ("csr", lambda F: F.CSR()),
    ("csc", lambda F: F.CSC()),
    ("dcsr", lambda F: F.DCSR()),
    ("coo", lambda F: F.COO(2)),
]
FORMATS_3D = [
    ("csf", lambda F: F.CSF(3)),
    ("dcsf", lambda F: F.DCSF(3)),
    ("coo3", lambda F: F.COO(3)),
]
FORMATS_BLOCKED = [
    ("bcsr", lambda F: F.BCSR((2, 2))),
    ("bcsc", lambda F: F.BCSC((2, 2))),
]
FORMATS_ADD = FORMATS + FORMATS_BLOCKED
CELLS = ([(e, *f) for e in ("spmv", "spmm", "sddmm") for f in FORMATS_ADD]
         + [("spadd3", *f) for f in FORMATS_ADD]
         + [(e, *f) for e in ("spttv", "spmttkrp") for f in FORMATS_3D])
# The reference's scalar rows union leaf raises on all-zero operands
# (ROADMAP Queue 3): there the port is held to the interpreters alone.
REFERENCE_RAISES = {("spadd3", f, "rows", True)
                    for f in ("csr", "csc", "dcsr", "coo")}


def _sparse_2d(rng, n, m, density=0.25):
    d = ((rng.random((n, m)) < density) *
         rng.standard_normal((n, m))).astype(np.float32)
    d[rng.integers(0, n)] = 0                                   # empty row
    d[rng.integers(0, n)] = rng.standard_normal(m).astype(np.float32)  # skew
    return d


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _arrays(expr, rng, empty):
    """The cell's operands as numpy arrays: B first, then the dense ones."""
    if expr == "spttv":
        dims = (20, 15, 11)
        dB3 = ((rng.random(dims) < 0.1) *
               rng.standard_normal(dims)).astype(np.float32)
        return dB3, _normal(rng, dims[2])
    if expr == "spmttkrp":
        dims, L = (16, 9, 7), 4
        dB3 = ((rng.random(dims) < 0.12) *
               rng.standard_normal(dims)).astype(np.float32)
        dB3[rng.integers(0, dims[0])] = 0                       # empty slice
        return dB3, _normal(rng, (dims[1], L)), _normal(rng, (dims[2], L))
    n, m, K = 19, 13, 5
    dB = np.zeros((n, m), np.float32) if empty else _sparse_2d(rng, n, m)
    if expr == "spadd3":
        return (dB,) + tuple(np.zeros((n, m), np.float32) if empty
                             else _sparse_2d(rng, n, m, d)
                             for d in (0.15, 0.1))
    if expr == "spmv":
        return dB, _normal(rng, m)
    if expr == "spmm":
        return dB, _normal(rng, (m, 7))
    return dB, _normal(rng, (n, K)), _normal(rng, (K, m))


def _stmt(pkg, F, expr, fm, dB, *dense):
    n = dB.shape[0]
    B = pkg.Tensor.from_dense("B", dB, fm(F))
    ops = {name: pkg.Tensor.from_dense(name, x)
           for name, x in zip("CD", dense)}
    if expr == "spmv":
        return pkg.parse_tin("a(i) = B(i,j) * c(j)",
                             a=pkg.Tensor.zeros_dense("a", (n,)), B=B,
                             c=pkg.Tensor.from_dense("c", dense[0]))
    if expr == "spmm":
        return pkg.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                             A=pkg.Tensor.zeros_dense("A", (n, 7)), B=B,
                             **ops)
    if expr == "spadd3":
        return pkg.parse_tin(
            "A(i,j) = B(i,j) + C(i,j) + D(i,j)",
            A=pkg.Tensor.from_dense("A", np.zeros_like(dB), F.CSR()), B=B,
            **{name: pkg.Tensor.from_dense(name, x, fm(F))
               for name, x in zip("CD", dense)})
    if expr == "sddmm":
        return pkg.parse_tin("A(i,j) = B(i,j) * C(i,k) * D(k,j)",
                             A=pkg.Tensor.from_dense("A", (dB != 0) * 1.0,
                                                     F.CSR()), B=B, **ops)
    if expr == "spttv":
        return pkg.parse_tin(
            "A(i,j) = B(i,j,k) * c(k)",
            A=pkg.Tensor.from_dense(
                "A", np.einsum("ijk,k->ij", dB, dense[0]) * 0, F.CSR()),
            B=B, c=pkg.Tensor.from_dense("c", dense[0]))
    return pkg.parse_tin("A(i,l) = B(i,j,k) * C(j,l) * D(k,l)",
                         A=pkg.Tensor.zeros_dense("A", (n, dense[0].shape[1])),
                         B=B, **ops)


def _lower_twice(pkg, lower, stmt, strategy, pieces, stats, **kw):
    """Cold and warm lowers, and the ADD_STREAM_STATS counts of each."""
    machine = pkg.Machine(("x", pieces))
    sched = (pkg.lower.default_row_schedule if strategy == "rows"
             else pkg.lower.default_nnz_schedule)(stmt, machine)
    pkg.clear_lowering_caches()
    counts = []
    for _ in range(2):
        before = dict(stats)
        counts.append((lower(stmt, machine, schedule=sched, **kw),
                       {k: stats[k] - before[k] for k in stats}))
    return counts


def _check_cell(expr, fmt_name, fm, strategy, pieces, empty=False):
    cell_tag = f"{expr}/{fmt_name}/{strategy}/{pieces}/{empty}"
    rng = np.random.default_rng(zlib.crc32(cell_tag.encode()))
    arrays = _arrays(expr, rng, empty)
    r_stmt = _stmt(rc, RF, expr, fm, *arrays)
    t_stmt = _stmt(tc, TF, expr, fm, *arrays)
    (r_cold, r_add0), (r_warm, r_add1) = _lower_twice(
        rc, r_lower, r_stmt, strategy, pieces, RP.ADD_STREAM_STATS)
    (t_cold, t_add0), (t_warm, t_add1) = _lower_twice(
        tc, t_lower, t_stmt, strategy, pieces, TP.ADD_STREAM_STATS,
        device="cpu")
    assert (t_add0, t_add1) == (r_add0, r_add1)
    assert t_cold.cell_id() == r_cold.cell_id()
    assert t_cold.leaf_name == r_cold.leaf_name
    assert t_cold.fallbacks == r_cold.fallbacks == []
    assert t_cold.comm.as_dict() == r_cold.comm.as_dict()
    assert t_cold.cache.as_dict() == r_cold.cache.as_dict()
    assert t_warm.cache.as_dict() == r_warm.cache.as_dict()
    assert t_warm.cache.warm
    assert t_cold.imbalance() == r_cold.imbalance()
    assert t_cold.explain().startswith(f"kernel {r_cold.cell_id()}")
    got = t_warm.run()
    if (expr, fmt_name, strategy, empty) in REFERENCE_RAISES:
        with pytest.raises(ValueError):
            r_warm.run()
        want = r_interpret(r_stmt)
    else:
        want = r_warm.run()
    if expr == "spadd3" and not isinstance(want, np.ndarray):
        # the union's stored coordinates, in the reference's storage order
        assert got.format == TF.format_from_key(
            RF.format_key(want.format), want.format.block_shape)
        for gl, wl in zip(got.levels, want.levels):
            assert gl.size == wl.size
            for x, y in ((gl.pos, wl.pos), (gl.crd, wl.crd)):
                assert (x is None) == (y is None)
                if x is not None:
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
        assert got.vals.shape == want.vals.shape
        np.testing.assert_allclose(got.vals, want.vals, atol=1e-3)
    if expr in ("sddmm", "spttv", "spadd3"):
        # a sparse output: the port's Tensor, in the reference's format
        assert isinstance(got, tc.Tensor)
        if not isinstance(want, np.ndarray):
            assert TF.format_key(got.format) == RF.format_key(want.format)
            want = want.to_dense()
        got = got.to_dense()
    else:
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-3)
    np.testing.assert_allclose(got, t_interpret(t_stmt, device="cpu"),
                               atol=1e-3)
    np.testing.assert_allclose(got, r_interpret(r_stmt), atol=1e-3)


@pytest.mark.parametrize("pieces", [2, 4])
@pytest.mark.parametrize("strategy", ["rows", "nnz"])
@pytest.mark.parametrize("expr,fmt_name,fm", CELLS,
                         ids=[f"{c[0]}-{c[1]}" for c in CELLS])
def test_cell(expr, fmt_name, fm, strategy, pieces):
    _check_cell(expr, fmt_name, fm, strategy, pieces)


@pytest.mark.parametrize("strategy", ["rows", "nnz"])
@pytest.mark.parametrize("fmt_name,fm", FORMATS, ids=[f[0] for f in FORMATS])
def test_empty_operand_cell(fmt_name, fm, strategy):
    _check_cell("spmv", fmt_name, fm, strategy, 4, empty=True)


@pytest.mark.parametrize("strategy", ["rows", "nnz"])
@pytest.mark.parametrize("fmt_name,fm", FORMATS_BLOCKED,
                         ids=[f[0] for f in FORMATS_BLOCKED])
@pytest.mark.parametrize("expr", ["spmv", "spmm", "sddmm"])
def test_blocked_empty_operand_cell(expr, fmt_name, fm, strategy):
    """An all-zero blocked operand: no stored block, nothing launched."""
    _check_cell(expr, fmt_name, fm, strategy, 4, empty=True)


@pytest.mark.parametrize("strategy", ["rows", "nnz"])
@pytest.mark.parametrize("fmt_name,fm", [
    ("bcsr", lambda F: F.BCSR((4, 8))), ("bcsc", lambda F: F.BCSC((4, 8)))],
    ids=["bcsr", "bcsc"])
@pytest.mark.parametrize("expr", ["spmv", "spmm", "sddmm"])
def test_blocked_nonsquare_cell(expr, fmt_name, fm, strategy):
    """(4, 8) blocks over a 19 x 13 operand: br != bc, and a ragged last
    block-row and block-column."""
    _check_cell(expr, fmt_name, fm, strategy, 3)


# Blocks with more than 32 rows or more than 256 entries, and ones longer
# or wider than the 19 x 13 operand itself (ROADMAP Queue 3 item 1).
OVERSIZED_BLOCKS = [(33, 1), (16, 32), (1, 300), (64, 8)]


@pytest.mark.parametrize("strategy", ["rows", "nnz"])
@pytest.mark.parametrize("fmt", ["bcsr", "bcsc"])
@pytest.mark.parametrize("block", OVERSIZED_BLOCKS,
                         ids=[f"{b[0]}x{b[1]}" for b in OVERSIZED_BLOCKS])
@pytest.mark.parametrize("expr", ["spmv", "spmm", "sddmm"])
def test_blocked_oversized_cell(expr, block, fmt, strategy):
    """The blocked cells of test_blocked_nonsquare_cell at blocks the
    kernels once refused: each lowers and runs on the CPU and equals the
    reference's run() and both interpreters."""
    make = "BCSR" if fmt == "bcsr" else "BCSC"
    _check_cell(expr, f"{fmt}{block[0]}x{block[1]}",
                lambda F: getattr(F, make)(block), strategy, 3)


@pytest.mark.parametrize("strategy", ["rows", "nnz"])
@pytest.mark.parametrize("fmt_name,fm", FORMATS_ADD,
                         ids=[f[0] for f in FORMATS_ADD])
def test_spadd3_empty_operand_cell(fmt_name, fm, strategy):
    """All three addends empty: an empty union, built without a launch."""
    _check_cell("spadd3", fmt_name, fm, strategy, 4, empty=True)


@pytest.mark.parametrize("strategy", ["rows", "nnz"])
def test_spadd3_unsorted_storage(strategy):
    """CSR storage whose columns are not sorted within a row (handed over
    as plain arrays): the rows shards are sorted once at lower time for the
    union kernel's merge, and the union still equals the reference's."""
    rng = np.random.default_rng(12)
    ds = _arrays("spadd3", rng, False)
    n, m = ds[0].shape
    r_ops, t_ops = {}, {}
    for name, d in zip("BCD", ds):
        t = rc.Tensor.from_dense(name, d, RF.CSR())
        pos, crd, vals = t.levels[1].pos, t.levels[1].crd.copy(), \
            t.vals.copy()
        for r in range(n):               # reverse every row's entries
            lo, hi = pos[r], pos[r + 1]
            crd[lo:hi], vals[lo:hi] = crd[lo:hi][::-1], vals[lo:hi][::-1]
        r_ops[name] = rc.Tensor(name, (n, m), RF.CSR(), [
            t.levels[0], RLevelData(t.levels[1].kind, m, pos, crd)], vals,
            vals.dtype)
        t_ops[name] = tc.Tensor.from_storage(name, (n, m), "csr",
                                             [(None, None), (pos, crd)], vals)
    stmts = [pkg.parse_tin(
        "A(i,j) = B(i,j) + C(i,j) + D(i,j)",
        A=pkg.Tensor.from_dense("A", np.zeros((n, m), np.float32), F.CSR()),
        **ops_) for pkg, F, ops_ in ((rc, RF, r_ops), (tc, TF, t_ops))]
    outs = []
    for pkg, lower, stmt, kw in ((rc, r_lower, stmts[0], {}),
                                 (tc, t_lower, stmts[1], {"device": "cpu"})):
        machine = pkg.Machine(("x", 3))
        sched = (pkg.lower.default_row_schedule if strategy == "rows"
                 else pkg.lower.default_nnz_schedule)(stmt, machine)
        outs.append(lower(stmt, machine, schedule=sched, **kw).run())
    want, got = outs
    np.testing.assert_array_equal(got.levels[1].pos, want.levels[1].pos)
    np.testing.assert_array_equal(got.levels[1].crd, want.levels[1].crd)
    np.testing.assert_allclose(got.vals, want.vals, atol=1e-6)
    assert (np.diff(got.levels[1].crd)[np.diff(np.repeat(
        np.arange(n), np.diff(got.levels[1].pos))) == 0] > 0).all()


def test_weighted_nnz_split_matches_reference():
    rng = np.random.default_rng(3)
    dB, c = _arrays("spmv", rng, False)
    w = np.array([1.0, 3.0, 2.0])
    out = []
    for pkg, F, lower, kw in ((rc, RF, r_lower, {}),
                              (tc, TF, t_lower, {"device": "cpu"})):
        stmt = _stmt(pkg, F, "spmv", lambda F: F.CSR(), dB, c)
        machine = pkg.Machine(("x", 3))
        k = lower(stmt, machine,
                  schedule=pkg.lower.default_nnz_schedule(stmt, machine),
                  weights=w, **kw)
        out.append((k.comm.as_dict(),
                    k.plans["B"].vals_bounds.tolist(),
                    np.asarray(k.run())))
    assert out[0][:2] == out[1][:2]
    np.testing.assert_allclose(out[1][2], out[0][2], atol=1e-3)


@pytest.mark.parametrize("case", ["auto"])
def test_unported_paths_raise(case):
    """Every schedule string the reference takes lowers in the port now:
    ``"auto"`` runs the autoscheduler (tests/test_torch_plan_search.py) and
    gives the reference's winner and result; any other string raises the
    reference's ``ValueError``."""
    rng = np.random.default_rng(0)
    dB, c = _arrays("spmv", rng, False)
    r_stmt = _stmt(rc, RF, "spmv", lambda F: F.CSR(), dB, c)
    stmt = _stmt(tc, TF, "spmv", lambda F: F.CSR(), dB, c)
    machine = tc.Machine(("x", 2))
    k = t_lower(stmt, machine, device="cpu", schedule=case)
    assert k.tuned is not None and k.cache.tuned_misses == 1
    np.testing.assert_allclose(
        k.run().numpy(), np.asarray(r_lower(r_stmt, rc.Machine(("x", 2)),
                                            schedule=case).run()),
        atol=1e-3)
    with pytest.raises(ValueError, match="unknown schedule string"):
        t_lower(stmt, machine, device="cpu", schedule="fast")


def test_chip_smoke_slice_on_cpu():
    """The chip script's two main paths at a tiny size, on the CPU: the ten
    cells lower cold and warm, run, agree with the host computation and
    repeat bit for bit; no kernel launches; every edge case of the kernels
    gives an error of 0.0 against its plain version (on the CPU the wrapper
    is the plain version)."""
    before = dict(_build.LAUNCHES)
    data = chip_smoke.make_inputs(256, 4, 5, seed=0, dims3=(64, 16, 16),
                                  rank=3)
    cells = {}
    for path in (chip_smoke.MATRIX_CELLS, chip_smoke.SLICE_CELLS):
        recs, launches = chip_smoke.run_slice(data, path, pieces=4,
                                              device="cpu", reps=1)
        assert set(launches.values()) == {0}
        cells.update(recs)
    assert sorted(cells) == sorted(
        f"{e}/{s}" for e, s in chip_smoke.MATRIX_CELLS
        + chip_smoke.SLICE_CELLS)
    for name, rec in cells.items():
        expr, strat = name.split("/")
        key = "csf" if expr in ("spttv", "spmttkrp") else "csr"
        assert rec["kernel"].cell_id() == f"{expr}/{key}/{strat}/4x1"
        assert rec["max_abs_err"] < 1e-3
        assert rec["bitwise"] and rec["runs"] >= 3
    assert _build.LAUNCHES == before
    rng = np.random.default_rng(0)
    seen = set()
    for label, name, args, abs_args in chip_smoke.kernel_cases(
            rng, torch.device("cpu")):
        assert chip_smoke.compare_kernel(label, name, args, abs_args) == 0.0
        seen.add(name)
    # the sLSTM kernels' edge cases are SLSTM_CASES, held by their own
    # comparison (tests/test_torch_slstm.py rehearses it)
    assert seen | {"slstm_fwd", "slstm_bwd"} == set(chip_smoke.KERNELS)
    assert {c[1] for c in chip_smoke.SLSTM_CASES} == {1, 2, 127, 4096}


def test_chip_smoke_add_path_on_cpu():
    """The chip script's SpAdd3 path at a tiny size, on the CPU: the four
    lowered cells (CSR and BCSR((4, 4)), rows and nnz) and the two dense
    ops cells run, store exactly the host union's coordinates, agree with
    its values and repeat bit for bit; no kernel launches."""
    before = dict(_build.LAUNCHES)
    data = chip_smoke.make_inputs(256, 4, 5, seed=0)
    data["add"] = chip_smoke.add_operands(256, 0, data["B"])
    data["dense"] = chip_smoke.add_operands(64, 1)
    recs, launches = chip_smoke.run_slice(data, chip_smoke.ADD_CELLS,
                                          pieces=4, device="cpu", reps=1)
    assert set(launches.values()) == {0}
    assert sorted(recs) == sorted(f"{e}/{s}" for e, s in chip_smoke.ADD_CELLS)
    for name, rec in recs.items():
        expr, strat = name.split("/")
        if strat == "ops":
            assert rec["out"].shape == data["dense"]["scalar"][0].shape
        else:
            key = "bcsr" if "bcsr" in expr else "csr"
            assert rec["kernel"].cell_id() == f"spadd3/{key}/{strat}/4x1"
            assert chip_smoke.leaf_call(rec["kernel"]) == rec["call"]
        assert rec["call"][0] in chip_smoke.PATH_KERNELS["add"]
        assert rec["max_abs_err"] < 1e-5
        assert rec["bitwise"] and rec["runs"] >= 3
    assert _build.LAUNCHES == before


def test_chip_smoke_blocked_path_on_cpu():
    """The chip script's blocked path at a tiny size, on the CPU: SpMV, SpMM
    and SDDMM over the BCSR((4, 4)) operand under rows and nnz lower, run,
    agree with the float64 host computation (SDDMM keeps B's blocks) and
    repeat bit for bit; no kernel launches."""
    before = dict(_build.LAUNCHES)
    data = chip_smoke.make_inputs(256, 4, 5, seed=0, rank=3)
    data["add"] = chip_smoke.add_operands(256, 0, data["B"])
    recs, launches = chip_smoke.run_slice(data, chip_smoke.BLOCKED_CELLS,
                                          pieces=4, device="cpu", reps=1)
    assert set(launches.values()) == {0}
    assert sorted(recs) == sorted(f"{e}/{s}"
                                  for e, s in chip_smoke.BLOCKED_CELLS)
    for name, rec in recs.items():
        expr, strat = name.split("/")
        base = expr.split("_")[0]
        assert rec["kernel"].cell_id() == f"{base}/bcsr/{strat}/4x1"
        assert rec["kernel"].leaf_name == f"bcsr_{base}_{strat}"
        assert rec["call"] == chip_smoke.leaf_call(rec["kernel"])
        assert rec["call"][0] in chip_smoke.PATH_KERNELS["blocked"]
        assert rec["max_abs_err"] < 1e-4
        assert rec["bitwise"] and rec["runs"] >= 3
    assert _build.LAUNCHES == before


def test_chip_smoke_grid_path_on_cpu():
    """The chip script's grid path at a tiny size, on the CPU: the 2x2 grid
    rows and nnz cells over B and its BCSR((4, 4)) twin, the 2x2x2 bricks,
    nested-column SpAdd3 and replicated SpMM and SDDMM, the b[dcsr]
    conversion cell and the generic path lower cold and warm, run, agree
    with the host computation and repeat bit for bit; each cell's kernel is
    the one its leaf documents; no kernel launches."""
    before = dict(_build.LAUNCHES)
    data = chip_smoke.make_inputs(256, 4, 5, seed=0, dims3=(64, 16, 16),
                                  rank=3)
    data["add"] = chip_smoke.add_operands(256, 0, data["B"])
    data["grid"] = chip_smoke.grid_operands(data, 32, 0)
    recs, launches = chip_smoke.run_slice(data, chip_smoke.GRID_CELLS,
                                          pieces=4, device="cpu", reps=1)
    assert set(launches.values()) == {0}
    assert sorted(recs) == sorted(map(chip_smoke.cell_name,
                                      chip_smoke.GRID_CELLS))
    kernels = set()
    for name, rec in recs.items():
        k = rec["kernel"]
        expr, strat, mesh = name.split("/")
        assert k.cell_id().endswith(f"/{strat}/{mesh}")
        assert rec["max_abs_err"] < 1e-3
        assert rec["bitwise"] and rec["runs"] >= 3
        call = chip_smoke.leaf_call(k)
        assert (rec["call"] is None) == (call is None)
        if expr == "generic":
            assert k.leaf_name.startswith("generic[") and rec["call"] is None
            assert rec["per_run"] == 0
            continue
        assert rec["per_run"] == (2 if mesh.endswith("r") else 1)
        assert rec["call"][0] == call[0]
        kernels.add(call[0])
        # phase 5's record inputs: the kernel at the cell's own tiles
        name_, args = call
        assert chip_smoke.compare_kernel(name, name_, args,
                                         chip_smoke._abs_args(args)) == 0.0
        assert min(chip_smoke._moved(name_, args, 1, 1)) >= 0
        if expr == "spmv_bdcsr":
            assert k.fallbacks == ["B: b[dcsr] -> csr"]
            assert k.cell_id() == "spmv/b[dcsr]/rows/4x1"
        elif strat == "rows" and mesh != "4x1":
            assert "grid" in k.leaf_name and k.comm.axes
    assert kernels == set(chip_smoke.PATH_KERNELS["grid"])
    assert _build.LAUNCHES == before


def test_chip_smoke_autosched_path_on_cpu(capfd):
    """Path 4i on the CPU at a tiny size: each of the four cells lowers
    ``schedule="auto"`` cold (one tuned miss, one search, its top 3
    measured on the CPU) and warm (one hit, no search), the winner gives
    the bits of a hand lower of its point and agrees with the host
    product, and every enumerated point runs as a hand cell; no kernel
    launches."""
    before = dict(_build.LAUNCHES)
    data = chip_smoke.make_inputs(256, 4, 8, seed=0, dims3=(64, 16, 16),
                                  rank=4)
    data["add"] = chip_smoke.add_operands(256, 0, data["B"])
    launches = chip_smoke.autosched_path(data, torch.device("cpu"), reps=2)
    assert launches == {} and _build.LAUNCHES == dict.fromkeys(before, 0)
    out = capfd.readouterr().out
    lines = [l for l in out.splitlines() if l.startswith("[auto] ")]
    assert len(lines) == len(chip_smoke.AUTOSCHED_CELLS)
    fields = [dict(f.split("=", 1) for f in l.split()[1:]) for l in lines]
    assert [f["cell"].split("/")[:2] for f in fields] == [
        ["spmv", "csr"], ["spmm", "csr"], ["spmv", "bcsr"],
        ["spmttkrp", "csf"]]
    for f in fields:
        assert f["bits_of_hand_lower"] == "True"
        assert f["winner"] in f["model_order"].split(",")
        assert float(f["search_s"]) > 0 and float(f["ratio"]) > 0
    assert sorted(fields[1]["model_order"].split(",")) == \
        ["nnz/4x1", "rows/2x1x2r", "rows/2x2", "rows/4x1"]
    assert fields[2]["tile"] != "-" and fields[0]["tile"] == "-"
    assert fields[3]["model_order"].count(",") == 1
    assert "[autosched] " in out
