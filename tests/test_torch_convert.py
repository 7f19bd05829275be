"""The port's format-conversion fallback and generic path against the JAX
package's.

Three cases, each cold and warm, under rows and nnz: SpMV over a blocked
grid whose root is compressed (``b[dcsr]``, converted to CSR), SpAdd3 over
blocked addends whose block shapes differ (forced to CSR), and a statement
outside the emitter table (``generic[<sig>|<space>]``, the interpreter on
the kernel's device). ``fallbacks``, ``declared_formats``, ``cell_id``,
``leaf_name`` and the cache counters (the convert counters among them)
must equal the reference's; ``run()`` must be allclose to the reference's
and to both interpreters at 1e-3; the conversion is logged as a WARNING on
the port's lower logger."""
import logging
import zlib

import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import formats as RF
from repro.core.interp import interpret as r_interpret
from repro.core.lower import lower as r_lower

import repro_torch.core as tc
from repro_torch.core import formats as TF
from repro_torch.core.interp import interpret as t_interpret
from repro_torch.core.lower import lower as t_lower

from test_torch_lower import _arrays, _stmt

LOGGER = "repro_torch.core.lower"


def _case(pkg, F, case, arrays):
    if case == "bdcsr":
        return _stmt(pkg, F, "spmv",
                     lambda F: F.Format(F.DCSR().levels, block_shape=(2, 2)),
                     *arrays)
    if case == "mixed_blocks":
        dB, dC, dD = arrays
        return pkg.parse_tin(
            "A(i,j) = B(i,j) + C(i,j) + D(i,j)",
            A=pkg.Tensor.from_dense("A", np.zeros_like(dB), F.CSR()),
            **{name: pkg.Tensor.from_dense(name, x, F.BCSR(block))
               for name, x, block in zip("BCD", (dB, dC, dD),
                                         ((2, 2), (4, 4), (2, 2)))})
    dB, c = arrays                     # outside the table: a scaled copy
    return pkg.parse_tin("A(i,j) = B(i,j) * c(j)",
                         A=pkg.Tensor.zeros_dense("A", dB.shape),
                         B=pkg.Tensor.from_dense("B", dB, F.CSR()),
                         c=pkg.Tensor.from_dense("c", c))


EXPECTED = {
    "bdcsr": (["B: b[dcsr] -> csr"], {"B": "b[dcsr]"}, "spmv/b[dcsr]"),
    "mixed_blocks": (["B: bcsr -> csr", "C: bcsr -> csr", "D: bcsr -> csr"],
                     {"B": "bcsr", "C": "bcsr", "D": "bcsr"},
                     "spadd3/bcsr"),
    "generic": ([], {}, "d2(i,j)=s2(i,j)*d1(j)/csr"),
}


def _lower_cold_warm(pkg, lower, stmt, strategy, **kw):
    machine = pkg.Machine(("x", 4))
    sched = (pkg.lower.default_row_schedule if strategy == "rows"
             else pkg.lower.default_nnz_schedule)(stmt, machine)
    pkg.clear_lowering_caches()
    return [lower(stmt, machine, schedule=sched, **kw) for _ in range(2)]


def _dense(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return x.to_dense() if hasattr(x, "to_dense") else np.asarray(x)


@pytest.mark.parametrize("strategy", ["rows", "nnz"])
@pytest.mark.parametrize("case", ["bdcsr", "mixed_blocks", "generic"])
def test_conversion_matches_reference(case, strategy, caplog):
    rng = np.random.default_rng(zlib.crc32(f"{case}/{strategy}".encode()))
    arrays = _arrays("spadd3" if case == "mixed_blocks" else "spmv", rng,
                     False)
    r_stmt = _case(rc, RF, case, arrays)
    t_stmt = _case(tc, TF, case, arrays)
    r_cold, r_warm = _lower_cold_warm(rc, r_lower, r_stmt, strategy)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        t_cold, t_warm = _lower_cold_warm(tc, t_lower, t_stmt, strategy,
                                          device="cpu")
    fallbacks, declared, cell = EXPECTED[case]
    for r, t in ((r_cold, t_cold), (r_warm, t_warm)):
        assert t.fallbacks == r.fallbacks == fallbacks
        assert t.declared_formats == r.declared_formats == declared
        assert t.cell_id() == r.cell_id() == f"{cell}/{strategy}/4x1"
        assert t.leaf_name == r.leaf_name
        assert t.cache.as_dict() == r.cache.as_dict()
        assert t.comm.as_dict() == r.comm.as_dict()
    assert t_cold.cache.convert_misses == len(fallbacks)
    assert t_warm.cache.convert_hits == len(fallbacks)
    assert t_warm.cache.warm
    warned = [rec for rec in caplog.records
              if rec.name == LOGGER and "converting to" in rec.getMessage()]
    assert len(warned) == 2 * len(fallbacks)
    if fallbacks:
        assert "fallbacks: " + "; ".join(fallbacks) in t_cold.explain()
    else:
        assert t_cold.leaf_name == \
            f"generic[{t_stmt.signature()}|{t_cold.strategy.space}]"
    got = _dense(t_warm.run())
    np.testing.assert_allclose(got, _dense(r_warm.run()), atol=1e-3)
    np.testing.assert_allclose(got, t_interpret(t_stmt, device="cpu"),
                               atol=1e-3)
    np.testing.assert_allclose(got, r_interpret(r_stmt), atol=1e-3)


def test_generic_path_runs_on_the_kernels_device(monkeypatch):
    """The generic runner interprets on the device the kernel was lowered
    for, never on another one."""
    from repro_torch.core import interp
    rng = np.random.default_rng(2)
    stmt = _case(tc, TF, "generic", _arrays("spmv", rng, False))
    seen = []
    real = interp.interpret
    monkeypatch.setattr(interp, "interpret", lambda s, device=None: (
        seen.append(device), real(s, device=device))[1])
    k = t_lower(stmt, tc.Machine(("x", 2)), device="cpu")
    k.run()
    assert seen == [k.device] and k.device.type == "cpu"


def test_converted_grid_cell_matches_reference():
    """The conversion runs before the grid dispatch: a b[dcsr] operand on a
    2x2 grid tiles its CSR conversion."""
    rng = np.random.default_rng(9)
    arrays = _arrays("spmv", rng, False)
    out = []
    for pkg, F, lower, kw in ((rc, RF, r_lower, {}),
                              (tc, TF, t_lower, {"device": "cpu"})):
        stmt = _case(pkg, F, "bdcsr", arrays)
        M = pkg.Machine(("x", 2), ("y", 2))
        pkg.clear_lowering_caches()
        k = lower(stmt, M, schedule=pkg.lower.default_grid_schedule(stmt, M),
                  **kw)
        out.append((k.cell_id(), k.leaf_name, k.fallbacks,
                    k.declared_formats, k.comm.as_dict(), k.cache.as_dict(),
                    _dense(k.run())))
    assert out[1][:6] == out[0][:6]
    assert out[1][0] == "spmv/b[dcsr]/rows/2x2"
    np.testing.assert_allclose(out[1][6], out[0][6], atol=1e-3)


def test_no_grid_emitter_raises_as_the_reference():
    """SpTTV has no grid emitter in either package."""
    rng = np.random.default_rng(1)
    arrays = _arrays("spttv", rng, False)
    for pkg, F, lower, kw in ((rc, RF, r_lower, {}),
                              (tc, TF, t_lower, {"device": "cpu"})):
        stmt = _stmt(pkg, F, "spttv", lambda F: F.CSF(3), *arrays)
        M = pkg.Machine(("x", 2), ("y", 2))
        with pytest.raises(NotImplementedError, match="no 2-D grid emitter"):
            lower(stmt, M, schedule=pkg.lower.default_grid_schedule(stmt, M),
                  **kw)


@pytest.mark.parametrize("target", ["csr", "csc", "coo"])
@pytest.mark.parametrize("source", ["bcsr", "bcsc", "bdcsr", "empty"])
def test_blocked_to_format_matches_reference(source, target):
    """A blocked tensor converts to an unblocked sparse format from its
    stored cells (no dense image); the result equals the reference's
    dense-image conversion exactly: levels, values and dtype. Ragged
    boundary blocks, zero cells inside stored blocks and a -0.0 cell are
    in the operand."""
    rng = np.random.default_rng(zlib.crc32(f"{source}{target}".encode()))
    d = np.zeros((19, 13), np.float32) if source == "empty" else (
        (rng.random((19, 13)) < 0.3)
        * rng.standard_normal((19, 13))).astype(np.float32)
    if source != "empty":
        d[0, 0] = -0.0
    out = []
    for pkg, F in ((rc, RF), (tc, TF)):
        fm = {"bcsr": F.BCSR((4, 3)), "bcsc": F.BCSC((4, 3)),
              "empty": F.BCSR((2, 2)),
              "bdcsr": F.Format(F.DCSR().levels, block_shape=(2, 5))}[source]
        target_fm = {"csr": F.CSR(), "csc": F.CSC(), "coo": F.COO(2)}[target]
        out.append(pkg.Tensor.from_dense("B", d, fm).to_format(target_fm))
    want, got = out
    assert got.vals.dtype == want.vals.dtype
    np.testing.assert_array_equal(got.vals, want.vals)
    for gl, wl in zip(got.levels, want.levels):
        assert gl.size == wl.size
        for x, y in ((gl.pos, wl.pos), (gl.crd, wl.crd)):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
