#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py            # full size: 2^21 x 2^21, 25.1 M entries

Phases, one line each (a failing phase raises and the script exits non-zero):

1. device  — the card's name, count, and ``nvidia-smi`` name and power limit.
2. build   — ``nvcc`` for ``sm_90a`` over every CUDA source (in parallel),
             with each kernel's registers, shared memory and spills.
3. kernels — each Hopper kernel against its plain PyTorch version on the
             card: first at edge-case shapes (empty rows, an empty piece, a
             row longer than 128 entries, J in {1, 16, 130}), later at the
             main path's shapes. Per-row tolerance
             |y_kernel - y_plain| <= 1e-4 * (|B|.|c|)_row + 1e-6: f32 sums of
             up to a million terms, taken in a different order.
4. main    — ``powerlaw_matrix`` (n = m = 2^21, 16 entries per row on
             average, alpha 1.6, seed 0) in CSR on ``Machine(("x", 4))``:
             lower and run SpMV and SpMM (J = 32) under the rows and nnz
             strategies, check each result against ``np.bincount`` over the
             CSR arrays on the host (same per-row tolerance), and report the
             cold and warm lower times, the median ``run()`` time and the
             peak device memory. Kernel launch counts are reset just before
             and read just after; each kernel must have launched.
5. the ``{"kernels": [...]}`` line: per kernel its launches on the main
   path, its time (CUDA events, median of 20), its bound at these shapes,
   its plain version's time and one PyTorch library call's time on the same
   inputs (a yardstick only; the port never calls it).

The last line is ``{"ok": true, "device": {...}}``. Without a card, or
without the package beside this file, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
RTOL_ROW, ATOL = 1e-4, 1e-6
AVG_NNZ, PIECES, SPMM_J, SEED = 16, 4, 32, 0    # the main path's cells

KERNELS = {
    "spmv_csr_rows": ("src/repro_torch/kernels/csrc/spmv.cu",
                      "src/repro/kernels/spmv.py:72"),
    "spmv_coo_nnz": ("src/repro_torch/kernels/csrc/spmv.cu",
                     "src/repro/kernels/spmv.py:126"),
    "spmm_csr_rows": ("src/repro_torch/kernels/csrc/spmm.cu",
                      "src/repro/kernels/spmm.py:54"),
}


def phase(tag: str, /, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


# ---------------------------------------------------------------------------
# Tolerance and timing
# ---------------------------------------------------------------------------

def check_rows(name: str, got, want, scale) -> float:
    """Per-row check |got - want| <= RTOL_ROW * scale + ATOL, where
    ``scale`` is (|B|.|c|) for the same rows; returns the max abs error."""
    import torch
    got, want, scale = (torch.as_tensor(x).double().cpu()
                        for x in (got, want, scale))
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    bad = err > RTOL_ROW * scale + ATOL
    if bad.any():
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(
            f"{name}: {int(bad.sum())} entries off; first at flat index {i}: "
            f"got {got.flatten()[i]} want {want.flatten()[i]} "
            f"scale {scale.flatten()[i]}")
    return float(err.max()) if err.numel() else 0.0


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_events(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``reps`` calls, each timed by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_host(fn, device, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``reps`` calls on the host clock, each ending
    in a device synchronize."""
    for _ in range(warmup):
        fn()
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_cases(rng, device):
    """Edge-case batched inputs per kernel: (label, kernel name, args,
    args with |vals| and |c| for the tolerance). Pieces of one batch share
    R and the padded entry count N; one piece of every batch is empty,
    every matrix has an empty row, the (4, 300) one a row longer than 128
    entries."""
    import numpy as np
    import torch

    def csr(n, m, density):
        d = ((rng.random((n, m)) < density)
             * rng.standard_normal((n, m))).astype(np.float32)
        d[rng.integers(0, n)] = 0                                # empty row
        d[rng.integers(0, n)] = rng.standard_normal(m)           # dense row
        rows, cols = np.nonzero(d)
        pos = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=pos[1:])
        return pos, cols, d[rows, cols]

    def stack(pieces, R, N):
        P = len(pieces)
        pos = np.zeros((P, R + 1), np.int32)
        crd = np.zeros((P, N), np.int32)
        vals = np.zeros((P, N), np.float32)
        for p, (pp, cc, vv) in enumerate(pieces):
            pos[p, :pp.shape[0]] = pp
            pos[p, pp.shape[0]:] = pp[-1]
            crd[p, :cc.shape[0]] = cc
            vals[p, :vv.shape[0]] = vv
        return pos, crd, vals

    def dev(*xs):
        return [torch.as_tensor(x).to(device).contiguous() for x in xs]

    shapes = [(8, 8), (37, 53), (64, 128), (130, 65), (1, 7), (256, 17),
              (4, 300)]
    for n, m in shapes:
        mats = [csr(n, m, 0.3), (np.zeros(n + 1, np.int64),
                                 np.zeros(0, np.int64),
                                 np.zeros(0, np.float32)), csr(n, m, 0.05)]
        N = max(1, max(x[1].shape[0] for x in mats))
        pos, crd, vals = stack(mats, n, N)
        c = rng.standard_normal(m).astype(np.float32)
        pos_t, crd_t, vals_t, c_t = dev(pos, crd, vals, c)
        yield (f"spmv_csr_rows {n}x{m}", "spmv_csr_rows",
               (pos_t, crd_t, vals_t, c_t),
               (pos_t, crd_t, vals_t.abs(), c_t.abs()))
        # the nnz kernel's input: row-sorted rebased rows, padding dropped
        rows = np.full((3, N), n, np.int32)
        for p in range(3):
            cnt = int(pos[p, -1])
            rows[p, :cnt] = np.repeat(np.arange(n), np.diff(pos[p]))
        rows_t, = dev(rows)
        yield (f"spmv_coo_nnz {n}x{m}", "spmv_coo_nnz",
               (rows_t, crd_t, vals_t, c_t, n),
               (rows_t, crd_t, vals_t.abs(), c_t.abs(), n))
        for J in (1, 16, 130):
            C_t, = dev(rng.standard_normal((m, J)).astype(np.float32))
            yield (f"spmm_csr_rows {n}x{m} J={J}", "spmm_csr_rows",
                   (pos_t, crd_t, vals_t, C_t),
                   (pos_t, crd_t, vals_t.abs(), C_t.abs()))


def kernel_fns():
    from repro_torch.kernels import spmm, spmv
    return {
        "spmv_csr_rows": (spmv.spmv_csr_rows, spmv.spmv_csr_rows_plain),
        "spmv_coo_nnz": (spmv.spmv_coo_nnz, spmv.spmv_coo_nnz_plain),
        "spmm_csr_rows": (spmm.spmm_csr_rows, spmm.spmm_csr_rows_plain),
    }


def compare_kernel(label, name, args, abs_args) -> float:
    kernel, plain = kernel_fns()[name]
    got = kernel(*args)
    want = plain(*args)
    scale = plain(*abs_args)
    _sync(got.device)
    return check_rows(label, got, want, scale)


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def make_inputs(n: int, avg_nnz: int, J: int, seed: int):
    """The sparse operand (reference generator, CSR) and the dense
    operands c (m,) and C (m, J), all from ``seed``."""
    import numpy as np
    from repro_torch.data.spdata import powerlaw_matrix
    B = powerlaw_matrix("B", n, n, avg_nnz, alpha=1.6, seed=seed)
    rng = np.random.default_rng(seed + 1)
    c = rng.standard_normal(n).astype(np.float32)
    C = rng.standard_normal((n, J)).astype(np.float32)
    return B, c, C


def statements(B, c, C):
    import repro_torch.core as tc
    n, m = B.shape
    J = C.shape[1]
    spmv = tc.parse_tin("a(i) = B(i,j) * c(j)",
                        a=tc.Tensor.zeros_dense("a", (n,)), B=B,
                        c=tc.Tensor.from_dense("c", c))
    spmm = tc.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                        A=tc.Tensor.zeros_dense("A", (n, J)), B=B,
                        C=tc.Tensor.from_dense("C", C))
    return {"spmv": spmv, "spmm": spmm}


def drive_main_path(B, c, C, pieces: int, device, reps: int):
    """Lower (cold, then warm) and run the four cells of the slice through
    the public entry points. Returns {cell: record}."""
    import torch
    import repro_torch.core as tc
    from repro_torch.core import lower as L

    machine = tc.Machine(("x", pieces))
    stmts = statements(B, c, C)
    cells = {}
    for expr, strat in (("spmv", "rows"), ("spmv", "nnz"),
                        ("spmm", "rows"), ("spmm", "nnz")):
        stmt = stmts[expr]
        sched = (L.default_row_schedule if strat == "rows"
                 else L.default_nnz_schedule)(stmt, machine)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        L.clear_lowering_caches()
        t0 = time.perf_counter()
        k = L.lower(stmt, machine, schedule=sched, device=device)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        k = L.lower(stmt, machine, schedule=sched, device=device)
        warm_s = time.perf_counter() - t0
        if not k.cache.warm:
            raise AssertionError(f"{k.cell_id()}: warm re-lower missed a "
                                 f"cache: {k.cache.as_dict()}")
        run_ms = time_host(k.run, device, reps)
        out = k.run()
        _sync(device)
        cells[f"{expr}/{strat}"] = {
            "kernel": k, "cold_s": cold_s, "warm_s": warm_s,
            "run_ms": run_ms, "out": out,
            "max_mem": (torch.cuda.max_memory_allocated(device)
                        if device.type == "cuda" else 0)}
    return cells


def reference_products(B, c, C):
    """y = B.c and Y = B.C on the host with np.bincount over the CSR arrays
    (float64), plus the per-row scales |B|.|c| and |B|.|C|."""
    import numpy as np
    n = B.shape[0]
    pos, crd = B.levels[1].pos, B.levels[1].crd
    rows = np.repeat(np.arange(n), np.diff(pos))
    v = B.vals.astype(np.float64)
    out = {"spmv": (np.bincount(rows, v * c[crd], minlength=n),
                    np.bincount(rows, np.abs(v) * np.abs(c[crd]),
                                minlength=n))}
    J = C.shape[1]
    Y = np.empty((n, J))
    S = np.empty((n, J))
    for j in range(J):
        g = C[crd, j].astype(np.float64)
        Y[:, j] = np.bincount(rows, v * g, minlength=n)
        S[:, j] = np.bincount(rows, np.abs(v) * np.abs(g), minlength=n)
    out["spmm"] = (Y, S)
    return out


def run_slice(n: int, avg_nnz: int, pieces: int, J: int, seed: int, device,
              reps: int = 10):
    """Phase 4: make the inputs, drive the main path and check every cell
    against the host computation. Returns (B, c, C, cells)."""
    from repro_torch.core.device import resolve_device
    device = resolve_device(device)
    B, c, C = make_inputs(n, avg_nnz, J, seed)
    cells = drive_main_path(B, c, C, pieces, device, reps)
    want = reference_products(B, c, C)
    for name, rec in cells.items():
        expr = name.split("/")[0]
        rec["max_abs_err"] = check_rows(name, rec["out"], *want[expr])
    return B, c, C, cells


# ---------------------------------------------------------------------------
# Phase 5: the kernels line
# ---------------------------------------------------------------------------

def kernel_records(B, C, cells, launches, reps: int):
    """Time each kernel, its plain version and a library yardstick at the
    main path's shapes, and compute its bound from this run's inputs."""
    import torch
    k_rows, k_nnz = cells["spmv/rows"]["kernel"], cells["spmv/nnz"]["kernel"]
    k_mm = cells["spmm/rows"]["kernel"]
    dev = k_rows.device
    pos, crd, vals, c = k_rows.args[:4]
    rows, cols, nvals, c2 = k_nnz.args[:4]
    max_rows = int(k_nnz.shards["B"].meta["max_rows"])
    mpos, mcrd, mvals, Cd = k_mm.args[:4]
    nnz = int(B.nnz)
    n, m = B.shape
    J = C.shape[1]
    P, R = pos.shape[0], pos.shape[1] - 1

    csr = torch.sparse_csr_tensor(
        torch.as_tensor(B.levels[1].pos).to(dev),
        torch.as_tensor(B.levels[1].crd).to(dev),
        torch.as_tensor(B.vals).to(dev), size=(n, m))
    inputs = {
        "spmv_csr_rows": (pos, crd, vals, c),
        "spmv_coo_nnz": (rows, cols, nvals, c2, max_rows),
        "spmm_csr_rows": (mpos, mcrd, mvals, Cd),
    }
    library = {
        "spmv_csr_rows": lambda: csr @ c,
        "spmv_coo_nnz": lambda: csr @ c2,
        "spmm_csr_rows": lambda: csr @ Cd,
    }
    # bytes each input read once and each output written once (real entries
    # only), and the f32 operations the data needs
    moved = {
        "spmv_csr_rows": (nnz * 8 + P * (R + 1) * 4 + m * 4 + P * R * 4,
                          2 * nnz),
        "spmv_coo_nnz": (nnz * 12 + m * 4 + P * max_rows * 4, 2 * nnz),
        "spmm_csr_rows": (nnz * 8 + P * (R + 1) * 4 + m * J * 4
                          + P * R * J * 4, 2 * nnz * J),
    }
    records = []
    for name, (kernel, plain) in kernel_fns().items():
        args = inputs[name]
        nbytes, flops = moved[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        source, replaces = KERNELS[name]
        err = compare_kernel(f"{name} main-path shapes", name, args,
                             [a.abs() if torch.is_tensor(a)
                              and a.is_floating_point() else a
                              for a in args])
        records.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err,
            "ms": time_events(lambda: kernel(*args), reps),
            "plain_ms": time_events(lambda: plain(*args), max(reps // 4, 3)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_events(library[name], reps),
        })
    return records


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-n", type=int, default=21,
                    help="matrix side as a power of two (default 21; a "
                    "smaller side is a quick rehearsal)")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed kernel launches (run() takes half)")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: the repro_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    phase("device", name=repr(kind), count=count, torch=torch.__version__,
          cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build(force=True)
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}",
          sources=",".join(sorted(logs)))
    for src, log in sorted(logs.items()):
        for line in log.splitlines():
            if ("Compiling entry" in line or "Used" in line
                    or "spill" in line):
                print(f"  {src}: {line.strip()}")

    # 3a. kernels against plain at edge-case shapes
    rng = np.random.default_rng(SEED)
    worst = {}
    for label, name, kargs, abs_args in kernel_cases(rng, device):
        err = compare_kernel(label, name, kargs, abs_args)
        worst[name] = max(worst.get(name, 0.0), err)
    phase("kernels-edge", **{k: f"{v:.3g}" for k, v in worst.items()})

    # 4. the main path, with the launch counts of exactly this run
    _build.reset_launches()
    B, c, C, cells = run_slice(1 << args.log2_n, AVG_NNZ, PIECES, SPMM_J,
                               SEED, device, max(args.reps // 2, 1))
    launches = dict(_build.LAUNCHES)
    phase("data", n=B.shape[0], nnz=B.nnz,
          longest_row=int(np.diff(B.levels[1].pos).max()))
    for rec in cells.values():
        k = rec["kernel"]
        phase("main", cell=k.cell_id(), leaf=k.leaf_name,
              cold_lower_s=f"{rec['cold_s']:.3f}",
              warm_lower_s=f"{rec['warm_s']:.4f}",
              run_ms=f"{rec['run_ms']:.3f}",
              max_abs_err=f"{rec['max_abs_err']:.3g}",
              max_mem_gb=f"{rec['max_mem'] / 2**30:.2f}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    phase("launches", **launches)

    # 3b + 5. kernels at the main path's shapes, timed
    records = kernel_records(B, C, cells, launches, args.reps)
    for r in records:
        phase("kernel", name=r["name"], max_abs_err=f"{r['max_abs_err']:.3g}",
              ms=f"{r['ms']:.4f}", bound_ms=f"{r['bound_ms']:.4f}",
              plain_ms=f"{r['plain_ms']:.3f}",
              library_ms=f"{r['library_ms']:.4f}")
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
