"""Quickstart — the paper's Figure 1 program, in this framework.

Distributed SpMV with independent computation / format / distribution /
schedule descriptions. The distributed loop runs in this process over the
machine's pieces, each piece's leaf kernel on the card.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np

import repro_torch.core as tc
from repro_torch.core import formats as F
from repro_torch.core.schedule import CPUThread, Schedule
from repro_torch.core.tdn import dist
from repro_torch.core.tensor import Tensor


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the kernels run (default: the card)")
    args = ap.parse_args(argv)

    # --- Machine: 1-D grid of processors (Fig. 1 line 5) -------------------
    pieces = 4
    M = tc.Machine(("x", pieces))

    # --- Tensors + formats (Fig. 1 lines 12-22) ----------------------------
    rng = np.random.default_rng(0)
    n, m = 64, 48
    dense_B = ((rng.random((n, m)) < 0.15) *
               rng.standard_normal((n, m))).astype(np.float32)

    a = Tensor.zeros_dense("a", (n,))                      # BlockedDense
    B = Tensor.from_dense("B", dense_B, F.CSR())           # BlockedCSR
    c = Tensor.from_dense("c", rng.standard_normal(m)      # ReplDense
                          .astype(np.float32))

    # data distributions (TDN): block a and B row-wise, replicate c
    distributions = {
        "a": dist(a, "x -> x", M),
        "B": dist(B, "xy -> x", M),
        "c": dist(c, "x -> *", M),
    }

    # --- Computation (Fig. 1 line 26) --------------------------------------
    i, j = tc.index_vars("i j")
    stmt = tc.Assignment(a(i), B(i, j) * c(j))

    # --- Schedule (Fig. 1 lines 30-39) -------------------------------------
    io, ii = tc.index_vars("io ii")
    s = (Schedule(stmt, M)
         .divide(i, io, ii, M.x)          # block i for each node
         .distribute(io)                  # each block on its own node
         .communicate([a, B, c], io)      # fetch sub-tensors per iteration
         .parallelize(ii, CPUThread))     # leaf parallelism

    # --- Compile + run ------------------------------------------------------
    kernel = tc.lower_stmt(stmt, M, schedule=s, distributions=distributions,
                           device=args.device)
    y = kernel.run().cpu().numpy()

    expected = dense_B @ np.asarray(c.to_dense())
    out = {"leaf": kernel.leaf_name,
           "max_err": float(np.abs(y - expected).max()),
           "imbalance": round(kernel.imbalance(), 3),
           "communication": kernel.comm.as_dict()}
    print("leaf kernel:        ", out["leaf"])
    print("max |err| vs dense: ", out["max_err"])
    print("row imbalance:      ", out["imbalance"])
    print("communication:      ", out["communication"])
    assert np.allclose(y, expected, atol=1e-4)
    print("OK — distributed SpMV matches the dense oracle")
    return out


if __name__ == "__main__":
    main()
