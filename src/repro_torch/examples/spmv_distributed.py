"""Row-based vs non-zero-based distributed SpMV (paper §II-D) on a skewed
matrix, including real SPMD execution over ranks when started with
``torchrun`` (gloo ranks, sharing the card or on the CPU).

    PYTHONPATH=src python -m repro_torch.examples.spmv_distributed
    PYTHONPATH=src torchrun --nproc-per-node 8 \\
        -m repro_torch.examples.spmv_distributed --device cpu
"""
import argparse
import os

import numpy as np
import torch.distributed as tdist

import repro_torch.core as tc
from repro_torch.core.lower import (default_nnz_schedule,
                                    default_row_schedule, lower)
from repro_torch.core.tensor import Tensor
from repro_torch.data.spdata import powerlaw_matrix


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the kernels run (default: the card)")
    args = ap.parse_args(argv)

    pieces = 8
    M = tc.Machine(("x", pieces))

    B = powerlaw_matrix("B", 4000, 4000, avg_nnz_per_row=12, seed=0)
    c = Tensor.from_dense("c", np.random.default_rng(1)
                          .standard_normal(4000).astype(np.float32))
    a = Tensor.zeros_dense("a", (4000,))
    stmt = tc.parse_tin("a(i) = B(i,j) * c(j)", a=a, B=B, c=c)
    expected = B.to_dense() @ np.asarray(c.to_dense())

    out = {}
    for name, sched in [("row-based", default_row_schedule(stmt, M)),
                        ("nnz-based", default_nnz_schedule(stmt, M))]:
        k = lower(stmt, M, schedule=sched, device=args.device)
        y = k.run().cpu().numpy()
        assert np.allclose(y, expected, atol=1e-3)
        vb = k.plans["B"].vals_bounds
        counts = vb[:, 1] - vb[:, 0]
        out[name] = {"leaf": k.leaf_name, "imbalance": k.imbalance(),
                     "nnz_min": int(counts.min()),
                     "nnz_max": int(counts.max()),
                     "comm": k.comm.total_network_bytes()}
        print(f"{name:10s} leaf={k.leaf_name:10s} imbalance="
              f"{k.imbalance():5.2f} shard nnz: min={counts.min()} "
              f"max={counts.max()}  comm={k.comm.total_network_bytes()}B")
    # the non-zero split balances the pieces by construction
    nb = out["nnz-based"]
    assert nb["nnz_max"] - nb["nnz_min"] <= 0.01 * nb["nnz_max"], nb

    # --- real SPMD execution when started as enough ranks ------------------
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world >= pieces:
        from repro_torch.distributed.executor import to_spmd
        from repro_torch.distributed.mesh import machine_to_mesh
        tdist.init_process_group("gloo")
        try:
            mesh = machine_to_mesh(M, backend="gloo", device=args.device)
            for name, sched in [("row-based", default_row_schedule(stmt, M)),
                                ("nnz-based", default_nnz_schedule(stmt, M))]:
                k = lower(stmt, M, schedule=sched, device=mesh.device)
                y = to_spmd(k, mesh)().cpu().numpy()
                assert np.allclose(y, expected, atol=1e-3)
                out[name]["spmd"] = True
                if tdist.get_rank() == 0:
                    print(f"{name} via to_spmd on {pieces} ranks: OK")
        finally:
            tdist.destroy_process_group()
    else:
        print(f"(single process — rerun with torchrun --nproc-per-node "
              f"{pieces} for the to_spmd path)")
    return out


if __name__ == "__main__":
    main()
