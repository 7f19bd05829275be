"""Batched sparse-attention decode through the serving fast path.

The sliding-window block mask (models/sparse_attention.band_plan) is a
sparse matrix that never changes between decode steps — exactly the shape
the serving fast path freezes: ``band_decode_kernel`` lowers it ONCE per
batch bucket (one plan, one CSR shard pack on the card), and every step
folds the live decode streams' per-kv-block summary vectors into a single
bucketized SpMM via ``run_many``. A ``SparseKernelServer`` then drives the
same kernel from a request queue, reporting p50/p99 latency against an
SLO.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched
"""
import argparse

import numpy as np

import repro_torch.core as tc
from repro_torch.core.tensor import Tensor
from repro_torch.launch.serve import SparseKernelServer
from repro_torch.models.sparse_attention import band_decode_kernel, band_plan
from repro_torch.runtime import telemetry


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the kernels run (default: the card)")
    args = ap.parse_args(argv)

    SEQ, Q_BLOCK, WINDOW = 2048, 64, 256
    BATCH = 8
    machine = tc.Machine(("x", 4))

    mask = band_plan(SEQ, Q_BLOCK, WINDOW)
    nq = mask.shape[0]
    out = {"blocks": nq, "present": int(mask.nnz)}
    print(f"band mask: {nq}x{nq} blocks, {mask.nnz} present "
          f"({mask.nnz / nq**2:.1%} of dense)")

    # --- batched decode: B streams -> one SpMM -----------------------------
    bk = band_decode_kernel(SEQ, Q_BLOCK, WINDOW, machine, batch=BATCH,
                            device=args.device)
    rng = np.random.default_rng(0)
    streams = [rng.integers(-3, 4, nq).astype(np.float32)
               for _ in range(BATCH)]
    outs = bk.run_many(streams)

    dense_mask = mask.to_dense()
    for v, y in zip(streams, outs):
        assert np.array_equal(y.cpu().numpy().ravel(), dense_mask @ v)
    print(f"run_many: {BATCH} decode streams -> one SpMM, bit-for-bit vs "
          "dense reference")
    print(bk.explain())

    # --- the same kernel behind a request queue ----------------------------
    stmt = tc.parse_tin("y(i) = attn_mask(i,j) * v(j)",
                        y=Tensor.zeros_dense("y", (nq,)),
                        attn_mask=mask,
                        v=Tensor.zeros_dense("v", (nq,)))
    srv = SparseKernelServer(stmt, machine, max_batch=BATCH, slo_ms=100.0,
                             device=args.device)
    for wave in range(4):
        for v in streams:
            srv.submit(rng.permutation(v))
        srv.drain()
    stats = srv.stats()
    out["stats"] = stats
    print(f"served {stats['served']} requests: p50={stats['p50_ms']:.2f}ms "
          f"p99={stats['p99_ms']:.2f}ms "
          f"SLO({stats['slo_ms']:.0f}ms) attainment="
          f"{stats['slo_attainment']:.0%}")
    assert stats["served"] == 4 * BATCH

    snap = telemetry.METRICS.snapshot()
    occ = snap.get("histograms", {}).get("serve.batch.occupancy", {})
    if occ:
        print(f"batch occupancy: mean={occ['mean']:.2f} over "
              f"{occ['count']} batches (1.0 = no padded slots)")
    return out


if __name__ == "__main__":
    main()
