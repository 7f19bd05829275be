"""The paper's technique inside the LM stack: MoE token routing as a
distributed sparse tensor computation.

The router's (token × expert) assignment is a sparse matrix with top-k
non-zeros per row. This example builds it as a core.Tensor, then compares
the two distribution strategies of paper §II-D on it:

- expert-major UNIVERSE partition (block of experts per device) — imbalance
  equals routing skew;
- coordinate-fused NON-ZERO partition (Fig. 5c) — balanced by construction;

and shows the same effect inside the real `models.moe` layer via its
capacity-drop count.

    PYTHONPATH=src python -m repro_torch.examples.moe_sparse_dispatch
"""
import argparse

import numpy as np
import torch

from repro_torch.core import formats as F
from repro_torch.core.device import resolve_device
from repro_torch.core.partition import (partition_by_bounds,
                                        partition_tensor_nonzeros,
                                        partition_tensor_rows)
from repro_torch.core.tensor import Tensor
from repro_torch.models import moe as MOE


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the MoE layer runs (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    E, TOPK, N, D = 16, 2, 4096, 64
    pieces = 8
    rng = np.random.default_rng(0)

    # --- skewed router: zipf-popular experts (the realistic failure mode) --
    popularity = 1.0 / np.arange(1, E + 1) ** 1.2
    popularity /= popularity.sum()
    assign = np.stack([rng.choice(E, TOPK, replace=False, p=popularity)
                       for _ in range(N)])
    coords = np.stack([np.repeat(np.arange(N), TOPK), assign.ravel()], 1)
    routing = Tensor.from_coo("R", (N, E), coords,
                              np.ones(N * TOPK, np.float32),
                              F.CSC())  # expert-major: experts are the root

    # expert-major universe partition: block of experts per device
    uni = partition_tensor_rows(routing, partition_by_bounds(E, pieces))
    # coordinate-fused non-zero partition (paper Fig. 5c)
    nnz = partition_tensor_nonzeros(routing, pieces)
    out = {"universe_imbalance": uni.imbalance(),
           "nonzero_imbalance": nnz.imbalance()}

    print(f"router: {N} tokens x {E} experts, top-{TOPK}, zipf skew")
    print(f"  expert-major universe partition imbalance: "
          f"{out['universe_imbalance']:.2f}")
    print(f"  fused non-zero partition imbalance:        "
          f"{out['nonzero_imbalance']:.2f}")
    assert out["nonzero_imbalance"] <= out["universe_imbalance"]

    # --- the same skew inside the real MoE layer ---------------------------
    params = MOE.moe_init(torch.Generator(device).manual_seed(0), D, 4 * D, E)
    x = torch.randn((4, N // 4, D), generator=torch.Generator(device)
                    .manual_seed(1), device=device)
    with torch.no_grad():
        y, aux = MOE.moe_apply(params, x, n_experts=E, top_k=TOPK,
                               capacity_factor=1.25)
        # the layer's capacity drops: assignments past an expert's C slots
        C = int(max(-(-N * TOPK // E) * 1.25, 1))
        slot = MOE._dispatch(params, x.reshape(N, D), E, TOPK, C)[1]
        drops = int((slot == E * C).sum())
    out.update(shape=tuple(y.shape), aux=float(aux), drops=drops,
               capacity=C)
    print(f"moe layer out: {out['shape']}, load-balance aux loss: "
          f"{out['aux']:.3f}")
    print(f"capacity {C} a expert: {drops} of {N * TOPK} assignments "
          f"dropped")
    assert torch.isfinite(y).all() and 0 <= drops < N * TOPK
    print("OK")
    return out


if __name__ == "__main__":
    main()
