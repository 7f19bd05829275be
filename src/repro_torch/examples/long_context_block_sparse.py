"""Block-sparse sliding-window attention from the paper's format machinery
(models/sparse_attention.py) — the long_500k path for full-attention archs.

Builds the banded block mask as a block-CSR core.Tensor, packs it
ELL-style, runs attention over only the listed blocks, and validates
against a dense masked reference.

    PYTHONPATH=src python -m repro_torch.examples.long_context_block_sparse
"""
import argparse

import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.sparse_attention import (band_plan,
                                                 block_sparse_attention,
                                                 mask_to_ell)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the attention runs (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    B, S, H, hd = 2, 1024, 4, 32
    Q_BLOCK, WINDOW = 128, 256

    mask = band_plan(S, Q_BLOCK, WINDOW)
    out = {"blocks": mask.shape[0], "present": int(mask.nnz),
           "fraction": mask.nnz / mask.shape[0] ** 2}
    print(f"block mask: {mask.shape[0]}x{mask.shape[1]} blocks, "
          f"{mask.nnz} present ({out['fraction']:.1%} of dense)")
    idx = mask_to_ell(mask, device=device)

    gen = torch.Generator(device).manual_seed(0)
    q, k, v = (torch.randn((B, S, H, hd), generator=gen, device=device)
               for _ in range(3))
    with torch.no_grad():
        got = block_sparse_attention(q, k, v, idx, Q_BLOCK, window=WINDOW)

        # dense reference with the same mask
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / hd ** 0.5
        pos = torch.arange(S, device=device)
        m = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - WINDOW)
        ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(
            torch.where(m[None, None], scores, -1e30), -1), v)
    out["max_err"] = float((got - ref).abs().max())
    print(f"max |err| vs dense windowed reference: {out['max_err']:.2e}")
    assert out["max_err"] < 1e-4
    print("OK — compute scales with S*window, not S^2")
    return out


if __name__ == "__main__":
    main()
