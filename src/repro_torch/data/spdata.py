"""Sparse matrix generators for the chip run and the tests.

The reference's generators (``repro/data/spdata.py``), deterministic in
``seed``: the same seed gives the same matrix in both packages, entry for
entry. Stand-ins for the paper's datasets (Table II), matched on the
structural property that drives its results: skewed row degrees
(power-law, like web graphs such as arabic-2005), banded PDE matrices
(nlpkkt240; the weak-scaling matrix of Fig. 13), skewed slice sizes
(FROSTT-like 3-tensors such as nell-2) and uniform random.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core import formats as F
from ..core.tensor import Tensor


def uniform_sparse(name: str, shape: Tuple[int, ...], density: float,
                   seed: int = 0, fmt=None) -> Tensor:
    rng = np.random.default_rng(seed)
    nnz = max(int(np.prod([float(s) for s in shape]) * density), 1)
    coords = np.stack([rng.integers(0, s, nnz) for s in shape], axis=1)
    vals = rng.standard_normal(nnz).astype(np.float32)
    fmt = fmt or (F.CSR() if len(shape) == 2 else F.CSF(len(shape)))
    return Tensor.from_coo(name, shape, coords, vals, fmt)


def powerlaw_matrix(name: str, n: int, m: int, avg_nnz_per_row: int = 16,
                    alpha: float = 1.6, seed: int = 0) -> Tensor:
    """Zipf-distributed row degrees, capped at ``m`` (duplicates merge): the
    load-imbalance regime where the paper's non-zero partitions beat
    universe partitions (§II-D)."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(alpha, size=n).astype(np.float64)
    deg = np.minimum(np.maximum(
        (raw / raw.mean() * avg_nnz_per_row).astype(np.int64), 1), m)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = rng.integers(0, m, size=rows.shape[0])
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return Tensor.from_coo(name, (n, m),
                           np.stack([rows, cols], 1), vals, F.CSR())


def banded_matrix(name: str, n: int, bandwidth: int = 5,
                  seed: int = 0) -> Tensor:
    """The weak-scaling matrix of paper Fig. 13 (synthetic banded)."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-bandwidth, bandwidth + 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), offs.shape[0])
    cols = rows + np.tile(offs, n)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return Tensor.from_coo(name, (n, n),
                           np.stack([rows, cols], 1), vals, F.CSR())


def powerlaw_tensor3(name: str, dims: Tuple[int, int, int],
                     avg_nnz_per_slice: int = 64, alpha: float = 1.8,
                     seed: int = 0) -> Tensor:
    """FROSTT-like 3-tensor in CSF with Zipf-distributed slice sizes (capped
    at ``dims[1] * dims[2]``; duplicates merge)."""
    rng = np.random.default_rng(seed)
    n = dims[0]
    raw = rng.zipf(alpha, size=n).astype(np.float64)
    deg = np.minimum(np.maximum(
        (raw / raw.mean() * avg_nnz_per_slice).astype(np.int64), 1),
        dims[1] * dims[2])
    i = np.repeat(np.arange(n, dtype=np.int64), deg)
    j = rng.integers(0, dims[1], size=i.shape[0])
    k = rng.integers(0, dims[2], size=i.shape[0])
    vals = rng.standard_normal(i.shape[0]).astype(np.float32)
    return Tensor.from_coo(name, dims, np.stack([i, j, k], 1), vals,
                           F.CSF(3))
