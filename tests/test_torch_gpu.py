"""Tests of the Hopper kernels that need the card. They import neither JAX
nor the JAX package, so they run where the port runs:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card each test skips with its reason."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_kernels_match_plain_versions(card):
    """Every edge case of chip_smoke (empty rows, an empty piece, a row
    longer than 128 entries, J in {1, 16, 130}) launches its kernel once and
    agrees with the plain version within the per-row tolerance."""
    before = dict(_build.LAUNCHES)
    cases = 0
    for label, name, args, abs_args in chip_smoke.kernel_cases(
            np.random.default_rng(3), card):
        chip_smoke.compare_kernel(label, name, args, abs_args)
        cases += 1
    assert sum(_build.LAUNCHES.values()) - sum(before.values()) == cases


@pytest.mark.gpu
def test_kernels_repeat_bit_for_bit(card):
    """No float atomics: two launches on the same inputs give the same
    bits."""
    fns = chip_smoke.kernel_fns()
    for _, name, args, _ in chip_smoke.kernel_cases(
            np.random.default_rng(4), card):
        kernel = fns[name][0]
        assert torch.equal(kernel(*args), kernel(*args)), name


@pytest.mark.gpu
def test_lower_runs_the_kernels(card):
    """The slice's four cells on the card go through the three kernels and
    agree with the host computation."""
    before = dict(_build.LAUNCHES)
    _, _, _, cells = chip_smoke.run_slice(n=4096, avg_nnz=8, pieces=4, J=33,
                                          seed=1, device=None, reps=1)
    for rec in cells.values():
        assert rec["out"].device.type == "cuda"
    assert all(_build.LAUNCHES[k] > before[k] for k in before)
