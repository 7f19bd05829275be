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
    bits (every part of a compressed result too)."""
    fns = chip_smoke.kernel_fns()
    for _, name, args, _ in chip_smoke.kernel_cases(
            np.random.default_rng(4), card):
        kernel = fns[name][0]
        a, b = kernel(*args), kernel(*args)
        if not isinstance(a, tuple):
            a, b = (a,), (b,)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name


@pytest.mark.gpu
def test_lower_runs_the_kernels(card):
    """The ten cells of the two main paths on the card go through the five
    kernels and agree with the host computation; SDDMM and SpMTTKRP repeat
    bit for bit. The launches are counted over the drive alone: run_slice
    raises unless each cell's kernel launched once per run()."""
    data = chip_smoke.make_inputs(4096, 8, 33, seed=1, dims3=(2048, 64, 64),
                                  rank=33)
    for path, cells in (("matrix", chip_smoke.MATRIX_CELLS),
                        ("slice", chip_smoke.SLICE_CELLS)):
        cells, launches = chip_smoke.run_slice(data, cells, pieces=4,
                                               device=None, reps=1)
        assert all(launches[k] > 0 for k in chip_smoke.PATH_KERNELS[path])
        for name, rec in cells.items():
            if name.split("/")[0] in ("spmv", "spmm", "spmttkrp"):
                assert rec["out"].device.type == "cuda"
            if name.split("/")[0] in ("sddmm", "spmttkrp"):
                assert rec["bitwise"]


@pytest.mark.gpu
def test_new_kernels_match_plain_versions(card):
    """The edge cases of sddmm_coo (K in {1, 7, 32, 33}, C shared and per
    piece) and spmttkrp_coo (L in {1, 7, 32, 33}; an empty row and piece,
    rows across segment edges) launch and agree with the plain versions."""
    cases = [c for c in chip_smoke.kernel_cases(np.random.default_rng(7),
                                                card)
             if c[1] in ("sddmm_coo", "spmttkrp_coo")]
    before = dict(_build.LAUNCHES)
    for label, name, args, abs_args in cases:
        chip_smoke.compare_kernel(label, name, args, abs_args)
    assert (_build.LAUNCHES["sddmm_coo"] - before["sddmm_coo"]
            + _build.LAUNCHES["spmttkrp_coo"] - before["spmttkrp_coo"]
            == len(cases) > 0)


@pytest.mark.gpu
def test_spadd3_kernels_match_plain_versions(card):
    """The SpAdd3 edge cases (an empty operand and piece, a row longer than
    one merge task, coordinates in all three operands, a sum that cancels,
    padding that must not be read, block shapes (2, 2) and (4, 4) with
    ragged edges) launch once each and agree with the plain versions; a
    compressed result has the plain version's pattern exactly."""
    cases = [c for c in chip_smoke.kernel_cases(np.random.default_rng(9),
                                                card) if "spadd3" in c[1]]
    assert {c[1] for c in cases} == set(chip_smoke.PATH_KERNELS["add"])
    before = sum(_build.LAUNCHES.values())
    for label, name, args, abs_args in cases:
        chip_smoke.compare_kernel(label, name, args, abs_args)
    assert sum(_build.LAUNCHES.values()) - before == len(cases)


@pytest.mark.gpu
def test_lower_runs_the_spadd3_kernels(card):
    """The add path on the card at a small size: each of its six cells
    launches its kernel once per run(), stores exactly the host union's
    coordinates and repeats bit for bit (run_slice raises otherwise)."""
    data = chip_smoke.make_inputs(4096, 8, 3, seed=2)
    data["add"] = chip_smoke.add_operands(4096, 2, data["B"])
    data["dense"] = chip_smoke.add_operands(1024, 3)
    recs, launches = chip_smoke.run_slice(data, chip_smoke.ADD_CELLS,
                                          pieces=4, device=None, reps=1)
    assert all(launches[k] > 0 for k in chip_smoke.PATH_KERNELS["add"])
    assert all(rec["bitwise"] for rec in recs.values())


@pytest.mark.gpu
def test_bcsr_kernels_match_plain_versions(card):
    """The blocked edge cases (an empty piece and block-row, a block-row
    across several segments, runs on segment edges, padding that must not
    be read, blocks (2, 2), (4, 4) and (4, 8), J in {1, 16, 33}, K in
    {1, 7, 32, 33}) launch and agree with the plain versions, and two
    launches give the same bits."""
    fns = chip_smoke.kernel_fns()
    cases = [c for c in chip_smoke.kernel_cases(np.random.default_rng(11),
                                                card)
             if c[1] in chip_smoke.PATH_KERNELS["blocked"]]
    assert {c[1] for c in cases} == set(chip_smoke.PATH_KERNELS["blocked"])
    before = sum(_build.LAUNCHES.values())
    for label, name, args, abs_args in cases:
        chip_smoke.compare_kernel(label, name, args, abs_args)
        assert torch.equal(fns[name][0](*args), fns[name][0](*args)), label
    assert sum(_build.LAUNCHES.values()) - before == 3 * len(cases)


@pytest.mark.gpu
def test_lower_runs_the_blocked_kernels(card):
    """The blocked path on the card at a small size: SpMV, SpMM and SDDMM
    over BCSR((4, 4)), rows and nnz, each launch their kernel once per
    run(), agree with the host computation and repeat bit for bit
    (run_slice raises otherwise)."""
    data = chip_smoke.make_inputs(4096, 8, 33, seed=3, rank=33)
    data["add"] = chip_smoke.add_operands(4096, 3, data["B"])
    recs, launches = chip_smoke.run_slice(data, chip_smoke.BLOCKED_CELLS,
                                          pieces=4, device=None, reps=1)
    assert all(launches[k] > 0 for k in chip_smoke.PATH_KERNELS["blocked"])
    assert all(rec["bitwise"] for rec in recs.values())
    assert all(rec["out"].device.type == "cuda" for name, rec in recs.items()
               if not name.startswith("sddmm"))
