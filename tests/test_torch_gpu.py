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
    longer than 128 entries, J in {1, 16, 130}; for the rows kernels a row
    of 60,000 entries, rows of 256 and 257, rows ending on chunk edges, 300
    empty rows in a row, J in {1, 32, 130}) launches its kernel once and
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
    """The ten cells of the two main paths on the card go through the six
    kernels, agree with the host computation and repeat bit for bit. The
    launches are counted over the drive alone: run_slice raises unless each
    cell's kernel launched once per run()."""
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
            assert rec["bitwise"], name


@pytest.mark.gpu
def test_new_kernels_match_plain_versions(card):
    """The edge cases of sddmm_coo (K in {1, 4, 7, 8, 16, 32, 33, 64, 128,
    256}, C shared and per piece, C views 4 bytes off an aligned base) and
    spmttkrp_coo (L in {1, 7, 32, 33}; an empty row and piece,
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
    ragged edges; for the rows unions chip_smoke.union_task_pieces: a row
    of nine tasks with repeated columns at the split values, a column
    longer than a window with empty tasks after it, three identical
    lists, one list alone over two windows, tiles (), (1, 3), (3, 2),
    (2, 2) and (4, 4)) launch once each and agree with the plain versions;
    a compressed result has the plain version's pattern exactly."""
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
    across several segments, runs on segment edges, ids below 0 and
    padding that must not be read, blocks (1, 1), (2, 2), (3, 5), (4, 4),
    (4, 8), (8, 4) and (32, 8), J in {1, 16, 33}, K in {1, 7, 32, 33})
    launch and agree with the plain versions, and two launches give the
    same bits."""
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


@pytest.mark.gpu
def test_spmm_coo_nnz_matches_plain_version(card):
    """spmm_coo_nnz's edge cases (an empty piece and row, runs across one
    and two 256-entry segments, padding ids, J in {1, 7, 16, 32, 33, 130};
    chip_smoke.nnz_split_pieces and nnz_group_pieces: runs of 1024 and
    1025, 1,190 empty rows, rows over 64, 65, 128 and 129 segments, J in
    {1, 7, 32, 33}) launch once each, agree with the plain version and
    repeat bit for bit."""
    kernel = chip_smoke.kernel_fns()["spmm_coo_nnz"][0]
    cases = [c for c in chip_smoke.kernel_cases(np.random.default_rng(13),
                                                card)
             if c[1] == "spmm_coo_nnz"]
    before = _build.LAUNCHES["spmm_coo_nnz"]
    for label, name, args, abs_args in cases:
        chip_smoke.compare_kernel(label, name, args, abs_args)
        assert torch.equal(kernel(*args), kernel(*args)), label
    assert _build.LAUNCHES["spmm_coo_nnz"] - before == 3 * len(cases) > 0


@pytest.mark.gpu
def test_lower_spmm_nnz_repeats_bit_for_bit(card):
    """An nnz SpMM cell lowered on the card launches spmm_coo_nnz once per
    run(), agrees with the host computation, and two run()s give the same
    bits (the plain leaf's index_add_ did not)."""
    import repro_torch.core as tc
    from repro_torch.core.lower import default_nnz_schedule, lower
    data = chip_smoke.make_inputs(1 << 14, 8, 33, seed=5)
    stmt = chip_smoke.statements(data)["spmm"]
    machine = tc.Machine(("x", 4))
    k = lower(stmt, machine, schedule=default_nnz_schedule(stmt, machine))
    before = _build.LAUNCHES["spmm_coo_nnz"]
    a, b = k.run(), k.run()
    assert _build.LAUNCHES["spmm_coo_nnz"] - before == 2
    assert torch.equal(a, b)
    want, scale = chip_smoke.reference_products(data, {"spmm"})["spmm"]
    chip_smoke.check_rows("spmm/nnz", a, want, scale)


@pytest.mark.gpu
def test_lower_spmm_rows_long_row_repeats_bit_for_bit(card):
    """A rows SpMM cell lowered on the card over a power-law matrix whose
    longest row holds more than 10^5 entries (the merge-path split spreads
    it over hundreds of chunks, folded in a fixed order): spmm_csr_rows
    launches once per run(), two run()s give the same bits, and the result
    agrees with the host computation."""
    import repro_torch.core as tc
    from repro_torch.core.lower import default_row_schedule, lower
    data = chip_smoke.make_inputs(1 << 18, 8, 33, seed=5)
    assert np.diff(data["B"].levels[1].pos).max() > 10**5
    stmt = chip_smoke.statements(data)["spmm"]
    machine = tc.Machine(("x", 4))
    k = lower(stmt, machine, schedule=default_row_schedule(stmt, machine))
    before = _build.LAUNCHES["spmm_csr_rows"]
    a, b = k.run(), k.run()
    assert _build.LAUNCHES["spmm_csr_rows"] - before == 2
    assert torch.equal(a, b)
    want, scale = chip_smoke.reference_products(data, {"spmm"})["spmm"]
    chip_smoke.check_rows("spmm/rows", a, want, scale)


@pytest.mark.gpu
def test_flash_attention_matches_plain_version(card):
    """flash_attention against its plain version in f32 (2e-5) and bf16
    (3e-2), G in {1, 4, 8}, ragged S, hd in {16, 64, 128}; position 0 is
    v[0]; two launches give the same bits."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    gen = torch.Generator(card).manual_seed(0)
    before = _build.LAUNCHES["flash_attention"]
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, H, Hkv, hd in ((1, 130, 4, 4, 64), (2, 257, 8, 2, 128),
                                 (1, 333, 8, 1, 16), (2, 64, 32, 8, 128)):
            q, k, v = (torch.randn(shape, generator=gen, device=card)
                       .to(dtype) for shape in
                       ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
            got = flash_attention(q, k, v)
            chip_smoke.compare_flash(f"{dtype} {(B, S, H, Hkv, hd)}", got,
                                     flash_attention_plain(q, k, v), q, v)
            assert torch.equal(got, flash_attention(q, k, v))
            n += 2
    assert _build.LAUNCHES["flash_attention"] - before == n


@pytest.mark.gpu
def test_lm_flash_matches_dense_on_card(card):
    """tests/test_flash_kernel.py's 2-layer model on the card: the flash
    variant launches the kernel once per layer and agrees with the dense
    variant at 1e-3; a 2-layer slice of the attention path at full width
    runs its checks (run_attention raises otherwise)."""
    from repro_torch.configs import ArchConfig
    from repro_torch.models import LM
    cfg = ArchConfig(name="fl", family="dense", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                     head_dim=16, remat=False, dtype="float32")
    lm = LM(cfg)
    params = lm.init_params(torch.Generator(card).manual_seed(0), card)
    tokens = torch.randint(0, 128, (2, 128), device=card)
    before = _build.LAUNCHES["flash_attention"]
    flash, _ = lm.apply(params, tokens, variant="flash")
    assert _build.LAUNCHES["flash_attention"] - before == cfg.n_layers
    dense, _ = lm.apply(params, tokens, variant="dense")
    torch.testing.assert_close(flash, dense, atol=1e-3, rtol=1e-3)
    rec, launches = chip_smoke.run_attention(
        chip_smoke.lm_config(n_layers=2), 1, 512, card, 3)
    assert launches["flash_attention"] == 2 * rec["runs"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flash_attention", "spmv_coo_nnz"])
def test_redesigned_kernels_repeat_bit_for_bit(card, name):
    """The two kernels redesigned last, at their tiles' edges:
    flash_attention's bf16 tensor-core kernels at every bf16 case of
    chip_smoke.FLASH_CASES (S in {1, 15, 17, 65}, hd in {16, 32, 64}, G in
    {1, 3, 8} among them, and the wide kernel's edges at hd 320 and 512),
    spmv_coo_nnz over the block-edge pieces (runs
    on a block's last entry, of 1024 and 1025, over six blocks, 1,190
    empty rows, padding, an empty piece, a piece of one row). Each agrees with
    its plain version and two launches give the same bits (compare_kernel
    launches flash_attention a second time to check its bits itself)."""
    kernel = chip_smoke.kernel_fns()[name][0]
    cases = [c for c in chip_smoke.kernel_cases(np.random.default_rng(17),
                                                card)
             if c[1] == name and (name == "spmv_coo_nnz"
                                  or c[2][0].dtype == torch.bfloat16)]
    before = _build.LAUNCHES[name]
    for label, _, args, abs_args in cases:
        chip_smoke.compare_kernel(label, name, args, abs_args)
        assert torch.equal(kernel(*args), kernel(*args)), label
    per_case = 4 if name == "flash_attention" else 3
    assert _build.LAUNCHES[name] - before == per_case * len(cases) > 0


@pytest.mark.gpu
def test_lower_spmv_nnz_long_row_repeats_bit_for_bit(card):
    """An nnz SpMV cell lowered on the card over a power-law matrix whose
    longest row holds more than 10^5 entries (over 100 1024-entry blocks,
    folded in a fixed order by phase 2): spmv_coo_nnz launches once per
    run(), two run()s give the same bits, and the result agrees with the
    host computation."""
    import repro_torch.core as tc
    from repro_torch.core.lower import default_nnz_schedule, lower
    data = chip_smoke.make_inputs(1 << 18, 8, 1, seed=5)
    assert np.diff(data["B"].levels[1].pos).max() > 10**5
    stmt = chip_smoke.statements(data)["spmv"]
    machine = tc.Machine(("x", 4))
    k = lower(stmt, machine, schedule=default_nnz_schedule(stmt, machine))
    before = _build.LAUNCHES["spmv_coo_nnz"]
    a, b = k.run(), k.run()
    assert _build.LAUNCHES["spmv_coo_nnz"] - before == 2
    assert torch.equal(a, b)
    want, scale = chip_smoke.reference_products(data, {"spmv"})["spmv"]
    chip_smoke.check_rows("spmv/nnz", a, want, scale)


@pytest.mark.gpu
def test_lower_spmm_nnz_long_row_repeats_bit_for_bit(card):
    """An nnz SpMM cell lowered on the card over a power-law matrix whose
    longest row holds more than 10^5 entries (over 64 segments of 256, so
    phase 2 folds it through the 64-segment group sums): spmm_coo_nnz
    launches once per run(), two run()s give the same bits, and the result
    agrees with the host computation."""
    import repro_torch.core as tc
    from repro_torch.core.lower import default_nnz_schedule, lower
    data = chip_smoke.make_inputs(1 << 18, 8, 33, seed=5)
    assert np.diff(data["B"].levels[1].pos).max() > 10**5
    stmt = chip_smoke.statements(data)["spmm"]
    machine = tc.Machine(("x", 4))
    k = lower(stmt, machine, schedule=default_nnz_schedule(stmt, machine))
    before = _build.LAUNCHES["spmm_coo_nnz"]
    a, b = k.run(), k.run()
    assert _build.LAUNCHES["spmm_coo_nnz"] - before == 2
    assert torch.equal(a, b)
    want, scale = chip_smoke.reference_products(data, {"spmm"})["spmm"]
    chip_smoke.check_rows("spmm/nnz", a, want, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("expr", ["spadd3", "spadd3_bcsr"])
def test_lower_spadd3_rows_many_tasks_repeats_bit_for_bit(card, expr):
    """A rows SpAdd3 cell lowered on the card, scalar and BCSR((4, 4)),
    over operands whose longest row spans hundreds of 256-entry merge tasks
    (each merged by a warp): its union kernel launches once per run(), two
    run()s give the same bits, and the union holds exactly the host
    union's coordinates (run_slice raises otherwise)."""
    data = chip_smoke.make_inputs(1 << 18, 8, 3, seed=6)
    data["add"] = chip_smoke.add_operands(1 << 18, 6, data["B"])
    kind = "blocked" if expr == "spadd3_bcsr" else "scalar"
    longest = max(int(np.diff(t.levels[1].pos).max())
                  for t in data["add"][kind])
    assert 3 * longest > 100 * 256
    recs, launches = chip_smoke.run_slice(data, ((expr, "rows"),), pieces=4,
                                          device=None, reps=1)
    name = "bcsr_spadd3_union_rows" if kind == "blocked" \
        else "spadd3_union_rows"
    assert launches[name] == recs[f"{expr}/rows"]["runs"] > 0
    assert recs[f"{expr}/rows"]["bitwise"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sddmm_coo", "bcsr_spmm"])
def test_gather_redesigns_repeat_bit_for_bit(card, name):
    """The two kernels redesigned to keep more gathers in flight, at their
    edges: sddmm_coo at every lane-group size (K in {4, 8, 16, 32, 64, 128,
    256}), at K % 4 != 0 and with C views 4 bytes off an aligned base (its
    scalar kernel) at K in {1, 4, 7, 32, 33, 64}; bcsr_spmm at blocks
    (4, 4) (its templated instance), (1, 1), (2, 2), (3, 5), (4, 8),
    (8, 4), (32, 8) and (4, 4) tiles 4 bytes off an aligned base (the
    generic one), over runs on segment edges, ids below 0 and padding.
    Each agrees with its plain version and two launches give the same
    bits."""
    kernel = chip_smoke.kernel_fns()[name][0]
    cases = [c for c in chip_smoke.kernel_cases(np.random.default_rng(19),
                                                card) if c[1] == name]
    labels = " ".join(c[0] for c in cases)
    if name == "sddmm_coo":
        assert "K=256" in labels and "K=64 shared C at a 4-byte" in labels
    else:
        assert "tiles at a 4-byte offset" in labels
        assert all(f"block=({b})" in labels
                   for b in ("1, 1", "3, 5", "8, 4", "32, 8"))
    before = _build.LAUNCHES[name]
    for label, _, args, abs_args in cases:
        chip_smoke.compare_kernel(label, name, args, abs_args)
        assert torch.equal(kernel(*args), kernel(*args)), label
    per_case = 4 if name == "flash_attention" else 3
    assert _build.LAUNCHES[name] - before == per_case * len(cases) > 0


@pytest.mark.gpu
def test_gather_redesigns_take_their_paths(card):
    """The kernel each wrapper launches, by name (torch.profiler): an
    aligned C at K = 32 runs sddmm_coo's group kernel with G = 8 and a C
    view 4 bytes off its scalar kernel; aligned (4, 4) tiles run
    bcsr_spmm's (4, 4) instance and tiles 4 bytes off its generic one."""
    fns = chip_smoke.kernel_fns()
    cases = [c for c in chip_smoke.kernel_cases(np.random.default_rng(23),
                                                card)
             if c[1] in ("sddmm_coo", "bcsr_spmm")]
    want = {("sddmm_coo", "K=32 shared", False): "sddmm_group_kernel<8",
            ("sddmm_coo", "K=32 shared", True): "sddmm_coo_kernel",
            ("bcsr_spmm", "block=(4, 4) J=33", False): "bcsr_spmm_phase1<4",
            ("bcsr_spmm", "block=(4, 4) J=33", True): "bcsr_spmm_phase1<8"}
    for (name, tag, off), kernel in want.items():
        label, _, args, _ = next(
            c for c in cases if c[1] == name and tag in c[0]
            and ("4-byte offset" in c[0]) == off)
        launched = chip_smoke.device_breakdown(lambda: fns[name][0](*args))
        assert kernel in launched, (label, sorted(launched))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bcsr_spmv", "bcsr_spmm", "bcsr_sddmm"])
def test_blocked_kernels_take_oversized_blocks(card, name):
    """Blocks with more than 32 rows or more than 256 entries, (33, 1) and
    (64, 8), over chip_smoke's blocked edge cases (runs on segment edges,
    ids below 0, padding): each blocked kernel launches, agrees with its
    plain version and gives the same bits twice."""
    kernel = chip_smoke.kernel_fns()[name][0]
    cases = [c for c in chip_smoke.kernel_cases(np.random.default_rng(29),
                                                card)
             if c[1] == name and ("block=(33, 1)" in c[0]
                                  or "block=(64, 8)" in c[0])]
    assert {"(33, 1)" in c[0] for c in cases} == {True, False}
    before = _build.LAUNCHES[name]
    for label, _, args, abs_args in cases:
        chip_smoke.compare_kernel(label, name, args, abs_args)
        assert torch.equal(kernel(*args), kernel(*args)), label
    assert _build.LAUNCHES[name] - before == 3 * len(cases)


@pytest.mark.gpu
def test_flash_attention_other_head_widths(card):
    """hd 112 (zero-padded to the 128 instance), 256 (its own width),
    300 (padded to 384), 392 (run at 512; in bf16 and f16 read unpadded,
    ending inside the second 256-dim slab) and 512 (flash_mma_wide_kernel
    in bf16 and f16 at 256, 384 and 512,
    the f32 kernel's own instances in f32) in f32, bf16 and f16, then hd
    640, 768 and 1024 in f32 (flash_f32_cluster_kernel<128>, clusters of
    5, 6 and 8 blocks) at G 1 and 3, 2048 (16 blocks of 128 columns), 2176
    at G 1 and 3 and 2432 (flash_f32_cluster_kernel<256>: 9 and 10 blocks
    of 256 columns, the last one's second half past hd), 4096 (its
    widest, 16 blocks) and 4224 (past it: the f32 column-chunk kernel),
    then the wide
    16-bit kernel's tile edges and hd 640 in bf16 and f16
    (chip_smoke.WIDE16_EDGE_CASES: S one below, at and one past 16 rows,
    a 32-row group, 64 keys and a 128-key tile, G in {1, 3, 8}, hd 200,
    256, 320 and 512; hd 130, padded to 256; hd 640 at G 1 and 3), then
    the f32 kernel's tile edges
    (chip_smoke.f32_edge_cases:
    S one below and one past a block's stacked rows and one past a 64-key
    stage, G in {1, 3, 8}, hd 128, 256 and 512), against the plain version
    (2e-5, 3e-2, 1e-2), position 0 is v[0], two launches give the same
    bits."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    gen = torch.Generator(card).manual_seed(1)
    before = _build.LAUNCHES["flash_attention"]
    n = 0
    cases = [(dtype, shape) for dtype in (torch.float32, torch.bfloat16,
                                          torch.float16)
             for shape in ((2, 257, 8, 2, 112), (1, 200, 4, 1, 256),
                           (1, 130, 6, 2, 300), (1, 130, 6, 2, 392),
                           (2, 70, 4, 2, 512))] + [
        (torch.float32, (1, 130, 2 * G, 2, hd)) for hd in (640, 768, 1024)
        for G in (1, 3)] + [
        (torch.float32, (1, 130, 2, 1, 2048)),
        (torch.float32, (1, 70, 2, 1, 2176)),
        (torch.float32, (1, 130, 6, 2, 2176)),
        (torch.float32, (1, 70, 6, 2, 2432)),
        (torch.float32, (1, 70, 2, 1, 4096)),
        (torch.float32, (1, 70, 2, 1, 4224))] + [
        (getattr(torch, dt), shape)
        for *shape, dt in chip_smoke.WIDE16_EDGE_CASES
        + chip_smoke.f32_edge_cases()]
    for dtype, (B, S, H, Hkv, hd) in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
                   for shape in ((B, S, H, hd), (B, S, Hkv, hd),
                                 (B, S, Hkv, hd)))
        got = flash_attention(q, k, v)
        chip_smoke.compare_flash(f"{dtype} {(B, S, H, Hkv, hd)}", got,
                                 flash_attention_plain(q, k, v), q, v)
        assert torch.equal(got, flash_attention(q, k, v))
        n += 2
    assert _build.LAUNCHES["flash_attention"] - before == n


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bcsr_spmv", "spadd3_union_nnz",
                                  "bcsr_spadd3_union_nnz"])
def test_spmv_and_union_redesigns_repeat_bit_for_bit(card, name):
    """bcsr_spmv over chip_smoke's blocked cases (every block, tiles 4
    bytes off an aligned base, block-rows over 70 and 128 segments) and
    the two nnz union kernels over its SpAdd3 streams (runs over 8
    segments, U = 59, values 4 bytes off): each agrees with its plain
    version and two launches give the same bits."""
    kernel = chip_smoke.kernel_fns()[name][0]
    cases = [c for c in chip_smoke.kernel_cases(np.random.default_rng(41),
                                                card) if c[1] == name]
    labels = " ".join(c[0] for c in cases)
    assert ("long block-rows" in labels if name == "bcsr_spmv"
            else "over 8 segments" in labels)
    before = _build.LAUNCHES[name]
    for label, _, args, abs_args in cases:
        chip_smoke.compare_kernel(label, name, args, abs_args)
        assert torch.equal(kernel(*args), kernel(*args)), label
    per_case = 4 if name == "flash_attention" else 3
    assert _build.LAUNCHES[name] - before == per_case * len(cases) > 0


@pytest.mark.gpu
def test_spmv_and_union_redesigns_take_their_paths(card):
    """The kernels each wrapper launches, by name (torch.profiler): aligned
    (4, 4) tiles run bcsr_spmv's (4, 4) instance, tiles 4 bytes off its
    generic one, and a block-row over 70 segments the group sums and the
    edge fold; (4, 4) union values run the 16-byte warp union kernel,
    values 4 bytes off its 4-byte instance, and scalar values the kernel
    with a thread per run."""
    fns = chip_smoke.kernel_fns()
    names = ("bcsr_spmv", "spadd3_union_nnz", "bcsr_spadd3_union_nnz")
    cases = [c for c in chip_smoke.kernel_cases(np.random.default_rng(43),
                                                card) if c[1] in names]
    p1, p44 = "bcsr_spmv_phase1", "bcsr_spmv_phase1_44"
    want = {("bcsr_spmv", "P=4 N=", "block=(4, 4)", False): ({p44}, {p1}),
            ("bcsr_spmv", "P=4 N=", "block=(4, 4)", True): ({p1}, {p44}),
            ("bcsr_spmv", "long block-rows", "block=(4, 4)", False):
            ({p44, "segment_fold::group_sums",
              "segment_fold::edge_fold<128>"}, set()),
            ("bcsr_spadd3_union_nnz", "over 8 segments", "tile=(4, 4)",
             False): ({"union_runs_warp_kernel<true>"},
                      {"union_runs_warp_kernel<false>"}),
            ("bcsr_spadd3_union_nnz", "over 8 segments", "tile=(4, 4)",
             True): ({"union_runs_warp_kernel<false>"},
                     {"union_runs_warp_kernel<true>"}),
            ("spadd3_union_nnz", "over 8 segments", "tile=()", False):
            ({"union_runs_kernel"}, {"union_runs_warp_kernel<true>",
                                     "union_runs_warp_kernel<false>"})}
    for (name, tag, block, off), (runs, not_runs) in want.items():
        label, _, args, _ = next(
            c for c in cases if c[1] == name and tag in c[0]
            and block in c[0] and ("4-byte offset" in c[0]) == off)
        launched = set(chip_smoke.device_breakdown(
            lambda: fns[name][0](*args)))
        assert runs <= launched and not (not_runs & launched), \
            (label, sorted(launched))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bcsr_sddmm", "spmttkrp_coo"])
def test_blocked_sddmm_and_mttkrp_repeat_bit_for_bit(card, name):
    """The two kernels redesigned to keep more gathers in flight and fold
    in groups, at their edges: bcsr_sddmm at every block of chip_smoke's
    blocked cases, K in {1, 7, 32, 33}, C shared and per piece and 4 bytes
    off an aligned base; spmttkrp_coo over rows across one and two segment
    edges, rows over 64, 65, 128 and 129 segments (the group fold), L in
    {1, 7, 32, 33}. Each agrees with its plain version and two launches
    give the same bits."""
    kernel = chip_smoke.kernel_fns()[name][0]
    cases = [c for c in chip_smoke.kernel_cases(np.random.default_rng(31),
                                                card) if c[1] == name]
    labels = " ".join(c[0] for c in cases)
    assert ("C at a 4-byte offset" in labels if name == "bcsr_sddmm"
            else "group edges" in labels)
    before = _build.LAUNCHES[name]
    for label, _, args, abs_args in cases:
        chip_smoke.compare_kernel(label, name, args, abs_args)
        assert torch.equal(kernel(*args), kernel(*args)), label
    per_case = 4 if name == "flash_attention" else 3
    assert _build.LAUNCHES[name] - before == per_case * len(cases) > 0


@pytest.mark.gpu
def test_blocked_sddmm_and_mttkrp_take_their_paths(card):
    """The kernels each wrapper launches, by name (torch.profiler): an
    aligned C at K = 32 runs bcsr_sddmm's 16-byte instance and a C view 4
    bytes off its 4-byte one; spmttkrp_coo over rows across many segments
    runs phase 1, the group sums and the edge fold."""
    fns = chip_smoke.kernel_fns()
    cases = [c for c in chip_smoke.kernel_cases(np.random.default_rng(37),
                                                card)
             if c[1] in ("bcsr_sddmm", "spmttkrp_coo")]
    want = {("bcsr_sddmm", "block=(4, 4) K=32 shared", False):
            ("bcsr_sddmm_kernel<true",),
            ("bcsr_sddmm", "block=(4, 4) K=32 shared", True):
            ("bcsr_sddmm_kernel<false",),
            ("spmttkrp_coo", "group edges L=32", False):
            ("spmttkrp_phase1_kernel", "group_sums", "edge_fold")}
    for (name, tag, off), kernels in want.items():
        label, _, args, _ = next(
            c for c in cases if c[1] == name and tag in c[0]
            and ("4-byte offset" in c[0]) == off)
        launched = " ".join(chip_smoke.device_breakdown(
            lambda: fns[name][0](*args)))
        assert all(k in launched for k in kernels), (label, launched)


@pytest.fixture(scope="module")
def grid_data():
    """The grid path's operands at a small size (chip_smoke's generators)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    data = chip_smoke.make_inputs(4096, 8, 33, seed=1, dims3=(2048, 64, 64),
                                  rank=33)
    data["add"] = chip_smoke.add_operands(4096, 1, data["B"])
    data["grid"] = chip_smoke.grid_operands(data, 64, 1)
    return data


def _host(x):
    if torch.is_tensor(x):
        return x.cpu().numpy()
    return np.asarray(x) if isinstance(x, np.ndarray) else x


@pytest.mark.gpu
@pytest.mark.parametrize("cell", chip_smoke.GRID_CELLS,
                         ids=chip_smoke.cell_name)
def test_grid_cell_on_card_matches_cpu(card, grid_data, cell):
    """One cell per grid emitter (and the grid nnz, conversion and generic
    cells), lowered on the card: its kernel launches as many times per
    run() as the emitter documents and nothing else launches (run_slice
    raises otherwise), it agrees with the host computation, repeats bit
    for bit, and matches the same cell lowered on the CPU."""
    recs, launches = chip_smoke.run_slice(grid_data, (cell,), pieces=4,
                                          device=None, reps=1)
    (rec,) = recs.values()
    assert rec["bitwise"]
    if rec["call"] is not None:
        assert rec["per_run"] >= 1
        assert launches[rec["call"][0]] == rec["runs"] * rec["per_run"]
    cpu, _ = chip_smoke.run_slice(grid_data, (cell,), pieces=4,
                                  device="cpu", reps=1)
    (want,) = cpu.values()
    got, exp = _host(rec["out"]), _host(want["out"])
    if isinstance(got, np.ndarray):
        np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-4)
    else:
        for gl, wl in zip(got.levels, exp.levels):
            for x, y in ((gl.pos, wl.pos), (gl.crd, wl.crd)):
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(got.vals, exp.vals, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["csr", "bcsr"])
@pytest.mark.parametrize("strategy", ["rows", "nnz"])
def test_grid_equals_flat_twin_bitwise_on_card(card, strategy, fmt):
    """A 2x2 SpMM grid cell on integer inputs gives exactly the bits of its
    pieces-equal 4x1 twin on the card (every f32 sum is exact)."""
    import repro_torch.core as tc
    from repro_torch.core import lower as L
    rng = np.random.default_rng(5)
    n, m, J = 3000, 2000, 33
    d = (rng.integers(-3, 4, (n, m))
         * (rng.random((n, m)) < 0.01)).astype(np.float32)
    d[7] = rng.integers(-3, 4, m)                       # a long row
    fm = tc.CSR() if fmt == "csr" else tc.BCSR((4, 4))
    stmt = tc.parse_tin(
        "A(i,j) = B(i,k) * C(k,j)", A=tc.Tensor.zeros_dense("A", (n, J)),
        B=tc.Tensor.from_dense("B", d, fm),
        C=tc.Tensor.from_dense("C", rng.integers(-3, 4, (m, J))
                               .astype(np.float32)))
    M22, M4 = tc.Machine(("x", 2), ("y", 2)), tc.Machine(("x", 4))
    grid, flat = ((L.default_grid_schedule, L.default_row_schedule)
                  if strategy == "rows" else
                  (L.default_grid_nnz_schedule, L.default_nnz_schedule))
    kg = L.lower(stmt, M22, grid(stmt, M22), device=card)
    k1 = L.lower(stmt, M4, flat(stmt, M4), device=card)
    got = kg.run()
    assert got.device.type == "cuda"
    assert torch.equal(got, k1.run())
    np.testing.assert_array_equal(got.cpu().numpy(), d @ stmt.rhs.accesses()[
        1].tensor.to_dense())


# -- the distributed executor on the card ------------------------------------

SPMD_CARD_CELLS = [("spmv/csr/rows/2", "spmv", "csr", "rows", "2"),
                   ("spmv/csr/nnz/2", "spmv", "csr", "nnz", "2"),
                   ("spmm/csr/grid/1x2", "spmm", "csr", "grid", "1x2"),
                   ("sddmm/bcsr44/nnz/2", "sddmm", "bcsr44", "nnz", "2")]


@pytest.mark.gpu
def test_executor_ranks_share_the_card(card, tmp_path):
    """Two ranks on the one card, over gloo: every cell is its k.run() bit
    for bit on both ranks and launches its kernel once per call on each;
    the ring shift (staged through the host by table), the gather and the
    reduce-scatter hold on the card; NCCL asked for the two ranks on one
    device raises, naming them."""
    from test_torch_spmd import operands, spawn_ranks
    data = tmp_path / "data.npz"
    np.savez(data, **operands())
    statuses = spawn_ranks(2, SPMD_CARD_CELLS, data, str(tmp_path),
                           device="cuda:0", checks=("nccl", "ring"))
    for s in statuses:
        for cell in SPMD_CARD_CELLS:
            assert s["bits"][cell[0]], (cell[0], s["rank"])
            assert s["launches"][cell[0]], (cell[0], s["rank"])
        assert s["collectives"]["nccl_two_ranks_one_device"], s["rank"]
        assert s["collectives"]["one_axis_ring_gather_scatter"], s["rank"]


def _card_spmm(sched, card):
    import repro_torch.core as tc
    rng = np.random.default_rng(5)
    n, m, j = 3000, 2000, 32
    dB = np.where(rng.random((n, m)) < 0.01,
                  rng.standard_normal((n, m)), 0).astype(np.float32)
    stmt = tc.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                        A=tc.Tensor.zeros_dense("A", (n, j)),
                        B=tc.Tensor.from_dense("B", dB, tc.CSR()),
                        C=tc.Tensor.from_dense("C", rng.standard_normal(
                            (m, j)).astype(np.float32)))
    if sched == "grid":
        machine = tc.Machine(("x", 2), ("y", 2))
        s = tc.lower.default_grid_schedule(stmt, machine)
    else:
        machine = tc.Machine(("x", 4))
        s = (tc.lower.default_nnz_schedule(stmt, machine) if sched == "nnz"
             else tc.lower.default_row_schedule(stmt, machine))
    return tc.lower_stmt(stmt, machine, schedule=s, device=card)


@pytest.mark.gpu
@pytest.mark.parametrize("sched", ["rows", "nnz", "grid"])
def test_run_overlapped_and_profile_pieces_on_card(card, sched):
    """run_overlapped's copy stream and event: the chunked run is k.run()
    bit for bit, overlapped or not, launching the kernel once a chunk;
    profile_pieces times every piece with CUDA events."""
    from repro_torch.distributed.executor import (profile_pieces,
                                                  run_overlapped)
    k = _card_spmm(sched, card)
    kernel = {"spmm_rows": "spmm_csr_rows", "spmm_nnz": "spmm_coo_nnz",
              "spmm_grid_rows": "spmm_csr_rows"}[k.leaf_name]
    ref = k.run()
    for chunks in (2, 4):
        for overlap in (True, False):
            before = dict(_build.LAUNCHES)
            got = run_overlapped(k, chunks=chunks, overlap=overlap)
            launched = {n: c - before[n] for n, c in _build.LAUNCHES.items()
                        if c != before[n]}
            assert got.device == ref.device and torch.equal(got, ref)
            assert launched == {kernel: chunks}
    prof = profile_pieces(k, iters=2)
    assert prof.seconds.shape == (k.strategy.pieces,)
    assert np.all(prof.seconds > 0)


# ---------------------------------------------------------------------------
# The runtime and serving on the card
# ---------------------------------------------------------------------------

def _int_spmm_stmt(seed, n=4096, m=3000, j=8, fmt="csr", spmv=False):
    """An integer-valued SpMM (or SpMV) over a sparse B with a row 200
    times longer than the mean: every sum is exact in f32."""
    import repro_torch.core as tc
    rng = np.random.default_rng(seed)
    dB = np.where(rng.random((n, m)) < 0.004, rng.integers(-3, 4, (n, m)),
                  0).astype(np.float32)
    dB[17] = rng.integers(-3, 4, m)
    fm = tc.BCSR((4, 4)) if fmt == "bcsr" else tc.CSR()
    B = tc.Tensor.from_dense("B", dB, fm)
    if spmv:
        return tc.parse_tin("a(i) = B(i,j) * c(j)",
                            a=tc.Tensor.zeros_dense("a", (n,)), B=B,
                            c=tc.Tensor.from_dense("c", rng.integers(
                                -3, 4, m).astype(np.float32)))
    return tc.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                        A=tc.Tensor.zeros_dense("A", (n, j)), B=B,
                        C=tc.Tensor.from_dense("C", rng.integers(
                            -3, 4, (m, j)).astype(np.float32)))


@pytest.mark.gpu
@pytest.mark.parametrize("expr,fmt,sched", [("spmv", "csr", "rows"),
                                            ("spmm", "csr", "nnz"),
                                            ("spmv", "bcsr", "rows")])
def test_recovery_on_card_matches_unfaulted_run(card, tmp_path, expr, fmt,
                                                sched):
    """run_with_recovery on the card: a device loss at step 3 (P = 4 -> 3)
    and B corrupted at step 5 give the unfaulted run's bits, the state
    stays on the card, and each step launches the cell's kernel once."""
    import repro_torch.core as tc
    from repro_torch.core import lower as L
    from repro_torch.runtime.elastic import run_with_recovery
    from repro_torch.runtime.fault import FaultEvent, FaultInjector
    stmt = _int_spmm_stmt(5, fmt=fmt, spmv=expr == "spmv")
    M4 = tc.Machine(("x", 4))
    schedule = L.default_nnz_schedule(stmt, M4) if sched == "nnz" else None
    kernel = {"spmv": "bcsr_spmv" if fmt == "bcsr" else "spmv_csr_rows",
              "spmm": "spmm_coo_nnz"}[expr]
    out = []
    for faulted in (False, True):
        L.clear_lowering_caches()
        inj = FaultInjector([FaultEvent(step=3, kind="device_loss", piece=1),
                             FaultEvent(step=5, kind="corrupt",
                                        tensor="B")]) if faulted else None
        before = dict(_build.LAUNCHES)
        state, rep = run_with_recovery(
            stmt, M4, 8, ckpt_dir=str(tmp_path / str(faulted)),
            schedule=schedule, injector=inj, device=card)
        launched = {n: c - before[n] for n, c in _build.LAUNCHES.items()
                    if c != before[n]}
        replayed = 3 - rep.restored_step if faulted else 0
        assert launched == {kernel: 1 + 8 + replayed}
        assert state.device.type == "cuda"
        out.append((state, rep))
    (ref, _), (state, rep) = out
    assert torch.equal(state, ref)
    assert rep.restarts == 1 and rep.final_pieces == 3
    assert rep.healed == ["B"] and rep.shard_reuse >= 0.5
    assert abs(rep.restore_s + rep.replan_s + rep.rejit_s
               - rep.recovery_s) < 1e-9


@pytest.mark.gpu
@pytest.mark.parametrize("sched", ["rows", "nnz", "grid"])
def test_run_many_matches_loop_on_card(card, sched):
    """run_many on the card: each batch one launch of its SpMM kernel, the
    per-request loop's bits, the exact product."""
    import repro_torch.core as tc
    from repro_torch.core import lower as L
    stmt = _int_spmm_stmt(6, spmv=True)
    B = stmt.rhs.accesses()[0].tensor.to_dense()
    n, m = B.shape
    stmt = tc.parse_tin("a(i) = B(i,j) * c(j)",
                        a=tc.Tensor.zeros_dense("a", (n,)),
                        B=stmt.rhs.accesses()[0].tensor,
                        c=tc.Tensor.zeros_dense("c", (m,)))
    if sched == "grid":
        machine, fn = tc.Machine(("x", 2), ("y", 2)), L.default_grid_schedule
    else:
        machine = tc.Machine(("x", 4))
        fn = L.default_nnz_schedule if sched == "nnz" else None
    bk = L.lower_batched(stmt, machine, batch=8, schedule=fn, device=card)
    kernel = {"rows": "spmm_csr_rows", "nnz": "spmm_coo_nnz",
              "grid": "spmm_csr_rows"}[sched]
    rng = np.random.default_rng(7)
    reqs = [rng.integers(-3, 4, m).astype(np.float32) for _ in range(8)]
    for size in (8, 5):
        before = dict(_build.LAUNCHES)
        batch = bk.run_many(reqs[:size])
        launched = {n_: c - before[n_] for n_, c in _build.LAUNCHES.items()
                    if c != before[n_]}
        assert launched == {kernel: 1}
        loop = [bk.run_many([r])[0] for r in reqs[:size]]
        for r, yb, yl in zip(reqs, batch, loop):
            assert yb.device.type == "cuda" and torch.equal(yb, yl)
            assert np.array_equal(yb.cpu().numpy(), B @ r)


@pytest.mark.gpu
@pytest.mark.parametrize("sched", ["rows", "nnz"])
@pytest.mark.parametrize("fmt", ["csr", "bcsr"])
def test_elastic_lower_equals_plain_on_card(card, sched, fmt):
    """An elastic lower on the card: the plain lower's shard arrays and
    meta, and its run() bits, at P = 4 and on migration bounds at P = 3."""
    import repro_torch.core as tc
    from repro_torch.core import lower as L
    from repro_torch.core.partition import elastic_row_bounds
    stmt = _int_spmm_stmt(8, fmt=fmt)
    M4, M3 = tc.Machine(("x", 4)), tc.Machine(("x", 3))

    def schedule(m):
        return L.default_nnz_schedule(stmt, m) if sched == "nnz" else None

    L.clear_lowering_caches()
    k = L.lower(stmt, M4, schedule=schedule(M4), elastic=True, device=card)
    p = L.lower(stmt, M4, schedule=schedule(M4), device=card)
    for name, sh in p.shards.items():
        assert k.shards[name].meta == sh.meta
        for x, a in sh.arrays.items():
            assert np.array_equal(k.shards[name].arrays[x], a), (name, x)
    ref = p.run()
    assert torch.equal(k.run(), ref)
    merged = elastic_row_bounds(L._elastic_init_bounds(k), 1)
    k3 = L.lower(stmt, M3, schedule=schedule(M3), elastic=True,
                 init_bounds=merged, device=card)
    p3 = L.lower(stmt, M3, schedule=schedule(M3), init_bounds=merged,
                 device=card)
    assert torch.equal(k3.run(), p3.run()) and torch.equal(k3.run(), ref)
    assert torch.equal(L.relower(k, M3, dead=2).run(), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["csr", "bcsr"])
def test_autoscheduler_measures_on_card(card, fmt):
    """``schedule="auto"`` on the card with the default search: the model's
    top 3 are lowered and timed there (``measured_s``), the winner is the
    measured minimum and its run() has the bits of a hand lower of its
    point (and the exact product); the warm re-lower hits the tuned-plan
    cache without searching again."""
    import repro_torch.core as tc
    from repro_torch.core import lower as L
    from repro_torch.core import plan_search as PS
    stmt = _int_spmm_stmt(9, fmt=fmt)
    machine = tc.Machine(("x", 4))
    L.clear_lowering_caches()
    k = L.lower(stmt, machine, schedule="auto", device=card)
    w = k.tuned
    assert w is not None and k.cache.tuned_misses == 1
    top = w.candidates[:PS.DEFAULT_CONFIG.refine_top_k]
    assert all(c["measured_s"] is not None and c["measured_s"] > 0
               for c in top)
    assert all(c["measured_s"] is None
               for c in w.candidates[PS.DEFAULT_CONFIG.refine_top_k:])
    assert w.label == min(top, key=lambda c: c["measured_s"])["label"]
    assert k.strategy.tile == w.tile and (w.tile is not None) == (
        fmt == "bcsr")
    sched, m = w.build(stmt, machine)
    hand = L.lower(stmt, m, schedule=sched, device=card)
    got = k.run()
    assert got.device.type == "cuda" and torch.equal(got, hand.run())
    B = stmt.rhs.accesses()[0].tensor.to_dense()
    C = stmt.rhs.accesses()[1].tensor.to_dense()
    assert np.array_equal(got.cpu().numpy(), B @ C)
    real = PS.search
    PS.search = lambda *a, **kw: pytest.fail("the warm lower searched")
    try:
        warm = L.lower(stmt, machine, schedule="auto", device=card)
    finally:
        PS.search = real
    assert warm.cache.tuned_hits == 1 and warm.cache.warm
    assert warm.tuned is w and torch.equal(warm.run(), got)


def _to(tree, device):
    """A nested dict / list of tensors, copied to ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "llama3-8b",
                                  "llama4-scout-17b-a16e", "llava-next-34b",
                                  "olmoe-1b-7b", "qwen3-14b",
                                  "seamless-m4t-medium", "starcoder2-15b",
                                  "xlstm-125m", "zamba2-7b"])
def test_lm_on_card_matches_cpu(card, arch):
    """Every family at reduced size in f32, the same weights on the card and
    on the CPU: the flash prefill (the kernel on the card, its plain
    version on the CPU) and four decode steps from an empty cache agree at
    1e-4 (MoE capacity raised, so no routing tie decides a drop)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import LM
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32",
                              moe_capacity_factor=16.0)
    lm = LM(cfg)
    cpu = lm.init_params(torch.Generator().manual_seed(0), "cpu")
    gpu = _to(cpu, card)
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    fe = (torch.randn((2, cfg.frontend_tokens, cfg.d_model), generator=gen)
          if cfg.frontend != "none" else None)
    want, _ = lm.apply(cpu, tok, fe, variant="flash")
    got, _ = lm.apply(gpu, tok.to(card), None if fe is None else fe.to(card),
                      variant="flash")
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    src = cfg.frontend_tokens if cfg.is_encdec else 0
    c_cpu = lm.init_cache(2, 8, src_len=src, device="cpu")
    c_gpu = lm.init_cache(2, 8, src_len=src, device=card)
    for s in range(4):
        want, _ = lm.decode_step(cpu, c_cpu, tok[:, s])
        got, _ = lm.decode_step(gpu, c_gpu, tok[:, s].to(card))
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for k, t in c_gpu.items():
        torch.testing.assert_close(t.cpu(), c_cpu[k], atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_server_on_card_repeats_and_keeps_the_fresh_slot_rule(card):
    """The reduced llama3-8b in bf16 on the card, 2 slots and 5 requests:
    a second run gives the same tokens, and each request the tokens it
    gets alone in a fresh Server on the same weights."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import Server, draw_requests
    cfg = dataclasses.replace(get_arch("llama3-8b").reduced(),
                              param_dtype="bfloat16")
    srv = Server(cfg, slots=2, context=64, device=card)
    first = srv.run(draw_requests(cfg.vocab_size, 5, 6))
    assert srv.run(draw_requests(cfg.vocab_size, 5, 6)) == first
    for r in draw_requests(cfg.vocab_size, 5, 6):
        alone = Server(cfg, slots=2, context=64, device=card,
                       params=srv.params)
        assert alone.run([r]) == {r.rid: first[r.rid]}


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(card):
    """One reduced internlm2-1.8b ``make_train_step`` step (f32
    activations, TF32 off, 2 microbatches) on the card against the same
    step on the CPU from the same weights and tokens: loss and gnorm at
    1e-4, every first moment (the clipped mean gradient) at a relative
    Frobenius error <= 1e-4, the new parameters within 4 lr (AdamW's first
    step is near lr * sign(g)); no kernel launches."""
    import dataclasses
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import LM
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("internlm2-1.8b").reduced(),
                              dtype="float32")
    shape = ShapeConfig("t", "train", seq_len=32, global_batch=4,
                        grad_accum=2)
    lr = 1e-3
    host = LM(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    tok = torch.from_numpy(TokenSource(DataConfig(cfg.vocab_size, 32, 4))
                           .batch_at(0)["tokens"])
    before = dict(_build.LAUNCHES)
    out = []
    for dev in (card, torch.device("cpu")):
        mesh = make_smoke_mesh(dev)
        fn, _ = steps.make_train_step(steps.build_lm(cfg, mesh), shape,
                                      mesh, peak_lr=lr, total_steps=10)
        p = tree_map(lambda x: x.clone().to(dev), host)
        new_p, opt, m = fn(p, adamw_init(p), tok.to(dev))
        out.append((tree_map(lambda x: x.cpu(), (new_p, opt.mu)),
                    {k: float(v) for k, v in m.items()}))
    assert _build.LAUNCHES == before
    ((p_card, mu_card), m_card), ((p_cpu, mu_cpu), m_cpu) = out
    for k in ("loss", "gnorm", "lr"):
        assert m_card[k] == pytest.approx(m_cpu[k], rel=1e-4), k
    for a, b in zip(leaves(mu_card), leaves(mu_cpu)):
        assert float((a - b).norm() / b.norm()) <= 1e-4
    for a, b in zip(leaves(p_card), leaves(p_cpu)):
        assert float((a - b).abs().max()) <= 4 * lr


@pytest.mark.gpu
def test_flash_f32_plan_is_the_kernels(card):
    """The wrapper's f32_plan is the library's F32Plan at every f32
    width."""
    from repro_torch.kernels.flash_attention import F32_WIDTHS
    assert sorted(chip_smoke.check_f32_plan()) == sorted(F32_WIDTHS)


@pytest.mark.gpu
def test_flash_f32_cluster_plan_is_the_kernels(card):
    """The wrapper's f32_cluster_plan is the library's ClusterPlan at hd
    640, 1024, 2048, 2176 and 4096, and the card holds a cluster of each
    width's blocks; the library refuses a width past the widest cluster
    (16 blocks of 256 columns)."""
    from repro_torch.kernels.flash_attention import (F32_CLUSTER_COLS,
                                                     F32_CLUSTER_MAX,
                                                     f32_cluster_plan_card)
    resident = chip_smoke.check_f32_cluster_plan()
    assert sorted(resident) == list(chip_smoke.F32_CLUSTER_WIDTHS)
    with pytest.raises(ValueError):
        f32_cluster_plan_card(F32_CLUSTER_MAX * F32_CLUSTER_COLS + 128)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_refuses_unaligned_views(card, dtype):
    """A contiguous view that starts off a 16-byte boundary raises a
    ValueError before any launch (the kernels load 16 bytes at a time);
    the same values in a fresh tensor run and match the plain version."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    B, S, H, Hkv, hd = 1, 70, 4, 2, 64
    flat = torch.randn(B * S * H * hd + 1, device=card).to(dtype)
    q = flat[1:].view(B, S, H, hd)
    k, v = (torch.randn(B, S, Hkv, hd, device=card).to(dtype)
            for _ in range(2))
    assert q.is_contiguous() and q.data_ptr() % 16
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, k, v)
    assert _build.LAUNCHES == before
    q = q.clone()
    chip_smoke.compare_flash("aligned copy", flash_attention(q, k, v),
                             flash_attention_plain(q, k, v), q, v)


@pytest.mark.gpu
def test_flash_attention_refuses_autograd_on_card(card):
    """The kernel has no backward (nor has the reference's): CUDA tensors
    that require grad raise before any launch; under no_grad it runs."""
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn(1, 64, 4, 64, device=card, dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn(1, 64, 2, 64, device=card, dtype=torch.bfloat16)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention(q, k, k)
    assert _build.LAUNCHES == before
    with torch.no_grad():
        o = flash_attention(q, k, k)
    assert o.shape == q.shape and not o.requires_grad
    assert _build.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 1


@pytest.mark.gpu
def test_dryrun_flops_equal_the_card_step(card):
    """The ``meta`` FLOP count of a reduced train step (remat on, 2
    microbatches) equals ``FlopCounterMode`` over the same step on the
    card."""
    import dataclasses
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(get_arch("internlm2-1.8b").reduced(),
                              remat=True)
    shape = ShapeConfig("t", "train", 64, 8, grad_accum=2)
    meta = dryrun.count_step(cfg, shape, make_smoke_mesh("meta"))["flops"]
    mesh = make_smoke_mesh(card)
    lm = S.build_lm(cfg, mesh)
    params = lm.init_params(torch.Generator(card).manual_seed(0), card)
    fn, _ = S.make_train_step(lm, shape, mesh)
    tokens = torch.randint(0, cfg.vocab_size, (8, 64), device=card,
                           dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        fn(params, adamw_init(params), tokens)
    torch.cuda.synchronize(card)
    assert fc.get_total_flops() == meta > 0


@pytest.mark.gpu
def test_slstm_kernels_match_plain_versions(card):
    """slstm_fwd and slstm_bwd against the plain loop and autograd through
    it (chip_smoke's phase 3 cases at S <= 127, and S = 4096 at hd 192 in
    bf16): one launch of each a case, of the design its width calls for,
    within SLSTM_TOL and SLSTM_GRAD_TOL, in all three dtypes."""
    cases = [c for c in chip_smoke.SLSTM_CASES if c[1] <= 127] + [
        (1, 4096, 192, "bfloat16")]
    before = dict(_build.LAUNCHES)
    worst = chip_smoke.slstm_checks(np.random.default_rng(5), card, cases)
    assert set(worst) == {"float32", "bfloat16", "float16"}
    for name in ("slstm_fwd", "slstm_bwd"):
        assert _build.LAUNCHES[name] - before[name] == len(cases)


@pytest.mark.gpu
def test_slstm_forward_repeats_bit_for_bit(card):
    """No atomics: two launches on the same inputs give the same bits,
    so remat's replay saves the states of the first pass; in all three
    dtypes, and the transpose too."""
    import torch
    for dt in ("float32", "bfloat16", "float16"):
        ins = chip_smoke.slstm_inputs(np.random.default_rng(6), 2, 300, 4,
                                      192, dt, card, grad=False)
        a = torch.ops.repro_torch.slstm_scan(*ins, True)
        b = torch.ops.repro_torch.slstm_scan(*ins, True)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), dt
        gy = torch.randn(a[0].shape, device=card,
                         generator=torch.Generator(card).manual_seed(1)
                         ).to(a[0].dtype)
        args = (gy, None, None, *ins[1:4], ins[4], ins[5], a[3], a[5],
                True)
        da = torch.ops.repro_torch.slstm_scan_bwd(*args)
        db = torch.ops.repro_torch.slstm_scan_bwd(*args)
        assert all(torch.equal(x, y) for x, y in zip(da, db)), dt


@pytest.mark.gpu
def test_slstm_designs_by_width(card):
    """xlstm-125m's shapes take the cluster kernels (4 heads of 192 at B 2:
    clusters of at least 2 blocks a recurrence); a head past the cluster
    kernels' 480 (hd 640) takes the split cluster forward (the plan the
    wrapper's ``split_shape`` mirrors: 32 terms a lane in registers, the
    rest in shared memory; 16 blocks a chain at 2 chains, 8 at 10: 160
    blocks pass the H100's 132 SMs) and the one-block backward; past the
    split forward's 960 (hd 1024) both take the one-block kernels. Each is
    held to the plain loop's bits (y and the final c and h) and its
    gradients, and the launches are counted by design and dtype."""
    from repro_torch.kernels import slstm as K
    for backward in (False, True):
        assert K.plan(8, 192, torch.bfloat16, backward)["C"] >= 2
        assert K.plan(2, 16, torch.float16, backward)["C"] >= 1
        assert K.plan(2, 1024, torch.float32, backward)["C"] == 0
    assert K.plan(2, 640, torch.float32, True)["C"] == 0
    keys = ("C", "KS", "KT", "KX", "threads")
    for chains, C in ((2, 16), (10, 8)):
        fwd = K.plan(chains, 640, torch.float32)
        assert fwd["C"] == C and fwd["KX"] > 0, chains
        assert {k: fwd[k] for k in keys} \
            == {k: K.split_shape(640, C)[k] for k in keys}, chains
    for B, hd, fwd_design in ((1, 640, "cluster"), (5, 640, "cluster"),
                              (1, 1024, "block")):
        before = dict(K.ROUTES)
        worst = chip_smoke.slstm_checks(np.random.default_rng(8), card,
                                        [(B, 64, hd, "float16")])
        assert worst["float16"]["y"] == 0.0, hd
        assert worst["float16"]["c"] == 0.0, hd
        assert worst["float16"]["h"] == 0.0, hd
        ran = {key: n - before[key] for key, n in K.ROUTES.items()
               if n != before[key]}
        assert ran == {("slstm_fwd", fwd_design, "float16"): 1,
                       ("slstm_bwd", "block", "float16"): 1}, hd


@pytest.mark.gpu
def test_xlstm_train_step_on_card_matches_cpu(card):
    """One reduced xlstm-125m ``make_train_step`` step (f32 activations,
    remat on, 2 microbatches) on the card against the same step on the
    CPU: loss and gnorm at 1e-4, every first moment at a relative
    Frobenius error <= 1e-3; the sLSTM kernels launch (forward, replay,
    backward) and nothing else."""
    import dataclasses
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import LM
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("xlstm-125m").reduced(),
                              dtype="float32", remat=True)
    shape = ShapeConfig("t", "train", seq_len=64, global_batch=4,
                        grad_accum=2)
    host = LM(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    tok = torch.from_numpy(TokenSource(DataConfig(cfg.vocab_size, 64, 4))
                           .batch_at(0)["tokens"])
    out = []
    for dev in (card, torch.device("cpu")):
        before = dict(_build.LAUNCHES)
        mesh = make_smoke_mesh(dev)
        fn, _ = steps.make_train_step(steps.build_lm(cfg, mesh), shape,
                                      mesh, peak_lr=1e-3, total_steps=10)
        p = tree_map(lambda x: x.clone().to(dev), host)
        _, opt, m = fn(p, adamw_init(p), tok.to(dev))
        launched = {k: n - before[k] for k, n in _build.LAUNCHES.items()
                    if n != before[k]}
        out.append((tree_map(lambda x: x.cpu(), opt.mu),
                    {k: float(v) for k, v in m.items()}, launched))
    (mu_card, m_card, l_card), (mu_cpu, m_cpu, l_cpu) = out
    assert l_cpu == {} and l_card == {"slstm_fwd": 2 * 2, "slstm_bwd": 2}
    for k in ("loss", "gnorm"):
        assert m_card[k] == pytest.approx(m_cpu[k], rel=1e-4), k
    for a, b in zip(leaves(mu_card), leaves(mu_cpu)):
        assert float((a - b).norm() / b.norm()) <= 1e-3


@pytest.mark.gpu
def test_slstm_build_failure_raises(card, monkeypatch):
    """A kernel that does not build raises on CUDA tensors: the op never
    falls back to the plain loop."""
    from repro_torch.kernels import slstm as K

    def fail(*a, **k):
        raise RuntimeError("nvcc failed for slstm")

    def fallback(*a, **k):
        raise AssertionError("CUDA inputs fell back to the plain loop")
    monkeypatch.setattr(_build, "build", fail)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(K, "slstm_scan_plain", fallback)
    ins = chip_smoke.slstm_inputs(np.random.default_rng(7), 1, 4, 2, 16,
                                  "float32", card, grad=False)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        K.slstm_scan(*ins)
