#!/usr/bin/env python3
"""Compare kernels of the port's sparse paths with those of another
checkout, on one card and the main path's inputs.

    python3 scripts/ab_kernels.py spmm_coo_nnz spadd3_union_rows
        # this tree alone
    python3 scripts/ab_kernels.py spmm_coo_nnz --parent build/parent
        # build/parent: an unpacked ``git archive`` of the commit to compare

Each named kernel is one that a lowered cell of ``chip_smoke.py``'s sparse
paths launches (``chip_smoke.PATH_KERNELS``), or ``flash_attention``,
which is taken at the llama3-8b layer's heads and length (q (2, 4096, 32,
hd), k and v (2, 4096, 8, hd), standard normal from a seeded generator;
at hd 128 in bf16, the prefill's launches) in bf16 and f16 at head widths
128, 256, 320, 512 and 640 (``FLASH_16_WIDTHS``), in f32 at 64, 128, 256,
320, 512, 640 and 2176 (``FLASH_F32_WIDTHS``; a cell in ``SLOW_CELLS`` is
timed over fewer launches: a launch of its parent took seconds), and in
f32
at seamless-m4t-medium's heads (16 of 64) and the length and batch of
``chip_smoke.py``'s path 4j (2 x 128), where its teacher-forced forward
launches the f32 kernel at hd 64; ``--cells`` keeps only the flash cells
whose name matches a regular expression (a probe of one cell against a
variant tree in the parent slot). Each flash cell also times
``scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` on the
same inputs in the same process (``sdpa_ms``: a yardstick the port never
calls). The sparse operands are made as
``chip_smoke.py`` makes them, at its main-path sizes; the cells of the
paths that launch the named kernels are lowered with this tree's package,
in ``chip_smoke.PATH_CELLS``' order, and each named kernel is taken with the
arguments of every cell that launches it (``chip_smoke.leaf_call``).
Its wrapper in this tree and in the parent (that checkout's ``repro_torch``
imported as ``repro_torch_parent``, its kernels built into its own
``build/``) is called on those arguments. Per kernel and cell: whether the
two give the same bits (and the largest difference), the CUDA-event median
of ``chip_smoke.REPS`` launches in the order parent, this, this, parent,
the peak device memory of one call above what was held before it, and the
device time of each phase (``torch.profiler``). A JSON summary goes to
``--out``.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SPARSE_KERNELS = sorted({k for path in cs.PATH_CELLS
                         for k in cs.PATH_KERNELS[path]})
KERNELS = SPARSE_KERNELS + ["flash_attention"]
FLASH_16_WIDTHS = (128, 256, 320, 512, 640)
FLASH_F32_WIDTHS = (64, 128, 256, 320, 512, 640, 2176)
# cells timed over fewer launches than chip_smoke.REPS, by name
SLOW_CELLS = {"llama3-8b layer f32 hd2176": 3}


def load_parent(tree: Path):
    """The parent checkout's ``repro_torch``, as ``repro_torch_parent``."""
    pkg = tree / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "repro_torch_parent", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["repro_torch_parent"] = mod
    spec.loader.exec_module(mod)
    return mod


def same_bits(a, b):
    """(equal bits, largest |a - b| over the float parts or None when the
    shapes differ)."""
    import torch
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    equal = all(x.shape == y.shape and torch.equal(x, y)
                for x, y in zip(a, b))
    diff = 0.0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            return equal, None
        if x.is_floating_point() and x.numel():
            diff = max(diff, float((x - y).abs().max()))
    return equal, diff


def peak_mb(fn) -> float:
    """MB of device memory one call of ``fn`` holds at its peak, above what
    was allocated before it."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def compare(name, cell, kargs, fns, reps=None):
    """The record of kernel ``name`` on ``kargs`` (cell ``cell``'s),
    {version: wrapper}, each time the median of ``reps`` launches
    (``chip_smoke.REPS`` by default)."""
    import torch
    outs = {tag: fn(*kargs) for tag, fn in fns.items()}
    torch.cuda.synchronize()
    rec = {}
    if "parent" in outs:
        rec["bitwise_equal"], rec["max_abs_diff"] = same_bits(
            outs["this"], outs["parent"])
    del outs
    order = ["parent", "this", "this", "parent"] if "parent" in fns \
        else ["this"]
    rec["ms"] = {tag: [] for tag in fns}
    for tag in order:
        rec["ms"][tag].append(cs.time_events(lambda: fns[tag](*kargs),
                                             reps or cs.REPS))
    rec["peak_mb"] = {tag: peak_mb(lambda: fn(*kargs))
                      for tag, fn in fns.items()}
    rec["phases"] = {tag: cs.device_breakdown(lambda: fn(*kargs))
                     for tag, fn in fns.items()}
    for tag in fns:
        print(f"[ab] kernel={name} cell={cell} version={tag} ms="
              + ",".join(f"{t:.4f}" for t in rec["ms"][tag])
              + f" peak_mb={rec['peak_mb'][tag]:.2f} "
              + " ".join(f"{p.replace(' ', '_')}={v:.4f}"
                         for p, v in rec["phases"][tag].items()),
              flush=True)
    if "bitwise_equal" in rec:
        print(f"[ab] kernel={name} cell={cell} "
              f"bitwise_equal={rec['bitwise_equal']} "
              f"max_abs_diff={rec['max_abs_diff']}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels", nargs="+", choices=KERNELS,
                    metavar="KERNEL",
                    help="kernels to compare: " + ", ".join(KERNELS))
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of an unpacked checkout to compare with")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out"
                    / "ab_kernels.json")
    ap.add_argument("--cells", default="",
                    help="regular expression: only the flash cells whose "
                         "name it matches (default: every cell)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch.core as tc
    from repro_torch.core import lower as L

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"[device] {smi}", flush=True)
    versions = {"this": importlib.import_module("repro_torch")}
    if args.parent is not None:
        versions["parent"] = load_parent(args.parent.resolve())
    wanted = dict.fromkeys(args.kernels)
    fns = {}
    for name in wanted:
        this = cs.kernel_fns()[name][0]
        fns[name] = {tag: getattr(importlib.import_module(
            this.__module__.replace("repro_torch", mod.__name__, 1)),
            this.__name__) for tag, mod in versions.items()}
    sources = {Path(cs.KERNELS[name][0]).stem for name in wanted}
    for tag, mod in versions.items():
        logs = importlib.import_module(mod.__name__ + ".kernels._build") \
            .build(force=True)
        for src in sorted(sources):
            for line in logs.get(src, "").splitlines():
                if "Compiling entry" in line or "Used" in line \
                        or "spill" in line:
                    print(f"  {tag} {src}: {line.strip()}")

    summary = {"device": smi, "kernels": {}}
    if "flash_attention" in wanted:
        import torch.nn.functional as F
        from repro_torch.configs import get_arch
        cfg = cs.lm_config()
        sm = get_arch("seamless-m4t-medium")
        layer = (cs.PREFILL_BATCH, cs.PREFILL_SEQ, cfg.n_heads,
                 cfg.n_kv_heads)
        cells = summary["kernels"]["flash_attention"] = {}
        for dtype, (B, S, H, Hkv), hd, cell in [
                (dtype, layer, hd, f"llama3-8b layer {tag} hd{hd}")
                for hd in FLASH_16_WIDTHS
                for dtype, tag in ((torch.bfloat16, "bf16"),
                                   (torch.float16, "f16"))] + [
                (torch.float32, layer, hd, f"llama3-8b layer f32 hd{hd}")
                for hd in FLASH_F32_WIDTHS] + [
                (torch.float32, (cs.ARCH_BATCH, cs.ARCH_SEQ, sm.n_heads,
                                 sm.n_kv_heads), sm.resolved_head_dim,
                 "seamless-m4t-medium path 4j f32")]:
            if not re.search(args.cells, cell):
                continue
            gen = torch.Generator(device).manual_seed(cs.SEED)
            q, k, v = (torch.randn(shape, generator=gen, device=device)
                       .to(dtype) for shape in
                       ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
            reps = SLOW_CELLS.get(cell)
            cells[cell] = compare("flash_attention", cell, (q, k, v),
                                  fns["flash_attention"], reps)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            cells[cell]["sdpa_ms"] = cs.time_events(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True),
                reps or cs.REPS)
            print(f"[ab] kernel=flash_attention cell={cell} "
                  f"sdpa_ms={cells[cell]['sdpa_ms']:.4f}", flush=True)
            del q, k, v, qt, kt, vt
    paths = [p for p in cs.PATH_CELLS
             if set(cs.PATH_KERNELS[p]) & set(wanted)]
    dims3 = ((1 << cs.LOG2_I, 1 << cs.LOG2_JK, 1 << cs.LOG2_JK)
             if "slice" in paths else None)
    data = (cs.make_inputs(1 << cs.LOG2_N, cs.AVG_NNZ, cs.SPMM_J, cs.SEED,
                           dims3) if paths else {})
    if {"add", "blocked"} & set(paths):
        data["add"] = cs.add_operands(1 << cs.LOG2_N, cs.SEED, data["B"])
    stmts = cs.statements(data) if paths else {}
    machine = tc.Machine(("x", cs.PIECES))
    for expr, strat in (c for p in paths for c in cs.PATH_CELLS[p]):
        if strat not in ("rows", "nnz"):
            continue
        sched = (L.default_row_schedule if strat == "rows"
                 else L.default_nnz_schedule)(stmts[expr], machine)
        k = L.lower(stmts[expr], machine, schedule=sched, device=device)
        call = cs.leaf_call(k)
        if call is not None and call[0] in wanted:
            cell = k.cell_id()
            summary["kernels"].setdefault(call[0], {})[cell] = compare(
                call[0], cell, call[1], fns[call[0]])
        del k, call
        L.clear_lowering_caches()
        torch.cuda.empty_cache()
    missing = [n for n in wanted if n not in summary["kernels"]]
    if missing:
        print(f"ab_kernels: no lowered cell launches {missing}",
              file=sys.stderr)
        return 1
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
