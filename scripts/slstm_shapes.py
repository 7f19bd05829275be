"""Time the sLSTM kernels (``csrc/slstm.cu``) over launch shapes on one card.

    PYTHONPATH=src python scripts/slstm_shapes.py [--reps 5]

At path 4k's shape (xlstm-125m's sLSTM layer over one microbatch: B 2,
S 4096, 4 heads of 192, bf16, the forward keeping its states) it prints:

- ``[ptxas]`` registers and spills of each cluster instance;
- ``[plan]`` the shape the rule picks (``slstm.plan``) for a few widths
  and chain counts;
- ``[cluster-step]`` the exchange alone (``slstm_cluster_probe``): hd / C
  doubles a block over KS lanes a column (8, or 4 where 8 would pass 512
  threads), 8 clusters, at C = 2, 4, 8 and 16, by a split cluster barrier
  a step (``barrier``), by st.async stores counted on mbarriers
  (``st.async``), and the barrier without stores (``bare``); ns a step,
  CUDA-event median;
- ``[shape]`` ``slstm_fwd`` and ``slstm_bwd`` at each (C, KS) in
  ``--shapes`` (C = 0: the one-block kernels), CUDA-event medians of
  ``--reps``, each output's bits against the first shape's.

    PYTHONPATH=src python scripts/slstm_shapes.py --ab --parent build/parent

compares instead this tree's ``slstm.cu`` with an unpacked checkout's
(``--parent``, a ``git archive`` under ``build/``), both built as scratch
libraries in one process, each at the rule's shape of its own tree, the
order parent, this, this, parent: ``[ab]`` lines for path 4k's shape
(forward and backward; the bits must agree) and for phase 3's hd-640 case
at S 4096 (B 3, 2 heads, bf16; the forward: the parent's one-block kernel
against the split cluster forward, each output against the plain loop's
bits), ``[cluster-step]``
for the exchange at hd 640 on 16 blocks, and ``[ptxas]`` for the split
instances.

The entry points of ``libslstm`` take the rule's shape themselves. The
shapes are forced through a scratch library of its own,
``build/slstm_sweep.so`` (``build/slstm_sweep_parent.so`` for the
parent): a translation unit that includes ``slstm.cu`` and adds two bf16
entry points taking (C, KS). It imports neither JAX nor the JAX
package."""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build, slstm as K  # noqa: E402

# the forced-shape entry points: slstm_fwd's and slstm_bwd's arguments in
# bf16, with (C, KS) in place of the dtype (C 0: the one-block kernels;
# ``{split}`` passes the direction on: this tree's shape_for takes it, the
# parent's may not)
SWEEP_SOURCE = r"""
#include "{source}"

namespace {{
bool forced(int hd, int C, int KS, bool bwd, Plan* p) {{
    Plan none{{}};
    none.threads = threads_for(hd);
    *p = none;
    return C == 0 || shape_for(hd, C, KS, p{split});
}}
}}  // namespace

extern "C" int sweep_fwd(const void* zx, const void* ip, const void* fp,
                         const void* op, const void* r, const void* c0,
                         const void* h0, void* y, void* c_out, void* h_out,
                         void* cs, void* hs, void* zs, int B, int S, int H,
                         int hd, int save, int C, int KS, void* stream) {{
    Plan p;
    if (!forced(hd, C, KS, false, &p)) return int(cudaErrorInvalidValue);
    return fwd<__nv_bfloat16>(zx, ip, fp, op, r, c0, h0, y, c_out, h_out,
                              cs, hs, zs, B, S, H, hd, save, p,
                              static_cast<cudaStream_t>(stream));
}}

extern "C" int sweep_bwd(const void* gy, const void* gc, const void* gh,
                         const void* ip, const void* fp, const void* op,
                         const void* rT, const void* c0, const void* cs,
                         const void* zs, void* dzx, void* dip, void* dfp,
                         void* dop, void* dc0, void* dh0, int B, int S,
                         int H, int hd, int need_dh0, int C, int KS,
                         void* stream) {{
    Plan p;
    if (!forced(hd, C, KS, true, &p)) return int(cudaErrorInvalidValue);
    return bwd<__nv_bfloat16>(gy, gc, gh, ip, fp, op, rT, c0, cs, zs, dzx,
                              dip, dfp, dop, dc0, dh0, B, S, H, hd, need_dh0,
                              p, static_cast<cudaStream_t>(stream));
}}
"""
_P, _I = ctypes.c_void_p, ctypes.c_int


def sweep_library(tree: Path = None):
    """Compile the scratch library (``SWEEP_SOURCE``) from this tree's
    ``slstm.cu`` or, with ``tree``, that checkout's (into
    ``slstm_sweep_parent.so``); returns (the loaded library, nvcc's and
    ptxas' output)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = "" if tree is None else "_parent"
    src = _build.BUILD_DIR / f"slstm_sweep{tag}.cu"
    out = _build.BUILD_DIR / f"slstm_sweep{tag}.so"
    source = (_build.CSRC if tree is None else
              tree / "src" / "repro_torch" / "kernels" / "csrc") \
        / _build.SOURCES["slstm"]
    src.write_text(SWEEP_SOURCE.format(
        source=source, split="" if tree is not None else ", bwd"))
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.sweep_fwd.argtypes = [_P] * 13 + [_I] * 7 + [_P]
    lib.sweep_bwd.argtypes = [_P] * 16 + [_I] * 7 + [_P]
    lib.sweep_fwd.restype = lib.sweep_bwd.restype = _I
    return lib, proc.stdout + proc.stderr


def events_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def inputs(B, S, H, hd, dtype, device, seed=0):
    """The scan's inputs from a seeded generator on ``device``: zx in
    ``dtype``, ip, fp (centred on 1) and op, r scaled by hd ** -0.5, the
    zero state."""
    g = torch.Generator(device).manual_seed(seed)
    d = H * hd

    def n(*shape):
        return torch.randn(*shape, generator=g, device=device)
    return [n(B, S, d).to(dtype), n(B, S, d), n(B, S, d) + 1.0,
            n(B, S, d), n(H, hd, hd) * hd ** -0.5,
            torch.zeros(B, d, device=device), torch.zeros(B, d, device=device)]


def launch_fwd(lib, ins, outs, C, KS):
    zx = ins[0]
    B, S, d = zx.shape
    H, hd = ins[4].shape[0], ins[4].shape[1]
    err = lib.sweep_fwd(*(t.data_ptr() for t in ins + outs), B, S, H, hd,
                        1, C, KS, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"slstm_fwd C={C} KS={KS}: CUDA error {err}")


def launch_bwd(lib, args, outs, C, KS, H, hd):
    gy, ip, fp, op, rT, c0, cs, zs = args
    B, S, _ = cs.shape
    err = lib.sweep_bwd(gy.data_ptr(), None, None,
                        *(t.data_ptr() for t in (ip, fp, op, rT, c0, cs, zs,
                                                 *outs)),
                        B, S, H, hd, 0, C, KS,
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"slstm_bwd C={C} KS={KS}: CUDA error {err}")


def fwd_outs(ins):
    zx = ins[0]
    B, S, d = zx.shape
    dev = zx.device
    return [torch.empty_like(zx), torch.empty(B, d, device=dev),
            torch.empty(B, d, device=dev), torch.empty(B, S, d, device=dev),
            torch.empty(B, S, d, device=dev), torch.empty_like(zx)]


def print_ptxas(log: str, tag: str, want: str) -> None:
    """``[ptxas]`` registers and spills of the instances whose mangled name
    contains ``want``."""
    name = None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        if name and want in name and ("Used" in line or "spill" in line):
            print(f"[ptxas] {tag} {name}: {line.strip()}")


def ab(args, dev) -> int:
    """The ``--ab`` comparison (the module's docstring)."""
    this, log = sweep_library()
    parent, _ = sweep_library(args.parent.resolve())
    print_ptxas(log, "this", "slstm_fwd_cluster")
    libs = {"parent": parent, "this": this}
    order = ("parent", "this", "this", "parent")
    dt = torch.bfloat16
    lib = K.library("slstm", K._SIGNATURES)
    # path 4k's shape: both trees at the rule's cluster shape
    B, S, H, hd = 2, 4096, 4, 192
    ins = inputs(B, S, H, hd, dt, dev)
    rT = ins[4].transpose(1, 2).contiguous()
    rule, rule_b = K.plan(B * H, hd, dt, False), K.plan(B * H, hd, dt, True)
    print(f"[ab] cell=4k shape=B{B}_S{S}_H{H}_hd{hd} fwd_plan={rule} "
          f"bwd_plan={rule_b}")
    got, times = {}, {"fwd": {t: [] for t in libs},
                      "bwd": {t: [] for t in libs}}
    for tag, sweep in libs.items():
        outs = fwd_outs(ins)
        launch_fwd(sweep, ins, outs, rule["C"], rule["KS"])
        y, c, h, cs, hs, zs = outs
        gy = torch.randn(y.shape, device=dev, generator=torch.Generator(
            dev).manual_seed(3)).to(dt)
        bargs = (gy, ins[1], ins[2], ins[3], rT, ins[5], cs, zs)
        bouts = [torch.empty_like(zs), torch.empty_like(cs),
                 torch.empty_like(cs), torch.empty_like(cs),
                 torch.empty(B, H * hd, device=dev),
                 torch.zeros(B, H * hd, device=dev)]
        launch_bwd(sweep, bargs, bouts, rule_b["C"], rule_b["KS"], H, hd)
        torch.cuda.synchronize()
        got[tag] = (outs, bouts, bargs)
    for tag in order:
        outs, bouts, bargs = got[tag]
        times["fwd"][tag].append(events_ms(lambda: launch_fwd(
            libs[tag], ins, outs, rule["C"], rule["KS"]), args.reps))
        times["bwd"][tag].append(events_ms(lambda: launch_bwd(
            libs[tag], bargs, bouts, rule_b["C"], rule_b["KS"], H, hd),
            args.reps))
    for part, i in (("fwd", 0), ("bwd", 1)):
        same = all(torch.equal(a, b) for a, b in zip(got["this"][i],
                                                     got["parent"][i]))
        for tag in libs:
            print(f"[ab] cell=4k kernel=slstm_{part} version={tag} ms="
                  + ",".join(f"{t:.4f}" for t in times[part][tag]))
        print(f"[ab] cell=4k kernel=slstm_{part} bitwise_equal={same}")
    del got, ins, rT
    # phase 3's hd-640 case at S 4096: the parent's one-block forward
    # against the split forward
    B, S, H, hd = 3, 4096, 2, 640
    ins = inputs(B, S, H, hd, dt, dev, seed=1)
    rule = K.plan(B * H, hd, dt, False)
    print(f"[ab] cell=hd640 shape=B{B}_S{S}_H{H}_hd{hd} fwd_plan={rule}")
    want = K.slstm_scan_plain(*ins, save=True)
    variants = {"parent": (parent, 0, 0), "this": (this, rule["C"],
                                                   rule["KS"])}
    outs = {tag: fwd_outs(ins) for tag in variants}
    for tag, (sweep, C, KS) in variants.items():
        launch_fwd(sweep, ins, outs[tag], C, KS)
    torch.cuda.synchronize()
    for tag in variants:
        same = [torch.equal(a, b) for a, b in zip(
            outs[tag], (want[0], want[1], want[2], want[3], want[4],
                        want[5]))]
        print(f"[ab] cell=hd640 version={tag} plain_bits="
              f"{dict(zip(('y', 'c', 'h', 'cs', 'hs', 'zs'), same))}")
    ms = {tag: [] for tag in variants}
    for tag in ("parent", "this", "this", "parent"):
        sweep, C, KS = variants[tag]
        ms[tag].append(events_ms(lambda: launch_fwd(
            sweep, ins, outs[tag], C, KS), args.reps))
    for tag in variants:
        print(f"[ab] cell=hd640 kernel=slstm_fwd version={tag} ms="
              + ",".join(f"{t:.4f}" for t in ms[tag])
              + f" step_us={min(ms[tag]) / S * 1e3:.4f}")
    sink = torch.empty(16 * B * H, dtype=torch.float64, device=dev)
    W = -(-hd // rule["C"])

    def probe():
        err = lib.slstm_cluster_probe(
            rule["C"], W, rule["KS"], B * H, S, 1, sink.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"probe: CUDA error {err}")
    ms_x = events_ms(probe, args.reps)
    print(f"[cluster-step] C={rule['C']} W={W} KS={rule['KS']} "
          f"exchange=st.async clusters={B * H} steps={S} ms={ms_x:.4f} "
          f"ns_per_step={ms_x / S * 1e6:.1f}")
    print(f"[card] {torch.cuda.get_device_name(0)}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--shapes", default="16:8,16:16,16:32,8:8,8:16,4:8,0:0",
                    help="C:KS pairs; C 0 is the one-block kernel")
    ap.add_argument("--ab", action="store_true",
                    help="compare with --parent (the docstring)")
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of an unpacked checkout to compare with")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.ab:
        if args.parent is None:
            ap.error("--ab needs --parent")
        return ab(args, dev)
    sweep, log = sweep_library()
    name = None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "cluster" in name:
            inst = re.search(r"slstm_(fwd|bwd)_cluster\w*?I(\w+?)Li(\d+)E",
                             name)
            print(f"[ptxas] {inst.group(1) if inst else name} "
                  f"{inst.group(2) if inst else ''} "
                  f"KT={inst.group(3) if inst else '?'} "
                  f"registers={m.group(1)}")
        if "spill" in line and name and "cluster" in name \
                and not line.strip().startswith("0 bytes spill") \
                and " 0 bytes spill stores" not in line:
            print(f"[ptxas] {name}: {line.strip()}")
    lib = K.library("slstm", K._SIGNATURES)
    for chains, hd in ((8, 192), (6, 192), (2, 192), (32, 192), (64, 192),
                       (2, 16), (6, 16), (2, 64), (2, 256), (6, 512)):
        for bwd in (False, True):
            print(f"[plan] chains={chains} hd={hd} "
                  f"{'bwd' if bwd else 'fwd'} "
                  f"{K.plan(chains, hd, torch.bfloat16, bwd)}")
    sink = torch.empty(16 * 8, dtype=torch.float64, device=dev)
    iters = 4096
    for C in (2, 4, 8, 16):
        W = 192 // C
        KS = 8 if W * 8 <= 512 else 4

        for mode, how in enumerate(("barrier", "st.async", "bare")):
            def probe():
                err = lib.slstm_cluster_probe(
                    C, W, KS, 8, iters, mode, sink.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"probe C={C}: CUDA error {err}")
            ms = events_ms(probe, args.reps)
            print(f"[cluster-step] C={C} W={W} KS={KS} exchange={how} "
                  f"clusters=8 steps={iters} ms={ms:.4f} "
                  f"ns_per_step={ms / iters * 1e6:.1f}")
    B, S, H, hd = 2, 4096, 4, 192
    dt = torch.bfloat16
    ins = inputs(B, S, H, hd, dt, dev)
    rT = ins[4].transpose(1, 2).contiguous()
    rule = K.plan(B * H, hd, dt, False)
    rule_b = K.plan(B * H, hd, dt, True)
    print(f"[shape-rule] fwd={rule} bwd={rule_b}")
    d = H * hd
    ref = None
    for pair in args.shapes.split(","):
        C, KS = (int(x) for x in pair.split(":"))
        outs = [torch.empty_like(ins[0]), torch.empty(B, d, device=dev),
                torch.empty(B, d, device=dev),
                torch.empty(B, S, d, device=dev),
                torch.empty(B, S, d, device=dev), torch.empty_like(ins[0])]
        try:
            launch_fwd(sweep, ins, outs, C, KS)
        except RuntimeError as e:
            print(f"[shape] C={C} KS={KS} refused: {e}")
            continue
        torch.cuda.synchronize()
        y, c, h, cs, hs, zs = outs
        gy = torch.randn(y.shape, device=dev,
                         generator=torch.Generator(dev).manual_seed(3)
                         ).to(dt)
        bargs = (gy, ins[1], ins[2], ins[3], rT, ins[5], cs, zs)
        bouts = [torch.empty_like(zs), torch.empty_like(cs),
                 torch.empty_like(cs), torch.empty_like(cs),
                 torch.empty(B, d, device=dev), torch.zeros(B, d,
                                                            device=dev)]
        launch_bwd(sweep, bargs, bouts, C, KS, H, hd)
        torch.cuda.synchronize()
        if ref is None:
            ref = ([t.clone() for t in outs], [t.clone() for t in bouts])
        same_f = all(torch.equal(a, b) for a, b in zip(outs, ref[0]))
        err_b = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(bouts, ref[1]))
        f_ms = events_ms(lambda: launch_fwd(sweep, ins, outs, C, KS),
                         args.reps)
        b_ms = events_ms(lambda: launch_bwd(sweep, bargs, bouts, C, KS, H,
                                            hd), args.reps)
        print(f"[shape] C={C} KS={KS} fwd_ms={f_ms:.4f} "
              f"fwd_step_us={f_ms / S * 1e3:.4f} bwd_ms={b_ms:.4f} "
              f"bwd_step_us={b_ms / S * 1e3:.4f} fwd_bits_as_first={same_f} "
              f"bwd_max_diff_first={err_b:.3g}")
    print(f"[card] {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
