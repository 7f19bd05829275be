"""Multi-pod dry-run: one rank's step of every (architecture × input shape ×
mesh) cell, counted on the ``meta`` device.

For every cell: build the step (:func:`.steps.build_step`) on the
production mesh, a layout with no process group behind it
(:func:`.mesh.make_production_mesh`: (16, 16), or (2, 16, 16) multi-pod),
and run rank 0's step eagerly on ``meta`` tensors under the counters of
:mod:`.roofline` (FLOPs, HBM bytes, the bytes the gathers would move)
and a tracker of live bytes. Nothing is allocated and no card is needed:
running on the host is what the dry-run is, not a fallback. The step is
the one the port really runs: each rank gathers the whole weights, runs
its rows and sums the gradients by ``collectives.reduce_rows`` (an
all-gather of partials), so its collective bytes are the port's, not
GSPMD's.

**Peak memory** is tracked, not estimated: each storage the step makes
adds its bytes when it is made and gives them back when it is freed (a
weakref finalizer on the storage), on top of the rank's arguments (its
blocks of the parameters and moments, or of the cache, and the batch).
The peak therefore holds the gathered whole weights, the f32 gradient
sums, the activations autograd keeps (under remat, the group inputs and
one group's recomputation) and every attention intermediate, the
(B, H, S, S) scores of dense attention included, where the ``auto``
variant makes them. Bytes only: the caching allocator's rounding and
fragmentation on the card come on top.

**A cell has a budget** of ``CELL_BUDGET_S`` seconds of counting on
the host (in the main thread, where an alarm can stop it). A step whose
eager ``meta`` run makes millions of op calls takes hours: the sLSTM's time
loop (xlstm-125m) runs S Python steps a layer. Such a cell is recorded
as an error (``TimeoutError``), not counted.

A ``--mesh card`` cell runs the one-rank smoke mesh (1, 1) at a shape
given on the command line, so that the prediction can be set beside a
real step on the card (``chip_smoke.py`` path 4l). Under ``--variant
flash`` the Hopper kernel is stood in for by its output's shape (its
FLOPs, 4·B·H·S²·hd as ``FlopCounterMode`` counts attention, and its
input bytes are added by hand: ``FlopCounterMode`` sees only aten ops).

Usage::

    python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod both
    python -m repro_torch.launch.dryrun --arch internlm2-1.8b --mesh card \\
        --kind train --seq-len 4096 --global-batch 8 --grad-accum 4

Results land in ``experiments/dryrun_torch/<arch>_<shape>_<mesh>.json``
with the reference's record keys; ``python -m repro_torch.launch.report``
renders them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import signal
import threading
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict, Optional
from unittest import mock

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs.base import ArchConfig, ShapeConfig, all_archs, get_arch
from ..distributed import collectives
from ..distributed.mesh import Mesh
from ..models import attention
from . import steps as steps_mod
from .mesh import make_production_mesh, make_smoke_mesh
from .roofline import ByteCounter, roofline_report

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
#: seconds of counting a cell may take (on a loaded 8-core host
#: llama4-scout's train_4k takes about 150 s, zamba2-7b's several minutes)
CELL_BUDGET_S = 900


def model_flops_per_device(cfg, shape, mesh) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) per device; decode counts one
    token per sequence, forward-only shapes count 2·N·D."""
    n_chips = mesh.size
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens / n_chips
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens / n_chips
    tokens = shape.global_batch
    return 2.0 * n_active * tokens / n_chips


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages alive, and their peak: a storage counts
    from the op that makes it until it is freed (module docstring)."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen = set()

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.add(t)
        return out


def _storages(tree) -> Dict[int, int]:
    """{storage key: bytes} of the tensors of a tree (each storage once)."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


@contextlib.contextmanager
def _meta_flash(extra: Dict[str, float]):
    """The flash kernel stood in for by its output's shape on ``meta``,
    its FLOPs and input bytes added to ``extra``."""
    def flash(q, k, v, **_):
        B, S, H, hd = q.shape
        extra["flops"] += 4.0 * B * H * S * k.shape[1] * hd
        extra["bytes"] += sum(t.numel() * t.element_size() for t in (q, k, v))
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    with mock.patch.object(attention, "flash_attention", flash):
        yield


def count_step(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, *,
               variant: str = "auto") -> Dict:
    """Rank 0's step of the cell on ``meta`` under the counters: its
    FLOPs, HBM bytes, collective bytes by kind, memory record and
    gradient accumulation, and the step's outputs."""
    fn, args, lm = steps_mod.build_step(cfg, shape, mesh, variant=variant)
    live = LiveBytes()
    for t in tree_leaves(args):
        if isinstance(t, torch.Tensor):
            live.add(t)
    arg_st = _storages(args)
    before = dict(collectives.TRAFFIC_BY_KIND)
    extra = {"flops": 0.0, "bytes": 0.0}
    grad = (contextlib.nullcontext() if shape.kind == "train"
            else torch.no_grad())
    with FlopCounterMode(display=False) as fc, ByteCounter() as bc, \
            _meta_flash(extra), grad, live:
        out = fn(*args)
    coll = {k: collectives.TRAFFIC_BY_KIND[k] - before[k]
            for k in collectives.COLLECTIVE_KINDS}
    out_st = _storages(out)
    arg_b = sum(arg_st.values())
    out_b = sum(out_st.values())
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    temp = live.peak - arg_b - out_b + alias
    return {
        "flops": float(fc.get_total_flops()) + extra["flops"],
        "mem_bytes": float(bc.nbytes) + extra["bytes"],
        "coll_bytes": coll,
        "grad_accum": getattr(fn, "accum", shape.grad_accum),
        "memory": {
            "argument_bytes_per_dev": arg_b,
            "output_bytes_per_dev": out_b,
            "temp_bytes_per_dev": temp,
            "alias_bytes_per_dev": alias,
            "peak_estimate_gib": round(
                (arg_b + out_b + temp - alias) / 2**30, 3),
        },
        "outputs": out,
    }


@contextlib.contextmanager
def _budget(seconds: float):
    """Raise ``TimeoutError`` in the block after ``seconds`` (main thread
    only; elsewhere no limit)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def stop(signum, frame):
        raise TimeoutError(f"counting took more than {seconds} s on the "
                           "host")
    old = signal.signal(signal.SIGALRM, stop)
    # again every second: an alarm that lands in a weakref finalizer is
    # printed and dropped, not raised
    signal.setitimer(signal.ITIMER_REAL, seconds, 1.0)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _run(arch_name: str, shape_name: str, mesh_tag: str, cfg: ArchConfig,
         shape: ShapeConfig, make_mesh, variant: str = "auto") -> dict:
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_tag,
           "status": "error"}
    t0 = time.time()
    try:
        mesh = make_mesh()
        with _budget(CELL_BUDGET_S):
            c = count_step(cfg, shape, mesh, variant=variant)
        rec.update({
            "status": "ok",
            "count_s": round(time.time() - t0, 2),
            "n_devices": mesh.size,
            "grad_accum": c["grad_accum"],
            "memory": c["memory"],
            "roofline": roofline_report(
                c["flops"], c["mem_bytes"], c["coll_bytes"],
                model_flops_per_device=model_flops_per_device(
                    cfg, shape, mesh)),
        })
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = round(time.time() - t0, 2)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = OUT_DIR / f"{arch_name}_{shape_name}_{mesh_tag}.json"
    out.write_text(json.dumps(rec, indent=2, default=float))
    return rec


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             save_hlo: bool = False) -> dict:
    """The reference's cell: ``arch_name`` at its shape ``shape_name`` on
    the production mesh. ``save_hlo`` has no meaning here (there is no
    HLO) and raises."""
    if save_hlo:
        raise ValueError("save_hlo: the port compiles no HLO; the dry-run "
                         "counts its step on meta instead")
    cfg = get_arch(arch_name)
    shape = cfg.shapes()[shape_name]
    return _run(arch_name, shape_name, "pod512" if multi_pod else "pod256",
                cfg, shape, lambda: make_production_mesh(multi_pod=multi_pod))


def card_shape(kind: str, seq_len: int, global_batch: int,
               grad_accum: int = 1) -> ShapeConfig:
    """The shape of a ``--mesh card`` cell, named after its numbers."""
    name = f"{kind}_s{seq_len}_b{global_batch}"
    if kind == "train":
        name += f"_a{grad_accum}"
    return ShapeConfig(name, kind, seq_len, global_batch,
                       grad_accum=grad_accum)


def run_card_cell(arch_name: str, shape: ShapeConfig,
                  variant: str = "auto",
                  cfg: Optional[ArchConfig] = None) -> dict:
    """A cell on the one-rank smoke mesh (1, 1): ``shape`` as one card
    runs it (``variant`` names the prefill's attention; ``cfg`` replaces
    the registered config)."""
    cfg = cfg or get_arch(arch_name)
    name = shape.name + ("" if variant == "auto" else f"_{variant}")
    return _run(arch_name, name, "card", cfg, shape,
                lambda: make_smoke_mesh(device="meta"), variant=variant)


def _line(rec: dict) -> str:
    tag = "ok" if rec["status"] == "ok" else "FAIL"
    extra = "" if rec["status"] == "ok" else " :: " + rec.get("error", "?")
    mem = rec.get("memory", {}).get("peak_estimate_gib", "-")
    return (f"[{tag}] {rec['arch']} {rec['shape']} {rec['mesh']} "
            f"wall={rec['wall_s']}s mem/dev={mem}GiB{extra}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=["on", "off", "both"],
                    default="off")
    ap.add_argument("--save-hlo", action="store_true",
                    help="refused: the port compiles no HLO")
    ap.add_argument("--mesh", choices=["pod", "card"], default="pod",
                    help="pod: the production meshes (--multi-pod); card: "
                    "the one-rank mesh at --kind/--seq-len/--global-batch")
    ap.add_argument("--kind", choices=["train", "prefill", "decode"],
                    default="train")
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--variant", default="auto",
                    help="the prefill's attention variant (card cells)")
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo: the port compiles no HLO (its step is counted "
                 "on meta); there is nothing to save")

    archs = sorted(all_archs()) if args.arch == "all" else [args.arch]
    if args.mesh == "card":
        shape = card_shape(args.kind, args.seq_len, args.global_batch,
                           args.grad_accum)
        for a in archs:
            print(_line(run_card_cell(a, shape, args.variant)), flush=True)
        return
    pods = {"on": [True], "off": [False], "both": [False, True]}[
        args.multi_pod]
    for a in archs:
        cfg = get_arch(a)
        shapes = list(cfg.shapes()) if args.shape == "all" else [args.shape]
        for s in shapes:
            for mp in pods:
                print(_line(run_cell(a, s, mp)), flush=True)


if __name__ == "__main__":
    main()
