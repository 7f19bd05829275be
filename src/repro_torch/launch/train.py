"""Training launcher: ties together configs, models, planner, pipeline,
checkpointing and fault tolerance.

Small scale, on the CPU::

    python -m repro_torch.launch.train --arch internlm2-1.8b --steps 50 \\
        --reduced --global-batch 8 --seq-len 128 --device cpu

Without ``--device`` the trainer runs on the card. Under an initialized
process group (``torch.distributed``, its address, world size and rank
given by the caller) the mesh follows the world size: (16, 16) from 256
ranks, (2, 16, 16) from 512, else (world, 1); each rank then holds only
its planned blocks of the parameters and moments. One process runs on the
one-piece smoke mesh.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import ArchConfig, ShapeConfig, get_arch
from ..core.device import resolve_device
from ..data.pipeline import DataConfig, Pipeline
from ..distributed import planner
from ..distributed.mesh import Mesh, make_mesh
from ..optim.adamw import adamw_init
from ..runtime.checkpoint import CheckpointManager
from ..runtime.fault import RestartPolicy, StepWatchdog
from ..tree import tree_map
from . import steps as steps_mod
from .mesh import make_smoke_mesh


def pick_mesh(device=None) -> Mesh:
    """The mesh of this process: by the world size of an initialized
    process group (its backend), else the one-piece smoke mesh. ``device``
    as :func:`..distributed.mesh.make_mesh` takes it (None: the card)."""
    n = (dist.get_world_size()
         if dist.is_available() and dist.is_initialized() else 1)
    if n == 1:
        return make_smoke_mesh(device)
    backend = dist.get_backend()
    if n >= 512:
        return make_mesh((2, 16, 16), ("pod", "data", "model"),
                         backend=backend, device=device)
    if n >= 256:
        return make_mesh((16, 16), ("data", "model"), backend=backend,
                         device=device)
    # generic small mesh: all ranks on data
    return make_mesh((n, 1), ("data", "model"), backend=backend,
                     device=device)


class Trainer:
    """Trains ``cfg`` on ``shape`` from seeded weights (seed 0, a
    ``torch.Generator`` on the device) over the synthetic ``Pipeline``
    (seed 0), checkpointing every ``ckpt_every`` steps into ``ckpt_dir``
    and resuming from its newest checkpoint. The host syncs once a step,
    to read the metrics."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, *,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 peak_lr: float = 3e-4, total_steps: int = 10000,
                 device=None):
        self.cfg, self.shape = cfg, shape
        self.mesh = pick_mesh(device)
        self.device = self.mesh.device
        self.lm = steps_mod.build_lm(cfg, self.mesh)
        self.ckpt = (CheckpointManager(ckpt_dir) if ckpt_dir else None)
        self.ckpt_every = ckpt_every
        self.watchdog = StepWatchdog()
        self.metrics_log: list = []

        self.pipeline = Pipeline(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
            global_batch=shape.global_batch,
            frontend_tokens=cfg.frontend_tokens if cfg.frontend != "none"
            else 0, d_model=cfg.d_model))

        gen = torch.Generator(device=self.device).manual_seed(0)
        params = self.lm.init_params(gen, self.device)
        self.param_specs = planner.params_pspecs(params, self.mesh)
        self.params = planner.place(params, self.param_specs, self.mesh)
        del params
        self.opt = adamw_init(self.params)
        self.step_fn, self.accum = steps_mod.make_train_step(
            self.lm, shape, self.mesh, peak_lr=peak_lr,
            total_steps=total_steps, param_specs=self.param_specs)
        self.step = 0
        self._saved = None       # the last step saved or restored
        if self.ckpt and self.ckpt.latest_step() is not None:
            self.restore()

    # ------------------------------------------------------------------
    def restore(self) -> None:
        like = {"params": self.params, "opt": self.opt,
                "cursor": self.pipeline.cursor(), "step": 0}
        step, state = self.ckpt.restore(like)
        # the checkpoint holds this rank's blocks: back onto the device, in
        # the tensors' own dtypes
        self.params = tree_map(
            lambda like, a: torch.from_numpy(np.asarray(a)).to(
                device=like.device, dtype=like.dtype),
            self.params, state["params"])
        self.opt = tree_map(
            lambda like, a: torch.from_numpy(np.asarray(a)).to(
                device=like.device, dtype=like.dtype),
            self.opt, state["opt"])
        self.pipeline.restore({k: int(v) for k, v in
                               state["cursor"].items()})
        self.step = self._saved = int(state["step"])

    def save(self, blocking: bool = False) -> None:
        if not self.ckpt:
            return
        self._saved = self.step
        self.ckpt.save(self.step, {
            "params": self.params, "opt": self.opt,
            "cursor": self.pipeline.cursor(), "step": self.step,
        }, blocking=blocking)

    # ------------------------------------------------------------------
    def run(self, n_steps: int, log_every: int = 10) -> Dict[str, Any]:
        while self.step < n_steps:
            batch = next(self.pipeline)
            args = [self.params, self.opt,
                    torch.from_numpy(batch["tokens"]).to(self.device)]
            if "frontend" in batch:
                args.append(torch.from_numpy(batch["frontend"]).to(
                    device=self.device, dtype=torch.bfloat16))
            self.watchdog.start()
            t0 = time.perf_counter()
            self.params, self.opt, metrics = self.step_fn(*args)
            loss, gnorm, lr = torch.stack(
                [metrics["loss"].float(), metrics["gnorm"].float(),
                 metrics["lr"].float()]).cpu().tolist()    # the one sync
            seconds = time.perf_counter() - t0
            straggled = self.watchdog.stop()
            self.step += 1
            rec = {"step": self.step, "loss": loss, "gnorm": gnorm,
                   "lr": lr, "seconds": seconds, "straggled": straggled}
            self.metrics_log.append(rec)
            if self.step % log_every == 0 or self.step == 1:
                print(f"step {self.step:5d} loss {rec['loss']:.4f} "
                      f"gnorm {rec['gnorm']:.3f} "
                      f"({self.watchdog.median()*1000:.0f} ms/med)",
                      flush=True)
            if self.ckpt and self.step % self.ckpt_every == 0:
                self.save()
        if self.ckpt:
            # a step saves once: the reference saves a step on the
            # checkpoint interval twice, and the second write fails on the
            # committed directory (ROADMAP Queue 3 record 5)
            if self._saved == self.step:
                self.ckpt.wait()
            else:
                self.save(blocking=True)
        if not self.metrics_log:
            # resumed at/past n_steps: nothing to do (restart safety)
            return {"final_loss": float("nan"), "steps": self.step,
                    "median_step_s": 0.0}
        return {"final_loss": self.metrics_log[-1]["loss"],
                "steps": self.step,
                "median_step_s": self.watchdog.median()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--global-batch", type=int, default=0)
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="where to train (default: the card; 'cpu' to run "
                    "the plain PyTorch path on the CPU)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig(
        "custom", "train",
        seq_len=args.seq_len or 4096,
        global_batch=args.global_batch or 256,
        grad_accum=args.grad_accum)
    tr = Trainer(cfg, shape, ckpt_dir=args.ckpt_dir or None,
                 total_steps=args.steps, peak_lr=args.lr,
                 device=resolve_device(args.device))
    policy = RestartPolicy(max_restarts=3)
    restarts = policy.run_with_restarts(
        lambda: tr.run(args.steps),
        on_restart=lambda n: (print(f"[restart {n}] restoring"),
                              tr.restore() if tr.ckpt else None))
    tr.pipeline.close()
    print(f"done: final loss {tr.metrics_log[-1]['loss']:.4f}, "
          f"{restarts} restarts")


if __name__ == "__main__":
    main()
