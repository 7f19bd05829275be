"""End-to-end training: a small dense LM for a few hundred steps
with checkpoint/restart.

Defaults: about 10M parameters, 300 steps, the loss visibly decreasing on
the structured synthetic corpus. Scale up with --dmodel/--layers/--steps;
under a process group the same Trainer shards over the mesh the world
size gives.

    PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 300
"""
import argparse
import tempfile

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.train import Trainer
from repro_torch.runtime.fault import RestartPolicy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dmodel", type=int, default=256)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                    "one, removed at the end)")
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the card)")
    args = ap.parse_args(argv)

    cfg = ArchConfig(
        name="e2e-dense", family="dense", n_layers=args.layers,
        d_model=args.dmodel, n_heads=max(args.dmodel // 64, 1),
        n_kv_heads=max(args.dmodel // 128, 1), d_ff=args.dmodel * 4,
        vocab_size=8192, remat=False, dtype="float32")
    print(f"params ≈ {cfg.param_count()/1e6:.1f}M")
    shape = ShapeConfig("e2e", "train", seq_len=args.seq,
                        global_batch=args.batch)
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, shape, ckpt_dir=args.ckpt or tmp, ckpt_every=100,
                     total_steps=args.steps, peak_lr=1e-3,
                     device=args.device)
        RestartPolicy(max_restarts=2).run_with_restarts(
            lambda: tr.run(args.steps),
            on_restart=lambda n: print(f"[restart {n}]"))
    if not tr.metrics_log:
        print(f"checkpoint already at step {tr.step} ≥ {args.steps}; "
              f"nothing to train (use a fresh --ckpt dir to restart)")
        return {"params": cfg.param_count(), "steps": 0}
    first = tr.metrics_log[0]["loss"]
    last = tr.metrics_log[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({'improved' if last < first else 'NOT improved'})")
    assert last < first, f"the loss rose from {first} to {last}"
    return {"params": cfg.param_count(), "steps": len(tr.metrics_log),
            "first_loss": first, "last_loss": last}


if __name__ == "__main__":
    main()
