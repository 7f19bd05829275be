"""The port's train step on a mesh of gloo ranks, and the chip script's
training path (4k) rehearsed on the CPU.

The mesh step is tests/test_spmd.py::test_pjit_train_step_on_mesh's: the
reduced llama3-8b on a (data=4, model=2) mesh in 8 ranks, global batch 8
of 32 tokens in 2 microbatches, each rank holding only its planned blocks
of the parameters and moments (``planner.place``). It must equal the same
step in one process at 1e-5 (loss, gnorm, the gathered new parameters),
in f32 activations, and every rank's local shapes must be its spec's
blocks. The ranks are ``chip_smoke.train_mesh_rank``, spawned from the
script, whose top level imports no JAX, over a FileStore under
``tmp_path``; the group has a time limit. This file imports no JAX: the
one-process step is held against the reference in
tests/test_torch_train.py."""
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def test_mesh_train_step_matches_one_process(tmp_path):
    rec = chip_smoke.train_mesh("llama3-8b", torch.device("cpu"),
                                shape=(4, 2), seq=32, batch=8, accum=2,
                                lr=1e-3, root=tmp_path)
    assert rec["world"] == 8
    assert rec["loss_rel"] <= 1e-5 and rec["param_abs"] <= 1e-5
    # a rank holds a fraction of the state: the sharded leaves in blocks
    assert rec["held_fraction"] < 0.5


def test_chip_smoke_train_path_on_cpu(tmp_path, capsys):
    """Path 4k on the CPU at reduced width, remat on: the Trainer's steps
    and checks, the f32 twin (the CPU against itself), the restart from a
    checkpoint and a (2, 2) mesh in 4 ranks; no kernel launches."""
    before = dict(_build.LAUNCHES)
    out = chip_smoke.train_path(
        torch.device("cpu"),
        train=dict(seq=32, batch=8, accum=4, steps=4, lr=3e-3,
                   total_steps=4),
        twin=dict(layers=2, batch=2, seq=16),
        restart=dict(seq=16, batch=8, accum=2, ckpt_every=2, first=4,
                     more=2),
        mesh=dict(shape=(2, 2), seq=16, batch=8, accum=2, lr=1e-3),
        reduce=lambda c: dataclasses.replace(c.reduced(), remat=True),
        root=tmp_path)
    assert _build.LAUNCHES == before
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("[train] ") for line in lines) == 4
    for tag in ("train-summary", "train-twin", "train-restart",
                "train-mesh", "train-path"):
        assert sum(line.startswith(f"[{tag}] ") for line in lines) == 1
    assert out["full"]["attention_calls"] == 2 * 2 * 4 * 4
    assert out["restart"]["resumed_at"] == 4
    # (5) xlstm-125m reduced: its steps, summary and twin, no kernel here
    assert sum(line.startswith("[train-xlstm] ") for line in lines) == 3
    for tag in ("train-xlstm-summary", "train-xlstm-twin"):
        assert sum(line.startswith(f"[{tag}] ") for line in lines) == 1
    assert out["xlstm"]["attention_calls"] == 0 and out["launches"] == {}
    assert out["xlstm"]["first_batch_again"] < out["xlstm"]["losses"][0]
    assert out["xlstm_twin"]["kernel_vs_plain_rel"] <= 1e-3
    assert not any(tmp_path.iterdir())
