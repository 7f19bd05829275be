"""The port's six examples against the JAX package's ``examples/``, on the
CPU: each reference example runs through ``runpy`` with its stdout
captured, the port's twin through its ``main(["--device", "cpu"])``, and
the host-side figures they print must agree (floats at the reference's
own tolerances; timing lines left out). Figures drawn from each package's
own random generator (the MoE layer's weights and inputs, the attention
inputs, the LM's weights) cannot agree and are held to the reference's
asserts instead: the attention error below 1e-4, the loss falling."""
import re
import runpy
import sys
from pathlib import Path

import pytest

from repro_torch.examples import (long_context_block_sparse,
                                  moe_sparse_dispatch, quickstart,
                                  serve_batched, spmv_distributed, train_e2e)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TINY_TRAIN = ["--steps", "4", "--dmodel", "64", "--layers", "1", "--seq",
              "16", "--batch", "4"]


def _reference(name, capsys, monkeypatch, argv=()):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out.splitlines()


def _port(module, capsys, argv=()):
    capsys.readouterr()
    figures = module.main(["--device", "cpu", *argv])
    return figures, capsys.readouterr().out.splitlines()


def _line(lines, prefix):
    hits = [x for x in lines if x.startswith(prefix)]
    assert len(hits) == 1, (prefix, lines)
    return hits[0]


def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.?\d*(?:e-?\d+)?", line)]


def test_quickstart_matches_reference(capsys, monkeypatch):
    ref = _reference("quickstart", capsys, monkeypatch)
    figs, got = _port(quickstart, capsys)
    for prefix in ("leaf kernel:", "row imbalance:", "communication:"):
        assert _line(got, prefix) == _line(ref, prefix)
    err = _numbers(_line(ref, "max |err| vs dense:"))[0]
    assert figs["max_err"] == _numbers(_line(got, "max |err|"))[0]
    assert abs(figs["max_err"] - err) <= 1e-4 and figs["max_err"] <= 1e-4
    assert got[-1] == ref[-1]


def test_spmv_distributed_matches_reference(capsys, monkeypatch):
    ref = _reference("spmv_distributed", capsys, monkeypatch)
    figs, got = _port(spmv_distributed, capsys)
    for prefix in ("row-based ", "nnz-based "):
        assert _line(got, prefix) == _line(ref, prefix)
    assert figs["nnz-based"]["imbalance"] < figs["row-based"]["imbalance"]
    # one process: both take the single-process path and say so
    assert got[-1].startswith("(single process") and \
        ref[-1].startswith("(single device")


def test_moe_sparse_dispatch_matches_reference(capsys, monkeypatch):
    ref = _reference("moe_sparse_dispatch", capsys, monkeypatch)
    figs, got = _port(moe_sparse_dispatch, capsys)
    for prefix in ("router:", "  expert-major", "  fused non-zero"):
        assert _line(got, prefix) == _line(ref, prefix)
    # the layer's weights come from each package's generator: the shape
    # agrees, the aux loss is near E·Σ(1/E)² = 1 in both
    assert _line(got, "moe layer out").split(",")[:3] == \
        _line(ref, "moe layer out").split(",")[:3]
    r_aux = _numbers(_line(ref, "moe layer out"))[-1]
    assert abs(figs["aux"] - r_aux) < 0.2
    assert 0 <= figs["drops"] < 4096 * 2
    assert got[-1] == ref[-1] == "OK"


def test_long_context_block_sparse_matches_reference(capsys, monkeypatch):
    ref = _reference("long_context_block_sparse", capsys, monkeypatch)
    figs, got = _port(long_context_block_sparse, capsys)
    assert _line(got, "block mask:") == _line(ref, "block mask:")
    r_err = _numbers(_line(ref, "max |err|"))[-1]
    assert figs["max_err"] < 1e-4 and r_err < 1e-4
    assert got[-1] == ref[-1]


def test_serve_batched_matches_reference(capsys, monkeypatch):
    ref = _reference("serve_batched", capsys, monkeypatch)
    figs, got = _port(serve_batched, capsys)
    for prefix in ("band mask:", "run_many:", "batched kernel over",
                   "  bucket 8:"):
        assert _line(got, prefix) == _line(ref, prefix)
    # the SLO line: the same count and SLO; latencies are timing
    served = _line(got, "served ")
    assert served.split(":")[0] == _line(ref, "served ").split(":")[0]
    assert figs["stats"]["served"] == 32
    assert served.endswith("attainment=100%")


def test_train_e2e_matches_reference(capsys, monkeypatch, tmp_path):
    ref = _reference("train_e2e", capsys, monkeypatch,
                     TINY_TRAIN + ["--ckpt", str(tmp_path / "ref")])
    figs, got = _port(train_e2e, capsys,
                      TINY_TRAIN + ["--ckpt", str(tmp_path / "port")])
    assert _line(got, "params ≈") == _line(ref, "params ≈")
    assert figs["steps"] == 4 and figs["last_loss"] < figs["first_loss"]
    assert _line(got, "loss ").endswith("over 4 steps (improved)")
    # the reference prints its verdict and asserts none (over 4 steps of
    # its own weights it may not improve)
    assert re.search(r"over 4 steps \((NOT )?improved\)$",
                     _line(ref, "loss "))


def test_examples_refuse_the_cpu_unless_asked(monkeypatch):
    """Without ``--device`` an example runs on the card, and raises where
    there is none."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        long_context_block_sparse.main([])
