"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points refuse to run on the CPU unless the caller asks for it."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import plan_search
from repro_torch.kernels import ops
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b|"
                       r"from\s+(jax|repro)\b)", re.M)


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.kernels.spmm, repro_torch.kernels.spmv\n"
        "import repro_torch.kernels.sddmm, repro_torch.kernels.spmttkrp\n"
        "import repro_torch.kernels.spadd3, repro_torch.kernels.bcsr\n"
        "import repro_torch.kernels.layout\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.configs, repro_torch.configs.llama3_8b\n"
        "import repro_torch.models, repro_torch.models.attention\n"
        "import repro_torch.models.convert\n"
        "import repro_torch.core.lower, repro_torch.kernels.ops\n"
        "import repro_torch.data.spdata\n"
        "import repro_torch.runtime.telemetry, chip_smoke\n"
        "import repro_torch.distributed.mesh\n"
        "import repro_torch.distributed.collectives\n"
        "import repro_torch.distributed.planner\n"
        "import repro_torch.distributed.executor\n"
        "import repro_torch.core.plan_search\n"
        "import repro_torch.kernels.autotune, repro_torch.launch.roofline\n"
        "import repro_torch.runtime.fault, repro_torch.runtime.checkpoint\n"
        "import repro_torch.runtime.elastic\n"
        "import repro_torch.launch, repro_torch.launch.report\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.models.sparse_attention\n"
        "import repro_torch.models.moe\n"
        "import repro_torch.models.model, repro_torch.models.gla\n"
        "import repro_torch.models.ssm, repro_torch.models.xlstm\n"
        "import repro_torch.optim, repro_torch.optim.adamw\n"
        "import repro_torch.optim.schedules, repro_torch.optim.grad_compress\n"
        "import repro_torch.data, repro_torch.data.pipeline\n"
        "import repro_torch.launch.steps, repro_torch.launch.train\n"
        "import repro_torch.launch.mesh, repro_torch.tree\n"
        "import repro_torch.launch.dryrun\n"
        "import repro_torch.examples.quickstart\n"
        "import repro_torch.examples.spmv_distributed\n"
        "import repro_torch.examples.moe_sparse_dispatch\n"
        "import repro_torch.examples.long_context_block_sparse\n"
        "import repro_torch.examples.serve_batched\n"
        "import repro_torch.examples.train_e2e\n"
        "import repro_torch.configs.base as cb\n"
        "assert len(cb.all_archs()) == 10\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _spmv_stmt():
    d = np.eye(4, dtype=np.float32)
    return tc.parse_tin("a(i) = B(i,j) * c(j)",
                        a=tc.Tensor.zeros_dense("a", (4,)),
                        B=tc.Tensor.from_dense("B", d, tc.CSR()),
                        c=tc.Tensor.from_dense("c", np.ones(4, np.float32)))


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stmt = _spmv_stmt()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.lower_stmt(stmt, tc.Machine(("x", 2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.spmv([0, 1], [0], [1.0], [2.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.interpret(stmt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.lower_stmt(stmt, tc.Machine(("x", 2)), schedule="auto")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_search.search(stmt, tc.Machine(("x", 2)))
    k = tc.lower_stmt(stmt, tc.Machine(("x", 2)), device="cpu")
    assert k.device == torch.device("cpu")
    np.testing.assert_array_equal(k.run().numpy(), np.ones(4, np.float32))


def test_training_entry_points_need_a_card_unless_asked_for_cpu(
        monkeypatch):
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_smoke_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("internlm2-1.8b").reduced()
    shape = ShapeConfig("t", "train", seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_smoke_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.Trainer(cfg, shape)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "internlm2-1.8b", "--reduced", "--steps", "1"])
    tr = train.Trainer(cfg, shape, device="cpu")
    assert tr.device == torch.device("cpu")
    assert all(x.device.type == "cpu" for x in leaves((tr.params, tr.opt)))
    tr.pipeline.close()


def test_chip_smoke_refuses_to_run_without_a_card_or_the_package(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    env["CUDA_VISIBLE_DEVICES"] = ""          # no card, even on a machine
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
