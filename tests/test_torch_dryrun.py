"""The port's dry-run against the JAX package's, on the CPU.

- ``LM.abstract_params`` leaf for leaf (shape and dtype) against the
  reference's ``abstract_params()``, carried into the port's tree by the
  weight converter, for all ten architectures, reduced and full;
- ``input_specs`` and ``abstract_state`` against the reference's
  ``jax.eval_shape`` stand-ins at every shape of every architecture;
- ``step_shardings``' specs against the reference planner's on the
  (16, 16) and (2, 16, 16) stand-in meshes, and the donated arguments;
- ``model_flops_per_device`` equal to the reference's;
- each shape kind's step on ``meta`` against ``jax.eval_shape`` of the
  reference's step, output for output;
- the collective bytes of a reduced train step on a ``meta`` (2, 2) mesh
  equal to ``collectives.TRAFFIC`` after the real step on a (2, 2) mesh
  of gloo ranks;
- the FLOPs ``FlopCounterMode`` counts on ``meta`` against the dot FLOPs
  the reference's ``HloAnalyzer`` reads from the compiled prefill of the
  same reduced config, and against ``FlopCounterMode`` over the real step
  on the CPU;
- ``report.table`` and ``report.summary`` string-equal to the reference's
  over the same records;
- the peak tracker, the layout mesh's gathers, the CLI (one full-size
  cell, ``--save-hlo`` refused) and path 4l rehearsed at reduced size.
"""
import dataclasses
import functools
import json
import os
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
from repro.distributed import planner as rplanner
from repro.launch import report as rreport
from repro.launch import steps as rsteps
from repro.launch.roofline import HloAnalyzer
from repro.models.model import LM as RLM
from repro_torch.configs import ShapeConfig, all_archs, get_arch
from repro_torch.distributed import collectives, planner
from repro_torch.distributed.mesh import Mesh
from repro_torch.launch import dryrun, report
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.models import LM, convert
from repro_torch.tree import leaves, leaves_with_path

# the reference's dry-run module sets XLA_FLAGS (512 host devices) when it
# is imported; this process keeps its own flags
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as rdryrun  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ARCHS = sorted(all_archs())
META = torch.device("meta")
POD_MESHES = {"pod256": ((16, 16), ("data", "model"), False),
              "pod512": ((2, 16, 16), ("pod", "data", "model"), True)}


@pytest.fixture(autouse=True)
def _records_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path / "dryrun_torch")


def _ref_mesh(label):
    shape, axes, _ = POD_MESHES[label]
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, dtype=object))


def _port_tree(ref_abstract, cfg):
    """The reference's abstract tree as the port's tree of ``meta``
    tensors (shapes and dtypes), through the weight converter."""
    arrays = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype),
                                                    s.shape), ref_abstract)
    orig = convert._tensor
    convert._tensor = lambda x, device, dtype=None: torch.empty(
        np.shape(x), dtype=dtype or convert.DTYPES[np.asarray(x).dtype.name],
        device="meta")
    try:
        return convert.lm_params_from_reference(arrays, cfg, "meta")
    finally:
        convert._tensor = orig


def _sig(tree):
    return [(p, tuple(x.shape), x.dtype) for p, x in leaves_with_path(tree)]


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch, full, serve=False):
    rc = rcfg.get_arch(arch)
    rc = rc if full else rc.reduced()
    if serve:
        rc = dataclasses.replace(rc, param_dtype="bfloat16")
    return RLM(rc).abstract_params()


def _cfg(arch, full):
    cfg = get_arch(arch)
    return cfg if full else cfg.reduced()


# ---------------------------------------------------------------------------
# Abstract parameters, inputs and state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch, full):
    cfg = _cfg(arch, full)
    got = LM(cfg).abstract_params()
    assert all(x.device.type == "meta" for x in leaves(got))
    assert _sig(got) == _sig(_port_tree(_ref_abstract(arch, full), cfg))


def test_init_params_still_refuses_a_foreign_generator():
    with pytest.raises(ValueError, match="generator lives on"):
        LM(get_arch("internlm2-1.8b").reduced()).init_params(
            torch.Generator(), META)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_state_match_reference(arch):
    cfg, rc = get_arch(arch), rcfg.get_arch(arch)
    lm, rlm = LM(cfg), RLM(rc)
    params, opt = S.abstract_state(lm)
    r_params = _ref_abstract(arch, True)
    r_opt = jax.eval_shape(rsteps.adamw_init, r_params)
    assert _sig(params) == _sig(_port_tree(r_params, cfg))
    assert (tuple(opt.step.shape), opt.step.dtype) == ((), torch.int32)
    assert r_opt.step.shape == () and r_opt.step.dtype == jnp.int32
    for mine, ref in ((opt.mu, r_opt.mu), (opt.nu, r_opt.nu)):
        assert _sig(mine) == _sig(_port_tree(ref, cfg))
    for name, shape in cfg.shapes().items():
        got = S.input_specs(cfg, shape, lm)
        want = rsteps.input_specs(rc, rc.shapes()[name], rlm)
        assert sorted(got) == sorted(want)
        for key in ("tokens", "token", "frontend"):
            if key in want:
                assert tuple(got[key].shape) == want[key].shape
                assert str(got[key].dtype).split(".")[1] == \
                    want[key].dtype.name
        if "cache" in want:
            assert sorted(got["cache"]) == sorted(want["cache"])
            for k, v in want["cache"].items():
                assert tuple(got["cache"][k].shape) == v.shape, k
                assert str(got["cache"][k].dtype).split(".")[1] == \
                    v.dtype.name, k
                assert got["cache"][k].device.type == "meta"


def _check_specs(port_specs, port_tree, ref_specs):
    """Each port leaf's spec against its reference leaf's (the path without
    list indices), the reference's leading stacked dims unsharded."""
    ref_by_path = {}
    for path, sp in jax.tree_util.tree_flatten_with_path(
            ref_specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]:
        key = tuple(str(p.key) if hasattr(p, "key") else str(p.name)
                    for p in path)
        ref_by_path[key] = tuple(sp)
    got = leaves_with_path(port_specs, is_leaf=planner.is_spec)
    shapes = dict(leaves_with_path(port_tree))
    assert len(got) == len(shapes)
    for path, sp in got:
        want = ref_by_path[tuple(p for p in path if isinstance(p, str))]
        k = len(want) - len(sp)
        assert k >= 0 and want[:k] == (None,) * k, (path, want, sp)
        assert sp == want[k:], (path, want, sp)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_shardings_match_reference_planner(arch):
    cfg, rc = get_arch(arch), rcfg.get_arch(arch)
    for label, (_, _, multi) in POD_MESHES.items():
        pm, rm = make_production_mesh(multi_pod=multi), _ref_mesh(label)
        for name, shape in cfg.shapes().items():
            serve = shape.kind != "train"
            lm = S.build_lm(cfg, pm, serve=serve)
            rlm = RLM(dataclasses.replace(rc, param_dtype="bfloat16")
                      if serve else rc)
            args, shard, donate = S.step_shardings(cfg, shape, pm, lm)
            specs = [S._spec_tree(sh) if not isinstance(sh, planner.Sharding)
                     else sh.spec for sh in shard]
            r_params = _ref_abstract(arch, True, serve)
            _check_specs(specs[0], args[0],
                         rplanner.params_pspecs(r_params, rm, serve=serve))
            B = shape.global_batch
            if shape.kind == "train":
                assert donate == (0, 1)
                ro = rplanner.opt_pspecs(
                    jax.eval_shape(rsteps.adamw_init, r_params), r_params, rm)
                assert specs[1].step == tuple(ro.step) == ()
                _check_specs(specs[1].mu, args[0], ro.mu)
                _check_specs(specs[1].nu, args[0], ro.nu)
                assert specs[2] == tuple(rplanner.batch_pspec(rm, B))
            elif shape.kind == "prefill":
                assert donate == ()
                assert specs[1] == tuple(rplanner.batch_pspec(rm, B))
            else:
                assert donate == (1,)
                rcache = rsteps.input_specs(rc, rc.shapes()[name],
                                            rlm)["cache"]
                want = rplanner.cache_pspecs(rcache, rm, B)
                assert {k: v for k, v in specs[1].items()} == {
                    k: tuple(v) for k, v in want.items()}
                da = rsteps.data_axes(rm)
                tok = (da if B % (rsteps.axis_size(rm, *da) or 1) == 0
                       and B > 1 else None)
                assert specs[2] == tuple(jax.sharding.PartitionSpec(tok))
            if cfg.frontend != "none" and shape.kind != "decode":
                assert specs[-1] == tuple(rplanner.frontend_pspec(rm, B))


def test_model_flops_per_device_match_reference():
    for arch in ARCHS:
        cfg, rc = get_arch(arch), rcfg.get_arch(arch)
        for label, (_, _, multi) in POD_MESHES.items():
            pm, rm = make_production_mesh(multi_pod=multi), _ref_mesh(label)
            for name, shape in cfg.shapes().items():
                assert dryrun.model_flops_per_device(cfg, shape, pm) == \
                    rdryrun.model_flops_per_device(rc, rc.shapes()[name], rm)


# ---------------------------------------------------------------------------
# The step on meta against the reference's eval_shape
# ---------------------------------------------------------------------------

STEP_SHAPES = {"train": ShapeConfig("t", "train", 32, 4, grad_accum=2),
               "prefill": ShapeConfig("p", "prefill", 32, 2),
               "decode": ShapeConfig("d", "decode", 64, 2)}


@pytest.mark.parametrize("kind", sorted(STEP_SHAPES))
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-7b",
                                  "seamless-m4t-medium", "xlstm-125m"])
def test_step_outputs_match_reference_eval_shape(arch, kind):
    cfg, rc = get_arch(arch).reduced(), rcfg.get_arch(arch).reduced()
    shape = STEP_SHAPES[kind]
    fn, args, lm = S.build_step(cfg, shape, make_smoke_mesh(META))
    with torch.no_grad() if kind != "train" else torch.enable_grad():
        out = fn(*args)
    rmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    with rmesh:
        jf, rargs, _ = rsteps.build_step(rc, shape, rmesh)
        want = jax.eval_shape(jf, *rargs)
    if kind == "train":
        new_p, new_opt, metrics = out
        r_p, r_opt, r_metrics = want
        assert _sig(new_p) == _sig(_port_tree(r_p, cfg))
        assert _sig(new_opt.mu) == _sig(_port_tree(r_opt.mu, cfg))
        assert _sig(new_opt.nu) == _sig(_port_tree(r_opt.nu, cfg))
        assert sorted(metrics) == sorted(r_metrics)
        for k, v in r_metrics.items():
            assert tuple(metrics[k].shape) == v.shape == ()
        return
    if kind == "prefill":
        assert tuple(out.shape) == want.shape
        assert str(out.dtype).split(".")[1] == want.dtype.name
        return
    logits, cache = out
    assert tuple(logits.shape) == want[0].shape
    assert str(logits.dtype).split(".")[1] == want[0].dtype.name
    assert sorted(cache) == sorted(want[1])
    for k, v in want[1].items():
        assert tuple(cache[k].shape) == v.shape, k
        assert str(cache[k].dtype).split(".")[1] == v.dtype.name, k


# ---------------------------------------------------------------------------
# Collective bytes, FLOPs and peak memory
# ---------------------------------------------------------------------------

def test_layout_gather_counts_bytes_and_touches_no_group(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a layout mesh reached dist.all_gather")
    monkeypatch.setattr(collectives.dist, "all_gather", refuse)
    mesh = make_production_mesh()
    before = dict(collectives.TRAFFIC), dict(collectives.TRAFFIC_BY_KIND)
    x = torch.empty((3, 5), dtype=torch.bfloat16, device=META)
    parts = collectives.gather_parts(x, mesh, "data")
    assert len(parts) == 16 and all(
        p.shape == x.shape and p.dtype == x.dtype and p.device == META
        for p in parts)
    total = collectives.reduce_rows(x, mesh, ("data", "model"))
    assert total.shape == x.shape
    assert collectives.TRAFFIC["received"] - before[0]["received"] == \
        30 * (15 + 255)
    assert collectives.TRAFFIC_BY_KIND["all-gather"] - \
        before[1]["all-gather"] == 30 * 15
    assert collectives.TRAFFIC_BY_KIND["reduce"] - \
        before[1]["reduce"] == 30 * 255
    # a one-rank axis gathers nothing
    assert collectives.gather_parts(x, make_smoke_mesh(META), "data") == [x]


def test_dry_collective_bytes_equal_gloo_step(tmp_path):
    """One reduced train step on a meta (2, 2) layout mesh moves exactly
    the bytes the same step moved on a (2, 2) mesh of gloo ranks."""
    arch, seq, batch, accum = "internlm2-1.8b", 16, 8, 2
    statuses = chip_smoke.spawn_group(
        chip_smoke.train_mesh_rank, 4, tmp_path / "ranks",
        (arch, (2, 2), "cpu", seq, batch, accum, 1e-3), "traffic", 300)
    real = statuses[0]["traffic"]
    assert all(s["traffic"] == real for s in statuses)
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    dry = dryrun.count_step(
        cfg, ShapeConfig("t", "train", seq, batch, grad_accum=accum),
        Mesh(("data", "model"), (2, 2), None, META, 0, {}))
    assert dry["coll_bytes"] == {k: real[k]
                                 for k in collectives.COLLECTIVE_KINDS}
    assert sum(dry["coll_bytes"].values()) == real["received"] > 0


def test_flops_against_reference_hlo():
    """The FLOPs ``FlopCounterMode`` counts on ``meta`` for the reduced
    internlm2-1.8b prefill (2 x 64, dense attention) against the dot FLOPs
    ``HloAnalyzer`` reads from the reference's compiled prefill on one CPU
    device: equal (gap 0), since both count 2·m·n·k for each matrix
    product and nothing else."""
    arch, shape = "internlm2-1.8b", ShapeConfig("p", "prefill", 64, 2)
    cfg, rc = get_arch(arch).reduced(), rcfg.get_arch(arch).reduced()
    dry = dryrun.count_step(cfg, shape, make_smoke_mesh(META))
    rlm = RLM(dataclasses.replace(rc, param_dtype="bfloat16"))
    fn = rsteps.make_prefill_step(rlm, shape)
    hlo = jax.jit(fn).lower(
        rlm.abstract_params(),
        jax.ShapeDtypeStruct((2, 64), jnp.int32)).compile().as_text()
    want = HloAnalyzer(hlo).cost().flops
    assert want > 0
    assert abs(dry["flops"] - want) / want == 0.0, (dry["flops"], want)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "xlstm-125m"])
def test_meta_flops_equal_the_real_step_on_the_cpu(arch):
    """The CPU's twin of the card check of path 4l: the meta count of a
    reduced train step (remat on) equals ``FlopCounterMode`` over the
    same step run on the CPU (xlstm-125m: the sLSTM scan's formula on
    both, the plain loop inside it on the CPU)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(get_arch(arch).reduced(), remat=True)
    shape = ShapeConfig("t", "train", 32, 4, grad_accum=2)
    meta = dryrun.count_step(cfg, shape, make_smoke_mesh(META))["flops"]
    mesh = make_smoke_mesh("cpu")
    lm = S.build_lm(cfg, mesh)
    params = lm.init_params(torch.Generator().manual_seed(0), "cpu")
    fn, _ = S.make_train_step(lm, shape, mesh)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        fn(params, adamw_init(params), tokens)
    assert fc.get_total_flops() == meta > 0


def test_peak_holds_dense_attention_scores():
    """Dense attention's (B, Hkv, G, S, S) f32 scores are counted where the
    ``auto`` variant makes them (S <= 8192), and the peak covers them and
    the arguments; nothing is allocated."""
    cfg = get_arch("internlm2-1.8b").reduced()
    B, Sq = 2, 512
    rec = dryrun.count_step(cfg, ShapeConfig("p", "prefill", Sq, B),
                            make_smoke_mesh(META))
    m = rec["memory"]
    scores = B * cfg.n_heads * Sq * Sq * 4
    assert m["temp_bytes_per_dev"] >= scores
    assert m["alias_bytes_per_dev"] == 0
    assert m["peak_estimate_gib"] * 2**30 >= \
        m["argument_bytes_per_dev"] + scores - 2**20
    # train: the parameters and moments are written in place
    rec = dryrun.count_step(cfg, ShapeConfig("t", "train", 32, 4,
                                             grad_accum=2),
                            make_smoke_mesh(META))
    m = rec["memory"]
    assert m["alias_bytes_per_dev"] >= 3 * 4 * cfg.param_count() * 0.99
    assert m["temp_bytes_per_dev"] > 0 and rec["grad_accum"] == 2


# ---------------------------------------------------------------------------
# Records, report and CLI
# ---------------------------------------------------------------------------

def _records():
    """Records of both meshes in the reference's form: ok cells, a failed
    one, and missing ones."""
    recs = []
    rng = np.random.default_rng(0)
    for mesh in ("pod256", "pod512"):
        for i, a in enumerate(report.ARCH_ORDER[:6]):
            for j, s in enumerate(report.SHAPE_ORDER):
                if (i + j) % 5 == 4:
                    continue
                if (i, j) == (2, 1):
                    recs.append({"arch": a, "shape": s, "mesh": mesh,
                                 "status": "error",
                                 "error": "RuntimeError: " + "x" * 60})
                    continue
                t = rng.random(3) * 10.0 ** rng.integers(-7, 2, 3)
                bound = float(t.max())
                recs.append({
                    "arch": a, "shape": s, "mesh": mesh, "status": "ok",
                    "memory": {"peak_estimate_gib": float(rng.random() * 40)},
                    "roofline": {
                        "compute_s": float(t[0]), "memory_s": float(t[1]),
                        "collective_s": float(t[2]),
                        "dominant": ["compute_s", "memory_s",
                                     "collective_s"][int(t.argmax())],
                        "roofline_bound_s": bound,
                        "compute_fraction_at_bound": float(t[0]) / bound,
                        "useful_flops_ratio": float(rng.random())}})
    return recs


def test_report_matches_reference(tmp_path, monkeypatch):
    for r in _records():
        (tmp_path / f"{r['arch']}_{r['shape']}_{r['mesh']}.json").write_text(
            json.dumps(r))
    monkeypatch.setattr(report, "OUT_DIR", tmp_path)
    monkeypatch.setattr(rreport, "OUT_DIR", tmp_path)
    for mesh in ("pod256", "pod512"):
        assert report.table(mesh) == rreport.table(mesh)
        assert json.dumps(report.summary(mesh), default=str) == \
            json.dumps(rreport.summary(mesh), default=str)
    for x in (3.2, 1.0, 0.25, 1e-3, 4.2e-5, 0.0):
        assert report.fmt_s(x) == rreport.fmt_s(x)


def test_cli_one_full_cell_and_report(tmp_path, monkeypatch, capsys):
    """One full-size cell through ``main`` (xlstm-125m's decode_32k on
    pod256; the other kinds' full-size cells run in path 4l and the
    sweep), its record in the reference's keys, and the report over it."""
    dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k"])
    assert capsys.readouterr().out.startswith("[ok] xlstm-125m decode_32k "
                                              "pod256")
    rec = json.loads((dryrun.OUT_DIR / "xlstm-125m_decode_32k_pod256.json")
                     .read_text())
    assert {"status", "n_devices", "grad_accum", "memory", "roofline",
            "wall_s"} <= set(rec)
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert set(rec["memory"]) == {
        "argument_bytes_per_dev", "output_bytes_per_dev",
        "temp_bytes_per_dev", "alias_bytes_per_dev", "peak_estimate_gib"}
    assert {"compute_s", "memory_s", "collective_s", "dominant",
            "roofline_bound_s", "compute_fraction_at_bound",
            "model_flops_per_dev", "useful_flops_ratio", "flops_per_dev",
            "mem_bytes_per_dev", "coll_bytes_per_dev"} <= set(rec["roofline"])
    monkeypatch.setattr(report, "OUT_DIR", dryrun.OUT_DIR)
    assert "| xlstm-125m | decode_32k |" in report.table("pod256")
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "xlstm-125m", "--save-hlo"])
    assert e.value.code == 2
    assert "compiles no HLO" in capsys.readouterr().err
    with pytest.raises(ValueError, match="no HLO"):
        dryrun.run_cell("xlstm-125m", "decode_32k", False, save_hlo=True)


def test_xlstm_prefill_32k_full_size_counts(monkeypatch):
    """xlstm-125m's prefill_32k on pod256 at full size: the sLSTM scan is
    one op a layer on meta, so the cell counts within seconds (it stopped
    at the 900 s budget while the scan looped over S), and its logits are
    the reference's eval_shape: (32, 50432) bf16."""
    import time
    counted = {}
    count = dryrun.count_step
    monkeypatch.setattr(dryrun, "count_step",
                        lambda *a, **k: counted.setdefault("c", count(*a,
                                                                      **k)))
    t0 = time.time()
    rec = dryrun.run_cell("xlstm-125m", "prefill_32k", False)
    assert rec["status"] == "ok", rec.get("error")
    assert time.time() - t0 < 60
    # rank 0's rows of the (32, 50432) logits: 32 over the 16 data ranks
    out = counted["c"]["outputs"]
    assert (out.shape[0] * 16, out.shape[1]) == (32, 50432)
    assert out.dtype == torch.bfloat16
    assert rec["roofline"]["flops_per_dev"] > 0


def test_failed_cell_is_recorded():
    bad = dataclasses.replace(get_arch("internlm2-1.8b").reduced(),
                              train_attn_variant="flash")
    rec = dryrun.run_card_cell("internlm2-1.8b",
                               dryrun.card_shape("train", 32, 2, 1), cfg=bad)
    assert rec["status"] == "error" and "no gradient" in rec["error"]
    assert "traceback" in rec and "wall_s" in rec


def test_cell_over_budget_is_recorded(monkeypatch):
    monkeypatch.setattr(dryrun, "CELL_BUDGET_S", 0.005)
    rec = dryrun.run_card_cell("xlstm-125m",
                               dryrun.card_shape("prefill", 512, 2),
                               cfg=get_arch("xlstm-125m").reduced())
    assert rec["status"] == "error"
    assert rec["error"].startswith("TimeoutError: counting took more than")
    assert json.loads((dryrun.OUT_DIR / "xlstm-125m_prefill_s512_b2_card"
                       ".json").read_text())["status"] == "error"


def test_chip_smoke_dryrun_path_on_cpu(capsys):
    """Path 4l (a) and (c) on the CPU at reduced size: the train step's
    meta FLOPs equal ``FlopCounterMode`` over path 4k's last step on the
    CPU; the prefill cell under ``flash``; an example with its own asserts
    (all six: tests/test_torch_examples.py)."""
    cfg = dataclasses.replace(get_arch("internlm2-1.8b").reduced(),
                              remat=True)
    train = dict(seq=32, batch=8, accum=4, steps=2, lr=3e-3, total_steps=2)
    rec = chip_smoke.train_full(cfg, torch.device("cpu"), **train)
    assert rec["step_flops"] > 0
    pcfg = chip_smoke.lm_config(n_layers=2).reduced()
    out = chip_smoke.dryrun_path(
        torch.device("cpu"), cfg, train, rec, pcfg, 2, 64,
        {"run_ms": 1.0, "max_mem": 0, "base_mem": 0}, cli=None,
        names=("quickstart",))
    lines = capsys.readouterr().out.splitlines()
    for tag in ("dryrun-train", "dryrun-prefill", "dryrun-path"):
        assert sum(x.startswith(f"[{tag}] ") for x in lines) == 1, tag
    assert sum(x.startswith("[example] ") for x in lines) == 1
    assert out["cells"]["prefill"]["roofline"]["flops_per_dev"] > 0
    assert out["examples"]["quickstart"]["figures"]["max_err"] <= 1e-4
