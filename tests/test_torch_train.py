"""The port's training stack against the JAX package's, on the CPU: one
``make_train_step`` step for each reduced dense architecture in f32 on
the reference's weights (loss, gnorm, every gradient leaf of a
microbatch, the first moments and the new parameters; the other families
are tests/test_torch_train_families.py's), the ``flash`` variant refused
as the reference's ``jax.grad`` refuses it, the active ``ShardCtx``, and
the ``Trainer`` (a twin of tests/test_system.py's training test, and the
reference's double save).

The reference's step is jitted on its one-device smoke mesh, as its
``Trainer`` runs it. The planner, the pipeline and the mesh step are
tests/test_torch_planner.py's and tests/test_torch_train_mesh.py's."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
from repro.configs.base import ArchConfig as RArchConfig
from repro.configs.base import ShapeConfig as RShapeConfig
from repro.launch import steps as rsteps
from repro.launch.mesh import make_smoke_mesh as r_smoke_mesh
from repro.models.model import LM as RLM
from repro.optim.adamw import adamw_init as r_adamw_init
from repro_torch.configs import ArchConfig, ShapeConfig, all_archs, get_arch
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import LM, ShardCtx
from repro_torch.models.convert import lm_params_from_reference
from repro_torch.optim import adamw_init
from repro_torch.tree import leaves, unflatten

ARCHS = sorted(all_archs())
# the step test is split across two files, so parallel test workers share it:
# the dense stacks here, the other families in
# tests/test_torch_train_families.py
DENSE = ("internlm2-1.8b", "llama3-8b", "llava-next-34b", "qwen3-14b",
         "starcoder2-15b")
B, S, ACCUM = 4, 16, 2
PEAK_LR, TOTAL = 1e-2, 10          # warmup 1: the first step takes the peak


def _configs(arch, **over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(get_arch(arch).reduced(), **over),
            dataclasses.replace(rcfg.get_arch(arch).reduced(), **over))


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    fe = None
    if cfg.frontend != "none":
        fe = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)
                                 ).astype(np.float32)
    return tok, fe


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else \
        float(np.abs(got).max(initial=0.0))


def _port_tree(ref_tree, cfg):
    return lm_params_from_reference(jax.tree.map(np.asarray, ref_tree), cfg,
                                    "cpu")


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's step on its smoke mesh (one jit, as its ``Trainer``
    runs it): the weights, the new parameters, the first moments and the
    metrics (numpy)."""
    _, rc = _configs(arch)
    mesh = r_smoke_mesh()
    shape = RShapeConfig("t", "train", seq_len=S, global_batch=B,
                         grad_accum=ACCUM)
    tok, fe = _batch(rc)
    with mesh:
        lm = rsteps.build_lm(rc, mesh)
        fn, accum = rsteps.make_train_step(lm, shape, mesh, peak_lr=PEAK_LR,
                                           total_steps=TOTAL)
        params = jax.jit(lm.init_params)(jax.random.PRNGKey(0))
        args = [params, r_adamw_init(params), jnp.asarray(tok)]
        if fe is not None:
            args.append(jnp.asarray(fe))
        new_p, new_opt, m = jax.jit(fn)(*args)
    host = functools.partial(jax.tree.map, np.asarray)
    return {"params": host(params), "new_p": host(new_p),
            "mu": host(new_opt.mu),
            "metrics": {k: float(v) for k, v in m.items()}, "accum": accum}


def _port_step(arch, cfg=None, params=None):
    cfg = cfg or _configs(arch)[0]
    ref = _reference(arch)
    mesh = make_smoke_mesh("cpu")
    shape = ShapeConfig("t", "train", seq_len=S, global_batch=B,
                        grad_accum=ACCUM)
    lm = steps.build_lm(cfg, mesh)
    fn, accum = steps.make_train_step(lm, shape, mesh, peak_lr=PEAK_LR,
                                      total_steps=TOTAL)
    p = params if params is not None else _port_tree(ref["params"], cfg)
    tok, fe = _batch(cfg)
    return fn, accum, p, _t(tok), _t(fe)


def check_train_step(arch):
    """One reduced architecture's step against the reference's. Loss and
    gnorm at 1e-5; each leaf of the mean gradient over the microbatches
    (from the port's ``loss_and_grads``; the reference's recovered from its
    first moment, mu = (1 - b1) * clip * g, exact to f32 rounding) and
    each first moment at a relative Frobenius error <= 1e-4; the new
    parameters within 4 lr (AdamW's first step is near lr * sign(g), so a
    coordinate whose gradient is near 0 may move either way)."""
    cfg, _ = _configs(arch)
    ref = _reference(arch)
    fn, accum, p, tok, fe = _port_step(arch)
    assert accum == ref["accum"] == ACCUM
    mb = B // accum
    losses, gsum = [], None
    for a in range(accum):
        loss, g = fn.loss_and_grads(p, tok[a * mb:(a + 1) * mb],
                                    None if fe is None
                                    else fe[a * mb:(a + 1) * mb])
        losses.append(float(loss))
        gsum = leaves(g) if gsum is None else [
            x + y for x, y in zip(gsum, leaves(g))]
    gnorm = ref["metrics"]["gnorm"]
    want_g = leaves(_port_tree(jax.tree.map(
        lambda m: (m / (0.1 * min(1.0, 1.0 / (gnorm + 1e-9)))).astype(
            np.float32), ref["mu"]), cfg))
    assert np.mean(losses) == pytest.approx(ref["metrics"]["loss"], rel=1e-5)
    for got, want in zip(gsum, want_g):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _rel(got / accum, want) <= 1e-4, arch
    new_p, new_opt, m = fn(p, adamw_init(p), tok, fe)
    for k in ("loss", "gnorm", "lr"):
        assert float(m[k]) == pytest.approx(ref["metrics"][k], rel=1e-5), k
    assert float(m["lr"]) == pytest.approx(PEAK_LR, rel=1e-6)
    for got, want in zip(leaves(new_opt.mu),
                         leaves(_port_tree(ref["mu"], cfg))):
        assert _rel(got, want) <= 1e-4, arch
    for got, want in zip(leaves(new_p), leaves(_port_tree(ref["new_p"],
                                                          cfg))):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=4 * PEAK_LR)
    assert int(new_opt.step) == 1


@pytest.mark.parametrize("arch", DENSE)
def test_train_step_matches_reference(arch):
    check_train_step(arch)


def test_flash_is_refused_under_autograd_as_the_reference_refuses_it():
    """The reference's Pallas kernel has no gradient: ``jax.grad`` of
    ``LM.loss(..., variant="flash")`` raises. The port's wrapper raises
    under autograd on the CPU too (its plain version, called directly,
    stays differentiable), and a train step for a ``flash`` config raises
    before its first step."""
    over = dict(name="fl", family="dense", n_layers=1, d_model=32,
                n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64, head_dim=16,
                remat=False, dtype="float32")
    rlm = RLM(RArchConfig(**over))
    rp = rlm.init_params(jax.random.PRNGKey(0))
    tok = jnp.zeros((1, 16), jnp.int32)
    with pytest.raises(Exception):
        jax.grad(lambda p: rlm.loss(p, tok, variant="flash"))(rp)

    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k, v = torch.randn(1, 8, 1, 16), torch.randn(1, 8, 1, 16)
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention(q, k, v)
    with torch.no_grad():
        assert torch.equal(flash_attention(q, k, v),
                           flash_attention_plain(q, k, v))
    with torch.inference_mode():
        flash_attention(q.detach(), k, v)
    flash_attention_plain(q, k, v).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()

    cfg = ArchConfig(**dict(over, train_attn_variant="flash"))
    lm = LM(cfg)
    p = lm.init_params(torch.Generator().manual_seed(0), "cpu")
    mesh = make_smoke_mesh("cpu")
    shape = ShapeConfig("t", "train", seq_len=16, global_batch=2)
    with pytest.raises(RuntimeError, match="no gradient"):
        steps.make_train_step(steps.build_lm(cfg, mesh), shape, mesh)
    # the plain loss through the wrapper under autograd raises too
    flat = [x.detach().requires_grad_(True) for x in leaves(p)]
    with pytest.raises(RuntimeError, match="no gradient"):
        lm.loss(unflatten(p, flat), torch.zeros((1, 16), dtype=torch.int32),
                variant="flash")


def test_shard_ctx_of_a_mesh_is_a_layout_hint():
    """make_ctx's context is active on every mesh, the one-piece smoke
    mesh included, as the reference's: a constraint changes no value (the
    same tensor comes back), checks its rank and axes as JAX does, and
    accepts a dim that does not divide by its axes' size (JAX pads)."""
    ctx = steps.make_ctx(make_smoke_mesh("cpu"))
    rctx = rsteps.make_ctx(r_smoke_mesh())
    assert (ctx.batch, ctx.model, ctx.seq, ctx.active, ctx.dp) == (
        rctx.batch, rctx.model, rctx.seq, rctx.active, rctx.dp)
    x = torch.ones(3, 5, 7)
    assert ctx.cs(x, "batch", None, "model") is x
    assert ctx.spec("batch", None, "model") == ("data", None, "model")
    with pytest.raises(ValueError, match="rank"):
        ctx.cs(x, "batch", None)
    odd = ShardCtx(batch=("data",), model="nope", active=True,
                   axis_names=("data", "model"))
    with pytest.raises(ValueError, match="not found"):
        odd.cs(x, "batch", None, "model")


def test_training_learns_and_checkpoints(tmp_path):
    """The twin of tests/test_system.py's test on the CPU."""
    from repro_torch.launch.train import Trainer
    cfg = ArchConfig(name="sys-dense", family="dense", n_layers=2,
                     d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                     vocab_size=512, head_dim=16, remat=False,
                     dtype="float32")
    shape = ShapeConfig("t", "train", seq_len=64, global_batch=8)
    tr = Trainer(cfg, shape, ckpt_dir=str(tmp_path), ckpt_every=20,
                 total_steps=60, peak_lr=5e-3, device="cpu")
    tr.run(60)
    losses = [m["loss"] for m in tr.metrics_log]
    # learns the structured corpus: best tail loss clearly below the head
    assert min(losses[30:]) < losses[0] - 0.03, (losses[0], min(losses[30:]))
    assert tr.ckpt.latest_step() is not None

    # restart from checkpoint reproduces the same forward batch sequence
    tr2 = Trainer(cfg, shape, ckpt_dir=str(tmp_path), ckpt_every=20,
                  total_steps=60, peak_lr=5e-3, device="cpu")
    assert tr2.step == 60                   # resumed
    b1 = next(tr.pipeline)
    b2 = next(tr2.pipeline)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    for a, b in zip(leaves((tr.params, tr.opt)), leaves((tr2.params,
                                                         tr2.opt))):
        assert torch.equal(a, b)
    tr.pipeline.close()
    tr2.pipeline.close()


def test_trainer_saves_a_step_once_where_the_reference_saves_it_twice(
        tmp_path):
    """The reference's ``Trainer.run`` saves a step on the checkpoint
    interval again at its end; the second write fails on the committed
    directory and the next save raises (ROADMAP Queue 3 record 5). The
    port's saves each step once, so a second ``run`` goes on."""
    from repro.launch.train import Trainer as RTrainer
    from repro_torch.launch.train import Trainer
    kw = dict(name="sys-dense", family="dense", n_layers=1, d_model=32,
              n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=128, head_dim=16,
              remat=False, dtype="float32")
    ref = RTrainer(RArchConfig(**kw), RShapeConfig("t", "train", seq_len=16,
                                                   global_batch=2),
                   ckpt_dir=str(tmp_path / "ref"), ckpt_every=2)
    ref.run(2)
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        ref.run(4)
    ref.pipeline.close()
    tr = Trainer(ArchConfig(**kw), ShapeConfig("t", "train", seq_len=16,
                                               global_batch=2),
                 ckpt_dir=str(tmp_path / "port"), ckpt_every=2, device="cpu")
    tr.run(2)
    tr.run(4)
    assert tr.ckpt.latest_step() == 4 and tr.step == 4
    tr.pipeline.close()
