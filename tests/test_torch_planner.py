"""The port's parameter planner and data pipeline against the JAX package's,
on the CPU.

Planner: ``params_pspecs``, ``opt_pspecs`` and ``cache_pspecs`` for all ten
architectures, reduced and full, on the (1, 1), (4, 2), (16, 16) and
(2, 16, 16) meshes, entry for entry. The reference's specs are computed on
a stand-in mesh (axis names and a device grid of the mesh's shape: all its
planner reads); full sizes come from the reference's ``jax.eval_shape``
shapes, carried into the port's tree by the weight converter as ``meta``
tensors (no memory). The reference stacks each group's layers on leading
axes that no rule shards; the port's leaf is the stacked leaf without
them, and its spec the reference's without their ``None`` entries.

Pipeline: twins of tests/test_runtime.py's two cases, and batches equal to
the reference's bit for bit for several (seed, step, shard)."""
import types

import jax
import numpy as np
import pytest
import torch

import repro.configs as rcfg
from repro.data import pipeline as rpipe
from repro.distributed import planner as rplanner
from repro.models.model import LM as RLM
from repro.optim.adamw import adamw_init as r_adamw_init
from repro_torch.configs import all_archs, get_arch
from repro_torch.data.pipeline import DataConfig, Pipeline, TokenSource
from repro_torch.distributed import planner
from repro_torch.distributed.mesh import Mesh
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.models import LM
from repro_torch.models import convert
from repro_torch.optim import adamw_init
from repro_torch.runtime.elastic import reshard_state
from repro_torch.tree import leaves, leaves_with_path

ARCHS = sorted(all_archs())
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(label):
    """(the port's layout mesh, the reference's stand-in)."""
    shape, axes = MESHES[label]
    if label == "16x16":
        port = make_production_mesh()
    elif label == "2x16x16":
        port = make_production_mesh(multi_pod=True)
    else:
        port = Mesh(axes, shape, None, torch.device("meta"), 0, {})
    ref = types.SimpleNamespace(axis_names=axes,
                                devices=np.empty(shape, dtype=object))
    return port, ref


def _meta_port_tree(ref_abstract, cfg):
    """The reference's abstract tree as the port's tree of ``meta``
    tensors, through the weight converter (its structure mapping)."""
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32),
                                                   s.shape), ref_abstract)
    orig = convert._tensor
    convert._tensor = lambda x, device, dtype=None: torch.empty(
        np.shape(x), device="meta")
    try:
        return convert.lm_params_from_reference(zeros, cfg, "meta")
    finally:
        convert._tensor = orig


def _check_tree(port_specs, port_tree, ref_specs):
    """Each port leaf's spec against its reference leaf's (the path without
    list indices), the reference's leading stacked dims unsharded."""
    ref_by_path = {}
    for path, sp in jax.tree_util.tree_flatten_with_path(
            ref_specs, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                    PartitionSpec))[0]:
        key = tuple(str(p.key) if hasattr(p, "key") else str(p.name)
                    for p in path)
        ref_by_path[key] = tuple(sp)
    got = leaves_with_path(port_specs, is_leaf=planner.is_spec)
    shapes = dict(leaves_with_path(port_tree))
    assert len(got) == len(shapes)
    n = 0
    for path, sp in got:
        want = ref_by_path[tuple(p for p in path if isinstance(p, str))]
        k = len(want) - len(sp)
        assert k >= 0 and want[:k] == (None,) * k, (path, want, sp)
        assert sp == want[k:], (path, want, sp)
        assert len(sp) == len(shapes[path].shape)
        n += 1
    return n


def _both(arch, full):
    cfg, rc = get_arch(arch), rcfg.get_arch(arch)
    if not full:
        cfg, rc = cfg.reduced(), rc.reduced()
    rlm = RLM(rc)
    abstract = rlm.abstract_params()
    return cfg, rc, rlm, abstract, _meta_port_tree(abstract, cfg)


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(arch, full):
    cfg, rc, rlm, abstract, port = _both(arch, full)
    opt_abs = jax.eval_shape(r_adamw_init, abstract)
    port_opt = adamw_init(port)
    for label in MESHES:
        pm, rm = _meshes(label)
        for serve in (False, True):
            n = _check_tree(planner.params_pspecs(port, pm, serve=serve),
                            port, rplanner.params_pspecs(abstract, rm,
                                                         serve=serve))
            assert n == len(leaves(port))
        ro = rplanner.opt_pspecs(opt_abs, abstract, rm)
        po = planner.opt_pspecs(port_opt, port, pm)
        assert po.step == tuple(ro.step) == ()
        _check_tree(po.mu, port, ro.mu)
        _check_tree(po.nu, port, ro.nu)
        for b in (1, 3, 8, 256, 512):
            assert planner.batch_pspec(pm, b) == tuple(
                rplanner.batch_pspec(rm, b))
            assert planner.frontend_pspec(pm, b) == tuple(
                rplanner.frontend_pspec(rm, b))


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, full):
    cfg, rc, rlm, _, _ = _both(arch, full)
    lm = LM(cfg)
    src = cfg.frontend_tokens if cfg.is_encdec else 0
    cases = ([(128, 32768, 0), (1, 524288, 8192), (8, 64, 0)] if full
             else [(8, 64, 0), (1, 64, 16), (3, 32, 0)])
    for batch, ctx, window in cases:
        ref_cache = jax.eval_shape(lambda: rlm.init_cache(
            batch, ctx, window=window, src_len=src))
        cache = lm.init_cache(batch, ctx, window=window, src_len=src,
                              device="meta")
        assert {k: tuple(v.shape) for k, v in cache.items()} == {
            k: tuple(v.shape) for k, v in ref_cache.items()}
        for label in MESHES:
            pm, rm = _meshes(label)
            got = planner.cache_pspecs(cache, pm, batch)
            want = rplanner.cache_pspecs(ref_cache, rm, batch)
            assert set(got) == set(want)
            for key in want:
                assert got[key] == tuple(want[key]), (key, label, batch)


def test_place_and_gather_on_one_rank_and_reshard():
    """On a one-piece mesh every block is the whole leaf: ``place`` keeps
    the tensors, ``gather`` returns them, and ``reshard_state`` places a
    host state (numpy arrays) on the mesh's device with fresh specs."""
    cfg = get_arch("llama3-8b").reduced()
    lm = LM(cfg)
    p = lm.init_params(torch.Generator().manual_seed(0), "cpu")
    mesh = make_smoke_mesh("cpu")
    specs = planner.params_pspecs(p, mesh)
    placed = planner.place(p, specs, mesh)
    assert all(a is b for a, b in zip(leaves(placed), leaves(p)))
    assert planner.gather(placed, specs, mesh) is placed
    sh = planner.shardings_from(specs, mesh)
    assert all(x[s.block(x.shape)].shape == x.shape
               for s, x in zip(leaves(sh, is_leaf=lambda x: isinstance(
                   x, planner.Sharding)), leaves(p)))
    opt = adamw_init(p)
    host = {"params": [x.numpy() for x in leaves(p)], "step": 3,
            "opt": type(opt)(np.int32(1), [np.ones(x.shape, np.float32)
                                           for x in leaves(p)],
                             [np.zeros(x.shape, np.float32)
                              for x in leaves(p)])}
    out = reshard_state(host, leaves(p), mesh)
    assert out["step"] == 3
    assert all(torch.is_tensor(x) and torch.equal(x, y)
               for x, y in zip(out["params"], leaves(p)))
    assert int(out["opt"].step) == 1
    assert all(torch.equal(m, torch.ones_like(x))
               for m, x in zip(out["opt"].mu, leaves(p)))


def test_production_meshes_are_layouts():
    m = make_production_mesh()
    assert (m.axis_names, m.shape, m.size) == (("data", "model"), (16, 16),
                                               256)
    m2 = make_production_mesh(multi_pod=True)
    assert (m2.axis_names, m2.shape) == (("pod", "data", "model"),
                                         (2, 16, 16))
    assert m.device.type == "meta" and not torch.distributed.is_initialized()
    s = make_smoke_mesh("cpu")
    assert (s.axis_names, s.shape, s.size) == (("data", "model"), (1, 1), 1)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

def test_pipeline_deterministic_and_resumable():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=3)
    p1 = Pipeline(cfg)
    batches = [next(p1) for _ in range(5)]
    cursor = p1.cursor()
    later = [next(p1) for _ in range(3)]
    p1.close()

    p2 = Pipeline(cfg)
    p2.restore(cursor)
    replay = [next(p2) for _ in range(3)]
    p2.close()
    for a, b in zip(later, replay):
        assert np.array_equal(a["tokens"], b["tokens"])
    # pure-function property: batch_at is reproducible
    src = TokenSource(cfg)
    assert np.array_equal(src.batch_at(2)["tokens"], batches[2]["tokens"])


def test_pipeline_shards_disjoint_rngs():
    cfg = DataConfig(vocab_size=1000, seq_len=32, global_batch=8, seed=1)
    src = TokenSource(cfg)
    b0 = src.batch_at(0, shard=0, n_shards=2)["tokens"]
    b1 = src.batch_at(0, shard=1, n_shards=2)["tokens"]
    assert b0.shape == (4, 32)
    assert not np.array_equal(b0, b1)


@pytest.mark.parametrize("seed,step,shard,n_shards,frontend", [
    (0, 0, 0, 1, 0), (0, 7, 0, 1, 0), (3, 2, 1, 2, 0), (5, 11, 3, 4, 0),
    (1, 4, 0, 2, 8), (92544, 1, 1, 4, 4)])
def test_batches_equal_reference_bit_for_bit(seed, step, shard, n_shards,
                                             frontend):
    kw = dict(vocab_size=92544, seq_len=64, global_batch=8, seed=seed,
              frontend_tokens=frontend, d_model=16)
    got = TokenSource(DataConfig(**kw)).batch_at(step, shard, n_shards)
    want = rpipe.TokenSource(rpipe.DataConfig(**kw)).batch_at(step, shard,
                                                              n_shards)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    # the prefetching pipeline serves the same batches, and a cursor
    # restored into the reference's pipeline replays the port's sequence
    p = Pipeline(DataConfig(**kw), shard=shard, n_shards=n_shards,
                 start_step=step)
    first = next(p)
    np.testing.assert_array_equal(first["tokens"], want["tokens"])
    cur = p.cursor()
    nxt = next(p)
    p.close()
    r = rpipe.Pipeline(rpipe.DataConfig(**kw), shard=shard,
                       n_shards=n_shards)
    r.restore(cur)
    np.testing.assert_array_equal(next(r)["tokens"], nxt["tokens"])
    r.close()
