"""The port's optimizer (``repro_torch.optim``) against the JAX package's, on
the CPU: twins of tests/test_optim.py, then AdamW, the schedule and both
gradient compressors held against the reference's on the same inputs
(numpy seeds) at 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.optim import adamw as ref_adamw
from repro.optim import grad_compress as ref_gc
from repro.optim.schedules import cosine_with_warmup as ref_cosine
from repro_torch.optim import grad_compress as gc
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.grad_compress import (compress_int8_ef,
                                             compress_topk_ef,
                                             int8_dequantize, int8_quantize)
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.tree import leaves


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


# ---------------------------------------------------------------------------
# Twins of tests/test_optim.py
# ---------------------------------------------------------------------------

def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = adamw_init(params)
    target = torch.tensor([1.0, 1.0, 1.0])

    def loss(p):
        return torch.sum((p["w"] - target) ** 2)

    for _ in range(300):
        w = params["w"].detach().requires_grad_(True)
        g = torch.autograd.grad(loss({"w": w}), w)[0]
        params, opt, _ = adamw_update(params, {"w": g}, opt, lr=0.05,
                                      weight_decay=0.0)
    assert float(loss(params)) < 1e-2


def test_grad_clip_norm():
    params = {"w": torch.zeros(4)}
    opt = adamw_init(params)
    g = {"w": torch.full((4,), 100.0)}
    _, _, gnorm = adamw_update(params, g, opt, lr=0.0, grad_clip_norm=1.0)
    assert float(gnorm) == pytest.approx(200.0, rel=1e-4)


def test_schedule_warmup_then_decay():
    lr0 = float(cosine_with_warmup(0, peak_lr=1.0, warmup_steps=10,
                                   total_steps=100))
    lr_peak = float(cosine_with_warmup(10, peak_lr=1.0, warmup_steps=10,
                                       total_steps=100))
    lr_end = float(cosine_with_warmup(100, peak_lr=1.0, warmup_steps=10,
                                      total_steps=100))
    assert lr0 == 0.0 and lr_peak == pytest.approx(1.0) and \
        lr_end == pytest.approx(0.1, rel=1e-3)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_int8_quantize_bounded_error(seed):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    q, s = int8_quantize(g)
    err = torch.abs(int8_dequantize(q, s) - g).max()
    assert float(err) <= float(s) * 0.5 + 1e-6


def test_error_feedback_accumulates():
    """EF property: over repeated identical grads, the quantized stream's
    mean converges to the true gradient (no bias)."""
    g = {"w": torch.from_numpy(np.linspace(-0.01, 0.01, 32)
                               .astype(np.float32))}
    err = None
    acc = torch.zeros(32)
    for _ in range(64):
        q, s, err = compress_int8_ef(g, err)
        acc = acc + int8_dequantize(q["w"], s["w"])
    mean = acc / 64
    assert float(torch.abs(mean - g["w"]).max()) < 2e-3


def test_topk_roundtrip_and_ef():
    g = {"w": torch.from_numpy(np.random.default_rng(0)
                               .standard_normal(128).astype(np.float32))}
    sparse, err, dense = compress_topk_ef(g, None, k_frac=0.1)
    v, i = sparse["w"]
    assert v.shape[0] == 12  # 10% of 128
    # densified top-k + error == original
    total = dense["w"] + err["w"]
    assert np.allclose(total.numpy(), g["w"].numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# Against the reference, on the same inputs
# ---------------------------------------------------------------------------

def _tree(seed):
    """A params-like tree (dicts and a list, as the port's blocks) and its
    reference twin (the list as a dict of its entries would reorder leaves,
    so both sides use the same nesting: jax flattens lists in order)."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (12, 8), "blocks": [{"wq": (8, 8), "ln": (8,)},
                                           {"wq": (8, 8), "ln": (8,)}],
              "final_norm": (8,)}

    def draw(x):
        if isinstance(x, dict):
            return {k: draw(v) for k, v in x.items()}
        if isinstance(x, list):
            return [draw(v) for v in x]
        return rng.standard_normal(x).astype(np.float32)
    return draw(shapes)


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, fn) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_update_matches_reference(clip):
    params, g1, g2 = _tree(0), _tree(1), _tree(2)
    g1 = _to(g1, lambda a: a * 3)           # a norm above the clip
    rp = _to(params, jnp.asarray)
    ropt = ref_adamw.adamw_init(rp)
    tp = _to(params, lambda a: torch.from_numpy(a.copy()))
    topt = adamw_init(tp)
    for step, g in enumerate((g1, g2)):
        lr = 1e-2 * (step + 1)
        rp, ropt, rn = ref_adamw.adamw_update(
            rp, _to(g, jnp.asarray), ropt, lr=lr, grad_clip_norm=clip)
        tp, topt, tn = adamw_update(
            tp, _to(g, torch.from_numpy), topt, lr=lr, grad_clip_norm=clip)
        np.testing.assert_allclose(_np(tn), np.asarray(rn), rtol=1e-6,
                                   atol=1e-6)
        for want, got in zip(jax.tree.leaves((rp, ropt.mu, ropt.nu)),
                             leaves((tp, topt.mu, topt.nu))):
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
        assert int(topt.step) == int(ropt.step) == step + 1
        assert topt.step.dtype == torch.int32


def test_adamw_state_and_lr_tensor_on_the_params_device():
    p = {"a": torch.ones(3, dtype=torch.bfloat16)}
    opt = adamw_init(p)
    assert opt.mu["a"].dtype == torch.float32 and opt.step.shape == ()
    lr = cosine_with_warmup(opt.step + 1, peak_lr=1e-3, warmup_steps=2,
                            total_steps=10)
    p2, opt2, _ = adamw_update(p, {"a": torch.ones(3, dtype=torch.bfloat16)},
                               opt, lr=lr)
    assert p2["a"] is p["a"] and p2["a"].dtype == torch.bfloat16
    assert opt2.mu["a"] is opt.mu["a"] and int(opt2.step) == 1


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 5), (200, 10000),
                                          (7, 7)])
def test_schedule_matches_reference(warmup, total):
    steps = np.arange(0, total + 3)
    want = np.array([float(ref_cosine(int(s), peak_lr=3e-4,
                                      warmup_steps=warmup,
                                      total_steps=total)) for s in steps])
    got = cosine_with_warmup(torch.from_numpy(steps.astype(np.int32)),
                             peak_lr=3e-4, warmup_steps=warmup,
                             total_steps=total)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)
    assert float(cosine_with_warmup(3, peak_lr=3e-4, warmup_steps=warmup,
                                    total_steps=total)) == pytest.approx(
        want[3], rel=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_compressor_matches_reference(seed):
    g = _tree(seed)
    e = _to(_tree(seed + 10), lambda a: a * 0.01)
    rq, rs, re = ref_gc.compress_int8_ef(_to(g, jnp.asarray),
                                         _to(e, jnp.asarray))
    tq, ts, te = compress_int8_ef(_to(g, torch.from_numpy),
                                  _to(e, torch.from_numpy))
    for want, got in zip(jax.tree.leaves(rq), leaves(tq)):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    for want, got in zip(jax.tree.leaves((rs, re)), leaves((ts, te))):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    # no error state yet: the reference starts from zeros too
    rq0, _, _ = ref_gc.compress_int8_ef(_to(g, jnp.asarray), None)
    tq0, _, _ = compress_int8_ef(_to(g, torch.from_numpy), None)
    for want, got in zip(jax.tree.leaves(rq0), leaves(tq0)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_int8_rounds_half_to_even_as_reference():
    g = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    rq, rs = ref_gc.int8_quantize(jnp.asarray(g))
    tq, ts = int8_quantize(torch.from_numpy(g))
    np.testing.assert_array_equal(_np(tq), np.asarray(rq))


@pytest.mark.parametrize("seed,k_frac", [(0, 0.1), (1, 0.01), (2, 0.5)])
def test_topk_compressor_matches_reference(seed, k_frac):
    g = _tree(seed)              # continuous values: no ties in |g|
    e = _to(_tree(seed + 10), lambda a: a * 0.01)
    (rs, re, rd) = ref_gc.compress_topk_ef(_to(g, jnp.asarray),
                                           _to(e, jnp.asarray), k_frac)
    (ts, te, td) = compress_topk_ef(_to(g, torch.from_numpy),
                                    _to(e, torch.from_numpy), k_frac)
    for want, got in zip(jax.tree.leaves(rs), leaves(ts)):
        np.testing.assert_array_equal(_np(got).astype(np.int64)
                                      if got.dtype == torch.int64
                                      else _np(got),
                                      np.asarray(want).astype(_np(got).dtype))
    for want, got in zip(jax.tree.leaves((re, rd)), leaves((te, td))):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    v, i, shp = gc.topk_sparsify(torch.from_numpy(g["embed"]), k_frac)
    rv, ri, rshp = ref_gc.topk_sparsify(jnp.asarray(g["embed"]), k_frac)
    assert shp == tuple(rshp)
    np.testing.assert_array_equal(_np(i), np.asarray(ri))
    np.testing.assert_array_equal(
        _np(gc.topk_densify(v, i, shp)),
        np.asarray(ref_gc.topk_densify(rv, ri, rshp)))
