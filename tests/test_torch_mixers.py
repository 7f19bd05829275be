"""The port's sequence mixers and expert layer against the JAX package's on
the same inputs: ``gla_chunked`` (with ``init_state``; S not a chunk
multiple through ``ssm_apply``) and ``gla_decode_step``, the SSM, mLSTM and
sLSTM blocks, at 1e-4 in f32 and with the reference's dtypes in bf16; and
``moe_apply`` at ``capacity_factor=1.0``, where tokens drop: equal to the
reference in output and ``aux``, and the same bits twice."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gla as RG
from repro.models import moe as RMOE
from repro.models import ssm as RSSM
from repro.models import xlstm as RXL
from repro_torch.models import gla as G
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL

TOL = dict(atol=1e-4, rtol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a, dtype="float32"):
    """(jax array, torch tensor) of one numpy array in ``dtype``."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(np.array(a)).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _params(tree, dtype=None):
    """A reference parameter tree as the port's tensors, each leaf keeping
    its dtype unless ``dtype`` is given."""
    out = {}
    for k, v in tree.items():
        t = torch.from_numpy(np.array(v, np.float32))
        out[k] = t.to(dtype or {"float32": torch.float32,
                                "bfloat16": torch.bfloat16}[str(v.dtype)])
    return out


def _gla_inputs(seed, B, S, H, P, N, shared_kq):
    rng = _rng(seed)
    kq = (B, S, N) if shared_kq else (B, S, H, N)
    return dict(xv=_normal(rng, B, S, H, P),
                log_decay=-np.abs(_normal(rng, B, S, H, scale=0.3)),
                scale=np.abs(_normal(rng, B, S, H)),
                K=_normal(rng, *kq, scale=0.5), Q=_normal(rng, *kq, scale=0.5))


# ---------------------------------------------------------------------------
# gla
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("init", [False, True], ids=["zero", "init_state"])
@pytest.mark.parametrize("shared_kq", [False, True], ids=["per_head", "shared"])
@pytest.mark.parametrize("S,chunk", [(32, 8), (24, 24), (40, 8)])
def test_gla_chunked_matches_reference(S, chunk, shared_kq, init):
    B, H, P, N = 2, 3, 5, 4
    inp = _gla_inputs(S + chunk, B, S, H, P, N, shared_kq)
    h0 = _normal(_rng(9), B, H, N, P) if init else None
    want, wh = RG.gla_chunked(*(jnp.asarray(v) for v in inp.values()),
                              chunk=chunk,
                              init_state=None if h0 is None
                              else jnp.asarray(h0))
    got, gh = G.gla_chunked(*(torch.from_numpy(v) for v in inp.values()),
                            chunk=chunk,
                            init_state=None if h0 is None
                            else torch.from_numpy(h0))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(gh), _np(wh), **TOL)


def test_gla_chunked_needs_a_chunk_multiple():
    inp = _gla_inputs(0, 1, 10, 2, 3, 4, False)
    with pytest.raises(ValueError, match="multiple"):
        G.gla_chunked(*(torch.from_numpy(v) for v in inp.values()), chunk=8)


def test_gla_chunked_bf16_keeps_the_reference_casts():
    """bf16 values: the output and state stay bf16 and follow the
    reference's rounding (cum in f32, the decay matrices cast to bf16)."""
    inp = _gla_inputs(3, 2, 32, 3, 5, 4, False)
    j, t = zip(*(_both(v, "bfloat16") for v in inp.values()))
    # the gates as the models give them: float32
    j = (j[0], jnp.asarray(inp["log_decay"]), jnp.asarray(inp["scale"])) \
        + j[3:]
    t = (t[0], torch.from_numpy(inp["log_decay"]),
         torch.from_numpy(inp["scale"])) + t[3:]
    want, wh = RG.gla_chunked(*j, chunk=8)
    got, gh = G.gla_chunked(*t, chunk=8)
    assert got.dtype == gh.dtype == torch.bfloat16
    assert str(want.dtype) == str(wh.dtype) == "bfloat16"
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(_np(gh), _np(wh), atol=3e-2, rtol=3e-2)


def test_gla_chunked_gradient_is_finite_where_the_gate_sum_overflows():
    """A chunk whose gates sum below -88 overflows exp above the diagonal.
    The reference masks after exp, so its jax.grad is NaN there; the port
    masks before exp: its forward equals the reference's and its gradient
    equals that of the step-by-step recurrence (``gla_decode_step``)."""
    B, S, H, P, N, chunk = 1, 16, 2, 3, 4, 16
    inp = _gla_inputs(21, B, S, H, P, N, False)
    inp["log_decay"] = inp["log_decay"] - 8.0     # 15 steps: about -125
    jin = [jnp.asarray(v) for v in inp.values()]

    def jloss(g):
        return jnp.sum(RG.gla_chunked(jin[0], g, *jin[2:], chunk=chunk)[0])
    assert np.isnan(np.asarray(jax.grad(jloss)(jin[1]))).any()
    tin = [torch.from_numpy(v) for v in inp.values()]
    g = tin[1].clone().requires_grad_()
    y, _ = G.gla_chunked(tin[0], g, *tin[2:], chunk=chunk)
    want_y, _ = RG.gla_chunked(*jin, chunk=chunk)
    np.testing.assert_allclose(_np(y.detach()), _np(want_y), **TOL)
    (got,) = torch.autograd.grad(y.sum(), g)
    g2 = tin[1].clone().requires_grad_()
    h = torch.zeros((B, H, N, P))
    steps = []
    for t in range(S):
        yt, h = G.gla_decode_step(h, tin[0][:, t], g2[:, t], tin[2][:, t],
                                  tin[3][:, t], tin[4][:, t])
        steps.append(yt)
    (want,) = torch.autograd.grad(torch.stack(steps, 1).sum(), g2)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared_kq", [False, True], ids=["per_head", "shared"])
def test_gla_decode_step_matches_reference(shared_kq, dtype):
    rng = _rng(4)
    B, H, P, N = 3, 2, 5, 4
    kq = (B, N) if shared_kq else (B, H, N)
    h, xv, K, Q = (_normal(rng, B, H, N, P), _normal(rng, B, H, P),
                   _normal(rng, *kq), _normal(rng, *kq))
    g, s = -np.abs(_normal(rng, B, H)), np.abs(_normal(rng, B, H))
    (jh, th), (jx, tx), (jk, tk), (jq, tq) = (
        _both(a, dtype) for a in (h, xv, K, Q))
    want = RG.gla_decode_step(jh, jx, jnp.asarray(g), jnp.asarray(s), jk, jq)
    got = G.gla_decode_step(th, tx, torch.from_numpy(g), torch.from_numpy(s),
                            tk, tq)
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    for a, b in zip(got, want):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_allclose(_np(a), _np(b), **tol)


def test_gla_decode_steps_equal_the_chunked_form():
    """The recurrence one step at a time from ``init_state`` gives the
    chunked form's outputs and final state."""
    B, S, H, P, N = 2, 16, 3, 5, 4
    inp = {k: torch.from_numpy(v) for k, v in
           _gla_inputs(5, B, S, H, P, N, False).items()}
    h0 = torch.from_numpy(_normal(_rng(6), B, H, N, P))
    y, hS = G.gla_chunked(*inp.values(), chunk=4, init_state=h0)
    h = h0
    for t in range(S):
        yt, h = G.gla_decode_step(h, inp["xv"][:, t], inp["log_decay"][:, t],
                                  inp["scale"][:, t], inp["K"][:, t],
                                  inp["Q"][:, t])
        torch.testing.assert_close(yt, y[:, t], **TOL)
    torch.testing.assert_close(h, hS, **TOL)


# ---------------------------------------------------------------------------
# ssm
# ---------------------------------------------------------------------------

SSM_KW = dict(state=8, expand=2, head_dim=16)


def _ssm_params(d=32, dtype=jnp.float32):
    rp = RSSM.ssm_init(jax.random.PRNGKey(1), d, dtype=dtype, **SSM_KW)
    # A_log and D away from their init so the gates and skip are tested
    rp["A_log"] = jnp.linspace(-1.0, 0.5, rp["A_log"].shape[0])
    rp["D"] = jnp.linspace(0.5, 1.5, rp["D"].shape[0])
    return rp


def test_ssm_dims_init_and_state_shape():
    assert SSM.ssm_dims(32, 2, 16) == RSSM.ssm_dims(32, 2, 16) == (64, 4)
    assert SSM.ssm_state_shape(3, 32, **SSM_KW) == RSSM.ssm_state_shape(
        3, 32, **SSM_KW) == (3, 4, 8, 16)
    got = SSM.ssm_init(torch.Generator().manual_seed(0), 32,
                       dtype=torch.bfloat16, **SSM_KW)
    want = RSSM.ssm_init(jax.random.PRNGKey(0), 32, dtype=jnp.bfloat16,
                         **SSM_KW)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


@pytest.mark.parametrize("S", [16, 21, 1], ids=["whole", "ragged", "one"])
def test_ssm_apply_matches_reference(S):
    """S = 21 and 1 are no multiple of the chunk: the pad and the cut."""
    rp = _ssm_params()
    x = _normal(_rng(7), 2, S, 32)
    want = RSSM.ssm_apply(rp, jnp.asarray(x), chunk=8, **SSM_KW)
    got = SSM.ssm_apply(_params(rp), torch.from_numpy(x), chunk=8, **SSM_KW)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_ssm_decode_matches_reference_and_the_forward():
    rp = _ssm_params()
    p = _params(rp)
    x = _normal(_rng(8), 2, 6, 32)
    h = np.zeros(RSSM.ssm_state_shape(2, 32, **SSM_KW), np.float32)
    jh, th = jnp.asarray(h), torch.from_numpy(h)
    outs = []
    for t in range(6):
        want, jh = RSSM.ssm_decode(rp, jnp.asarray(x[:, t:t + 1]), jh,
                                   **SSM_KW)
        got, th = SSM.ssm_decode(p, torch.from_numpy(x[:, t:t + 1]), th,
                                 **SSM_KW)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        outs.append(got)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    full = SSM.ssm_apply(p, torch.from_numpy(x), chunk=4, **SSM_KW)
    torch.testing.assert_close(torch.cat(outs, 1), full, **TOL)


def test_ssm_bf16_follows_the_reference():
    rp = _ssm_params(dtype=jnp.bfloat16)
    x = _normal(_rng(10), 2, 16, 32)
    jx, tx = _both(x, "bfloat16")
    want = RSSM.ssm_apply(rp, jx, chunk=8, **SSM_KW)
    got = SSM.ssm_apply(_params(rp), tx, chunk=8, **SSM_KW)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(_np(got), _np(want), atol=5e-2, rtol=5e-2)


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

D, NH = 32, 4


def test_xlstm_init_and_state_shapes():
    for port, ref, rkey in ((XL.mlstm_init, RXL.mlstm_init, 0),
                            (XL.slstm_init, RXL.slstm_init, 1)):
        got = port(torch.Generator().manual_seed(0), D, NH, torch.bfloat16)
        want = ref(jax.random.PRNGKey(rkey), D, NH, jnp.bfloat16)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert XL.mlstm_state_shape(3, D, NH) == RXL.mlstm_state_shape(
        3, D, NH) == (3, NH, 8, 9)
    assert XL.slstm_state_shape(3, D) == RXL.slstm_state_shape(3, D)


@pytest.mark.parametrize("S", [16, 13], ids=["whole", "ragged"])
def test_mlstm_apply_matches_reference(S):
    rp = RXL.mlstm_init(jax.random.PRNGKey(2), D, NH)
    x = _normal(_rng(11), 2, S, D)
    want = RXL.mlstm_apply(rp, jnp.asarray(x), n_heads=NH, chunk=8)
    got = XL.mlstm_apply(_params(rp), torch.from_numpy(x), n_heads=NH,
                         chunk=8)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_mlstm_decode_matches_reference_and_the_forward():
    rp = RXL.mlstm_init(jax.random.PRNGKey(3), D, NH)
    p = _params(rp)
    x = _normal(_rng(12), 2, 6, D)
    h = np.zeros(RXL.mlstm_state_shape(2, D, NH), np.float32)
    jh, th = jnp.asarray(h), torch.from_numpy(h)
    outs = []
    for t in range(6):
        want, jh = RXL.mlstm_decode(rp, jnp.asarray(x[:, t:t + 1]), jh,
                                    n_heads=NH)
        got, th = XL.mlstm_decode(p, torch.from_numpy(x[:, t:t + 1]), th,
                                  n_heads=NH)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        outs.append(got)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    full = XL.mlstm_apply(p, torch.from_numpy(x), n_heads=NH, chunk=4)
    torch.testing.assert_close(torch.cat(outs, 1), full, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_apply_matches_reference(dtype):
    rp = RXL.slstm_init(jax.random.PRNGKey(4), D, NH,
                        getattr(jnp, dtype))
    x = _normal(_rng(13), 2, 9, D)
    jx, tx = _both(x, dtype)
    want = RXL.slstm_apply(rp, jx, n_heads=NH)
    got = XL.slstm_apply(_params(rp), tx, n_heads=NH)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    tol = TOL if dtype == "float32" else dict(atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_slstm_decode_matches_reference_and_the_forward():
    """The (c, h) state stays float32 under bf16 activations."""
    rp = RXL.slstm_init(jax.random.PRNGKey(5), D, NH)
    p = _params(rp)
    x = _normal(_rng(14), 2, 6, D)
    st = np.zeros(RXL.slstm_state_shape(2, D), np.float32)
    jst, tst = jnp.asarray(st), torch.from_numpy(st)
    outs = []
    for t in range(6):
        want, jst = RXL.slstm_decode(rp, jnp.asarray(x[:, t:t + 1]), jst,
                                     n_heads=NH)
        got, tst = XL.slstm_decode(p, torch.from_numpy(x[:, t:t + 1]), tst,
                                   n_heads=NH)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        outs.append(got)
    np.testing.assert_allclose(_np(tst), _np(jst), **TOL)
    torch.testing.assert_close(
        torch.cat(outs, 1), XL.slstm_apply(p, torch.from_numpy(x),
                                           n_heads=NH), **TOL)
    y, st16 = XL.slstm_decode(p, torch.from_numpy(x[:, :1]).bfloat16(),
                              torch.zeros(2, 2, D), n_heads=NH)
    assert y.dtype == torch.bfloat16 and st16.dtype == torch.float32


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_case(E, k, d=16, f=24, N=(3, 20), seed=0):
    rp = RMOE.moe_init(jax.random.PRNGKey(seed), d, f, E)
    x = _normal(_rng(seed + 20), *N, d)
    return rp, _params(rp), x


def _drops(rp, x, E, k, cf):
    """How many assignments the reference's capacity drops."""
    logits = x.reshape(-1, x.shape[-1]) @ np.asarray(rp["router"])
    tope = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
    N = tope.shape[0]
    C = int(max(-(-N * k // E) * cf, 1))
    return int(np.maximum(np.bincount(tope.ravel(), minlength=E) - C,
                          0).sum())


def test_moe_init_matches_reference_layout():
    got = MOE.moe_init(torch.Generator().manual_seed(0), 16, 24, 4,
                       torch.bfloat16)
    want = RMOE.moe_init(jax.random.PRNGKey(0), 16, 24, 4, jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


@pytest.mark.parametrize("E,k", [(4, 1), (4, 2), (8, 3), (6, 6)])
@pytest.mark.parametrize("cf", [1.0, 1.25, 16.0])
def test_moe_apply_matches_reference(E, k, cf):
    """At capacity_factor 1.0 tokens drop (counted): the output and aux
    equal the reference's all the same, and a second call has the same
    bits."""
    rp, p, x = _moe_case(E, k, seed=E + k)
    want, waux = RMOE.moe_apply(rp, jnp.asarray(x), n_experts=E, top_k=k,
                                capacity_factor=cf)
    got, aux = MOE.moe_apply(p, torch.from_numpy(x), n_experts=E, top_k=k,
                             capacity_factor=cf)
    if cf == 1.0 and k < E:
        assert _drops(rp, x, E, k, cf) > 0
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), **TOL)
    again, aux2 = MOE.moe_apply(p, torch.from_numpy(x), n_experts=E,
                                top_k=k, capacity_factor=cf)
    assert torch.equal(got, again) and torch.equal(aux, aux2)


def test_moe_apply_keeps_the_reference_capacity_at_decode():
    """8 decode tokens at olmoe's top 8 of 64 experts get C = 1 (the
    reference's truncation of ceil(1) * 1.25): every expert past its first
    token drops it, as in the reference."""
    rp, p, x = _moe_case(64, 8, N=(8, 1), seed=3)
    want, _ = RMOE.moe_apply(rp, jnp.asarray(x), n_experts=64, top_k=8,
                             capacity_factor=1.25)
    got, _ = MOE.moe_apply(p, torch.from_numpy(x), n_experts=64, top_k=8,
                           capacity_factor=1.25)
    assert _drops(rp, x, 64, 8, 1.25) > 0
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_moe_apply_bf16_follows_the_reference():
    rp = RMOE.moe_init(jax.random.PRNGKey(7), 16, 24, 4, jnp.bfloat16)
    x = _normal(_rng(30), 2, 10, 16)
    jx, tx = _both(x, "bfloat16")
    want, _ = RMOE.moe_apply(rp, jx, n_experts=4, top_k=2,
                             capacity_factor=1.0)
    got, _ = MOE.moe_apply(_params(rp), tx, n_experts=4, top_k=2,
                           capacity_factor=1.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-2, rtol=3e-2)
