"""The sLSTM scan as one op (``repro_torch.kernels.slstm``) on the CPU:

- ``slstm_apply`` and ``slstm_decode`` against the reference's, and the
  gradients of ``slstm_apply`` (autograd through the op's backward)
  against ``jax.grad`` of the reference's, with respect to x and every
  parameter, at the reduced width (d 64, hd 16) and at xlstm-125m's hd 192;
  f32 at 1e-4, bf16 at 5e-2 (the mixers' tolerances), f16 at 1e-2;
- the explicit reverse loop the ``slstm_bwd`` kernel follows against
  autograd through the plain forward loop, with a nonzero initial state,
  pre-activations above the clamp at 6 and |c| crossing 1;
- on ``meta``: one dispatched op per call whatever S is, and
  ``FlopCounterMode``'s forward and forward + backward totals equal to the
  plain loop's on the CPU;
- the dispatch: CPU inputs take the plain version and never the kernel's
  library, inputs mixed across devices raise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro.models import xlstm as RXL
from repro_torch.kernels import slstm as K
from repro_torch.models import xlstm as XL

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2),
       "float16": dict(atol=1e-2, rtol=1e-2)}
DTYPES = ["float32", "bfloat16", "float16"]
# (d, heads): the reduced xlstm width (hd 16) and xlstm-125m's hd 192
WIDTHS = {"hd16": (64, 4), "hd192": (384, 2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _params(tree, grad=False):
    out = {}
    for k, v in tree.items():
        t = torch.from_numpy(np.array(v, np.float32)).to(
            {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}[str(v.dtype)])
        out[k] = t.requires_grad_(grad)
    return out


def _rel(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _case(width, dtype, seed, B=2, S=6):
    d, nh = WIDTHS[width]
    rp = RXL.slstm_init(jax.random.PRNGKey(seed), d, nh, getattr(jnp, dtype))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    w = rng.standard_normal((B, S, d)).astype(np.float32)
    return rp, x, w, nh


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_apply_matches_reference(width, dtype):
    rp, x, _, nh = _case(width, dtype, 1)
    want = RXL.slstm_apply(rp, jnp.asarray(x).astype(dtype), n_heads=nh)
    got = XL.slstm_apply(_params(rp), torch.from_numpy(x).to(
        getattr(torch, dtype)), n_heads=nh)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_matches_reference_at_hd_640(dtype):
    """Two heads of 640 (d 1280: past the cluster kernels' 480, the card's
    split forward), one row of 4 steps: the port's plain scan against the
    reference's ``slstm_apply``."""
    d, nh = 1280, 2
    rp = RXL.slstm_init(jax.random.PRNGKey(3), d, nh, getattr(jnp, dtype))
    x = np.random.default_rng(3).standard_normal((1, 4, d)).astype(
        np.float32)
    want = RXL.slstm_apply(rp, jnp.asarray(x).astype(dtype), n_heads=nh)
    got = XL.slstm_apply(_params(rp), torch.from_numpy(x).to(
        getattr(torch, dtype)), n_heads=nh)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_gradients_match_reference_jax_grad(width, dtype):
    """jax.grad of sum(slstm_apply(params, x) · w) with respect to x and
    every parameter, against autograd through the op's backward (relative
    Frobenius)."""
    rp, x, w, nh = _case(width, dtype, 2)
    jdt = getattr(jnp, dtype)

    def loss(p, xx):
        out = RXL.slstm_apply(p, xx, n_heads=nh)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w))
    want_p, want_x = jax.grad(loss, argnums=(0, 1))(
        rp, jnp.asarray(x).astype(jdt))
    p = _params(rp, grad=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    out = XL.slstm_apply(p, tx, n_heads=nh)
    (out.float() * torch.from_numpy(w)).sum().backward()
    tol = TOL[dtype]["rtol"]
    assert _rel(tx.grad, want_x) <= tol
    assert sorted(p) == sorted(want_p)
    for k, v in want_p.items():
        assert p[k].grad is not None, k
        assert _rel(p[k].grad, v) <= tol, (k, _rel(p[k].grad, v))


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_decode_matches_reference_from_a_nonzero_state(width):
    """The op at S = 1 from the cache's state, step after step."""
    rp, x, _, nh = _case(width, "float32", 3)
    d = x.shape[-1]
    rng = np.random.default_rng(30)
    st = (rng.standard_normal(RXL.slstm_state_shape(2, d)) * 2).astype(
        np.float32)
    jst, tst = jnp.asarray(st), torch.from_numpy(st)
    p = _params(rp)
    for t in range(x.shape[1]):
        want, jst = RXL.slstm_decode(rp, jnp.asarray(x[:, t:t + 1]), jst,
                                     n_heads=nh)
        got, tst = XL.slstm_decode(p, torch.from_numpy(x[:, t:t + 1]), tst,
                                   n_heads=nh)
        np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
        np.testing.assert_allclose(_np(tst), _np(jst), **TOL["float32"])


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_decode_in_float16_matches_reference(width):
    """The op at S = 1 in float16 activations from the cache's float16
    state, step after step, at the float16 tolerance."""
    rp, x, _, nh = _case(width, "float16", 3)
    d = x.shape[-1]
    rng = np.random.default_rng(31)
    st = (rng.standard_normal(RXL.slstm_state_shape(2, d)) * 2).astype(
        np.float16)
    jst, tst = jnp.asarray(st), torch.from_numpy(st)
    p = _params(rp)
    xh = x.astype(np.float16)
    for t in range(x.shape[1]):
        want, jst = RXL.slstm_decode(rp, jnp.asarray(xh[:, t:t + 1]), jst,
                                     n_heads=nh)
        got, tst = XL.slstm_decode(p, torch.from_numpy(xh[:, t:t + 1]), tst,
                                   n_heads=nh)
        assert got.dtype == tst.dtype == torch.float16
        np.testing.assert_allclose(_np(got), _np(want), **TOL["float16"])
        np.testing.assert_allclose(_np(tst), _np(jst), **TOL["float16"])


def _scan_inputs(dtype, seed, B=3, S=9, H=2, hd=16, grad=True,
                 state_grad=True):
    """Inputs that reach every branch of the backward: ip above the clamp
    at 6 in places, |c| crossing 1, a nonzero initial state."""
    g = torch.Generator().manual_seed(seed)
    d = H * hd
    zx = (torch.randn(B, S, d, generator=g) * 2).to(dtype)
    ip = torch.randn(B, S, d, generator=g) * 4 + 1
    fp = torch.randn(B, S, d, generator=g) * 2
    op = torch.randn(B, S, d, generator=g)
    r = torch.randn(H, hd, hd, generator=g) * hd ** -0.5
    c0 = torch.randn(B, d, generator=g) * 2
    h0 = torch.randn(B, d, generator=g)
    ins = [zx, ip, fp, op, r, c0, h0]
    for i, t in enumerate(ins):
        t.requires_grad_(grad and (state_grad or i < 5))
    return ins


def _loss(y, c, h, seed=7):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(y.shape, generator=g).to(y.device)
    return ((y.float() * w).sum()
            + 1.3 * c.sum() + 0.7 * h.sum())


@pytest.mark.parametrize("state_grad", [True, False],
                         ids=["state-grad", "zero-state"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_explicit_backward_matches_autograd_through_the_loop(dtype,
                                                             state_grad):
    ins = _scan_inputs(getattr(torch, dtype), 4, state_grad=state_grad)
    assert (ins[1] > 6).any()
    y, c, h = K.slstm_scan(*ins)
    need = [t for t in ins if t.requires_grad]
    got = torch.autograd.grad(_loss(y, c, h), need)
    y2, c2, h2, cs, _, _ = K.slstm_scan_plain(*ins, save=True)
    assert ((cs.abs() < 1).any() and (cs.abs() > 1).any())
    want = torch.autograd.grad(_loss(y2, c2, h2), need)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert _rel(a, b) <= 1e-5


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("S", [1, 4096])
def test_meta_call_is_one_op(S):
    ins = [t.detach().to("meta") for t in _scan_inputs(torch.bfloat16, 5,
                                                       S=1)]
    B, _, d = ins[0].shape
    ins[0] = torch.empty((B, S, d), dtype=torch.bfloat16, device="meta")
    for i in (1, 2, 3):
        ins[i] = torch.empty((B, S, d), device="meta")
    for grad in (False, True):
        for t in ins:
            t.requires_grad_(grad)
        with _Ops() as mode:
            y, c, h = K.slstm_scan(*ins)
        assert mode.ops == ["repro_torch.slstm_scan"]
        assert y.shape == (B, S, d) and y.dtype == torch.bfloat16
        assert c.shape == h.shape == (B, d)
    with _Ops() as mode:
        y.float().sum().backward()
    assert mode.ops.count("repro_torch.slstm_scan_bwd") == 1
    assert ins[4].grad.shape == ins[4].shape


@pytest.mark.parametrize("state_grad", [True, False],
                         ids=["state-grad", "zero-state"])
def test_flop_formula_equals_the_plain_loop(state_grad):
    """``FlopCounterMode`` over the op (on meta and on the CPU) counts what
    it counts over the plain loop on the CPU: forward, and forward plus
    backward."""
    def count(fn, ins):
        with FlopCounterMode(display=False) as fc:
            y, c, h = fn(*ins)[:3]
            fwd = fc.get_total_flops()
            torch.autograd.grad(_loss(y, c, h), [t for t in ins
                                                 if t.requires_grad])
        return fwd, fc.get_total_flops()

    ins = _scan_inputs(torch.float32, 6, state_grad=state_grad)
    plain = count(K.slstm_scan_plain, ins)
    B, S, d = ins[0].shape
    assert plain[0] == 2 * B * S * d * ins[4].shape[1]
    assert count(K.slstm_scan, ins) == plain
    meta = [t.detach().to("meta").requires_grad_(t.requires_grad)
            for t in ins]
    assert count(K.slstm_scan, meta) == plain


def test_cpu_inputs_take_the_plain_version(monkeypatch):
    calls = []
    plain = K.slstm_scan_plain
    monkeypatch.setattr(K, "slstm_scan_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))

    def refuse(*a, **k):
        raise AssertionError("CPU inputs reached the kernel's library")
    monkeypatch.setattr(K, "library", refuse)
    ins = _scan_inputs(torch.float32, 8)
    y, c, h = K.slstm_scan(*ins)
    assert calls == [1]
    _loss(y, c, h).backward()
    assert all(t.grad is not None for t in ins)


def test_mixed_devices_and_dtypes_raise():
    ins = _scan_inputs(torch.float32, 9, grad=False)
    mixed = list(ins)
    mixed[4] = mixed[4].to("meta")
    with pytest.raises(ValueError, match="one"):
        K.slstm_scan(*mixed)
    mixed = list(ins)
    mixed[1] = mixed[1].double()
    with pytest.raises(TypeError, match="float32"):
        K.slstm_scan(*mixed)
    mixed = list(ins)
    mixed[0] = mixed[0].int()
    with pytest.raises(TypeError):
        K.slstm_scan(*mixed)
    with pytest.raises(ValueError, match="H·hd"):
        K.slstm_scan(*ins[:4], ins[4][:, :8, :8], *ins[5:])


def test_chip_smoke_slstm_checks_on_cpu():
    """chip_smoke's phase 3 for the scan, rehearsed on the CPU over its
    short cases: the plain loop against itself through the op, every
    gradient named, all three dtypes; the inputs reach the clamp and |c| = 1."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    cases = [c for c in chip_smoke.SLSTM_CASES if c[1] <= 2 and c[2] <= 64]
    worst = chip_smoke.slstm_checks(np.random.default_rng(0),
                                    torch.device("cpu"), cases)
    assert set(worst) == {"float32", "bfloat16", "float16"}
    assert set(worst["float32"]) == {"y", "c", "h", "dzx", "dip", "dfp",
                                     "dop", "dr", "dc0", "dh0"}
    assert worst["float32"]["y"] == 0.0
    ins = chip_smoke.slstm_inputs(np.random.default_rng(1), 3, 127, 2, 16,
                                  "float32", torch.device("cpu"),
                                  grad=False)
    cs = K.slstm_scan_plain(*ins, save=True)[3]
    assert (ins[1] > 6).any() and (cs.abs() < 1).any() \
        and (cs.abs() > 1).any()
