"""The port's attention stack against the JAX package on the same numpy
inputs: the layers, the flash kernel's plain version against the Pallas
kernel (interpret mode, as tests/test_flash_kernel.py runs it), every
``attention_apply`` variant and ``attention_decode_`` over a wrapped ring
buffer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models import attention as RA
from repro.models import layers as RL
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.convert import attn_params_from_reference

# tests/test_flash_kernel.py's cases: B, S, H, Hkv, hd, bq, bk
FLASH_CASES = [
    (2, 256, 4, 2, 32, 128, 128),
    (1, 200, 8, 8, 16, 64, 128),       # MHA + ragged S (padding path)
    (2, 384, 6, 2, 64, 128, 64),       # G=3, uneven blocks
    (1, 128, 16, 2, 32, 64, 64),       # G=8 (starcoder2-like ratio)
]


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Layers, at 1e-6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 16)])
def test_rmsnorm_matches_reference(shape):
    rng = np.random.default_rng(0)
    x, g = _normal(rng, *shape), _normal(rng, shape[-1])
    np.testing.assert_allclose(L.rmsnorm(_t(x), _t(g)).numpy(),
                               np.asarray(RL.rmsnorm(x, g)),
                               atol=1e-6, rtol=1e-6)


def test_rmsnorm_keeps_bf16():
    x = torch.randn(4, 32).to(torch.bfloat16)
    assert L.rmsnorm(x, torch.ones(32)).dtype == torch.bfloat16


@pytest.mark.parametrize("head_dim,theta", [(16, 10000.0), (128, 500000.0)])
def test_rope_matches_reference(head_dim, theta):
    rng = np.random.default_rng(1)
    pos = np.arange(64, dtype=np.int32)
    x = _normal(rng, 2, 64, 3, head_dim)
    cos, sin = L.rope_angles(_t(pos), head_dim, theta)
    rcos, rsin = RL.rope_angles(jnp.asarray(pos), head_dim, theta)
    np.testing.assert_allclose(cos.numpy(), np.asarray(rcos), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(rsin), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(
        L.apply_rope(_t(x), cos, sin).numpy(),
        np.asarray(RL.apply_rope(x, rcos, rsin)), atol=1e-6, rtol=1e-6)


def test_swiglu_and_softmax_match_reference():
    rng = np.random.default_rng(2)
    a, b = _normal(rng, 4, 33), _normal(rng, 4, 33)
    np.testing.assert_allclose(L.swiglu(_t(a), _t(b)).numpy(),
                               np.asarray(RL.swiglu(a, b)), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(L.softmax_fp32(_t(a)).numpy(),
                               np.asarray(RL.softmax_fp32(a)), atol=1e-6,
                               rtol=1e-6)


def test_mlp_matches_reference():
    rng = np.random.default_rng(3)
    params = RL.mlp_init(jax.random.PRNGKey(0), 64, 128)
    x = _normal(rng, 2, 7, 64)
    got = L.mlp_apply({k: _t(v) for k, v in params.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(RL.mlp_apply(params, x)),
                               atol=1e-6, rtol=1e-6)


def test_initializers_draw_from_the_generator():
    gen = torch.Generator().manual_seed(0)
    w = L.dense_init(gen, 64, 32, torch.bfloat16)
    assert w.shape == (64, 32) and w.dtype == torch.bfloat16
    e = L.embed_init(torch.Generator().manual_seed(0), 100, 8)
    assert abs(float(e.std()) - 0.02) < 0.005
    again = L.dense_init(torch.Generator().manual_seed(0), 64, 32,
                         torch.bfloat16)
    assert torch.equal(w, again)
    p = L.mlp_init(torch.Generator().manual_seed(1), 8, 16)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "wg": (8, 16), "wu": (8, 16), "wd": (16, 8)}


def test_shard_ctx_is_a_no_op_until_active():
    """Inactive, a constraint is not even checked; active, it is the
    reference's layout hint: checked as JAX checks it (one entry per dim),
    and the same tensor comes back (tests/test_torch_train.py holds the
    mesh's context against the reference's)."""
    x = torch.ones(2, 3)
    assert L.NO_SHARD.cs(x, "batch") is x
    active = L.ShardCtx(batch=("data",), active=True)
    assert active.cs(x, "batch", None) is x
    with pytest.raises(ValueError, match="rank"):
        active.cs(x, "batch")


# ---------------------------------------------------------------------------
# The flash kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

def _qkv(seed, B, S, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return (_normal(rng, B, S, H, hd), _normal(rng, B, S, Hkv, hd),
            _normal(rng, B, S, Hkv, hd))


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"S{c[1]}H{c[2]}k{c[3]}" for c in FLASH_CASES])
def test_flash_matches_reference_f32(case):
    B, S, H, Hkv, hd, bq, bk = case
    q, k, v = _qkv(sum(case), B, S, H, Hkv, hd)
    want = ref_flash(q, k, v, block_q=bq, block_k=bk)
    got = flash_attention(_t(q), _t(k), _t(v), block_q=bq, block_k=bk)
    assert torch.equal(got, flash_attention_plain(_t(q), _t(k), _t(v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_matches_reference_bf16():
    q, k, v = _qkv(7, 2, 256, 4, 2, 64)
    want = ref_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    got = flash_attention(*(_t(x).to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


def test_flash_first_token_and_padding_rows():
    """Row 0 attends only to itself; positions past S (the reference pads
    100 to 128) do not reach the result."""
    q, k, v = _qkv(3, 1, 100, 2, 1, 16)
    got = flash_attention(_t(q), _t(k), _t(v), block_q=64, block_k=64)
    want = ref_flash(q, k, v, block_q=64, block_k=64)
    np.testing.assert_allclose(got[0, 0, 0].numpy(), v[0, 0, 0], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("hd", [24, 112, 256, 320, 512])
def test_flash_other_head_widths_match_reference(hd):
    """Widths outside the card's instances (24, zamba2-7b's 112), the
    widest instance, 256, and two widths of the column-chunk kernels (320,
    512): the plain version against the Pallas kernel in interpret mode,
    as test_flash_matches_reference_f32."""
    q, k, v = _qkv(hd, 1, 40, 4, 2, hd)
    want = ref_flash(q, k, v, block_q=16, block_k=16)
    got = flash_attention(_t(q), _t(k), _t(v), block_q=16, block_k=16)
    assert got.shape == (1, 40, 4, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_matches_reference_float16():
    """float16, which the reference takes, at the bf16 test's tolerance."""
    q, k, v = _qkv(16, 2, 128, 4, 2, 16)
    want = ref_flash(*(jnp.asarray(x, jnp.float16) for x in (q, k, v)))
    got = flash_attention(*(_t(x).to(torch.float16) for x in (q, k, v)))
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("hd,width", [(24, 32), (112, 128), (200, 256)])
def test_flash_zero_padding_keeps_the_result(hd, width):
    """What the wrapper does on the card for a width outside its
    instances: q, k and v zero-padded to the next instance, run with the
    true width's scale and sliced back, give the unpadded result."""
    q, k, v = (_t(x) for x in _qkv(hd + 1, 1, 33, 6, 2, hd))
    pad = [torch.nn.functional.pad(x, (0, width - hd)) for x in (q, k, v)]
    got = flash_attention_plain(*pad, scale=hd ** -0.5)[..., :hd]
    np.testing.assert_allclose(got.numpy(),
                               flash_attention_plain(q, k, v).numpy(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "mixed", "groups",
                                 "blocks", "layout"])
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = (_t(x) for x in _qkv(0, 1, 8, 4, 2, 16))
    if bad == "head_dim":                # q and k of different widths
        k, v = (torch.zeros(x.shape[:3] + (24,)) for x in (k, v))
    elif bad == "dtype":
        q, k, v = (x.to(torch.int32) for x in (q, k, v))
    elif bad == "mixed":
        v = v.to(torch.bfloat16)
    elif bad == "groups":
        q = torch.zeros(1, 8, 3, 16)
    elif bad == "layout":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    err = {"dtype": TypeError, "mixed": TypeError}.get(bad, ValueError)
    with pytest.raises(err):
        flash_attention(q, k, v, block_q=0 if bad == "blocks" else 128)


# ---------------------------------------------------------------------------
# attention_apply and attention_decode_, at 1e-4 in f32
# ---------------------------------------------------------------------------

D, H, HKV, HD = 64, 4, 2, 16


def _attn_params(qk_norm, seed=0):
    p = RA.attn_init(jax.random.PRNGKey(seed), D, H, HKV, HD,
                     qk_norm=qk_norm)
    if qk_norm:     # non-trivial norm weights
        rng = np.random.default_rng(seed)
        p["q_norm"] = jnp.asarray(1 + 0.1 * _normal(rng, HD))
        p["k_norm"] = jnp.asarray(1 + 0.1 * _normal(rng, HD))
    np_p = jax.tree.map(np.asarray, p)
    return p, attn_params_from_reference(np_p, "cpu")


APPLY_CASES = [   # variant, S, window, causal
    ("auto", 96, 0, True), ("dense", 96, 0, True), ("dense", 96, 0, False),
    ("chunked", 1100, 0, True), ("chunked", 200, 0, False),
    ("windowed", 1100, 64, True), ("auto", 1100, 64, True),
    ("flash", 200, 0, True)]


@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
@pytest.mark.parametrize("case", APPLY_CASES,
                         ids=[f"{c[0]}-S{c[1]}-w{c[2]}-"
                              f"{'causal' if c[3] else 'full'}"
                              for c in APPLY_CASES])
def test_attention_apply_matches_reference(case, qk_norm):
    variant, S, window, causal = case
    rp, p = _attn_params(qk_norm)
    x = _normal(np.random.default_rng(S + window), 1, S, D)
    kw = dict(n_heads=H, n_kv=HKV, head_dim=HD, rope_theta=10000.0,
              causal=causal, window=window, variant=variant)
    want = RA.attention_apply(rp, jnp.asarray(x), **kw)
    got = A.attention_apply(p, _t(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_attention_apply_refuses_non_causal_flash():
    _, p = _attn_params(False)
    with pytest.raises(ValueError, match="causal"):
        A.attention_apply(p, torch.zeros(1, 8, D), n_heads=H, n_kv=HKV,
                          head_dim=HD, causal=False, variant="flash")


def test_gqa_helpers_match_reference():
    rng = np.random.default_rng(5)
    q, k = _normal(rng, 2, 5, H, HD), _normal(rng, 2, 7, HKV, HD)
    s = A._gqa_scores(_t(q), _t(k))
    np.testing.assert_allclose(s.numpy(), np.asarray(RA._gqa_scores(q, k)),
                               atol=1e-5, rtol=1e-5)
    w = _normal(rng, 2, HKV, H // HKV, 5, 7)
    v = _normal(rng, 2, 7, HKV, HD)
    np.testing.assert_allclose(A._gqa_av(_t(w), _t(v)).numpy(),
                               np.asarray(RA._gqa_av(w, v)), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(A._repeat_kv(_t(k), 2).numpy(),
                                  np.asarray(RA._repeat_kv(k, 2)))


@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
@pytest.mark.parametrize("Sc", [8, 32], ids=["ring8", "full32"])
def test_attention_decode_matches_reference(Sc, qk_norm):
    """Twelve decode steps with per-sequence positions; with an 8-slot cache
    the ring buffer wraps. ``attention_decode_`` writes the new K/V into the
    caches passed in (copies of the last step's): output and both caches
    agree with the reference's returned ones at every step."""
    rp, p = _attn_params(qk_norm, seed=1)
    rng = np.random.default_rng(6)
    B = 2
    ck = np.zeros((B, Sc, HKV, HD), np.float32)
    cv = np.zeros_like(ck)
    rck, rcv = jnp.asarray(ck), jnp.asarray(cv)
    tk, tv = _t(ck), _t(cv)
    kw = dict(n_heads=H, n_kv=HKV, head_dim=HD, rope_theta=10000.0,
              window=Sc if Sc == 8 else 0)
    for step in range(12):
        pos = np.array([step, step + 3], np.int32)
        x = _normal(rng, B, 1, D)
        want, rck, rcv = RA.attention_decode(rp, jnp.asarray(x), rck, rcv,
                                             jnp.asarray(pos), **kw)
        tk, tv = tk.clone(), tv.clone()
        got = A.attention_decode_(p, _t(x), tk, tv, _t(pos), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(tk.numpy(), np.asarray(rck), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(rcv), atol=1e-5,
                                   rtol=1e-5)
