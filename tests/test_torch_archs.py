"""The port's LM for every architecture and group kind against the JAX
package's on the same weights (the twin of tests/test_archs.py): the ten
reduced configs, plus small configs for each group kind (``moe_every=2``
for moe_interleaved, a plain SSM stack, a hybrid stack with tail layers,
and the six kinds on the 2-layer model of tests/test_flash_kernel.py), in
f32 on weights carried over from the reference:

- ``apply`` logits and ``aux``, and ``loss``, at 1e-4;
- ``init_params`` with the reference's keys, shapes and dtypes;
- ``init_cache`` keys, shapes and dtypes;
- 12 ``decode_step``s (the cache written in place) against the
  reference's, logits and cache at 1e-4;
- the port's own teacher-forced decode against its forward at the
  reference test's 5e-2;
- ``reset_slot``: a slot decoded after a reset equals a fresh cache's."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
from repro.configs.base import ArchConfig as RArchConfig
from repro.models.model import LM as RLM
from repro_torch.configs import ArchConfig, all_archs, get_arch
from repro_torch.models import LM
from repro_torch.models.convert import lm_params_from_reference

ARCHS = sorted(all_archs())
# tests/test_flash_kernel.py's 2-layer model, and the six group kinds the
# port once refused on it
FL = dict(name="fl", family="dense", n_layers=2, d_model=64, n_heads=4,
          n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16, remat=False,
          dtype="float32")
KINDS = {
    "moe": dict(family="moe", moe_experts=4, moe_topk=2),
    "moe_interleaved": dict(family="moe", moe_experts=4, moe_topk=1,
                            moe_every=2),
    "ssm": dict(family="ssm", ssm_state=16, ssm_head_dim=16),
    "hybrid": dict(family="hybrid", ssm_state=16, ssm_head_dim=16,
                   hybrid_attn_every=2),
    "xlstm": dict(family="ssm", xlstm_pattern=("m", "s")),
    "encdec": dict(family="audio", encoder_layers=2, frontend="audio",
                   frontend_tokens=8),
}
# the reduced configs leave three layouts out: llama4's interleave
# (moe_every is 1 there), a plain SSM stack and a hybrid tail
EXTRA = {
    "llama4-every2": ("llama4-scout-17b-a16e", dict(moe_every=2, n_layers=4)),
    "zamba2-tail": ("zamba2-7b", dict(n_layers=5)),
}
CASES = ARCHS + sorted(EXTRA) + [f"fl-{k}" for k in sorted(KINDS)]
GROUP_KIND = {"llama4-scout-17b-a16e": "moe", "olmoe-1b-7b": "moe",
              "xlstm-125m": "xlstm", "zamba2-7b": "hybrid",
              "llama4-every2": "moe_interleaved", "zamba2-tail": "hybrid",
              "fl-encdec": "dense"}
B, S, STEPS, CONTEXT = 2, 20, 12, 16


def _configs(case):
    """(port config, reference config), reduced, in f32."""
    if case.startswith("fl-"):
        over = dict(FL, **KINDS[case[3:]])
        return ArchConfig(**over), RArchConfig(**over)
    arch, over = EXTRA.get(case, (case, {}))
    over = dict(over, dtype="float32")
    return (dataclasses.replace(get_arch(arch).reduced(), **over),
            dataclasses.replace(rcfg.get_arch(arch).reduced(), **over))


def _frontend(cfg, seed=2):
    if cfg.frontend == "none":
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


def _tokens(cfg, n=S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def _tensor(a):
    return None if a is None else torch.from_numpy(a)


@functools.lru_cache(maxsize=None)
def _models(case):
    """(port LM, port params, reference LM, reference params)."""
    cfg, rc = _configs(case)
    rlm = RLM(rc)
    rp = rlm.init_params(jax.random.PRNGKey(0))
    p = lm_params_from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu")
    return LM(cfg), p, rlm, rp


def _fill_cross(lm, params, cache, fe):
    """Encode once and stash each decoder layer's cross K/V in the cache,
    as tests/test_archs.py::test_decode_matches_forward does."""
    enc = lm._run_encoder(params, fe, 0, "auto")
    for g in range(lm.n_groups):
        k, v = lm._encode_kv(params["cross"][g]["attn"], enc)
        cache["enc_k"][g], cache["enc_v"][g] = k, v


def _ref_fill_cross(rlm, rp, cache, fe):
    enc = rlm._run_encoder(rp, jnp.asarray(fe), 0, "auto")
    ks, vs = [], []
    for g in range(rlm.n_groups):
        cp = jax.tree.map(lambda t: t[g], rp["cross"])
        k, v = rlm._encode_kv(cp["attn"], enc)
        ks.append(k)
        vs.append(v)
    return dict(cache, enc_k=jnp.stack(ks), enc_v=jnp.stack(vs))


def _leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict / list, in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("case", CASES)
def test_group_kind_matches_reference(case):
    lm, _, rlm, _ = _models(case)
    assert lm.group_kind == rlm.group_kind == GROUP_KIND.get(case, (
        case[3:] if case.startswith("fl-") else "dense"))
    assert (lm.n_groups, lm.group_size, lm.tail_layers) == (
        rlm.n_groups, rlm.group_size, rlm.tail_layers)


@pytest.mark.parametrize("case", CASES)
def test_apply_matches_reference(case):
    lm, p, rlm, rp = _models(case)
    tok, fe = _tokens(lm.cfg), _frontend(lm.cfg)
    want, raux = jax.jit(rlm.apply)(rp, jnp.asarray(tok),
                                    None if fe is None else jnp.asarray(fe))
    got, aux = lm.apply(p, torch.from_numpy(tok), _tensor(fe))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(raux), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_loss_matches_reference(case):
    lm, p, rlm, rp = _models(case)
    tok, fe = _tokens(lm.cfg, seed=3), _frontend(lm.cfg, seed=4)
    want = jax.jit(rlm.loss)(rp, jnp.asarray(tok),
                             None if fe is None else jnp.asarray(fe))
    got = lm.loss(p, torch.from_numpy(tok), _tensor(fe))
    np.testing.assert_allclose(float(got), float(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_init_params_matches_reference_layout(case):
    """The port's own init draws the converted reference tree's leaves:
    the same paths, shapes and dtypes (the router, A_log, D and the xLSTM
    gates float32 under bf16 weights too), and repeats from its seed."""
    cfg, rc = _configs(case)
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    rc = dataclasses.replace(rc, param_dtype="bfloat16")
    ref = lm_params_from_reference(
        jax.tree.map(np.asarray, RLM(rc).init_params(jax.random.PRNGKey(0))),
        cfg, "cpu")
    got = LM(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    want = [(path, tuple(t.shape), t.dtype) for path, t in _leaves(ref)]
    assert [(path, tuple(t.shape), t.dtype)
            for path, t in _leaves(got)] == want
    again = LM(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(_leaves(got), _leaves(again)))


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("case", CASES)
def test_init_cache_matches_reference(case, window):
    lm, _, rlm, _ = _models(case)
    src = lm.cfg.frontend_tokens if lm.cfg.is_encdec else 0
    want = rlm.init_cache(B, CONTEXT, window=window, src_len=src)
    got = lm.init_cache(B, CONTEXT, window=window, src_len=src,
                        device="cpu")
    assert set(got) == set(want)
    for k, t in got.items():
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).split(".")[-1] == str(want[k].dtype), k
        assert not t.any(), k


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_reference(case):
    """12 steps from an empty cache (the enc-dec cross K/V filled first):
    every step's logits and the final cache at 1e-4; the port writes its
    cache in place."""
    lm, p, rlm, rp = _models(case)
    tok = _tokens(lm.cfg, STEPS, seed=5)
    fe = _frontend(lm.cfg)
    src = lm.cfg.frontend_tokens if lm.cfg.is_encdec else 0
    rcache = rlm.init_cache(B, CONTEXT, src_len=src)
    cache = lm.init_cache(B, CONTEXT, src_len=src, device="cpu")
    if lm.cfg.is_encdec:
        rcache = _ref_fill_cross(rlm, rp, rcache, fe)
        _fill_cross(lm, p, cache, torch.from_numpy(fe))
    tensors = {k: t for k, t in cache.items()}
    step = jax.jit(rlm.decode_step)
    for s in range(STEPS):
        want, rcache = step(rp, rcache, jnp.asarray(tok[:, s]))
        got, out = lm.decode_step(p, cache, torch.from_numpy(tok[:, s]))
        assert out is cache and got.shape == (B, lm.vp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {s}")
    assert all(cache[k] is t for k, t in tensors.items())
    for k, t in cache.items():
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(rcache[k], np.float32),
                                   atol=1e-4, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_own_forward(case):
    """Teacher-forced decode == the forward (tests/test_archs.py::
    test_decode_matches_forward in the port): MoE capacity raised so no
    token drops, the enc-dec cross K/V from the encoder."""
    lm0, p, _, _ = _models(case)
    lm = LM(dataclasses.replace(lm0.cfg, moe_capacity_factor=16.0))
    tok = torch.from_numpy(_tokens(lm.cfg, STEPS, seed=6))
    fe = _tensor(_frontend(lm.cfg)) if lm.cfg.is_encdec else None
    full, _ = lm.apply(p, tok, fe)
    cache = lm.init_cache(B, STEPS, device="cpu",
                          src_len=lm.cfg.frontend_tokens if fe is not None
                          else 0)
    if fe is not None:
        _fill_cross(lm, p, cache, fe)
    errs = []
    for s in range(STEPS):
        lg, cache = lm.decode_step(p, cache, tok[:, s])
        errs.append(float((lg - full[:, s]).abs().max()))
    assert max(errs) < 5e-2, errs
    assert cache["pos"].tolist() == [STEPS] * B


@pytest.mark.parametrize("case", CASES)
def test_reset_slot_makes_a_slot_fresh(case):
    """Decode two steps, reset slot 0, decode three more: slot 0's logits
    equal those of a fresh cache fed the same three tokens."""
    lm, p, _, _ = _models(case)
    if lm.group_kind in ("moe", "moe_interleaved"):
        # the capacity couples the slots' tokens: raise it so none drops
        lm = LM(dataclasses.replace(lm.cfg, moe_capacity_factor=16.0))
    src = lm.cfg.frontend_tokens if lm.cfg.is_encdec else 0
    tok = torch.from_numpy(_tokens(lm.cfg, 5, seed=7))
    used = lm.init_cache(B, CONTEXT, src_len=src, device="cpu")
    fresh = lm.init_cache(B, CONTEXT, src_len=src, device="cpu")
    for s in range(2):
        lm.decode_step(p, used, tok[:, s])
    lm.reset_slot(used, 0)
    assert used["pos"].tolist() == [0, 2]
    for s in range(2, 5):
        a, _ = lm.decode_step(p, used, tok[:, s])
        b, _ = lm.decode_step(p, fresh, tok[:, s])
        assert torch.equal(a[0], b[0]), s


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-7b"])
def test_bf16_recurrent_stack_tracks_reference(arch, record_property):
    """The recurrent stacks in bf16 activations over bf16 weights (the
    card's serving dtypes) at 12 layers of the reduced width, 32 tokens,
    through both packages on the same weights. Their bf16 logits drift
    from the f32 forward with depth in the reference as in the port, so:
    the port's bf16 forward and its teacher-forced bf16 decode lie no
    farther from the reference's than the reference's bf16 forward lies
    from its own f32 one, and the port's teacher-forced error (decode
    against its forward) is no larger than the reference's. The numbers
    go to the junit record."""
    over = dict(dtype="bfloat16", param_dtype="bfloat16", n_layers=12)
    rc = dataclasses.replace(rcfg.get_arch(arch).reduced(), **over)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    rlm, rlm32 = RLM(rc), RLM(dataclasses.replace(rc, dtype="float32"))
    lm, lm32 = LM(cfg), LM(dataclasses.replace(cfg, dtype="float32"))
    rp = rlm.init_params(jax.random.PRNGKey(0))
    p = lm_params_from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu")
    S = 32
    tok = _tokens(cfg, S, seed=1)
    rf = jax.jit(lambda p, t: rlm.apply(p, t)[0])(rp, tok)
    rf32 = jax.jit(lambda p, t: rlm32.apply(p, t)[0])(rp, tok)
    rcache, step, rd = rlm.init_cache(B, S), jax.jit(rlm.decode_step), []
    for s in range(S):
        lg, rcache = step(rp, rcache, jnp.asarray(tok[:, s]))
        rd.append(np.asarray(lg, np.float32))
    cache, pd = lm.init_cache(B, S, device="cpu"), []
    with torch.inference_mode():
        pf = lm.apply(p, torch.from_numpy(tok))[0].float()
        pf32 = lm32.apply(p, torch.from_numpy(tok))[0]
        for s in range(S):
            lg, cache = lm.decode_step(p, cache, torch.from_numpy(tok[:, s]))
            pd.append(lg.float().numpy())
    rd, pd = np.stack(rd, 1), np.stack(pd, 1)
    got = {"f32_port_vs_ref": _rel(pf32, rf32),
           "ref_bf16_vs_f32": _rel(rf, rf32),
           "port_bf16_vs_f32": _rel(pf, pf32),
           "fwd_port_vs_ref": _rel(pf, rf),
           "decode_port_vs_ref": _rel(pd, rd),
           "tf_ref": _rel(rd, rf), "tf_port": _rel(pd, pf)}
    for k, v in got.items():
        record_property(k, v)
    assert got["f32_port_vs_ref"] <= 1e-4, got
    assert got["fwd_port_vs_ref"] <= got["ref_bf16_vs_f32"], got
    assert got["decode_port_vs_ref"] <= got["ref_bf16_vs_f32"], got
    assert got["tf_port"] <= got["tf_ref"], got


def test_float16_xlstm_matches_reference():
    """The reduced xlstm-125m in float16 activations computes in the port
    as in the reference (its sLSTM op takes float16, as the reference's
    scan does): float16 logits within 1e-2 relative Frobenius of the
    reference's, on the same weights and tokens."""
    over = dict(dtype="float16")
    rc = dataclasses.replace(rcfg.get_arch("xlstm-125m").reduced(), **over)
    cfg = dataclasses.replace(get_arch("xlstm-125m").reduced(), **over)
    rlm = RLM(rc)
    rp = rlm.init_params(jax.random.PRNGKey(0))
    p = lm_params_from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu")
    tok = _tokens(cfg)
    want = jax.jit(lambda p, t: rlm.apply(p, t)[0])(rp, jnp.asarray(tok))
    with torch.inference_mode():
        got = LM(cfg).apply(p, torch.from_numpy(tok))[0]
    assert got.dtype == torch.float16 and str(want.dtype) == "float16"
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    assert _rel(got.float().numpy(), want) <= 1e-2
