"""The port's LM (dense family) against the JAX package's on the same
weights: the configs of all ten architectures, the weight converter,
``LM.apply`` under the dense, chunked and flash variants (with and without
``last_only``) and ``loss``, at 1e-4 in f32; and the port's own flash
against dense at the reference test's 1e-3. The other families are
tests/test_torch_archs.py's."""
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
from repro.configs.base import ArchConfig as RArchConfig
from repro.models.model import LM as RLM
from repro_torch.configs import ArchConfig, all_archs, get_arch
from repro_torch.kernels import _build
from repro_torch.models import LM, NO_SHARD, ShardCtx
from repro_torch.models.convert import (attn_params_from_reference,
                                        lm_params_from_reference)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# tests/test_flash_kernel.py's 2-layer model
FL = dict(name="fl", family="dense", n_layers=2, d_model=64, n_heads=4,
          n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16, remat=False,
          dtype="float32")


def _configs(which):
    """(port config, reference config) in f32."""
    if which == "fl":
        return ArchConfig(**FL), RArchConfig(**FL)
    return (dataclasses.replace(get_arch("llama3-8b").reduced(),
                                dtype="float32"),
            dataclasses.replace(rcfg.get_arch("llama3-8b").reduced(),
                                dtype="float32"))


@functools.lru_cache(maxsize=None)
def _models(which):
    """(port LM, port params, reference LM, reference params), built once
    per config."""
    cfg, rc = _configs(which)
    rlm = RLM(rc)
    rp = rlm.init_params(jax.random.PRNGKey(0))
    p = lm_params_from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu")
    return LM(cfg), p, rlm, rp


def _tokens(vocab, B=2, S=128, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# Configs and weights
# ---------------------------------------------------------------------------

def test_configs_match_reference():
    assert set(all_archs()) == set(rcfg.all_archs())
    assert len(all_archs()) == 10
    for name in sorted(all_archs()):
        cfg, ref = get_arch(name), rcfg.get_arch(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), name
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
            ref.reduced()), name
        assert cfg.vocab_padded() == ref.vocab_padded(), name
        assert cfg.resolved_head_dim == ref.resolved_head_dim, name
        assert cfg.param_count() == ref.param_count(), name
        assert cfg.active_param_count() == ref.active_param_count(), name
        assert {k: dataclasses.asdict(v) for k, v in cfg.shapes().items()} \
            == {k: dataclasses.asdict(v) for k, v in ref.shapes().items()}
    assert get_arch("llama3-8b").vocab_padded() == 128256
    assert {c.family for c in all_archs().values()} == {
        "dense", "moe", "ssm", "hybrid", "vlm", "audio"}


@pytest.mark.parametrize("which", ["llama3-8b", "fl"])
def test_weight_converter(which):
    _, p, _, rp = _models(which)
    cfg, _ = _configs(which)
    assert len(p["blocks"]) == cfg.n_layers
    for i, layer in enumerate(p["blocks"]):
        for group in ("attn", "mlp"):
            for key, t in layer[group].items():
                want = np.asarray(rp["blocks"][group][key])[i]
                assert t.dtype == torch.float32 and t.device.type == "cpu"
                np.testing.assert_array_equal(t.numpy(), want)
        for key in ("ln1", "ln2"):
            np.testing.assert_array_equal(
                layer[key].numpy(), np.asarray(rp["blocks"][key])[i])
    for key in ("embed", "final_norm", "unembed"):
        np.testing.assert_array_equal(p[key].numpy(), np.asarray(rp[key]))
    bad = dataclasses.replace(cfg, n_layers=cfg.n_layers + 1)
    with pytest.raises(ValueError, match="layers"):
        lm_params_from_reference(jax.tree.map(np.asarray, rp), bad, "cpu")


def test_attn_converter_keeps_layout_and_casts():
    from repro.models.attention import attn_init
    rp = attn_init(jax.random.PRNGKey(3), 64, 4, 2, 16, qk_norm=True)
    p = attn_params_from_reference(jax.tree.map(np.asarray, rp), "cpu",
                                   torch.bfloat16)
    assert set(p) == {"wq", "wk", "wv", "wo", "q_norm", "k_norm"}
    assert p["wk"].shape == (64, 32) and p["wo"].shape == (64, 64)
    assert all(t.dtype == torch.bfloat16 for t in p.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_matches_reference_layout(dtype):
    cfg, rc = _configs("llama3-8b")
    cfg = dataclasses.replace(cfg, param_dtype=dtype)
    rc = dataclasses.replace(rc, param_dtype=dtype)
    p = LM(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree.map(lambda a: (a.shape[1:], str(a.dtype)),
                          RLM(rc).abstract_params()["blocks"])
    for layer in p["blocks"]:
        for group in ("attn", "mlp"):
            for key, t in layer[group].items():
                assert (tuple(t.shape), dtype) == shapes[group][key]
        assert layer["ln1"].shape == (cfg.d_model,)
    assert p["embed"].shape == (LM(cfg).vp, cfg.d_model)
    assert p["unembed"].shape == (cfg.d_model, LM(cfg).vp)
    assert all(t.dtype == getattr(torch, dtype) for t in
               (p["embed"], p["unembed"], p["final_norm"]))
    again = LM(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p["blocks"][1]["mlp"]["wd"],
                       again["blocks"][1]["mlp"]["wd"])


def test_init_params_needs_the_generator_on_the_device(monkeypatch):
    lm = LM(_configs("fl")[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(torch.Generator())
    with pytest.raises(ValueError, match="generator"):
        lm.init_params(torch.Generator(), torch.device("meta"))


# ---------------------------------------------------------------------------
# Forward and loss against the reference, at 1e-4 in f32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("last_only", [False, True], ids=["all", "last"])
@pytest.mark.parametrize("variant", ["dense", "chunked", "flash"])
@pytest.mark.parametrize("which", ["llama3-8b", "fl"])
def test_apply_matches_reference(which, variant, last_only):
    lm, p, rlm, rp = _models(which)
    tok = _tokens(lm.cfg.vocab_size)
    want, raux = rlm.apply(rp, jnp.asarray(tok), variant=variant,
                           last_only=last_only)
    got, aux = lm.apply(p, torch.from_numpy(tok), variant=variant,
                        last_only=last_only)
    assert got.shape == want.shape == (2, 1 if last_only else 128, lm.vp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert float(aux) == float(raux) == 0.0


@pytest.mark.parametrize("variant", ["auto", "flash"])
@pytest.mark.parametrize("which", ["llama3-8b", "fl"])
def test_loss_matches_reference(which, variant):
    lm, p, rlm, rp = _models(which)
    tok = _tokens(lm.cfg.vocab_size, seed=2)
    want = rlm.loss(rp, jnp.asarray(tok), variant=variant)
    got = lm.loss(p, torch.from_numpy(tok), variant=variant)
    np.testing.assert_allclose(float(got), float(want), atol=1e-4,
                               rtol=1e-4)


def test_flash_matches_dense_in_the_port():
    """tests/test_flash_kernel.py::test_flash_variant_in_model in the port,
    on the port's own random weights."""
    lm = LM(ArchConfig(**FL))
    params = lm.init_params(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, 128, (2, 128),
                           generator=torch.Generator().manual_seed(1))
    dense, _ = lm.apply(params, tokens, variant="dense")
    flash, _ = lm.apply(params, tokens, variant="flash")
    torch.testing.assert_close(flash, dense, atol=1e-3, rtol=1e-3)


def test_bf16_activations_follow_the_reference_dtype_rules():
    """bf16 activations over f32 weights: the logits come out bf16 and stay
    close to the f32 model's."""
    lm32, p, _, _ = _models("fl")
    lm16 = LM(dataclasses.replace(lm32.cfg, dtype="bfloat16"))
    tok = torch.from_numpy(_tokens(128))
    lg16, _ = lm16.apply(p, tok, variant="flash", last_only=True)
    lg32, _ = lm32.apply(p, tok, variant="flash", last_only=True)
    assert lg16.dtype == torch.bfloat16
    torch.testing.assert_close(lg16.float(), lg32, atol=5e-2, rtol=5e-2)


def test_models_package_exports():
    assert NO_SHARD == ShardCtx() and not NO_SHARD.active
    lm = LM(ArchConfig(**FL))
    assert (lm.group_kind, lm.n_groups, lm.vp) == ("dense", 2, 256)


def test_chip_smoke_attention_path_on_cpu():
    """The chip script's attention path at a tiny size, on the CPU: the
    flash prefill runs (warm-up, timed, twice more with equal bits), agrees
    with the dense variant in bf16 and, at f32 and 2 layers, at 1e-3; no
    kernel launches."""
    before = dict(_build.LAUNCHES)
    cfg = chip_smoke.lm_config(n_layers=3, d_model=128, n_heads=8,
                               n_kv_heads=2, head_dim=16, d_ff=256,
                               vocab_size=500)
    rec, launches = chip_smoke.run_attention(cfg, 2, 130, "cpu", 3)
    assert set(launches.values()) == {0} and _build.LAUNCHES == before
    assert rec["bitwise"] and rec["runs"] >= 5 and rec["layers"] == 3
    assert rec["rel_frobenius"] < chip_smoke.LOGITS_RTOL
    assert rec["f32_max_abs_err"] < chip_smoke.F32_TOL
    assert rec["param_bytes"] > 0
