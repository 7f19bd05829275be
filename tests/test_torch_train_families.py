"""The train step of the other families against the JAX package's, on the
CPU (the MoE, interleaved MoE, hybrid SSM, xLSTM and encoder-decoder
configs, reduced, in f32 on the reference's weights; the check is
tests/test_torch_train.py's), and rematerialization against none for all
ten architectures: the same loss and gradient bits."""
import dataclasses

import pytest
import torch

from repro_torch.configs import ShapeConfig, all_archs, get_arch
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.launch import steps
from repro_torch.models import LM
from test_torch_train import DENSE, check_train_step

FAMILIES = tuple(a for a in sorted(all_archs()) if a not in DENSE)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch):
    check_train_step(arch)


@pytest.mark.parametrize("arch", sorted(all_archs()))
def test_remat_gives_the_same_gradient_bits(arch):
    """Every group kind (MoE's spill row and the recurrent states written
    under autograd included): the loss and every gradient leaf with the
    group bodies rematerialized equal those without, bit for bit."""
    from repro_torch.tree import leaves
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32",
                                  remat=remat)
        params = LM(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
        shape = ShapeConfig("t", "train", seq_len=16, global_batch=2)
        lg = steps.make_loss_and_grads(LM(cfg), shape)
        tok = torch.from_numpy(TokenSource(DataConfig(cfg.vocab_size, 16, 2))
                               .batch_at(0)["tokens"])
        fe = None
        if cfg.frontend != "none":
            fe = torch.randn((2, cfg.frontend_tokens, cfg.d_model),
                             generator=torch.Generator().manual_seed(2))
        out.append(lg(params, tok, fe))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, b)
