"""The port's LM ``Server`` (launch/serve.py) against the JAX package's:
the twin of tests/test_system.py::test_serve_loop_generates; token for
token against the reference ``Server`` on the same weights for the
requests that took fresh slots; the fresh-slot rule (a request that takes
a freed slot gets the tokens it gets alone in a fresh ``Server``, held
against the reference run one request per fresh ``Server``; the reference
itself does not reset a reused slot); and ``main`` on the CPU."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as RArchConfig
from repro.launch.serve import Request as RRequest
from repro.launch.serve import Server as RServer
from repro_torch.configs import ArchConfig, get_arch
from repro_torch.launch import serve
from repro_torch.launch.serve import Request, Server, draw_requests
from repro_torch.models.convert import lm_params_from_reference

# tests/test_system.py::_tiny_cfg
TINY = dict(name="sys-dense", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
            remat=False, dtype="float32")
SLOTS, CONTEXT, MAX_NEW = 2, 64, 8


def _prompts(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 500, 5, dtype=np.int32) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _reference_run():
    """The reference Server over four requests on two slots, and its
    weights as the port's."""
    srv = RServer(RArchConfig(**TINY), slots=SLOTS, context=CONTEXT)
    out = srv.run([RRequest(i, p, MAX_NEW) for i, p in enumerate(_prompts())])
    params = lm_params_from_reference(jax.tree.map(np.asarray, srv.params),
                                      ArchConfig(**TINY), "cpu")
    return out, params


@functools.lru_cache(maxsize=None)
def _reference_alone(i):
    """Request ``i`` alone in a fresh reference Server."""
    srv = RServer(RArchConfig(**TINY), slots=SLOTS, context=CONTEXT)
    return srv.run([RRequest(i, _prompts()[i], MAX_NEW)])[i]


def _port(params, slots=SLOTS):
    return Server(ArchConfig(**TINY), slots=slots, context=CONTEXT,
                  device="cpu", params=params)


def test_serve_loop_generates():
    srv = Server(ArchConfig(**TINY), slots=2, context=64, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(2, 500, 5, dtype=np.int32),
                    max_new=8) for i in range(4)]
    out = srv.run(reqs)
    assert set(out) == {0, 1, 2, 3}
    assert all(len(v) == 8 for v in out.values())
    assert all(0 <= t < srv.lm.vp for v in out.values() for t in v)
    # one step per fed token: 5 prompt tokens and 7 fed outputs, twice
    assert len(srv.step_ms) == 2 * (5 + MAX_NEW - 1)


def test_server_matches_reference_in_fresh_slots():
    """Requests 0 and 1 take the two fresh slots: the port's tokens are
    the reference's."""
    want, params = _reference_run()
    got = _port(params).run([Request(i, p, MAX_NEW)
                             for i, p in enumerate(_prompts())])
    assert set(got) == set(want)
    for i in range(SLOTS):
        assert got[i] == want[i], i


@pytest.mark.parametrize("i", range(4))
def test_fresh_slot_rule_matches_reference_alone(i):
    """Every request, reused slot or not, gets the tokens the reference
    gives it alone in a fresh Server."""
    _, params = _reference_run()
    got = _port(params).run([Request(j, p, MAX_NEW)
                             for j, p in enumerate(_prompts())])
    assert got[i] == _reference_alone(i)


def test_reused_slots_start_fresh():
    """After a run the slots hold stale positions and KV; the next run's
    requests take them fresh and get the first run's tokens again."""
    _, params = _reference_run()
    srv = _port(params)
    reqs = lambda: [Request(j, p, MAX_NEW) for j, p in enumerate(_prompts())]
    first = srv.run(reqs())
    assert srv.cache["pos"].tolist() != [0, 0]
    assert srv.run(reqs()) == first


FAMILIES = {
    "hybrid": dict(family="hybrid", ssm_state=16, ssm_head_dim=16,
                   hybrid_attn_every=2, n_layers=3),
    "xlstm": dict(family="ssm", xlstm_pattern=("m", "s")),
    "ssm": dict(family="ssm", ssm_state=16, ssm_head_dim=16),
    "encdec": dict(family="audio", encoder_layers=2, frontend="audio",
                   frontend_tokens=8),
    "moe": dict(family="moe", moe_experts=4, moe_topk=2,
                moe_capacity_factor=16.0),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fresh_slot_rule_holds_for_every_state(family):
    """The SSM and xLSTM states of a reused slot are zeroed: each request
    of a 1-slot run gets its tokens alone in a fresh Server (MoE with its
    capacity raised, so the slots' tokens do not share experts' room)."""
    cfg = ArchConfig(**dict(TINY, **FAMILIES[family]))
    srv = Server(cfg, slots=1, context=CONTEXT, device="cpu")
    prompts = _prompts(3, seed=5)
    got = srv.run([Request(j, p, 6) for j, p in enumerate(prompts)])
    for j, p in enumerate(prompts):
        alone = Server(cfg, slots=1, context=CONTEXT, device="cpu",
                       params=srv.params)
        assert alone.run([Request(j, p, 6)])[j] == got[j], j


def test_server_stops_at_the_context():
    cfg = ArchConfig(**TINY)
    srv = Server(cfg, slots=1, context=12, device="cpu")
    out = srv.run([Request(0, np.arange(2, 7, dtype=np.int32), 50)])
    # the request is done once its position reaches context - 1
    assert len(out[0]) == 12 - 1 - 5 + 1


def test_draw_requests_matches_the_reference_main():
    rng = np.random.default_rng(0)
    want = [rng.integers(2, 1000, rng.integers(4, 17), dtype=np.int32)
            for _ in range(16)]
    got = draw_requests(1000, 16, 32)
    assert [r.rid for r in got] == list(range(16))
    assert all(np.array_equal(r.prompt, w) and r.max_new == 32
               for r, w in zip(got, want))
    assert all(4 <= len(r.prompt) <= 16 for r in got)


def test_server_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(ArchConfig(**TINY), slots=1, context=8)


def test_main_reduced_on_cpu(capsys):
    serve.main(["--arch", "internlm2-1.8b", "--reduced", "--requests", "3",
                "--max-new", "4", "--slots", "2", "--context", "32",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("served 3 requests, 12 tokens in ")
    assert "on cpu" in out
    assert dataclasses.asdict(get_arch("internlm2-1.8b").reduced())[
        "vocab_size"] == 256


def test_chip_smoke_lm_path_on_cpu(capsys):
    """The chip script's path 4j on the CPU with every architecture
    reduced: the Server's checks (token counts, a second run, the
    fresh-slot rule), each architecture's prefill and decode with their
    repeat checks, the flash prefill against the dense one and the five
    teacher-forced checks, then xlstm-125m in float16; no kernel launches,
    one line per architecture and dtype."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.kernels import _build
    before = dict(_build.LAUNCHES)
    total, scans = chip_smoke.lm_path(
        torch.device("cpu"), serve=dict(slots=2, context=64, requests=4,
                                        max_new=4),
        seq=12, steps=3, reduce=lambda c: c.reduced())
    assert set(total.values()) <= {0} and _build.LAUNCHES == before
    assert not scans
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("[serve-lm] ") for line in lines) == 1
    lm = [line for line in lines if line.startswith("[lm] ")]
    # the ten architectures, then xlstm-125m again in float16
    assert len(lm) == 11
    assert [line for line in lm if "dtype=float16" in line] == [lm[-1]]
    assert "arch=xlstm-125m" in lm[-1]
    assert sum("tf_rel_f32=" in line for line in lm) == 5
    assert all("flash_vs_dense=" in line for line in lm)
    assert "cut=none" in " ".join(lm)


def test_reference_server_reuses_a_stale_slot():
    """The reference's defect the fresh-slot rule avoids (ROADMAP Queue 3
    record 4): on one slot, a second request's tokens do not depend on its
    prompt, because the slot's position is never reset; the port's do."""
    first = np.arange(11, 16, dtype=np.int32)
    ref, port = [], []
    for second in (np.arange(11, 16), np.arange(300, 305)):
        reqs = [(0, first, 4), (1, second.astype(np.int32), 4)]
        srv = RServer(RArchConfig(**TINY), slots=1, context=CONTEXT)
        ref.append(srv.run([RRequest(*r) for r in reqs])[1])
        assert int(np.asarray(srv.cache["pos"])[0]) == 12
        params = lm_params_from_reference(
            jax.tree.map(np.asarray, srv.params), ArchConfig(**TINY), "cpu")
        port.append(_port(params, slots=1).run(
            [Request(*r) for r in reqs])[1])
    assert ref[0] == ref[1] == [253, 253, 253, 103]
    assert port[0] != port[1]
