"""Serving: the LM decode loop with continuous-batching slots, and the
sparse-kernel serving fast path.

:class:`Server` is the LM decode loop: fixed slots over one decode cache
on one card, every step one ``LM.decode_step`` over all slots, the argmax
taken on the card and one host sync a step. A queued request that takes a
freed slot finds that slot fresh (position 0, SSM and xLSTM states zero),
so its tokens do not depend on which request the slot served before.

:class:`SparseKernelServer` is a request queue over ONE lowered sparse
statement: the sparse operand (an attention band mask, an MoE dispatch
matrix) is frozen at construction, and each ``step`` drains the queue into
one bucketized batched SpMM (``core.lower.lower_batched``), so
steady-state serving pays no plan, shard or runner rebuilding: one
host-to-device copy of the stacked requests and one kernel launch a batch.

A small end-to-end run on the card (``--device cpu`` for the CPU)::

    python -m repro_torch.launch.serve --arch internlm2-1.8b --reduced \
        --requests 8 --max-new 32
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig, get_arch
from ..core.device import resolve_device
from ..models.model import LM
from ..runtime import telemetry


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) integer token ids
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Server:
    """Fixed-slot continuous batching on ``device`` (None: the card): up to
    ``slots`` concurrent requests share one decode cache of ``context``
    positions (``window`` > 0: a ring buffer of that many); finished
    requests free their slot for the queue.

    The model is ``LM(cfg)`` unsharded, its weights ``params`` or, by
    default, drawn from a ``torch.Generator`` seeded with 0 on the
    device. ``cfg`` is served as given (``param_dtype="bfloat16"`` for bf16
    weights). A prompt is fed one token a step through the decode step, as
    the reference feeds it. ``step_ms`` holds each step's host-clock time,
    from its tokens to its argmax on the host."""

    def __init__(self, cfg: ArchConfig, *, slots: int = 8,
                 context: int = 512, window: int = 0, device=None,
                 params=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lm = LM(cfg)
        self.context = context
        self.window = window
        self.params = (params if params is not None else
                       self.lm.init_params(
                           torch.Generator(self.device).manual_seed(0),
                           self.device))
        self.cache = self.lm.init_cache(
            slots, context, window=window,
            src_len=cfg.frontend_tokens if cfg.is_encdec else 0,
            device=self.device)
        self.slots: List[Optional[Request]] = [None] * slots
        self.pos = np.zeros(slots, np.int64)     # the cache's pos, on the host
        self.step_ms: List[float] = []

    def _take(self, i: int, r: Request) -> None:
        """Slot ``i`` takes request ``r``, fresh."""
        self.slots[i] = r
        self.lm.reset_slot(self.cache, i)
        self.pos[i] = 0

    def _feed_tokens(self) -> np.ndarray:
        toks = np.zeros(len(self.slots), np.int64)
        for i, r in enumerate(self.slots):
            if r is None or r.done:
                continue
            if self.pos[i] < len(r.prompt):
                toks[i] = r.prompt[self.pos[i]]
            elif r.out:
                toks[i] = r.out[-1]
        return toks

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        queue = list(requests)
        with torch.inference_mode():
            while queue or any(r is not None and not r.done
                               for r in self.slots):
                for i, r in enumerate(self.slots):
                    if (r is None or r.done) and queue:
                        self._take(i, queue.pop(0))
                t0 = time.perf_counter()
                toks = torch.from_numpy(self._feed_tokens()).to(self.device)
                logits, self.cache = self.lm.decode_step(
                    self.params, self.cache, toks, window=self.window)
                nxt = logits.argmax(-1).cpu().numpy()   # the step's one sync
                self.step_ms.append((time.perf_counter() - t0) * 1e3)
                self.pos += 1
                for i, r in enumerate(self.slots):
                    if r is None or r.done:
                        continue
                    if self.pos[i] >= len(r.prompt):     # generation phase
                        r.out.append(int(nxt[i]))
                        if len(r.out) >= r.max_new or \
                                self.pos[i] >= self.context - 1:
                            r.done = True
        return {r.rid: r.out for r in requests}


def draw_requests(vocab_size: int, n: int, max_new: int) -> List[Request]:
    """``n`` requests with prompts of 4-16 token ids in [2, vocab_size),
    drawn as the reference's ``main`` draws them (numpy seed 0)."""
    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt=rng.integers(2, vocab_size, rng.integers(4, 17),
                                        dtype=np.int32),
                    max_new=max_new)
            for i in range(n)]


@dataclasses.dataclass
class KernelRequest:
    """One queued sparse-kernel request: a dense RHS vector (or fixed-width
    panel) against the server's frozen sparse operand."""
    rid: int
    rhs: np.ndarray
    t_submit: float
    result: Optional[torch.Tensor] = None
    latency_s: Optional[float] = None


class SparseKernelServer:
    """Request batching over one lowered sparse statement, on ``device``
    (the card when None).

    ``submit`` enqueues a per-request RHS (a host array); ``step`` drains up
    to ``max_batch`` requests into one ``run_many`` call — requests share
    the plan, the sparse shards on the device, and (per batch bucket) the
    runner. A request's latency runs from ``submit`` to its batch's result
    being ready on the device. Queue depth, per-request latency and SLO
    attainment land in ``METRICS`` under ``serve.*`` (occupancy and padding
    come from ``BatchedKernel.run_many`` itself), rendered by
    ``launch/report.py --telemetry``.

    ``schedule`` / ``buckets`` / ``mesh`` pass straight through to
    :func:`repro_torch.core.lower.lower_batched`; ``slo_ms`` arms the
    ``serve.slo_violations`` counter and the attainment stat.
    """

    def __init__(self, stmt, machine, schedule: Any = None, *,
                 max_batch: int = 8, buckets=None, slo_ms: float = None,
                 mesh: Any = None, device=None):
        from ..core.cache import BATCH_BUCKETS
        from ..core.lower import BatchedKernel
        self.kernel = BatchedKernel(
            stmt, machine, schedule,
            buckets=BATCH_BUCKETS if buckets is None else buckets,
            mesh=mesh, device=device).warm(max_batch)
        self.device = self.kernel.device
        self.max_batch = int(max_batch)
        self.slo_ms = slo_ms
        self.queue: "deque[KernelRequest]" = deque()
        self.done: Dict[int, KernelRequest] = {}
        self.latencies_ms: List[float] = []
        self._next_rid = 0

    def submit(self, rhs) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(KernelRequest(rid, np.asarray(rhs, np.float32),
                                        time.perf_counter()))
        telemetry.METRICS.gauge("serve.queue_depth", float(len(self.queue)))
        return rid

    def step(self) -> int:
        """Serve one batch off the queue; returns how many were served."""
        if not self.queue:
            return 0
        take = min(self.max_batch, len(self.queue))
        batch = [self.queue.popleft() for _ in range(take)]
        outs = self.kernel.run_many([r.rhs for r in batch])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        for r, y in zip(batch, outs):
            r.result = y
            r.latency_s = now - r.t_submit
            ms = r.latency_s * 1e3
            self.latencies_ms.append(ms)
            telemetry.METRICS.observe("serve.latency_ms", ms)
            if self.slo_ms is not None and ms > self.slo_ms:
                telemetry.METRICS.counter("serve.slo_violations")
            self.done[r.rid] = r
        telemetry.METRICS.gauge("serve.queue_depth", float(len(self.queue)))
        return take

    def drain(self) -> int:
        served = 0
        while self.queue:
            served += self.step()
        return served

    def result(self, rid: int) -> torch.Tensor:
        return self.done[rid].result

    def stats(self) -> Dict[str, float]:
        """p50/p99 latency + SLO attainment over everything served."""
        lat = np.asarray(self.latencies_ms, np.float64)
        if lat.size == 0:
            return {"served": 0}
        out = {"served": int(lat.size),
               "p50_ms": float(np.percentile(lat, 50)),
               "p99_ms": float(np.percentile(lat, 99)),
               "max_ms": float(lat.max())}
        if self.slo_ms is not None:
            out["slo_ms"] = float(self.slo_ms)
            out["slo_attainment"] = float((lat <= self.slo_ms).mean())
        return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--context", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    reqs = draw_requests(cfg.vocab_size, args.requests, args.max_new)
    srv = Server(cfg, slots=args.slots, context=args.context,
                 device=args.device)
    t0 = time.time()
    out = srv.run(reqs)
    dt = time.time() - t0
    total = sum(len(v) for v in out.values())
    print(f"served {len(out)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s) on {srv.device}")


if __name__ == "__main__":
    main()
