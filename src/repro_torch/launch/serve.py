"""The sparse-kernel serving fast path.

:class:`SparseKernelServer` is a request queue over ONE lowered sparse
statement: the sparse operand (an attention band mask, an MoE dispatch
matrix) is frozen at construction, and each ``step`` drains the queue into
one bucketized batched SpMM (``core.lower.lower_batched``), so
steady-state serving pays no plan, shard or runner rebuilding: one
host-to-device copy of the stacked requests and one kernel launch a batch.

The LM decode server of the JAX package (``Server``, ``main``) needs the
LM decode step and waits for it (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..runtime import telemetry


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
