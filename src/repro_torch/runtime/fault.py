"""Fault tolerance: restart policy, step watchdog, straggler mitigation.

At 1000+ nodes, node failure is routine and stragglers dominate tail step
time. The pieces here are host-side (framework) logic; the device-side
counterpart is that every step is a pure function of (state, batch) so any
step can be replayed from the last checkpoint.

- :class:`RestartPolicy` — exponential-backoff restart budget; the train
  launcher wraps its step loop with `run_with_restarts`.
- :class:`StepWatchdog` — per-step wall-time tracker; flags steps beyond
  k·median as straggler events.
- :class:`StragglerMitigator` — converts repeated straggler flags into a
  *re-plan*: the paper's own weighted non-zero partitioning, reused on the
  training system itself. A slow shard gets proportionally fewer non-zeros
  (sparse workloads) or a smaller microbatch slice (dense workloads).
- :class:`FaultInjector` — deterministic fault simulation (device loss,
  shard corruption, straggler slowdown) at configurable steps of a run
  loop; drives the three mechanisms above against sparse kernels in
  :func:`repro_torch.runtime.elastic.run_with_recovery` and the elastic
  tests.

Host-side logic only (numpy): the operands' storage stays on the host in
the port too, so corruption perturbs it in place exactly as the reference
does, and the next content fingerprint detects it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class RestartPolicy:
    """Exponential-backoff restart budget.

    ``jitter`` spreads each delay uniformly over ``±jitter`` of its
    nominal value so a fleet restarting off the same failure doesn't
    thunder back in lockstep; ``seed`` makes the spread reproducible.
    A zero base delay stays zero (jitter is multiplicative)."""

    max_restarts: int = 100
    backoff_s: float = 1.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 300.0
    jitter: float = 0.1
    seed: Optional[int] = None

    def run_with_restarts(self, step_loop: Callable[[], None],
                          on_restart: Optional[Callable[[int], None]] = None,
                          sleep=time.sleep) -> int:
        """Run ``step_loop`` until it completes; on exception restore from
        the latest checkpoint via ``on_restart`` and retry with backoff.
        Returns the number of restarts used."""
        restarts = 0
        delay = self.backoff_s
        rng = np.random.default_rng(self.seed)
        while True:
            try:
                step_loop()
                return restarts
            except KeyboardInterrupt:
                raise
            except Exception:  # noqa: BLE001 — any step failure is retriable
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                if on_restart is not None:
                    on_restart(restarts)
                scale = max(0.0, 1.0 + self.jitter * rng.uniform(-1.0, 1.0))
                sleep(min(delay, self.backoff_max_s) * scale)
                delay *= self.backoff_factor


class StepWatchdog:
    """Flags straggling steps: wall time > threshold × running median.

    ``warmup`` is the number of recorded steps required before any step
    can be flagged — the first few samples (compile, cache warm-up) would
    otherwise poison the median and mark ordinary steps as stragglers."""

    def __init__(self, threshold: float = 2.0, window: int = 50,
                 warmup: int = 5):
        self.threshold = threshold
        self.window = window
        self.warmup = max(int(warmup), 1)
        self.times: List[float] = []
        self.straggler_steps: List[int] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self) -> bool:
        """Returns True if this step straggled."""
        assert self._t0 is not None
        dt = time.monotonic() - self._t0
        self._t0 = None
        self._step += 1
        is_straggler = False
        if len(self.times) >= self.warmup:
            med = float(np.median(self.times[-self.window:]))
            is_straggler = dt > self.threshold * med
        if is_straggler:
            self.straggler_steps.append(self._step)
        self.times.append(dt)
        return is_straggler

    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


class StragglerMitigator:
    """Persistent-straggler response: weighted re-partitioning.

    Tracks per-shard slowness reports; when a shard exceeds the report
    budget, emits new partition weights (slow shard gets less work). For
    sparse workloads these weights feed ``weighted_nonzero_bounds`` — the
    paper's non-zero partition generalized to heterogeneous shard speeds.
    """

    def __init__(self, n_shards: int, report_budget: int = 3,
                 slowdown_discount: float = 0.5):
        self.n = n_shards
        self.budget = report_budget
        self.discount = slowdown_discount
        self.reports = np.zeros(n_shards, dtype=np.int64)
        self.weights = np.ones(n_shards, dtype=np.float64)

    def report_slow(self, shard: int) -> bool:
        """Returns True when a re-plan is warranted."""
        self.reports[shard] += 1
        if self.reports[shard] >= self.budget:
            self.weights[shard] *= self.discount
            self.reports[shard] = 0
            self.weights /= self.weights.mean()
            return True
        return False

    def weighted_nonzero_bounds(self, nnz: int) -> np.ndarray:
        """(P, 2) position bounds proportional to shard weights — the
        weighted generalization of partition_nonzeros."""
        frac = self.weights / self.weights.sum()
        ends = np.floor(np.cumsum(frac) * nnz).astype(np.int64)
        ends[-1] = nnz
        starts = np.concatenate([[0], ends[:-1]])
        return np.stack([starts, ends], axis=1)


# ---------------------------------------------------------------------------
# Fault injection — deterministic failure simulation for the elastic loop
# ---------------------------------------------------------------------------


class DeviceLoss(RuntimeError):
    """A simulated device (piece) disappearing mid-run. Raised by
    :class:`FaultInjector`; :func:`..elastic.run_with_recovery` catches it,
    records the dead piece, and restarts on a shrunk machine."""

    def __init__(self, piece: int, step: int):
        super().__init__(f"device loss: piece {piece} at step {step}")
        self.piece = piece
        self.step = step


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault. ``kind`` ∈ {"device_loss", "corrupt",
    "straggler"}: device loss raises :class:`DeviceLoss` (piece ``piece``
    dies), corrupt perturbs the named tensor's values in place (detected
    downstream by content fingerprint against the last checkpoint),
    straggler reports a simulated per-step slowdown attributed to
    ``piece``. ``once`` events fire at most one time — a restarted loop
    replaying the same step does not re-fault."""

    step: int
    kind: str
    piece: int = 0
    tensor: Optional[str] = None
    slowdown_s: float = 0.0
    once: bool = True
    fired: int = 0


class FaultInjector:
    """Replays a list of :class:`FaultEvent` at configured steps.

    Call :meth:`before_step` at the top of each loop iteration with the
    live tensor map. Corruption mutates storage immediately; stragglers
    return the accumulated slowdown (seconds) the caller should simulate
    and record the slow piece in ``slow_piece``; device loss raises.
    ``log`` keeps a human-readable trace of everything that fired."""

    def __init__(self, events, seed: int = 0):
        self.events: List[FaultEvent] = list(events)
        self.rng = np.random.default_rng(seed)
        self.log: List[str] = []
        self.slow_piece: Optional[int] = None

    def before_step(self, step: int, tensors: Dict[str, object]) -> float:
        slowdown = 0.0
        self.slow_piece = None
        for ev in self.events:
            if ev.step != step or (ev.once and ev.fired):
                continue
            ev.fired += 1
            if ev.kind == "corrupt":
                if ev.tensor not in tensors:
                    raise KeyError(f"corrupt event names unknown tensor "
                                   f"{ev.tensor!r}")
                self._corrupt(tensors[ev.tensor])
                self.log.append(f"corrupt:{ev.tensor}@{step}")
            elif ev.kind == "straggler":
                slowdown += float(ev.slowdown_s)
                self.slow_piece = ev.piece
                self.log.append(f"straggler:{ev.piece}@{step}")
            elif ev.kind == "device_loss":
                self.log.append(f"device_loss:{ev.piece}@{step}")
                raise DeviceLoss(ev.piece, step)
            else:
                raise ValueError(f"unknown fault kind {ev.kind!r}")
        return slowdown

    def _corrupt(self, tensor) -> None:
        """Flip one stored value in place — the bit-rot analog. The next
        fingerprint of the tensor no longer matches the checkpointed one,
        which is exactly how real recovery detects silent corruption."""
        vals = np.asarray(tensor.vals).reshape(-1)
        if not vals.size:
            return
        idx = int(self.rng.integers(0, vals.size))
        vals[idx] = vals[idx] + 1.0
