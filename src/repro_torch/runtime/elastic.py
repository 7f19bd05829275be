"""Elastic scaling: resize the machine, re-plan, resume.

Every shard layout in this framework is a *pure function* of (global
state, machine) — ``Distribution.plan`` for sparse tensors — so scaling to
a different piece count is: checkpoint → build the new machine → re-derive
the plans → place the host arrays. Global shapes are the interchange
format; no shard-format conversion pass is needed.

:func:`run_with_recovery` is the sparse-kernel realization: an iterative
executor loop wiring the fault harness (:mod:`.fault`), sparse
checkpointing (:mod:`.checkpoint`), and the elastic re-plan
(:func:`repro_torch.core.lower.relower`) together — an injected device loss
restores the newest committed checkpoint, shrinks the machine to P−1,
re-lowers with per-piece shard reuse, and resumes to produce bit for bit
the unfaulted result. The accumulator stays on the kernel's device; only
checkpoints copy it to the host.

The LM half of the reference (``reshard_state``) places parameters with the
parameter planner and waits for it (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def valid_resize(global_batch: int, new_dp: int) -> bool:
    """A resize is legal when the global batch still shards evenly — the
    launcher keeps global batch fixed across resizes so optimization
    dynamics are unchanged."""
    return global_batch % max(new_dp, 1) == 0


def plan_resize(old_mesh_shape: Tuple[int, ...],
                available_chips: int,
                model_axis: int) -> Optional[Tuple[int, ...]]:
    """Pick the largest data axis that fits the surviving chip count,
    keeping the model axis intact (TP degree is architecture-bound)."""
    if available_chips < model_axis:
        return None
    data = available_chips // model_axis
    # keep power-of-two data axes for collective efficiency
    data = 1 << (data.bit_length() - 1)
    return (data, model_axis)


# ---------------------------------------------------------------------------
# Sparse-kernel elastic execution: fault-injected run loop with
# checkpointed recovery and shrink-and-re-plan device-loss handling.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RecoveryReport:
    """What the elastic loop observed and paid: fault trace, recovery wall
    time split (restore / re-plan / re-jit), and the shard-reuse fraction
    of the post-loss re-lower (the elastic claim: ≥ 50% of shard-cache
    lookups hit on a migration-style P→P−1).

    The time split is DERIVED FROM THE TRACE: every recovery phase runs
    inside a ``recovery.restore`` / ``recovery.replan`` / ``recovery.rejit``
    span (recorded on a loop-local tracer and, when enabled, the global
    :data:`repro_torch.runtime.telemetry.TRACER`), and the report sums span
    durations per phase at the end. Phases never nest, so
    ``restore_s + replan_s + rejit_s == recovery_s`` exactly. The rejit
    phase is the first ``run()`` after a re-plan (on the card: its launch
    and the kernel's work, waited for)."""

    steps: int = 0
    restarts: int = 0
    replans: int = 0                 # straggler-weight re-plans
    faults: List[str] = dataclasses.field(default_factory=list)
    healed: List[str] = dataclasses.field(default_factory=list)
    restored_step: Optional[int] = None
    restore_s: float = 0.0
    replan_s: float = 0.0
    rejit_s: float = 0.0
    recovery_s: float = 0.0          # total recovery wall time (all phases)
    shard_reuse: float = 0.0
    initial_pieces: int = 0
    final_pieces: int = 0

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_with_recovery(stmt, machine, steps: int, *, ckpt_dir: str,
                      schedule=None, injector=None, checkpoint_every: int = 1,
                      policy=None, watchdog=None, mitigator=None,
                      keep: int = 3, device=None,
                      ) -> Tuple[torch.Tensor, "RecoveryReport"]:
    """Fault-tolerant iterative executor over one sparse kernel with a
    dense output, on ``device`` (the card when None).

    Runs ``steps`` iterations of ``state += (t+1) · kernel.run()`` (a
    deterministic accumulation whose result is independent of piece count
    for row-family schedules and integer-valued operands — the bit-for-bit
    recovery yardstick), checkpointing the compressed trees + fingerprints
    + accumulator every ``checkpoint_every`` steps through
    :class:`..checkpoint.SparseCheckpoint`. ``state`` stays on the
    kernel's device; every step ends in a device synchronize before the
    watchdog stops, so step times and recovery spans time the card's work.

    Faults come from ``injector`` (:class:`..fault.FaultInjector`):

    - **device loss** — the step raises; ``RestartPolicy`` restarts the
      loop, which restores the newest committed checkpoint, shrinks the
      machine to P−1 (:func:`repro_torch.distributed.mesh.shrink_machine`),
      re-lowers with migration bounds (:func:`repro_torch.core.lower.
      relower`, per-piece shard reuse counted in the report), and resumes.
    - **corruption** — detected by CRC mismatch against the last
      checkpoint before the step runs; the tensor is healed in place and
      the kernel warm re-lowered (every shard a cache hit — the healed
      content fingerprints match the originals).
    - **straggler** — simulated slowdown; watchdog flags feed
      ``StragglerMitigator``; when its report budget trips on an nnz-space
      kernel, the weighted re-plan (``relower(..., weights=)``) rebalances.

    Returns ``(state, report)``.
    """
    from ..core.lower import lower, relower
    from ..distributed.mesh import shrink_machine
    from . import telemetry
    from .checkpoint import SparseCheckpoint
    from .fault import DeviceLoss, RestartPolicy, StepWatchdog

    # Recovery phases are spans on a loop-local always-on tracer (the
    # report is derived from it) AND on the global tracer when the user
    # has tracing enabled.
    trace = telemetry.Tracer(enabled=True)

    @contextlib.contextmanager
    def _phase(name: str, **attrs):
        with contextlib.ExitStack() as st:
            st.enter_context(trace.span(f"recovery.{name}", **attrs))
            st.enter_context(
                telemetry.TRACER.span(f"recovery.{name}", **attrs))
            yield

    policy = policy if policy is not None else RestartPolicy(
        max_restarts=8, backoff_s=0.0, seed=0)
    watchdog = watchdog if watchdog is not None else StepWatchdog(
        threshold=4.0, warmup=1)
    ck = SparseCheckpoint(ckpt_dir, keep=keep)
    tensors: Dict[str, Any] = {}
    for acc in stmt.accesses():
        tensors.setdefault(acc.tensor.name, acc.tensor)

    kernel = lower(stmt, machine, schedule=schedule, elastic=True,
                   device=device)
    dev = kernel.device
    report = RecoveryReport(steps=steps,
                            initial_pieces=kernel.strategy.pieces,
                            final_pieces=kernel.strategy.pieces)
    state = torch.zeros_like(kernel.run())
    ctx = {"kernel": kernel, "machine": machine, "state": state,
           "next": 0, "dead": None, "fresh": False}
    ck.save(0, tensors, {"state": ctx["state"]}, blocking=True)

    def run() -> torch.Tensor:
        out = ctx["kernel"].run()
        _sync(dev)
        return out

    def do_step() -> None:
        t = ctx["next"]
        slowdown = 0.0
        if injector is not None:
            slowdown = injector.before_step(t, tensors)  # may raise DeviceLoss
            bad = ck.stale_operands(tensors)
            if bad:
                report.faults.append("corrupt:" + ",".join(bad))
                with _phase("restore", kind="corruption",
                            tensors=",".join(bad)):
                    ck.restore(tensors, {"state": ctx["state"]})
                report.healed.extend(bad)
                with _phase("replan", kind="corruption"):
                    ctx["kernel"] = relower(ctx["kernel"], ctx["machine"])
        watchdog.start()
        if ctx["fresh"]:
            # first run after a re-plan: the new shards' first use (and a
            # runner build, if the runner cache missed) lands here
            with _phase("rejit", step=t):
                out = run()
            ctx["fresh"] = False
        else:
            out = run()
        if slowdown:
            time.sleep(slowdown)
        flagged = watchdog.stop()
        if (flagged and mitigator is not None and injector is not None
                and injector.slow_piece is not None):
            if (mitigator.report_slow(injector.slow_piece)
                    and ctx["kernel"].strategy.space == "nnz"):
                with _phase("replan", kind="straggler",
                            piece=injector.slow_piece):
                    ctx["kernel"] = relower(ctx["kernel"], ctx["machine"],
                                            weights=mitigator.weights)
                report.replans += 1
        nxt = t + 1
        ctx["state"] = ctx["state"] + nxt * out
        ctx["next"] = nxt
        if nxt % max(checkpoint_every, 1) == 0 or nxt == steps:
            ck.save(nxt, tensors, {"state": ctx["state"]}, blocking=True)

    def step_loop() -> None:
        while ctx["next"] < steps:
            try:
                do_step()
            except DeviceLoss as e:
                ctx["dead"] = e.piece
                report.faults.append(f"device_loss:{e.piece}@{e.step}")
                raise

    def on_restart(n: int) -> None:
        with _phase("restore", kind="restart", restart=n):
            step, extra, info = ck.restore(tensors, {"state": ctx["state"]})
            ctx["state"] = torch.from_numpy(
                np.asarray(extra["state"])).to(dev)
        ctx["next"] = int(step)
        report.restored_step = int(step)
        report.healed.extend(info["restored"])
        dead, ctx["dead"] = ctx["dead"], None
        if dead is not None:
            with _phase("replan", kind="device_loss", piece=dead):
                new_machine = shrink_machine(ctx["machine"])
                ctx["kernel"] = relower(ctx["kernel"], new_machine,
                                        dead=dead)
            ctx["machine"] = new_machine
            report.shard_reuse = ctx["kernel"].cache.shard_reuse
        else:
            with _phase("replan", kind="restart"):
                ctx["kernel"] = relower(ctx["kernel"], ctx["machine"])
        ctx["fresh"] = True

    report.restarts = policy.run_with_restarts(step_loop, on_restart,
                                               sleep=lambda s: None)
    report.final_pieces = ctx["kernel"].strategy.pieces

    # Derive the time split from the trace: per-phase span duration sums.
    # Phases never nest, so the three splits sum exactly to recovery_s.
    durs: Dict[str, float] = {}
    for ev in trace.spans():
        if ev["dur_us"] is not None:
            durs[ev["name"]] = durs.get(ev["name"], 0.0) + ev["dur_us"] / 1e6
    report.restore_s = durs.get("recovery.restore", 0.0)
    report.replan_s = durs.get("recovery.replan", 0.0)
    report.rejit_s = durs.get("recovery.rejit", 0.0)
    report.recovery_s = sum(durs.values())
    return ctx["state"], report
