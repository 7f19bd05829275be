"""Telemetry: span tracing, unified metrics, and byte-ledger verification.

One observability layer for the whole lowering/execution pipeline:

- :class:`Tracer` — a hierarchical span tracer. ``with span("lower.plan",
  sig=...)`` records a timed span nested under whatever span is open on
  the current thread; :meth:`Tracer.export_chrome` writes Chrome
  trace-event JSON loadable in Perfetto / ``chrome://tracing``. The
  module-global :data:`TRACER` starts **disabled**: every instrumentation
  site in ``core.lower`` / ``core.grid`` / ``core.partition`` /
  ``distributed.executor`` / ``runtime.elastic`` then costs one attribute
  read and one branch (the no-op singleton path).

- :class:`MetricsRegistry` — process-wide counters / gauges / histograms
  behind one :meth:`MetricsRegistry.snapshot` API, which also absorbs the
  plan / runner / shard / convert / add-stream / tuned-plan / spmd-run
  cache counters with derived hit rates.

- :func:`verify_byte_ledger` — the model-vs-ledger cross-check: re-derive
  the communication bytes a kernel *should* have charged from the
  statement + strategy alone (``grid.grid_axis_bytes`` for grids, the
  statement-level predictors of :mod:`repro_torch.core.plan_search` for
  1-D) and compare against the ``CommStats`` ledger the lowering
  recorded, per axis. Host work only.

Span taxonomy (dot-namespaced, the same names as the reference):
``lower`` > ``lower.plan`` / ``lower.materialize`` / ``lower.jit`` /
``lower.emit``; ``plan_search.search`` > ``plan_search.measure`` (and
the instant ``plan_search.tuned_cache``); ``partition.materialize``;
``execute.spmd`` / ``execute.piece`` (timed with CUDA events on a card);
``recovery.restore`` / ``recovery.replan`` / ``recovery.rejit``;
``serve.batch``.

CLI smoke (a traced 2x2 grid SpMM on the card, or where ``--device``
says)::

    PYTHONPATH=src python -m repro_torch.runtime.telemetry --smoke \
        --out TRACE_smoke.json [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Tracer", "MetricsRegistry", "TRACER", "METRICS", "span", "instant",
    "validate_chrome_trace", "configure_logging", "verify_byte_ledger",
    "smoke_trace",
]


# ---------------------------------------------------------------------------
# Span tracing
# ---------------------------------------------------------------------------


class _NullSpan:
    """The disabled-tracer span: a shared singleton whose enter/exit/set
    do nothing. ``Tracer.span`` returns it without allocating when
    tracing is off, so instrumentation sites cost one branch."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span. Created only on the enabled path; records itself
    into the owning tracer's event list on exit."""

    __slots__ = ("_tracer", "name", "id", "parent", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.id = 0
        self.parent: Optional[int] = None
        self._t0 = 0.0

    def set(self, **attrs) -> "_Span":
        """Attach attributes discovered after the span opened (e.g. the
        chosen leaf name, a cache-delta)."""
        self.args.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        tr = self._tracer
        stack = tr._stack()
        self.parent = stack[-1].id if stack else None
        with tr._lock:
            tr._seq += 1
            self.id = tr._seq
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        tr._record({
            "name": self.name,
            "id": self.id,
            "parent": self.parent,
            "ts_us": (self._t0 - tr._epoch) * 1e6,
            "dur_us": (t1 - self._t0) * 1e6,
            "tid": threading.get_ident(),
            "args": self.args,
        })
        return False


class Tracer:
    """Thread-safe hierarchical span tracer.

    Parentage is tracked per thread (a thread-local span stack) and
    recorded by span *id* at open time — a parent span finishes after its
    children, so positional references cannot work. Disabled tracers
    return the shared no-op span from :meth:`span` and record nothing.
    """

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._local = threading.local()
        self._events: List[Dict[str, Any]] = []
        self._seq = 0
        self._epoch = time.perf_counter()

    # -- control ----------------------------------------------------------
    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self._seq = 0
            self._epoch = time.perf_counter()

    # -- recording --------------------------------------------------------
    def _stack(self) -> List[_Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _record(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(ev)

    def span(self, name: str, **attrs):
        """Open a timed span: ``with tracer.span("lower.plan", sig=s):``.
        Returns the no-op singleton when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def instant(self, name: str, **attrs) -> None:
        """A zero-duration marker event (cache hit/miss, fault, …)."""
        if not self.enabled:
            return
        stack = self._stack()
        self._record({
            "name": name,
            "id": None,
            "parent": stack[-1].id if stack else None,
            "ts_us": (time.perf_counter() - self._epoch) * 1e6,
            "dur_us": None,
            "tid": threading.get_ident(),
            "args": attrs,
        })

    # -- inspection -------------------------------------------------------
    def spans(self) -> List[Dict[str, Any]]:
        """Finished events, oldest first (instants have ``dur_us=None``)."""
        with self._lock:
            return list(self._events)

    def call_tree(self) -> List[Dict[str, Any]]:
        """Reconstruct span nesting from recorded parent ids: a forest of
        ``{"name", "dur_us", "args", "children": [...]}`` nodes."""
        nodes: Dict[int, Dict[str, Any]] = {}
        roots: List[Dict[str, Any]] = []
        spans = [e for e in self.spans() if e["id"] is not None]
        for ev in spans:
            nodes[ev["id"]] = {"name": ev["name"], "dur_us": ev["dur_us"],
                               "args": ev["args"], "children": []}
        for ev in spans:
            node = nodes[ev["id"]]
            parent = nodes.get(ev["parent"]) if ev["parent"] else None
            (parent["children"] if parent else roots).append(node)
        for n in nodes.values():
            n["children"].sort(key=lambda c: c["dur_us"] or 0, reverse=True)
        return roots

    # -- export -----------------------------------------------------------
    def export_chrome(self, path: str) -> str:
        """Write the Chrome trace-event JSON (``{"traceEvents": [...]}``,
        "X" complete events in µs) — open in Perfetto (ui.perfetto.dev)
        or ``chrome://tracing``. Returns ``path``."""
        pid = os.getpid()
        out = []
        for ev in self.spans():
            args = {k: _jsonable(v) for k, v in ev["args"].items()}
            if ev["id"] is not None:
                args["span_id"] = ev["id"]
                if ev["parent"] is not None:
                    args["parent_id"] = ev["parent"]
            rec = {"name": ev["name"], "pid": pid, "tid": ev["tid"],
                   "ts": round(ev["ts_us"], 3), "args": args}
            if ev["dur_us"] is None:
                rec.update(ph="i", s="t")
            else:
                rec.update(ph="X", dur=round(ev["dur_us"], 3))
            out.append(rec)
        payload = {"traceEvents": out,
                   "displayTimeUnit": "ms",
                   "otherData": {"tool": "repro_torch.runtime.telemetry"}}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=1)
        return path


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


#: The process-wide tracer every instrumentation site records into.
#: Disabled by default — ``TRACER.enable()`` to start collecting.
TRACER = Tracer(enabled=False)


def span(name: str, **attrs):
    """Module-level convenience: a span on the global :data:`TRACER`."""
    return TRACER.span(name, **attrs)


def instant(name: str, **attrs) -> None:
    """Module-level convenience: an instant on the global :data:`TRACER`."""
    TRACER.instant(name, **attrs)


def overlap_report(tracer: "Tracer" = None) -> Dict[str, Any]:
    """Roll up comm/compute-overlap attribution from recorded spans.

    The overlapped executor (``distributed.executor.run_overlapped``)
    emits one ``execute.overlap.chunk`` instant per dense-operand chunk
    with ``comm_s`` (issue→ready transfer wall time), ``hidden_s`` (the
    slice of that window spent under the previous chunk's compute), and
    ``bytes``. This derives the summary:
    ``efficiency = sum(hidden_s) / sum(comm_s)`` — the fraction of
    transfer time the pipeline hid behind leaf kernels (0.0 when nothing
    overlapped or tracing was disabled)."""
    tracer = tracer or TRACER
    chunks = [e for e in tracer.spans()
              if e["name"] == "execute.overlap.chunk"]
    comm_s = sum(float(e["args"].get("comm_s", 0.0)) for e in chunks)
    hidden_s = sum(float(e["args"].get("hidden_s", 0.0)) for e in chunks)
    nbytes = sum(int(e["args"].get("bytes", 0)) for e in chunks)
    return {
        "chunks": len(chunks),
        "comm_s": comm_s,
        "hidden_s": hidden_s,
        "bytes": nbytes,
        "efficiency": (hidden_s / comm_s) if comm_s > 0 else 0.0,
    }


def validate_chrome_trace(path: str,
                          require: Sequence[str] = ()) -> Dict[str, int]:
    """Load and structurally validate an exported trace. Asserts the
    trace-event envelope, event field types, and that every name in
    ``require`` appears at least once. Returns name → occurrence count."""
    with open(path) as fh:
        payload = json.load(fh)
    assert isinstance(payload, dict) and "traceEvents" in payload, \
        f"{path}: not a Chrome trace-event JSON object"
    events = payload["traceEvents"]
    assert isinstance(events, list) and events, f"{path}: no traceEvents"
    counts: Dict[str, int] = {}
    for ev in events:
        assert isinstance(ev.get("name"), str), f"bad event name: {ev!r}"
        assert ev.get("ph") in ("X", "i"), f"bad phase: {ev!r}"
        assert isinstance(ev.get("ts"), (int, float)), f"bad ts: {ev!r}"
        assert isinstance(ev.get("pid"), int) and isinstance(
            ev.get("tid"), int), f"bad pid/tid: {ev!r}"
        if ev["ph"] == "X":
            assert isinstance(ev.get("dur"), (int, float)) \
                and ev["dur"] >= 0, f"bad dur: {ev!r}"
        counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    missing = [n for n in require if n not in counts]
    assert not missing, (
        f"{path}: required span names missing from trace: {missing}; "
        f"present: {sorted(counts)}")
    return counts


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

#: (snapshot key, module, attribute) for every pre-existing cache-stats
#: dict. Read through sys.modules so the registry never forces an import
#: (and never creates a cycle — telemetry is imported BY these modules).
_CACHE_SOURCES: Tuple[Tuple[str, str, str], ...] = (
    ("plan", "repro_torch.core.lower", "PLAN_CACHE_STATS"),
    ("runner", "repro_torch.core.lower", "RUNNER_CACHE_STATS"),
    ("shard", "repro_torch.core.partition", "SHARD_CACHE_STATS"),
    ("convert", "repro_torch.core.partition", "CONVERT_CACHE_STATS"),
    ("add_stream", "repro_torch.core.partition", "ADD_STREAM_STATS"),
    ("tuned_plan", "repro_torch.core.plan_search", "TUNED_PLAN_CACHE_STATS"),
    ("spmd_run", "repro_torch.distributed.executor", "SPMD_RUN_STATS"),
)


class MetricsRegistry:
    """Counters, gauges, and histograms behind one lock and one
    :meth:`snapshot`. Histogram observations are kept raw (bounded use:
    per-piece timings, per-axis bytes) and summarized at snapshot time."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, List[float]] = {}

    def counter(self, name: str, inc: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + inc

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._hists.setdefault(name, []).append(float(value))

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    @staticmethod
    def cache_stats() -> Dict[str, Dict[str, Any]]:
        """Hit/miss (+ derived hit rate) for every registered cache whose
        module is already imported."""
        out: Dict[str, Dict[str, Any]] = {}
        for key, mod_name, attr in _CACHE_SOURCES:
            mod = sys.modules.get(mod_name)
            stats = getattr(mod, attr, None) if mod else None
            if not isinstance(stats, dict):
                continue
            h, m = int(stats.get("hits", 0)), int(stats.get("misses", 0))
            entry: Dict[str, Any] = {"hits": h, "misses": m,
                                     "hit_rate": h / (h + m) if h + m else
                                     None}
            if "evictions" in stats:
                entry["evictions"] = int(stats["evictions"])
            out[key] = entry
        return out

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-ready structure: counters, gauges, histogram
        summaries (count/min/max/mean/p50/p90/total), cache hit rates."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: list(v) for k, v in self._hists.items()}
        summaries = {}
        for name, vals in hists.items():
            a = np.asarray(vals, dtype=np.float64)
            summaries[name] = {
                "count": int(a.size),
                "min": float(a.min()),
                "max": float(a.max()),
                "mean": float(a.mean()),
                "p50": float(np.percentile(a, 50)),
                "p90": float(np.percentile(a, 90)),
                "total": float(a.sum()),
            }
        return {"counters": counters, "gauges": gauges,
                "histograms": summaries, "caches": self.cache_stats()}


#: The process-wide registry every instrumentation site records into.
METRICS = MetricsRegistry()


def configure_logging(level: int = logging.INFO) -> logging.Logger:
    """Configure the ``repro_torch`` logger hierarchy in one call. Every
    module logs under ``__name__`` (``repro_torch.core.lower``, …), so a
    level + a handler on the ``repro_torch`` root covers the whole
    package. Idempotent — an existing handler is kept, only the level
    changes."""
    root = logging.getLogger("repro_torch")
    root.setLevel(level)
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)-7s %(name)s: %(message)s"))
        root.addHandler(h)
    return root


# ---------------------------------------------------------------------------
# Byte-ledger verification
# ---------------------------------------------------------------------------


def _flat_predicted_bytes(kernel) -> Tuple[int, int]:
    """(replicate, reduce) bytes a 1-D (or per-color grid-nnz) lowering of
    ``kernel.stmt`` must charge, re-derived from the statement + plans —
    independent of the running totals ``_lower_impl`` accumulated."""
    from ..core import lower as L
    from ..core import plan_search as PS

    stmt, strat = kernel.stmt, kernel.strategy
    sig = stmt.signature()

    if (sig, strat.space) in L._SELF_MATERIALIZING:
        # spadd3/nnz: whole concatenated entry stream ships to the root —
        # coords+vals per scalar entry, coords + a (br, bc) tile per block.
        seen, n_entries, tile = set(), 0, 0
        for acc in stmt.rhs.accesses():
            t = acc.tensor
            if t.format.is_sparse and t.name not in seen:
                seen.add(t.name)
                n_entries += int(t.vals.shape[0])
                if t.format.is_blocked:
                    tile = int(np.prod(t.format.block_shape))
        red = n_entries * (8 + tile * 4) if tile else n_entries * 12
        return 0, red

    if strat.space == "universe":
        rep = sum(L._nbytes(t) for t in PS._replicated_universe(stmt))
        return int(rep), 0

    # nnz space: operands replicate, output partials reduce
    rep_ts, out_partitioned = PS._replicated_nnz(stmt)
    rep = sum(L._nbytes(t) for t in rep_ts)
    out_t = stmt.lhs.tensor
    if not out_partitioned and not L._output_is_assembled(sig):
        # _compute_plans replicates the dense output when its leading
        # variable is not the position tensor's root variable (CSC/BCSC)
        rep += L._nbytes(out_t)
    ov = kernel.plans[next(iter(kernel.plans))]   # position-tensor plan
    if ov.tensor.format.dim_of_level(0) != 0:
        red = L._nbytes(out_t)                    # full-extent partials
    elif ov.tensor.format.is_blocked:
        bb = ov.levels[0].coord_bounds
        br = ov.tensor.format.block_shape[0]
        red = int((bb[:, 1] - bb[:, 0]).sum()
                  - (bb[:, 1].max() - bb[:, 0].min())) * br * 4
    else:
        rb = ov.root_coord_bounds
        red = int((rb[:, 1] - rb[:, 0]).sum()
                  - (rb[:, 1].max() - rb[:, 0].min())) * 4
    return int(rep), int(red)


def verify_byte_ledger(kernel) -> Dict[str, Any]:
    """Cross-check the kernel's recorded :class:`~repro_torch.core.lower.
    CommStats` ledger against statement-level model predictions, per
    machine axis. Covers replicate/broadcast and reduce bytes (the model
    has no view of ``redistribute_bytes`` — a property of the *data*
    distribution, not the schedule). Raises ``AssertionError`` on any
    mismatch; returns the check report."""
    from ..core import grid as grid_mod

    stmt, strat, comm = kernel.stmt, kernel.strategy, kernel.comm
    checks: List[Dict[str, Any]] = []

    def chk(field: str, axis: Optional[str], pred: int, ledger: int) -> None:
        checks.append({"field": field, "axis": axis, "predicted": int(pred),
                       "ledger": int(ledger), "ok": int(pred) == int(ledger)})

    if strat.is_grid and strat.space == "universe":
        model = grid_mod.grid_axis_bytes(stmt, strat)
        assert set(model) == set(comm.axes), (
            f"axis sets differ: model {sorted(model)} "
            f"vs ledger {sorted(comm.axes)}")
        for name in model:
            chk("broadcast", name, model[name].broadcast_bytes,
                comm.axes[name].broadcast_bytes)
            chk("reduce", name, model[name].reduce_bytes,
                comm.axes[name].reduce_bytes)
    elif strat.is_grid:
        # grid nnz: flat prediction re-attributed hierarchically in grid
        # order — the same collective model _lower_impl applies.
        rep, red = _flat_predicted_bytes(kernel)
        m = 1
        for d in strat.machine_dims:
            ax = comm.axes[d.name]
            chk("broadcast", d.name, m * rep, ax.broadcast_bytes)
            chk("reduce", d.name, m * red, ax.reduce_bytes)
            m *= d.size
    else:
        rep, red = _flat_predicted_bytes(kernel)
        chk("replicate", None, rep, comm.replicate_bytes)
        chk("reduce", None, red, comm.reduce_bytes)

    report = {"cell": kernel.cell_id(), "checks": checks,
              "ok": all(c["ok"] for c in checks)}
    bad = [c for c in checks if not c["ok"]]
    assert not bad, (
        f"byte-ledger mismatch for {kernel.cell_id()}: " + "; ".join(
            f"{c['field']}" + (f"[{c['axis']}]" if c["axis"] else "")
            + f" predicted={c['predicted']} ledger={c['ledger']}"
            for c in bad))
    return report


# ---------------------------------------------------------------------------
# Smoke trace — a traced 2-D grid SpMM lower + execute
# ---------------------------------------------------------------------------


def smoke_trace(out_path: str, n: int = 512, m: int = 512, j: int = 16,
                device=None) -> Dict[str, int]:
    """Lower + execute one SpMM on a 2x2 machine grid on ``device`` (the
    card when None) with tracing on, profile per-piece kernel times
    (CUDA events on a card), verify the byte ledger, export the Chrome
    trace, and validate it. Returns the span-name counts."""
    import repro_torch.core as tc
    from repro_torch.core.lower import (clear_lowering_caches,
                                        default_grid_schedule, lower)
    from repro_torch.distributed.executor import profile_pieces

    rng = np.random.default_rng(0)
    dB = ((rng.random((n, m)) < 0.05)
          * rng.standard_normal((n, m))).astype(np.float32)
    B = tc.Tensor.from_dense("B", dB, tc.CSR())
    C = tc.Tensor.from_dense(
        "C", rng.standard_normal((m, j)).astype(np.float32))
    stmt = tc.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                        A=tc.Tensor.zeros_dense("A", (n, j)), B=B, C=C)
    machine = tc.Machine(("x", 2), ("y", 2))

    clear_lowering_caches()
    TRACER.clear()
    TRACER.enable()
    try:
        kernel = lower(stmt, machine,
                       schedule=default_grid_schedule(stmt, machine),
                       device=device)
        with TRACER.span("execute", leaf=kernel.leaf_name):
            kernel.run()
            if kernel.device.type == "cuda":
                import torch
                torch.cuda.synchronize(kernel.device)
        prof = profile_pieces(kernel, iters=2, warmup=1)
        verify_byte_ledger(kernel)
    finally:
        TRACER.disable()
    TRACER.export_chrome(out_path)
    counts = validate_chrome_trace(out_path, require=(
        "lower", "lower.plan", "lower.materialize", "lower.jit",
        "execute", "execute.piece"))
    assert counts["execute.piece"] >= kernel.strategy.pieces, (
        f"expected per-piece timings for all {kernel.strategy.pieces} "
        f"pieces, saw {counts['execute.piece']} execute.piece spans")
    assert prof.seconds.shape[0] == kernel.strategy.pieces
    return counts


def _main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.telemetry",
        description="telemetry utilities (smoke trace / trace validation)")
    ap.add_argument("--smoke", action="store_true",
                    help="run a traced 2-D grid SpMM lower+execute")
    ap.add_argument("--out", default="TRACE_smoke.json",
                    help="trace output path (with --smoke)")
    ap.add_argument("--device", default=None,
                    help="where --smoke runs (default: the card; 'cpu' "
                    "for the plain PyTorch path)")
    ap.add_argument("--validate", metavar="TRACE",
                    help="validate an existing Chrome trace JSON")
    args = ap.parse_args(argv)
    if args.validate:
        counts = validate_chrome_trace(args.validate)
        print(json.dumps(counts, indent=2, sort_keys=True))
        return 0
    if args.smoke:
        counts = smoke_trace(args.out, device=args.device)
        print(f"wrote {args.out}")
        print(json.dumps(counts, indent=2, sort_keys=True))
        return 0
    ap.error("nothing to do: pass --smoke or --validate")
    return 2


if __name__ == "__main__":
    # `python -m repro_torch.runtime.telemetry` executes this file as
    # __main__, a SECOND module instance whose TRACER is not the one the
    # pipeline's `from ..runtime import telemetry` records into —
    # delegate to the canonical instance so --smoke traces the real
    # global tracer.
    import repro_torch.runtime.telemetry as _canonical
    raise SystemExit(_canonical._main())
