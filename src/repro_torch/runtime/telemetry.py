"""Telemetry: span tracing and unified metrics.

The tracer and metrics half of the JAX package's telemetry layer:

- :class:`Tracer` — a hierarchical span tracer. ``with span("lower.plan",
  sig=...)`` records a timed span nested under whatever span is open on
  the current thread. The module-global :data:`TRACER` starts
  **disabled**: every instrumentation site in ``core.lower`` /
  ``core.partition`` then costs one attribute read and one branch (the
  no-op singleton path).

- :class:`MetricsRegistry` — process-wide counters / gauges / histograms
  behind one :meth:`MetricsRegistry.snapshot` API, which also absorbs the
  plan / runner / shard / convert cache counters with derived hit rates.

Span taxonomy (dot-namespaced, the same names as the reference):
``lower`` > ``lower.plan`` / ``lower.materialize`` / ``lower.jit`` /
``lower.emit``; ``partition.materialize``. Chrome trace export and the
byte-ledger verifier are not ported yet.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "Tracer", "MetricsRegistry", "TRACER", "METRICS", "span", "instant",
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
