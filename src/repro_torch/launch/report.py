"""Render telemetry snapshots as markdown (:func:`telemetry_table`): the
view of ``repro_torch.runtime.telemetry.METRICS.snapshot()``.

    python -m repro_torch.launch.report --telemetry SNAPSHOT.json

The dry-run roofline tables of the JAX package's ``launch/report.py``
(``load``, ``table``, ``summary``) read the dry-run records, which wait for
the LM stack (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def _fmt_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"


def telemetry_table(snapshot: dict) -> str:
    """Markdown render of a ``MetricsRegistry.snapshot()`` (or a
    ``telemetry`` block holding one): cache hit rates, communication byte
    counters, histogram summaries, gauges."""
    out = []
    caches = snapshot.get("caches") or {}
    if caches:
        out += ["### Caches", "",
                "| cache | hits | misses | hit rate |", "|---|---|---|---|"]
        for name in sorted(caches):
            c = caches[name]
            rate = ("-" if c.get("hit_rate") is None
                    else f"{c['hit_rate']:.1%}")
            out.append(f"| {name} | {c['hits']} | {c['misses']} | {rate} |")
        out.append("")
    counters = snapshot.get("counters") or {}
    comm = {k: v for k, v in counters.items() if k.startswith("comm.")}
    other = {k: v for k, v in counters.items() if not k.startswith("comm.")}
    if comm:
        out += ["### Communication (modeled bytes, cumulative)", "",
                "| counter | bytes |", "|---|---|"]
        for k in sorted(comm):
            out.append(f"| {k} | {_fmt_bytes(comm[k])} |")
        out.append("")
    if other:
        out += ["### Counters", "", "| counter | value |", "|---|---|"]
        for k in sorted(other):
            v = other[k]
            out.append(f"| {k} | {v:g} |")
        out.append("")
    hists = snapshot.get("histograms") or {}
    if hists:
        out += ["### Histograms", "",
                "| name | count | mean | p50 | p90 | max |",
                "|---|---|---|---|---|---|"]
        for k in sorted(hists):
            h = hists[k]
            out.append(
                f"| {k} | {h['count']} | {h['mean']:.3e} | {h['p50']:.3e} "
                f"| {h['p90']:.3e} | {h['max']:.3e} |")
        out.append("")
    gauges = snapshot.get("gauges") or {}
    if gauges:
        out += ["### Gauges", "", "| gauge | value |", "|---|---|"]
        for k in sorted(gauges):
            out.append(f"| {k} | {gauges[k]:.4g} |")
        out.append("")
    return "\n".join(out) if out else "(empty telemetry snapshot)"


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--telemetry":
        payload = json.loads(Path(sys.argv[2]).read_text())
        print(telemetry_table(payload.get("telemetry", payload)))
        raise SystemExit(0)
    print("usage: python -m repro_torch.launch.report --telemetry "
          "SNAPSHOT.json", file=sys.stderr)
    raise SystemExit(2)
