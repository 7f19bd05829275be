"""Aggregate the dry-run's records into the roofline table (:func:`table`,
:func:`summary`), and render telemetry snapshots (:func:`telemetry_table`):
the markdown view of ``repro_torch.runtime.telemetry.METRICS.snapshot()``.

    python -m repro_torch.launch.report [pod256|pod512|card]
    python -m repro_torch.launch.report --telemetry SNAPSHOT.json

The records are the ones ``python -m repro_torch.launch.dryrun`` writes
under ``experiments/dryrun_torch/``: predictions from the H100 SXM's
datasheet figures (``launch/roofline.LM_HW``), not measurements.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

ARCH_ORDER = ["llava-next-34b", "zamba2-7b", "xlstm-125m", "starcoder2-15b",
              "llama3-8b", "internlm2-1.8b", "qwen3-14b", "olmoe-1b-7b",
              "llama4-scout-17b-a16e", "seamless-m4t-medium"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh="pod256"):
    recs = {}
    for f in OUT_DIR.glob(f"*_{mesh}.json"):
        r = json.loads(f.read_text())
        recs[(r["arch"], r["shape"])] = r
    return recs


def fmt_s(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def table(mesh="pod256") -> str:
    recs = load(mesh)
    rows = ["| arch | shape | compute | memory | collective | dominant | "
            "bound | mem/dev | useful-FLOPs |",
            "|---|---|---|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s))
            if r is None:
                rows.append(f"| {a} | {s} | - | - | - | MISSING | - | - | - |")
                continue
            if r["status"] != "ok":
                rows.append(f"| {a} | {s} | - | - | - | "
                            f"FAIL: {r.get('error','')[:40]} | - | - | - |")
                continue
            rl = r["roofline"]
            rows.append(
                f"| {a} | {s} | {fmt_s(rl['compute_s'])} | "
                f"{fmt_s(rl['memory_s'])} | {fmt_s(rl['collective_s'])} | "
                f"{rl['dominant'].replace('_s','')} | "
                f"{fmt_s(rl['roofline_bound_s'])} | "
                f"{r['memory']['peak_estimate_gib']:.2f}GiB | "
                f"{rl.get('useful_flops_ratio', 0):.2f} |")
    return "\n".join(rows)


def summary(mesh="pod256"):
    recs = load(mesh)
    ok = [r for r in recs.values() if r["status"] == "ok"]
    out = {
        "cells_ok": len(ok), "cells_total": len(recs),
        "over_16gib": sorted([(r["arch"], r["shape"],
                               r["memory"]["peak_estimate_gib"])
                              for r in ok
                              if r["memory"]["peak_estimate_gib"] > 16],
                             key=lambda t: -t[2]),
        "most_collective_bound": sorted(
            [(r["arch"], r["shape"],
              r["roofline"]["collective_s"] /
              max(r["roofline"]["roofline_bound_s"], 1e-12))
             for r in ok], key=lambda t: -t[2])[:5],
        "worst_compute_fraction": sorted(
            [(r["arch"], r["shape"],
              r["roofline"]["compute_fraction_at_bound"])
             for r in ok if r["shape"] == "train_4k"],
            key=lambda t: t[2])[:5],
    }
    return out


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
    mesh = sys.argv[1] if len(sys.argv) > 1 else "pod256"
    print(table(mesh))
    print()
    print(json.dumps(summary(mesh), indent=2, default=str))
