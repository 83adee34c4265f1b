"""Run summarizer: ``python -m repro_torch.obs.report run.jsonl [--trace run.json]``
(copied from ``repro.obs.report``; pure Python).

Reads a metrics JSONL stream (one row per sampled facade step, written by
:class:`repro_torch.obs.metrics.MetricsSink` through the facade observer) and
prints

- the run's cumulative ``ProtocolState`` totals (comm bytes/units/rounds,
  staleness, faults, flow skips) — read from the LAST row's ``proto`` block,
  so they match the engine's own accumulators EXACTLY, never re-derived;
- the wire-bytes-vs-loss frontier (the paper's headline trade-off): loss at
  evenly spaced communication budgets along the run;
- a staleness histogram over the per-row ``stale_time`` increments.

With ``--trace`` it additionally validates the exported Perfetto trace
against the event schema and prints per-type event counts.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def totals(rows: List[Dict[str, Any]]) -> Dict[str, float]:
    """Cumulative ProtocolState accumulators at the last sampled step."""
    for r in reversed(rows):
        if r.get("proto"):
            return dict(r["proto"])
    return {}


def frontier(rows: List[Dict[str, Any]], points: int = 10) -> List[Dict[str, float]]:
    """(step, comm_bytes, loss) at ``points`` evenly spaced rows — loss as a
    function of spent communication budget."""
    rows = [r for r in rows if "loss" in r and "comm_bytes" in r]
    if not rows:
        return []
    idx = sorted({round(i * (len(rows) - 1) / max(points - 1, 1))
                  for i in range(points)})
    return [{"step": rows[i]["step"],
             "comm_bytes": float(rows[i]["comm_bytes"]),
             "loss": float(rows[i]["loss"])} for i in idx]


def staleness_hist(rows: List[Dict[str, Any]], bins: int = 8):
    """Histogram over per-row stale_time increments (virtual/wall seconds of
    partner-row age accumulated per sampled step)."""
    deltas, prev = [], 0.0
    for r in rows:
        st = (r.get("proto") or {}).get("stale_time")
        if st is None:
            continue
        if st > prev:
            deltas.append(st - prev)
        prev = st
    if not deltas:
        return [], []
    lo, hi = min(deltas), max(deltas)
    width = (hi - lo) / bins or 1.0
    counts = [0] * bins
    for d in deltas:
        counts[min(int((d - lo) / width), bins - 1)] += 1
    edges = [lo + i * width for i in range(bins + 1)]
    return edges, counts


def summarize(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Machine-readable summary (what the benchmark / tests assert on)."""
    return {"rows": len(rows), "totals": totals(rows),
            "frontier": frontier(rows), "final_loss":
            float(rows[-1]["loss"]) if rows and "loss" in rows[-1] else None}


def print_report(rows: List[Dict[str, Any]]) -> None:
    tot = totals(rows)
    print(f"# {len(rows)} sampled steps")
    if tot:
        print("\n## ProtocolState totals (exact engine accumulators)")
        for k in sorted(tot):
            v = tot[k]
            print(f"  {k:>14}: {v}")
    fr = frontier(rows)
    if fr:
        print("\n## wire-bytes-vs-loss frontier")
        print(f"  {'step':>6} {'comm_MB':>10} {'loss':>10}")
        for p in fr:
            print(f"  {p['step']:>6} {p['comm_bytes']/1e6:>10.3f} "
                  f"{p['loss']:>10.4f}")
    edges, counts = staleness_hist(rows)
    if counts:
        print("\n## staleness histogram (stale_time increments per step)")
        peak = max(counts)
        for i, c in enumerate(counts):
            bar = "#" * round(40 * c / peak)
            print(f"  [{edges[i]:8.3f}, {edges[i+1]:8.3f}) {c:>5} {bar}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.report")
    ap.add_argument("metrics", help="metrics JSONL from a --metrics run")
    ap.add_argument("--trace", default="",
                    help="optionally validate an exported trace JSON too")
    args = ap.parse_args(argv)
    rows = load_jsonl(args.metrics)
    print_report(rows)
    if args.trace:
        from repro_torch.obs.schema import validate_trace
        with open(args.trace) as f:
            doc = json.load(f)
        errs = validate_trace(doc)
        by_type: Dict[str, int] = {}
        for e in doc.get("reproEvents", []):
            by_type[e.get("ev", "?")] = by_type.get(e.get("ev", "?"), 0) + 1
        print(f"\n## trace {args.trace}: "
              f"{len(doc.get('reproEvents', []))} events "
              f"({', '.join(f'{k}={v}' for k, v in sorted(by_type.items()))})")
        if errs:
            print("SCHEMA ERRORS:")
            for e in errs[:20]:
                print(f"  {e}")
            return 1
        print("schema: VALID")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
