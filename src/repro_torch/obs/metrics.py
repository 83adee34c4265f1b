"""MetricsSink — counters / gauges / histograms + JSONL record streaming
(copied from ``repro.obs.metrics``; pure Python).

The sink is the metrics half of the telemetry plane: engines (through the
facade observer) and the serve loop push

- **counters** — monotone totals, fed by DELTAS of the engine's own
  ``ProtocolState`` accumulators (comm_bytes, stale_time, wire_dropped, ...)
  so sink totals are exactly the state's totals, never a re-derivation;
- **gauges** — last-value scalars (pending_wires, virtual_time, ...);
- **histograms** — raw observation lists with summary stats (swap pauses,
  snapshot staleness, per-window staleness increments).

``record(row)`` streams one JSON object per line to ``path`` (opened lazily,
flushed per row so a crashed run keeps its telemetry) and keeps the rows
in memory for :func:`repro.obs.report` / tests.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


def _jsonable(v):
    """Best-effort scalar conversion for device arrays / numpy scalars."""
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


class MetricsSink:
    """Counter/gauge/histogram registry with optional JSONL streaming."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, List[float]] = {}
        self.records: List[Dict[str, Any]] = []
        self._fh = None

    # ------------------------------------------------------------ registry
    def counter_add(self, name: str, value) -> None:
        self.counters[name] = self.counters.get(name, 0) + _jsonable(value)

    def gauge_set(self, name: str, value) -> None:
        self.gauges[name] = _jsonable(value)

    def observe(self, name: str, value) -> None:
        self.hists.setdefault(name, []).append(_jsonable(value))

    def samples(self, name: str) -> List[float]:
        """The LIVE observation list for ``name`` (mutations — e.g. a
        benchmark's ``.clear()`` between phases — are seen by the sink)."""
        return self.hists.setdefault(name, [])

    # ----------------------------------------------------------- streaming
    def record(self, row: Dict[str, Any]) -> None:
        row = {k: _jsonable(v) for k, v in row.items()}
        self.records.append(row)
        if self.path is not None:
            if self._fh is None:
                self._fh = open(self.path, "w")
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # ------------------------------------------------------------- summary
    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        out.update(self.counters)
        out.update(self.gauges)
        for name, vals in self.hists.items():
            n = len(vals)
            out[f"{name}_count"] = n
            out[f"{name}_mean"] = (sum(vals) / n) if n else 0.0
            out[f"{name}_max"] = max(vals) if n else 0.0
        return out
