"""The numbers that decide ``correct``: the program's first training steps
against the plain reference's on the same weights, batches and draws.

- ``loss_gap``: over the checked steps, the larger relative gap of the
  workers' mean loss and of their largest loss; ``loss1_gap`` the same of
  the first step alone.
- ``grad1_gap``: the first step's gradient as the optimizer got it (the
  program's from its velocity after one step, ``-v / lr``), leaf by leaf:
  the gap between the program's norm and the reference's, over the larger
  of the reference's norm of that leaf and of the median leaf; the worst
  leaf of any worker.
- ``change3_gap``: the same for each leaf's change from the initial weights
  after the checked steps. Leaves whose reference gradient is under a
  thousandth of the median leaf's are left out: they move by round-off
  alone (a key's bias under softmax; here Mamba2's ``dt_bias`` and
  ``d_skip`` do not qualify, but a leaf with no path to the loss would).
  ``change3_med_gap``: the median over those leaves of the same gap, the
  worst worker.

A cell's limits file (``limits/<cell>.json``) names the numbers it
compares; the others are printed as diagnostics only.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List

NAMES = ("loss_gap", "loss1_gap", "grad1_gap", "grad1_med_gap", "change3_gap",
         "change3_med_gap")
QUIET = 1e-3


def _rel(p: float, r: float, floor: float) -> float:
    d = abs(p - r) / max(abs(r), floor)
    return d if math.isfinite(d) else math.inf


def compare(prog: dict, ref: dict) -> Dict[str, dict]:
    """{name: {"value", "worst"}}. ``prog``: ``loss_mean`` / ``loss_max``
    by step, ``grad1`` and ``change`` as ``[w]{leaf: norm}``; ``ref``:
    :func:`bench.reference.train.run`'s result."""
    loss, where, by_step = 0.0, None, []
    for s, rl in enumerate(ref["losses"]):
        by_step.append(0.0)
        for name, p, r in (("mean", prog["loss_mean"][s], sum(rl) / len(rl)),
                           ("max", prog["loss_max"][s], max(rl))):
            gap = _rel(p, r, 0.0)
            by_step[-1] = max(by_step[-1], gap)
            if not gap <= loss:
                loss, where = gap, f"step {s + 1} {name}"
    out = {"loss_gap": {"value": loss, "worst": f"{where}; by step {by_step}"},
           "loss1_gap": {"value": by_step[0], "worst": "step 1"}}
    g_val, g_at, c_val, c_at, g_med, med_val = 0.0, None, 0.0, None, 0.0, 0.0
    for w, (pg, rg, pc, rc) in enumerate(zip(prog["grad1"], ref["grad1"], prog["change"],
                                             ref["change"])):
        med = statistics.median(rg.values())
        ggaps = {k: _rel(pg[k], r, med) for k, r in rg.items()}
        for k, gap in ggaps.items():
            if not gap <= g_val:
                g_val, g_at = gap, f"worker {w} {k}"
        g_med = max(g_med, statistics.median(ggaps.values()))
        moved = [k for k in rc if rg[k] >= QUIET * med]
        medc = statistics.median(rc[k] for k in moved)
        gaps = {k: _rel(pc[k], rc[k], medc) for k in moved}
        for k, gap in gaps.items():
            if not gap <= c_val:
                c_val, c_at = gap, f"worker {w} {k}"
        med_val = max(med_val, statistics.median(gaps.values()))
    out["grad1_gap"] = {"value": g_val, "worst": g_at}
    out["grad1_med_gap"] = {"value": g_med, "worst": "median leaf"}
    out["change3_gap"] = {"value": c_val, "worst": c_at}
    out["change3_med_gap"] = {"value": med_val, "worst": "median leaf"}
    return out


def verdict(numbers: Dict[str, dict], limits: Dict[str, float]) -> bool:
    """Every compared number within its limit; no limits, no verdict."""
    return bool(limits) and all(numbers[n]["value"] <= v for n, v in limits.items())


def lines(numbers: Dict[str, dict], limits: Dict[str, float]) -> List[str]:
    """The diagnostics, then each compared number beside its limit."""
    other = " ".join(f"{n} {numbers[n]['value']!r} ({numbers[n]['worst']})" for n in NAMES
                     if n not in limits)
    return ([f"not compared: {other}"] if other else []) + [
        f"check {n} {numbers[n]['value']!r} limit {v!r} (worst: {numbers[n]['worst']})"
        for n, v in limits.items()]
