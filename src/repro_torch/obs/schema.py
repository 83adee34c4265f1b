"""The unified per-step metrics schema (the step-metrics part of
``repro.obs.schema``; the event schema comes with the obs slice).

Every engine's facade step returns at least :data:`CORE_STEP_KEYS`:
``step`` (facade step index), ``loss`` (fleet-mean loss), ``loss_mean``,
``loss_max`` (worst per-worker loss), ``fired`` (did a round fire),
``comm_active`` (workers that initiated an exchange), ``comm_round``
(cumulative fired-round count on the sim engine) and ``comm_bytes``
(cumulative expected per-worker egress).
"""
from __future__ import annotations

from typing import Any, Dict

CORE_STEP_KEYS = frozenset({
    "step", "loss", "loss_mean", "loss_max",
    "fired", "comm_active", "comm_round", "comm_bytes",
})


def normalize_step_metrics(metrics: Dict[str, Any], step: int) -> Dict[str, Any]:
    """Fill the CORE keys every engine owes the caller (additive: an
    engine's own keys are never removed)."""
    m = metrics
    m.setdefault("step", step)
    if "loss" not in m and "loss_mean" in m:
        m["loss"] = m["loss_mean"]
    m.setdefault("loss_mean", m.get("loss"))
    m.setdefault("loss_max", m.get("loss_mean"))
    if "comm_active" not in m:
        m["comm_active"] = 0
    m.setdefault("fired", m["comm_active"] > 0)
    m.setdefault("comm_round", -1)
    m.setdefault("comm_bytes", 0.0)
    return m
