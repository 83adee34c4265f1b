"""The unified telemetry schema (copied from ``repro.obs.schema``; pure
Python) — ONE documented contract for (a) the per-step metrics dict every
engine returns through ``GossipTrainer.step`` and (b) the typed events a
:class:`repro_torch.obs.trace.TraceRecorder` captures.

Step-metrics schema
-------------------

Every engine's facade step returns AT LEAST :data:`CORE_STEP_KEYS` (the
engine parity surface; the port's key sets equal the reference's on
equivalent configs):

- ``step``         facade step index (0-based host counter)
- ``loss``         fleet-mean loss this step (the headline scalar)
- ``loss_mean``    alias of the fleet mean (sim/async compute it per worker;
                   the dist engine all-reduces the fleet mean only, so
                   mean == loss)
- ``loss_max``     worst per-worker loss (dist: the fleet mean — a
                   documented degeneracy, per-worker losses are not
                   gathered there)
- ``fired``        bool — did a communication round fire this step
- ``comm_active``  number of workers that initiated an exchange (0 when the
                   round did not fire)
- ``comm_round``   the engine's gossip-round counter: cumulative fired-round
                   count on sim/async (a device tensor, no host sync), the
                   schedule's round index on dist — same monotonicity,
                   different base
- ``comm_bytes``   cumulative expected per-worker egress (applied-exchange
                   accounting — mirrors ``ProtocolState.comm_bytes``)

Documented per-engine extensions (present exactly when the feature is on):

- :data:`ASYNC_STEP_KEYS` — ``engine="async"`` event windows
- :data:`ASYNC_MESSAGE_KEYS` — async message mode (delay models)
- :data:`SERVE_STEP_KEYS` — the facade ``publish_every`` snapshot hook
  (conditional: only on publishing steps)

Event schema
------------

A trace event is a flat dict with the common required fields ``ev`` (a name
in :data:`EVENT_TYPES`), ``t`` (seconds — VIRTUAL time on the async engine,
host wall time since recorder start elsewhere) and ``step`` (the engine step
counter at emission), plus the per-type required fields listed in
:data:`EVENT_TYPES`. ``worker``/``peer`` are worker indices (-1 = the
whole-fleet/trainer track). :func:`validate_event` / :func:`validate_trace`
are the CI gate for exported traces.
"""
from __future__ import annotations

from typing import Any, Dict, List

# ---------------------------------------------------------------------------
# step-metrics schema
# ---------------------------------------------------------------------------

CORE_STEP_KEYS = frozenset({
    "step", "loss", "loss_mean", "loss_max",
    "fired", "comm_active", "comm_round", "comm_bytes",
})

# engine="async": one facade step is one virtual-time event window
ASYNC_STEP_KEYS = frozenset({
    "virtual_time", "window_size",
    "stale_time", "stale_steps", "stale_events",
})

# async message mode (FaultConfig delay models): host pending-wire queue
ASYNC_MESSAGE_KEYS = frozenset({
    "pending_wires", "exch_timeouts", "exch_retries",
})

# facade publish hook (publish_every=k): only on publishing steps, and only
# one of the two depending on snapshot validation
SERVE_STEP_KEYS = frozenset({"published_seq", "publish_rejected"})


def normalize_step_metrics(metrics: Dict[str, Any], step: int) -> Dict[str, Any]:
    """Fill the CORE keys every engine owes the caller (additive — never
    removes an engine's own keys, so existing consumers keep working).

    The engine backends already emit their natural keys; this normalizes the
    cross-engine differences: the dist path has no per-worker losses (mean ==
    max == loss), the sim path has no ``loss`` alias before the backend adds
    it, etc. Pure host dict manipulation — no device ops, no sync beyond what
    reading the values the backend already returned would cost.
    """
    m = metrics
    m.setdefault("step", step)
    if "loss" not in m and "loss_mean" in m:
        m["loss"] = m["loss_mean"]
    m.setdefault("loss_mean", m.get("loss"))
    m.setdefault("loss_max", m.get("loss_mean"))
    if "comm_active" not in m:
        # dist backends report fired + the per-worker active mask count when
        # they have one; a protocol with no communication has neither
        m["comm_active"] = 0
    m.setdefault("fired", m["comm_active"] > 0)
    m.setdefault("comm_round", -1)
    m.setdefault("comm_bytes", 0.0)
    return m


# ---------------------------------------------------------------------------
# event schema
# ---------------------------------------------------------------------------

# ev name -> the extra required fields beyond (ev, t, step)
EVENT_TYPES: Dict[str, frozenset] = {
    # compute spans: one per in-window worker (async, virtual time) or one
    # whole-fleet span on the trainer track (sim/dist, wall time)
    "compute":  frozenset({"worker", "dur"}),
    # in-window applied exchange: initiator -> sampled peer
    "exchange": frozenset({"worker", "peer"}),
    # message mode (delay models): a wire's life cycle
    "dispatch": frozenset({"worker", "peer", "arrival"}),
    "apply":    frozenset({"worker", "peer", "age", "gap"}),
    "timeout":  frozenset({"worker", "peer", "attempt"}),
    "retry":    frozenset({"worker", "peer", "attempt"}),
    # fault plane: wires lost / failing checksum (counted, never applied)
    "drop":     frozenset({"worker"}),
    "corrupt":  frozenset({"worker"}),
    # fleet plane: flow-control skip (with the refusing token balance) and
    # the partition chunk an initiator shipped
    "flow_skip": frozenset({"worker", "tokens"}),
    "chunk":     frozenset({"worker", "chunk"}),
    # async full-fleet outage (fail_rejoin with slow_worker=-1)
    "outage":   frozenset({"until"}),
    # serve plane: snapshot publishes and hot swaps
    "publish":          frozenset({"seq"}),
    "publish_rejected": frozenset(),
    "swap":             frozenset({"seq", "pause_s"}),
}

_COMMON_REQUIRED = ("ev", "t", "step")


def validate_event(event: Dict[str, Any]) -> List[str]:
    """Problems with one typed event ([] = valid)."""
    errs = []
    for f in _COMMON_REQUIRED:
        if f not in event:
            errs.append(f"missing required field {f!r}")
    ev = event.get("ev")
    if ev not in EVENT_TYPES:
        errs.append(f"unknown event type {ev!r}")
        return errs
    for f in sorted(EVENT_TYPES[ev]):
        if f not in event:
            errs.append(f"{ev}: missing field {f!r}")
    if "t" in event and not isinstance(event["t"], (int, float)):
        errs.append(f"{ev}: t must be a number, got {type(event['t']).__name__}")
    return errs


_PERFETTO_PH = {"X", "i", "I", "s", "f", "M", "C"}


def validate_trace(trace: Dict[str, Any]) -> List[str]:
    """Problems with an exported trace document ([] = valid): the raw typed
    events under ``reproEvents`` validate against :data:`EVENT_TYPES`, and
    the ``traceEvents`` timeline is structurally loadable by Perfetto /
    chrome://tracing (known phases, numeric timestamps, thread-name metadata
    for every referenced track)."""
    errs = []
    if not isinstance(trace.get("traceEvents"), list):
        return ["traceEvents missing or not a list"]
    for i, e in enumerate(trace.get("reproEvents", [])):
        for msg in validate_event(e):
            errs.append(f"reproEvents[{i}]: {msg}")
    named_tids = set()
    used_tids = set()
    for i, e in enumerate(trace["traceEvents"]):
        ph = e.get("ph")
        if ph not in _PERFETTO_PH:
            errs.append(f"traceEvents[{i}]: unknown phase {ph!r}")
            continue
        if ph == "M":
            if e.get("name") == "thread_name":
                named_tids.add(e.get("tid"))
            continue
        if not isinstance(e.get("ts"), (int, float)):
            errs.append(f"traceEvents[{i}]: non-numeric ts")
        if ph == "X" and not isinstance(e.get("dur"), (int, float)):
            errs.append(f"traceEvents[{i}]: complete event without dur")
        if "name" not in e:
            errs.append(f"traceEvents[{i}]: missing name")
        used_tids.add(e.get("tid"))
    for tid in sorted(used_tids - named_tids, key=str):
        errs.append(f"track tid={tid!r} has no thread_name metadata")
    return errs
