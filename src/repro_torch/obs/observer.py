"""Observer: binds an :class:`~repro_torch.common.config.ObsConfig` to a
:class:`TraceRecorder` and a :class:`MetricsSink` and hangs off the engine
hooks (port of ``repro.obs.observer``).

Observation adds no device work to a step. Every event is rebuilt on the
host from values the engines already hold:

- the gate and peers are what the step consumed (``SimTrainer.last_draws``;
  a ``torch.Generator`` cannot be replayed the way the reference re-derives
  them from the pre-step key);
- flow-control admission replays ``FlowControl.allow_np`` on the pre-step
  token balances;
- fault drops and corrupt wires replay the ``(seed, worker, step)`` hashes
  (``FaultModel.drop_mask`` / ``corrupt_mask``);
- partition chunk ids replay ``partition_ids_np``;
- message-mode wire events come from the async engine's pending queue,
  host code to begin with;
- metrics counters are DELTAS of the ``ProtocolState`` accumulators, so the
  sink's totals equal the state's exactly.

Timestamps: virtual seconds on the async engine's worker tracks, host wall
seconds since recorder start elsewhere.

The harvest runs one step behind. A hook copies the device values it needs
to the host with ``non_blocking`` copies (into pinned memory on a GPU),
records a CUDA event, and reads the PREVIOUS step's copies, which are done
by then; so no hook waits for the step just dispatched. Nothing in the
engines writes these values in place: each step replaces the counter, the
balances, the draws and the accumulators. :meth:`flush` (called by
:meth:`export`) reads the last pending step.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsSink
from repro_torch.obs.trace import TraceRecorder

# ProtocolState scalar accumulators mirrored into the metrics stream (only
# the ones the run's planes seeded are read)
PROTO_COUNTERS = (
    "comm_rounds", "comm_units", "comm_bytes",
    "stale_time", "stale_steps", "stale_events",
    "wire_dropped", "wire_corrupt", "exch_timeouts", "exch_retries",
    "flow_skipped",
)
# small per-worker / per-chunk arrays, recorded as lists
PROTO_ARRAYS = ("tokens", "chunk_units")
# metrics copied into a row when an engine returns them
ROW_KEYS = ("loss", "loss_mean", "loss_max", "fired", "comm_active", "comm_round",
            "comm_bytes", "virtual_time", "window_size", "pending_wires",
            "published_seq", "publish_rejected")


class _HostCopy:
    """Host copies of some device values, started without waiting: on a GPU
    ``non_blocking`` copies into pinned memory and an event after them;
    :meth:`get` waits for that event only."""

    def __init__(self, values: Dict[str, Any]):
        self.event = None
        self.values = {}
        for k, v in values.items():
            if isinstance(v, torch.Tensor):
                if v.device.type == "cuda":
                    v = v.detach().to("cpu", non_blocking=True)
                    if self.event is None:
                        self.event = torch.cuda.Event()
                else:
                    v = v.detach().clone()
            self.values[k] = v
        if self.event is not None:
            self.event.record()

    def get(self) -> Dict[str, Any]:
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return {k: v.numpy() if isinstance(v, torch.Tensor) else v
                for k, v in self.values.items()}


class Observer:
    """One per recording ``GossipTrainer`` (see the module docstring)."""

    def __init__(self, cfg, engine: str, num_workers: int):
        self.cfg = cfg
        self.engine = engine
        self.num_workers = num_workers
        self.trace: Optional[TraceRecorder] = (
            TraceRecorder(cfg.max_events) if cfg.trace_enabled() else None)
        self.sink: Optional[MetricsSink] = (
            MetricsSink(cfg.metrics_path or None) if cfg.metrics_enabled() else None)
        self._t0 = time.perf_counter()
        self._prev: Dict[str, float] = {}
        # the one-step-behind harvest
        self._pending_trace = None
        self._pending_row = None

    # ------------------------------------------------------------ utilities
    def now(self) -> float:
        """Host wall seconds since recorder start."""
        return time.perf_counter() - self._t0

    def want(self, step: int) -> bool:
        return step % max(1, self.cfg.sample_every) == 0

    @property
    def tracing(self) -> bool:
        return self.trace is not None

    def event(self, ev: str, t: float, step: int, worker: int = -1, **fields) -> None:
        if self.trace is not None:
            self.trace.emit(ev, t, step, worker, **fields)

    # ---------------------------------------------------------- engine hooks
    def on_sim_step(self, trainer, t_start: float, step0, tokens0) -> None:
        """Synchronous engine: one whole-fleet compute span (wall time) and
        the step's exchange / fault / flow / chunk events, from the draws the
        step consumed (``last_draws``), the pre-step counter ``step0`` and
        the pre-step balances ``tokens0``; harvested one step later."""
        if self.trace is None:
            return
        t = self.now()
        self._defer(trainer, t, step0, tokens0, mask=None,
                    spans=[(t_start, -1, t - t_start)], exchanges=True)

    def on_async_window(self, trainer, t: float, mask, nxt, clocks0, step0,
                        tokens0) -> None:
        """Async engine: per-worker compute spans in VIRTUAL time and, out of
        message mode, the window's exchange events at window time ``t``
        (message-mode wire events come from the pending queue)."""
        if self.trace is None:
            return
        spans = [(float(clocks0[w]), int(w), float(nxt[w]) - float(clocks0[w]))
                 for w in np.nonzero(mask)[0]]
        self._defer(trainer, t, step0, tokens0, mask=np.array(mask, copy=True), spans=spans,
                    exchanges=not getattr(trainer, "_message_mode", False))

    def on_dist_step(self, backend, t_start: float, step: int, fire, active,
                     rnd: int) -> None:
        """Dist engine: everything is host-side already (the schedule poll
        gives fire / active / round, the matching the partners, and the
        per-device wire is static); nothing to defer."""
        if self.trace is None or not self.want(step):
            return
        t = self.now()
        self.event("compute", t_start, step, worker=-1, dur=t - t_start)
        if not fire or active is None:
            return
        partners = np.asarray(backend.matching_partners(rnd))
        act = np.asarray(active).astype(bool)
        wire = float(backend.wire_bytes())
        for i in np.nonzero(act)[0]:
            i = int(i)
            k = int(partners[i])
            if k == i:
                continue
            self.event("exchange", t, step, worker=i, peer=k, round=int(rnd), wire_bytes=wire)

    # -------------------------------------------------- deferred trace harvest
    def _defer(self, trainer, t, step0, tokens0, mask, spans, exchanges) -> None:
        """Start the host copies of THIS step's values and harvest the
        PREVIOUS step's."""
        vals = {"step": step0}
        if exchanges and trainer._impl.pairwise:
            vals["gate"], vals["peers"] = trainer.last_draws
            if trainer.flow is not None and tokens0 is not None:
                vals["tokens"] = tokens0
        else:
            exchanges = False
        copy = _HostCopy(vals)
        self._flush_trace()
        self._pending_trace = (trainer, t, copy, mask, spans, exchanges)

    def _flush_trace(self) -> None:
        """Read the deferred step and classify each initiation into exchange
        / drop / corrupt / flow_skip (plus a chunk id under the partition
        plane), in the precedence the step applies."""
        p = self._pending_trace
        if p is None:
            return
        self._pending_trace = None
        trainer, t, copy, mask, spans, exchanges = p
        host = copy.get()
        step = int(host["step"])
        if not self.want(step):
            return
        for t0, w, dur in spans:
            self.event("compute", t0, step, worker=w, dur=dur)
        if not exchanges:
            return
        gate = np.asarray(host["gate"]).astype(bool)
        peers = np.asarray(host["peers"])
        active = gate if mask is None else (gate & mask)
        balances = host.get("tokens")
        if balances is not None:
            allowed = np.asarray(trainer.flow.allow_np(step, balances)).astype(bool)
            for w in np.nonzero(active & ~allowed)[0]:
                self.event("flow_skip", t, step, worker=int(w), tokens=float(balances[w]))
            active = active & allowed
        part = None
        if trainer.partition > 1:
            from repro_torch.fleet.partition import partition_ids_np
            part = partition_ids_np(trainer.fleet.seed, step, trainer.num_workers,
                                    trainer.partition)
        fm = trainer.fault_model
        for i in np.nonzero(active)[0]:
            i = int(i)
            k = int(peers[i])
            if k == i:
                continue
            if fm is not None and fm.injects_drop and bool(fm.drop_mask(i, step)):
                self.event("drop", t, step, worker=i)
                continue
            if fm is not None and fm.injects_corrupt and bool(fm.corrupt_mask(i, step)):
                self.event("corrupt", t, step, worker=i)
                continue
            self.event("exchange", t, step, worker=i, peer=k)
            if part is not None:
                self.event("chunk", t, step, worker=i, chunk=int(part[i]))

    # --------------------------------------------------------- facade metrics
    def on_step(self, step: int, metrics: Dict[str, Any], state) -> None:
        """One sampled metrics row: the normalized step metrics and the
        ``ProtocolState`` accumulators, copied to the host now and read one
        step later."""
        if self.sink is None:
            return
        if not self.want(step):
            self._flush_row()
            return
        row: Dict[str, Any] = {"step": step, "t": self.now(), "engine": self.engine}
        for k in ROW_KEYS:
            if k in metrics:
                row[k] = metrics[k]
        proto = getattr(state, "proto", None)
        keys = ()
        if proto is not None:
            keys = tuple(k for k in PROTO_COUNTERS + PROTO_ARRAYS
                         if getattr(proto, k, None) is not None)
            row.update({"proto/" + k: getattr(proto, k) for k in keys})
        copy = _HostCopy(row)
        self._flush_row()
        self._pending_row = (copy, keys)

    def _flush_row(self) -> None:
        p = self._pending_row
        if p is None:
            return
        self._pending_row = None
        copy, keys = p
        row = copy.get()
        host = {k: row.pop("proto/" + k) for k in keys}
        if keys:
            pr = {}
            for k in PROTO_COUNTERS:
                if k not in host:
                    continue
                v = float(host[k])
                pr[k] = v
                delta = v - self._prev.get(k, 0.0)
                self._prev[k] = v
                if delta:
                    self.sink.counter_add(k, delta)
                if k == "stale_time" and delta:
                    self.sink.observe("stale_time_delta", delta)
            for k in PROTO_ARRAYS:
                if k in host:
                    pr[k] = np.asarray(host[k]).tolist()
            row["proto"] = pr
            # the row's accumulators are the same values as the state's
            if "comm_bytes" in pr:
                row["comm_bytes"] = pr["comm_bytes"]
            if "comm_round" in row and "comm_rounds" in pr:
                row["comm_round"] = int(pr["comm_rounds"])
        elif "comm_bytes" in row:
            # dist, without a ProtocolState: the host float64 accumulator is
            # the comm account; mirror it into the proto block so the report
            # reads one shape
            v = float(row["comm_bytes"])
            row["proto"] = {"comm_bytes": v}
            delta = v - self._prev.get("comm_bytes", 0.0)
            self._prev["comm_bytes"] = v
            if delta:
                self.sink.counter_add("comm_bytes", delta)
        for k in ("window_size", "pending_wires"):
            if k in row:
                self.sink.observe(k, int(row[k]))
        self.sink.record(row)

    def flush(self) -> None:
        """Read the one-step-deferred harvest (call before reading the
        recorder or the sink mid-run; :meth:`export` does it)."""
        self._flush_trace()
        self._flush_row()

    # ---------------------------------------------------------------- export
    def export(self, trace_path: Optional[str] = None,
               metrics_path: Optional[str] = None) -> Dict[str, str]:
        """Write the trace (Perfetto JSON) and flush and close the metrics
        JSONL. Paths default to the config's; returns {kind: path} of what
        was written. Re-exporting the trace overwrites it."""
        self.flush()
        out = {}
        tp = trace_path or self.cfg.trace_path
        if self.trace is not None and tp:
            self.trace.save(tp, num_workers=self.num_workers)
            out["trace"] = tp
        mp = metrics_path or self.cfg.metrics_path
        if self.sink is not None:
            if mp and mp != (self.sink.path or ""):
                # a path given late, after in-memory recording: dump the rows
                with open(mp, "w") as f:
                    for r in self.sink.records:
                        f.write(json.dumps(r) + "\n")
                out["metrics"] = mp
            elif self.sink.path:
                out["metrics"] = self.sink.path
            self.sink.close()
        return out
