"""Asynchronous gossip engine: event-driven virtual time over the flat plane
(port of ``repro.core.gossip_async``).

Each worker owns a **virtual clock** driven by a pluggable compute-time
model (:mod:`repro_torch.hetero.models`); local SGD steps fire per worker as
its clock advances, and pairwise exchanges carry per-exchange **staleness
accounting** (the virtual-time and step-count gap between the partners) in
``ProtocolState``.

Execution model:

- The host keeps float64 mirrors of every worker's clock and local step
  count. One :meth:`AsyncTrainer.step` pops the earliest completion time
  ``t`` and forms the **event window**: every worker whose next step
  completes exactly at ``t`` (the whole fleet for a constant model; mostly
  one worker under lognormal stragglers). A worker's row of the resident
  ``[W, total]`` plane changes only at its own windows, so one window is one
  masked step over the plane.
- A **full-fleet window runs the synchronous sim step verbatim**, which
  keeps the constant fleet bit-exact against ``engine="sim"`` (theta,
  velocity, counters and the generator). A partial window runs the same
  step with a ``worker_mask``: in-window workers may initiate
  (``active &= mask``), and kernel B1 updates the window's rows only, so
  out-of-window rows keep their bits.
- Clocks, per-worker step counts and the staleness sums advance after the
  step (:meth:`AsyncTrainer._advance_clocks`) from the ``(gate, peers)``
  the step drew (``SimTrainer.last_draws``): a ``torch.Generator`` cannot
  be replayed the way the reference re-derives them from the pre-step key.
- **Exchange semantics**: a worker's resident row IS its last published
  step, so a partner is always ready. An in-window initiator mixes with its
  partner's current row through the symmetric matrix; when the partner is
  outside the window its row is kept, so that half of the displacement is
  dropped and a partial window does not conserve the parameter sum (the
  reference does the same).

With a delay model (``FaultConfig(delay_model=..., rendezvous=...,
timeout=...)``) exchanges leave the step: each initiation CAPTURES both
rows at dispatch (a ``clone()``, since the step updates the plane in
place), rides a host queue, and is applied at its virtual arrival time
(message mode), with timeouts, doubling backoff and retries; drops and
corrupt wires die at dispatch. With ``FleetConfig(plane="host")`` the plane
lives in pinned host memory and only the window's rows visit the card
(:mod:`repro_torch.fleet.hostplane`).

Draws of virtual time hash ``(seed, worker, step)``, so a run is
bit-reproducible across restarts; the host clock mirrors persist through
the checkpoint metadata (``hetero_clock``).
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.api.state import FlatState
from repro_torch.common.config import HeteroConfig, OptimizerConfig, ProtocolConfig
from repro_torch.core.gossip_sim import SimTrainer
from repro_torch.hetero.models import resolve_time_model

PyTree = Any


def _i32(n, device) -> torch.Tensor:
    return torch.tensor(int(n), dtype=torch.int32, device=device)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=device)


class AsyncTrainer(SimTrainer):
    """Virtual-time asynchronous trainer over W heterogeneous workers.

    The constructor of :class:`SimTrainer` plus ``hetero`` (a
    :class:`HeteroConfig` naming the compute-time model). The protocol must
    be barrier-free (pairwise gossip, EASGD or no communication).

    Step-indexed knobs count EVENT WINDOWS here: the shared ``step`` /
    ``opt.step`` counter advances once per window, so ``comm_period`` and
    learning-rate or moving-rate schedules advance per window (a warning
    flags non-constant schedules). Per-worker update counts live in
    ``ProtocolState.worker_steps``.
    """

    _supports_host_plane = True

    def __init__(self, loss_fn: Callable, num_workers: int,
                 protocol: ProtocolConfig, optimizer: OptimizerConfig,
                 hetero: Optional[HeteroConfig] = None,
                 fused_update: bool = True, faults=None, fleet=None, shard=None):
        super().__init__(loss_fn, num_workers, protocol, optimizer,
                         fused_update=fused_update, faults=faults, fleet=fleet, shard=shard)
        if not self._impl.barrier_free:
            raise ValueError(
                f"protocol {protocol.method!r} needs a global step barrier "
                '(barrier_free=False) and cannot run under engine="async"')
        if (optimizer.schedule != "constant" or optimizer.warmup_steps > 0
                or protocol.alpha_decay_steps > 0):
            warnings.warn(
                'engine="async": step-indexed schedules (lr warmup/decay, '
                "alpha annealing) advance once per EVENT WINDOW, not per "
                "worker update — under a heterogeneous fleet they run ~W "
                "times faster than any single worker's update count",
                UserWarning, stacklevel=3)
        self.hetero = hetero or HeteroConfig()
        self.time_model = resolve_time_model(self.hetero)
        # authoritative host mirrors of the virtual timeline (float64; the
        # state's ProtocolState.clocks are an f32 view for the staleness sums)
        self.clocks = np.zeros((num_workers,), np.float64)
        self.steps_done = np.zeros((num_workers,), np.int64)
        # message mode: a delay model, rendezvous or a timeout route every
        # exchange through the host queue of pending wires
        self.delay_model = None
        self._message_mode = False
        if faults is not None:
            from repro_torch.faults import delays_active, resolve_delay_model
            if delays_active(faults):
                self.delay_model = resolve_delay_model(faults)
                self._message_mode = True
        if self._message_mode:
            if not self._impl.pairwise:
                raise ValueError(
                    f"delay models need pairwise exchanges; protocol "
                    f"{protocol.method!r} is not pairwise")
            if self.codec is not None:
                raise ValueError(
                    "delay models route exchanges through the host wire "
                    "queue, which ships raw rows; codecs do not compose "
                    f"with delay model {faults.delay_model!r} yet")
            if self.partition > 1 or self.flow is not None:
                raise ValueError(
                    "the fleet plane (partition / flow control) does not compose "
                    "with delay-model message mode yet — exchanges would need "
                    "per-chunk wires and dispatch-time token draws in the host "
                    "pending queue")
        self.host_plane = fleet is not None and fleet.plane == "host"
        self._hostplane = None
        if self.host_plane:
            if self.codec is not None:
                raise ValueError(
                    "plane='host' ships raw host rows; codecs do not compose "
                    "with the host-resident plane yet")
            if faults is not None:
                raise ValueError(
                    "plane='host' does not compose with the message-level "
                    "fault plane yet")
            if optimizer.name != "nag":
                raise ValueError(
                    "plane='host' runs the fused NAG rows program; optimizer "
                    f"{optimizer.name!r} is not supported")
            if not self._impl.pairwise:
                raise ValueError(
                    "plane='host' realizes exchanges host-side pairwise; "
                    f"protocol {protocol.method!r} is not pairwise")
            from repro_torch.fleet.hostplane import HostPlane
            self._hostplane = HostPlane(self)
        self._pending: list = []
        self._per_event = 0.0

    # ------------------------------------------------------------- lifecycle
    def init(self, params_stack: PyTree, seed: int = 0) -> FlatState:
        self._pending = []
        if self.host_plane:
            return self._hostplane.init_state(params_stack, seed)
        state = super().init(params_stack, seed)
        W = self.num_workers
        dev = state.step.device
        self.anchor(np.zeros((W,)), np.zeros((W,), np.int64))
        proto = state.proto._replace(
            clocks=torch.zeros(W, dtype=torch.float32, device=dev),
            worker_steps=torch.zeros(W, dtype=torch.int32, device=dev),
            stale_time=_f32(0, dev), stale_steps=_i32(0, dev), stale_events=_i32(0, dev))
        if self._message_mode:
            proto = proto._replace(exch_timeouts=_i32(0, dev), exch_retries=_i32(0, dev))
            self._per_event = float(self._impl.comm_cost(
                self._wire_bytes(state.spec), W).bytes_per_event)
        return state.replace(proto=proto)

    def anchor(self, clocks, steps_done) -> None:
        """Re-anchor the host virtual-time mirrors (init / checkpoint load)."""
        self.clocks = np.array(clocks, np.float64).reshape(self.num_workers)
        self.steps_done = np.array(steps_done, np.int64).reshape(self.num_workers)

    def clock_state(self) -> dict:
        """JSON-serializable virtual-time position; float64 round-trips
        through JSON exactly, so a resumed run continues the clocks bit for
        bit."""
        return {"clocks": [float(c) for c in self.clocks],
                "steps_done": [int(s) for s in self.steps_done]}

    # ------------------------------------------------------------ event loop
    def next_window(self):
        """(t, mask, next_times): the earliest next completion time across the
        fleet and the boolean window of workers completing exactly then."""
        nxt = self.time_model.next_completion(self.steps_done, self.clocks)
        t = float(np.min(nxt))
        return t, nxt <= t, nxt

    def step(self, state: FlatState, x, y, draws=None):
        """Process ONE event window: every in-window worker completes a local
        step (on its row of the batch) and, gate willing, initiates an
        exchange. Under a full-fleet outage the window is EMPTY: the clocks
        cross the dark interval and no step runs. ``draws=(gate, peers)`` is
        the sim engine's parity hook: this window's gate and peer draws."""
        hold = self.time_model.outage_window(self.steps_done, self.clocks)
        if hold is not None:
            return self._outage_step(state, float(hold))
        t, mask, nxt = self.next_window()
        if self.host_plane:
            return self._hostplane.window_step(state, x, y, t, mask, nxt, draws=draws)
        step0 = state.step             # the step returns a new counter
        tokens0 = state.proto.tokens   # and new balances: these stay pre-step
        if self._message_mode:
            return self._message_step(state, x, y, t, mask, nxt, draws)
        if mask.all():
            # full-fleet window: the synchronous step, verbatim
            state, m = super().step(state, x, y, draws=draws)
        else:
            state, m = super().step(state, x, y, draws=draws, worker_mask=mask)
        proto = self._advance_clocks(state.proto, step0, nxt, mask, tokens0)
        state = state.replace(proto=proto)
        self.clocks = np.where(mask, nxt, self.clocks)
        self.steps_done = self.steps_done + mask
        m = dict(m, virtual_time=t, window_size=int(mask.sum()),
                 stale_time=proto.stale_time, stale_steps=proto.stale_steps,
                 stale_events=proto.stale_events)
        return state, m

    def _outage_step(self, state: FlatState, t_end: float):
        """Empty event window: the whole fleet is dark until ``t_end``. The
        clocks advance (host mirrors and the f32 view); no step runs."""
        W = self.num_workers
        self.clocks = np.full((W,), t_end, np.float64)
        proto = state.proto._replace(clocks=torch.as_tensor(
            self.clocks, dtype=torch.float32, device=state.step.device))
        state = state.replace(proto=proto)
        m = {"loss_mean": float("nan"), "loss_max": float("nan"),
             "comm_active": 0, "virtual_time": t_end, "window_size": 0,
             "stale_time": proto.stale_time, "stale_steps": proto.stale_steps,
             "stale_events": proto.stale_events}
        return state, m

    def _advance_clocks(self, proto, step0, nxt, mask, tokens0=None,
                        count_stale: bool = True):
        """Advance the f32 clocks and the per-worker step counts of the
        window, and add each in-window initiation's staleness (the
        |clock| and |step count| gaps to its partner, after the window).
        The gate and peers are what the step drew (``last_draws``); flow
        control masks with the PRE-step balances the step saw. Message mode
        passes ``count_stale=False``: it accounts staleness at arrival."""
        dev = proto.worker_steps.device
        mask_t = torch.as_tensor(mask, device=dev)
        clocks = torch.where(mask_t, torch.as_tensor(nxt, dtype=torch.float32, device=dev),
                             proto.clocks)
        wsteps = proto.worker_steps + mask_t.to(torch.int32)
        stale_time, stale_steps, stale_events = (
            proto.stale_time, proto.stale_steps, proto.stale_events)
        if self._impl.pairwise and count_stale:
            gate, peers = self.last_draws
            active = gate & mask_t
            if self.flow is not None and tokens0 is not None:
                active = active & self.flow.allow(step0, tokens0)
            peers = peers.long()
            act_i = active.to(torch.int32)
            stale_time = stale_time + torch.sum(
                active.to(torch.float32) * torch.abs(clocks - clocks[peers]))
            stale_steps = stale_steps + torch.sum(
                act_i * torch.abs(wsteps - wsteps[peers])).to(torch.int32)
            stale_events = stale_events + torch.sum(act_i).to(torch.int32)
        return proto._replace(clocks=clocks, worker_steps=wsteps, stale_time=stale_time,
                              stale_steps=stale_steps, stale_events=stale_events)

    # ------------------------------------------------ message mode (delays)
    def _message_step(self, state, x, y, t, mask, nxt, draws=None):
        """One event window in message mode: deliver every pending wire due
        at or before ``t`` (timing out and retrying stragglers), run the
        local step with the mixing deferred, then dispatch this window's new
        exchanges into the queue."""
        state = self._process_queue(state, t, mask)
        step0 = state.step
        state, m = SimTrainer.step(self, state, x, y, draws=draws,
                                   worker_mask=None if mask.all() else mask,
                                   defer_comm=True)
        proto = self._advance_clocks(state.proto, step0, nxt, mask, count_stale=False)
        state = state.replace(proto=proto)
        self.clocks = np.where(mask, nxt, self.clocks)
        self.steps_done = self.steps_done + mask
        state = self._dispatch(state, step0, t, mask)
        proto = state.proto
        m = dict(m, virtual_time=t, window_size=int(mask.sum()),
                 pending_wires=len(self._pending),
                 stale_time=proto.stale_time, stale_steps=proto.stale_steps,
                 stale_events=proto.stale_events,
                 exch_timeouts=proto.exch_timeouts, exch_retries=proto.exch_retries)
        return state, m

    def _dispatch(self, state, step0, t, mask):
        """Enqueue this window's exchanges: active initiator i captures its
        own published row (a Byzantine worker garbles it) and partner k's
        current row, both cloned now; the wire arrives at ``t + delay``.
        Dropped and corrupt wires die here, counted and never applied."""
        gate, peers = self.last_draws
        active = gate.cpu().numpy() & mask
        if not active.any():
            return state
        peers = peers.cpu().numpy()
        fm = self.fault_model
        step_host = int(step0)
        coef = float(self._impl.alpha_at(step0))
        drops = corrupts = 0
        for i in np.nonzero(active)[0]:
            i = int(i)
            k = int(peers[i])
            if k == i:
                continue
            if fm is not None and fm.injects_drop and bool(fm.drop_mask(i, step_host)):
                drops += 1
                continue
            if fm is not None and fm.injects_corrupt and bool(fm.corrupt_mask(i, step_host)):
                corrupts += 1
                continue
            wire_i = {b: state.theta[b][i].clone() for b in state.theta}
            wire_k = {b: state.theta[b][k].clone() for b in state.theta}
            if fm is not None and fm.injects_byzantine:
                wire_i = fm.garble_row(wire_i, i, step_host, self.num_workers)
                wire_k = fm.garble_row(wire_k, k, step_host, self.num_workers)
            d = float(self.delay_model.wire_delay(i, step_host, attempt=0))
            self._pending.append(dict(
                arrival=t + d, dispatch=t, attempt=0, i=i, k=k,
                wire_i=wire_i, wire_k=wire_k, step=step_host, coef=coef,
                gap=int(abs(self.steps_done[i] - self.steps_done[k]))))
        if drops or corrupts:
            proto = state.proto
            upd = {}
            if drops:
                upd["wire_dropped"] = proto.wire_dropped + drops
            if corrupts:
                upd["wire_corrupt"] = proto.wire_corrupt + corrupts
            state = state.replace(proto=proto._replace(**upd))
        return state

    def _process_queue(self, state, t, mask):
        """Deliver or time out pending wires at window time ``t``. A wire is
        deliverable once ``arrival <= t``; under rendezvous the initiator
        also waits for its partner's step boundary (``mask[k]``). A wire
        older than ``timeout * 2**attempt`` times out: re-dispatched with a
        fresh delay while retries remain, abandoned after. Timed-out
        exchanges never count their bytes; ``comm_bytes`` is re-derived
        from ``comm_units``."""
        if not self._pending:
            return state
        cfg = self.faults
        applied = timeouts = retries = gaps = 0
        ages = 0.0
        keep = []
        for e in self._pending:
            deliverable = (e["arrival"] <= t
                           and (not cfg.rendezvous or bool(mask[e["k"]])))
            if deliverable:
                self._apply_exchange(state.theta, e)
                applied += 1
                ages += t - e["dispatch"]
                gaps += e["gap"]
            elif (cfg.timeout > 0.0
                    and t > e["dispatch"] + cfg.timeout * (2.0 ** e["attempt"])):
                timeouts += 1
                if e["attempt"] < cfg.max_retries:
                    retries += 1
                    a = e["attempt"] + 1
                    d = float(self.delay_model.wire_delay(e["i"], e["step"], attempt=a))
                    keep.append(dict(e, attempt=a, dispatch=t, arrival=t + d))
                # else: abandoned
            else:
                keep.append(e)
        self._pending = keep
        if not (applied or timeouts):
            return state
        proto = state.proto
        dev = proto.comm_units.device
        units = min(int(proto.comm_units) + applied, 2 ** 31 - 1)
        upd = dict(
            comm_units=_i32(units, dev),
            comm_bytes=_f32((self._per_event / self.num_workers) * units, dev),
            comm_rounds=proto.comm_rounds + (1 if applied else 0),
            stale_time=proto.stale_time + _f32(ages, dev),
            stale_steps=proto.stale_steps + gaps,
            stale_events=proto.stale_events + applied)
        if timeouts:
            upd["exch_timeouts"] = proto.exch_timeouts + timeouts
        if retries:
            upd["exch_retries"] = proto.exch_retries + retries
        return state.replace(proto=proto._replace(**upd))

    def _apply_exchange(self, theta: dict, e: dict) -> None:
        """Realize ONE arrived exchange on the resident plane, in place: both
        rows move toward the row the OTHER side published at dispatch
        (symmetric pairwise averaging on the captured wires). Robust
        protocols go through their ``robust_rows_apply`` hook (the
        reference's ``robust_pair_apply`` on both rows at once: one B8
        launch per bucket), fed the wire's step-count gap."""
        i, k, coef = e["i"], e["k"], e["coef"]
        local = {b: theta[b][[i, k]] for b in theta}
        recv = {b: torch.stack([e["wire_k"][b], e["wire_i"][b]]) for b in theta}
        rows_hook = getattr(self._impl, "robust_rows_apply", None)
        if rows_hook is not None:
            new = rows_hook(local, recv, coef, gap=e["gap"])
        else:
            new = {b: (local[b].to(torch.float32) + coef * (
                recv[b].to(torch.float32) - local[b].to(torch.float32))).to(local[b].dtype)
                for b in local}
        for b in theta:
            theta[b][i] = new[b][0]
            theta[b][k] = new[b][1]
