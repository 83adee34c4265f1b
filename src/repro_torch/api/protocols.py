"""The paper's Algorithms 1-6 as Protocol objects (port of
``repro.api.protocols``).

Each protocol carries the paper's two components (§2.2): a
``gradient_transform`` (only All-reduce SGD averages gradients) and a gated
``comm_update`` on the stacked ``[W, N]`` buffers, plus ``comm_cost``
accounting and the capability flags the engines and the scheduler read
(``communicates``, ``pairwise``, ``uses_center``, ``per_worker_gate``).
Both components read the step-t state, so the engine composes them
additively (§2.3). The dist engine realises pairwise protocols through
``pair_gate_coef`` over the static matching schedule that
``schedule_partners`` surfaces; its cross-worker reductions (the gradient
mean, the EASGD center) take the rank's ``group``.

``ProtocolState.comm_units`` is an exact int32 participation count that
saturates at int32 max; ``comm_bytes`` is derived from it every update as
``(per_event / W) * units`` in f32, never accumulated, exactly as the
reference does. With a codec (:mod:`repro_torch.comm`, pairwise protocols
only) the per-event size is the codec's wire. With a fault plane
(:mod:`repro_torch.faults`) the engine hands ``comm_update`` a
:class:`WireFaults`: the marked senders' wires are discarded at the mixing
boundary, counted in ``wire_dropped``/``wire_corrupt``, and left out of
``comm_units``/``comm_bytes`` (bytes count applied exchanges only). The
robust protocols live in :mod:`repro_torch.api.robust`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.api.registry import register_protocol
from repro_torch.common.config import ProtocolConfig
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.core import topology

PyTree = Any


class ProtocolState(NamedTuple):
    center: Optional[PyTree]      # EASGD center variable (else None)
    comm_rounds: torch.Tensor     # int32: gossip rounds executed
    comm_units: torch.Tensor      # int32: cumulative worker participations
    comm_bytes: torch.Tensor      # f32: expected egress bytes/worker (derived)
    # virtual time of the async engine (None on the synchronous engines):
    # staleness is accounted per exchange initiation, the gap between the
    # initiator's (clock, local step count) and its partner's
    clocks: Optional[torch.Tensor] = None         # f32[W]: per-worker virtual clock
    worker_steps: Optional[torch.Tensor] = None   # int32[W]: per-worker local steps
    stale_time: Optional[torch.Tensor] = None     # f32: sum of virtual-time gaps
    stale_steps: Optional[torch.Tensor] = None    # int32: sum of step-count gaps
    stale_events: Optional[torch.Tensor] = None   # int32: exchange initiations
    # fault-plane counters: None unless a FaultConfig is given (the engine
    # then seeds them to 0 at init)
    wire_dropped: Optional[torch.Tensor] = None   # int32: wires lost in flight
    wire_corrupt: Optional[torch.Tensor] = None   # int32: wires failing checksum
    exch_timeouts: Optional[torch.Tensor] = None  # int32: exchanges timed out (async)
    exch_retries: Optional[torch.Tensor] = None   # int32: wire re-dispatches (async)
    # fleet plane: None unless a FleetConfig turns the feature on
    tokens: Optional[torch.Tensor] = None         # f32[W]: flow-control balances
    flow_skipped: Optional[torch.Tensor] = None   # int32: initiations flow control skipped
    chunk_units: Optional[torch.Tensor] = None    # int32[P]: applied exchanges per chunk id


class WireFaults(NamedTuple):
    """Per-event wire-fault masks, computed by the engine (pure hashes of
    (FaultConfig.seed, worker, step)) and handed to ``comm_update``, which
    discards the marked senders' wires at the mixing boundary and keeps them
    out of the byte accounting. Either mask may be None (that fault family
    is not configured)."""
    dropped: Optional[torch.Tensor] = None   # bool[W]: sender's wire lost in flight
    corrupt: Optional[torch.Tensor] = None   # bool[W]: sender's wire failed checksum

    def lost(self) -> Optional[torch.Tensor]:
        """Combined bool[W] mask of senders whose wire must be discarded."""
        if self.dropped is None:
            return self.corrupt
        if self.corrupt is None:
            return self.dropped
        return self.dropped | self.corrupt


@dataclasses.dataclass(frozen=True)
class CommCost:
    bytes_per_event: float     # bytes one worker transmits per communication event
    events_per_step: float     # expected events per training step

    @property
    def bytes_per_step(self) -> float:
        return self.bytes_per_event * self.events_per_step


def stacked_param_bytes(theta_stack: PyTree) -> int:
    """Bytes of ONE replica of a [W, ...]-stacked parameter pytree."""
    total = 0
    for leaf in tree_leaves(theta_stack):
        n = 1
        for d in leaf.shape[1:]:
            n *= int(d)
        total += n * leaf.element_size()
    return total


def _saturating_units_add(units: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """comm_units + inc, saturating at int32 max instead of wrapping."""
    new = units + inc
    return torch.where(new < units, units, new)


def _first_leaf(tree: PyTree) -> torch.Tensor:
    return tree_leaves(tree)[0]


class Protocol:
    """Base class: one distributed-training algorithm, fully self-describing.

    Instances are immutable views over a frozen :class:`ProtocolConfig`; all
    evolving quantities live in :class:`ProtocolState` or engine state.
    """

    name: ClassVar[str] = ""
    # capability flags consumed by the engines / scheduler / facade:
    communicates: ClassVar[bool] = True    # has a gated communication component
    pairwise: ClassVar[bool] = False       # pairwise gossip (one send/recv per round)
    uses_center: ClassVar[bool] = False    # EASGD-style center variable
    per_worker_gate: ClassVar[bool] = True  # Bernoulli per worker (vs one draw)
    # runs without a global step barrier (engine="async"); All-reduce SGD
    # averages gradients across ALL workers every step, so it cannot
    barrier_free: ClassVar[bool] = True

    def __init__(self, cfg: ProtocolConfig):
        self.cfg = cfg
        if self.communicates:
            assert (cfg.comm_probability > 0) != (cfg.comm_period > 0), (
                f"protocol {cfg.method!r} is gated: set exactly one of "
                "comm_probability / comm_period")
        if cfg.codec != "none":
            if not self.pairwise:
                raise ValueError(
                    f"codec {cfg.codec!r} compresses the pairwise gossip wire; "
                    f"protocol {cfg.method!r} is not pairwise")
            from repro_torch.comm import get_codec
            get_codec(cfg.codec)   # fail fast on unknown codec names

    # ---------------------------------------------------------------- state
    def init_state(self, params_stack: PyTree) -> ProtocolState:
        dev = _first_leaf(params_stack).device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return ProtocolState(self.init_center(params_stack), zero, zero.clone(),
                             torch.zeros((), dtype=torch.float32, device=dev))

    def init_center(self, params_stack: PyTree) -> Optional[PyTree]:
        return None

    # ----------------------------------------------------- gradient component
    def gradient_transform(self, grads_stack: PyTree, group=None) -> PyTree:
        """``group``: the dist engine's worker group, over which a protocol
        that reduces across workers reduces (None on the sim engine)."""
        return grads_stack

    # ------------------------------------------------------------ scheduling
    def alpha_at(self, step) -> torch.Tensor:
        """Moving rate at ``step`` (0-d tensor): constant, or linearly
        annealed to moving_rate_final."""
        cfg = self.cfg
        a0 = torch.full((), cfg.moving_rate, dtype=torch.float32, device=step.device)
        if cfg.moving_rate_final < 0 or cfg.alpha_decay_steps <= 0:
            return a0
        frac = torch.clamp(step.float() / cfg.alpha_decay_steps, 0.0, 1.0)
        return a0 + (cfg.moving_rate_final - a0) * frac

    def comm_gate(self, gen: torch.Generator, step: torch.Tensor,
                  num_workers: int) -> torch.Tensor:
        """Per-worker participation for this step: bool[W] on the device.

        period tau  -> all workers together every tau steps (Alg. 2/3/4/6);
        probability p -> independent Bernoulli per worker (Alg. 5 / GoSGD).
        """
        cfg = self.cfg
        if not self.communicates:
            return torch.zeros(num_workers, dtype=torch.bool, device=step.device)
        if cfg.comm_period:
            fire = (step % cfg.comm_period) == 0
            return fire.expand(num_workers).clone()
        return topology.participation(gen, num_workers, cfg.comm_probability)

    # ------------------------------------------------- communication component
    def sample_peers(self, gen: torch.Generator, num_workers: int) -> torch.Tensor:
        """Peer selection k'(i) for pairwise protocols (matching or uniform)."""
        if self.cfg.topology == "matching":
            return topology.sample_matching(gen, num_workers)
        return topology.sample_uniform_peers(gen, num_workers)

    def comm_update(self, gen: Optional[torch.Generator], active: torch.Tensor,
                    theta_stack: dict, state: ProtocolState, step=None,
                    transmit: Optional[dict] = None,
                    wire_bytes: Optional[float] = None,
                    peers: Optional[torch.Tensor] = None,
                    wire_faults: Optional[WireFaults] = None):
        """Communication-related component on the stacked ``[W, ...]`` dict.

        Pairwise protocols mix via :meth:`mix_matrix` over ``peers`` (drawn
        from ``gen`` when not given); the mixing matmul always runs, also on
        a step where nobody fires (identity mix), as in the reference.
        ``wire_bytes`` is the exact per-replica wire size; flat-resident
        callers pass it because their buffers carry lane padding.
        ``wire_faults`` carries the engine's fault masks: the lost senders'
        wires are discarded (:func:`topology.discard_lost`, the receiver
        keeps its own row for the undelivered share) and excluded from the
        applied-exchange accounting. Returns (theta', state'); theta' is a
        new dict of new tensors.
        """
        if not self.pairwise:
            return theta_stack, state
        if peers is None:
            peers = self.sample_peers(gen, active.shape[0])
        mix = self.mix_matrix(peers, active, step=step)
        lost = wire_faults.lost() if wire_faults is not None else None
        if lost is not None:
            mix = topology.discard_lost(mix, lost)
        if transmit is None:
            theta_new = topology.apply_mix(mix, theta_stack)
        else:
            theta_new = topology.apply_mix_split(mix, theta_stack, transmit)
        rounds = state.comm_rounds + torch.any(active).to(torch.int32)
        units, bytes_ = self._accrue_bytes(state, active, theta_stack, wire_bytes,
                                           lost=lost)
        state = self._count_wire_faults(state, active, wire_faults)
        return theta_new, state._replace(comm_rounds=rounds, comm_units=units,
                                         comm_bytes=bytes_)

    def mix_matrix(self, peers, active, step=None) -> torch.Tensor:
        """[W, W] mixing matrix over the worker axis."""
        raise ValueError(f"protocol {self.name!r} is not a pairwise-gossip method")

    # ------------------------------------- pairwise (dist-engine) realization
    def pair_gate_coef(self, my_active, peer_active):
        """Gate/coefficient for a matched pair in the dist engine:
        theta <- theta - coef*gate*(theta - peer)."""
        raise ValueError(f"protocol {self.name!r} is not a pairwise-gossip method")

    # ------------------------------------------------ host-side topology hook
    def _host_schedule(self, num_workers: int, mesh_cfg=None, seed: int = 0):
        from repro_torch.common.config import MeshConfig
        from repro_torch.core import gossip_dist
        mcfg = mesh_cfg or MeshConfig(data=num_workers, model=1, pods=1,
                                      workers_per_pod=num_workers)
        kind = "hypercube" if self.cfg.topology == "matching" else "random"
        cache = self.__dict__.setdefault("_host_sched_cache", {})
        key = (mcfg, kind, seed)
        if key not in cache:
            cache[key] = (gossip_dist.build_schedule(mcfg, kind, seed=seed), mcfg)
        return cache[key]

    def schedule_rounds(self, num_workers: int, mesh_cfg=None, seed: int = 0) -> int:
        """Number of distinct rounds in the host-side matching schedule
        (cycled by round index)."""
        return len(self._host_schedule(num_workers, mesh_cfg, seed)[0])

    def schedule_partners(self, round_idx: int, num_workers: int, mesh_cfg=None,
                          seed: int = 0) -> np.ndarray:
        """Host-side partner index per worker for one gossip round, the
        time-varying topology hook: it replays exactly the static
        ``gossip_dist.build_schedule`` the dist engine exchanges over, so the
        facade surfaces (``GossipTrainer.matching_partners``,
        ``GossipSchedule.partners``) and the engine stay in lock-step; a
        registered subclass overriding this changes every host consumer at
        once."""
        from repro_torch.core import gossip_dist
        sched, mcfg = self._host_schedule(num_workers, mesh_cfg, seed)
        return np.array([gossip_dist.partner_of(sched, round_idx, w, mcfg)
                         for w in range(mcfg.num_workers)])

    # ------------------------------------------------------------- accounting
    def events_per_step(self) -> float:
        cfg = self.cfg
        if cfg.comm_probability:
            return cfg.comm_probability
        return 1.0 / cfg.comm_period if cfg.comm_period else 0.0

    def comm_cost(self, param_bytes: int, num_workers: int) -> CommCost:
        """Expected egress bytes per worker per step (analytic)."""
        raise NotImplementedError

    def wire_stack_bytes(self, theta_stack: PyTree) -> float:
        """Bytes ONE replica puts on the wire per event: raw param bytes, or
        the codec's wire bytes of the flat plane when ``cfg.codec`` is set."""
        if self.cfg.codec == "none":
            return float(stacked_param_bytes(theta_stack))
        from repro_torch import comm
        from repro_torch.common.flat import FlatSpec
        spec = FlatSpec.build(theta_stack, leading=1)
        return float(comm.wire_param_bytes(comm.resolve_codec(self.cfg), spec))

    def _derived_bytes(self, per_event: float, W: int, units: torch.Tensor) -> torch.Tensor:
        # (per_event / W) rounds to f32 first, then one f32 multiply: the
        # reference's weak-typed python float times an f32 array
        return torch.full((), per_event / W, dtype=torch.float32,
                          device=units.device) * units.float()

    def _accrue_bytes(self, state: ProtocolState, active: torch.Tensor,
                      theta_stack: PyTree, wire_bytes: Optional[float] = None,
                      lost: Optional[torch.Tensor] = None):
        """(comm_units', comm_bytes'): the exact participation count plus the
        derived per-worker egress. ``lost`` (optional bool[W], the fault
        plane's discard mask) removes dropped/corrupted wires from the count:
        bytes accrue for applied exchanges only, and an all-false mask gives
        the identical integer."""
        W = active.shape[0]
        if wire_bytes is None:
            wire_bytes = self.wire_stack_bytes(theta_stack)
        per_event = self.comm_cost(wire_bytes, W).bytes_per_event
        engaged = active.to(torch.int32)
        if lost is not None:
            engaged = engaged * (~lost).to(torch.int32)
        units = _saturating_units_add(state.comm_units,
                                      torch.sum(engaged).to(torch.int32))
        return units, self._derived_bytes(per_event, W, units)

    def _count_wire_faults(self, state: ProtocolState, active: torch.Tensor,
                           wire_faults: Optional[WireFaults]) -> ProtocolState:
        """Accumulate the fault-plane counters among engaged senders."""
        if wire_faults is None:
            return state
        upd = {}
        for field, mask in (("wire_dropped", wire_faults.dropped),
                            ("wire_corrupt", wire_faults.corrupt)):
            if mask is not None:
                base = getattr(state, field)
                if base is None:
                    base = torch.zeros((), dtype=torch.int32, device=active.device)
                upd[field] = base + torch.sum((active & mask).to(torch.int32)).to(torch.int32)
        return state._replace(**upd) if upd else state


# ---------------------------------------------------------------------------
# Baselines without a gated communication component
# ---------------------------------------------------------------------------

@register_protocol("none")
class NoCommunication(Protocol):
    """Independent workers (paper §2.1): the divergence baseline."""
    communicates = False

    def comm_cost(self, param_bytes: int, num_workers: int) -> CommCost:
        return CommCost(0.0, 0.0)


@register_protocol("allreduce")
class AllReduceSGD(Protocol):
    """Alg. 1: gradient averaging every step (ring all-reduce accounting)."""
    communicates = False
    barrier_free = False   # every-step gradient averaging needs a full barrier

    def gradient_transform(self, grads_stack: PyTree, group=None) -> PyTree:
        if group is not None:
            # the dist engine: each rank's [1, N] row becomes the fleet mean
            return tree_map(lambda g: group.all_reduce_sum(g) / group.world, grads_stack)
        return tree_map(lambda g: torch.mean(g, dim=0, keepdim=True).expand_as(g),
                        grads_stack)

    def comm_update(self, gen, active, theta_stack, state, step=None,
                    transmit=None, wire_bytes=None, peers=None, wire_faults=None):
        # parameters untouched; the every-step ring all-reduce egress is
        # accounted so live runs expose the communication-cost gap
        W = active.shape[0]
        if wire_bytes is None:
            wire_bytes = stacked_param_bytes(theta_stack)
        per_event = self.comm_cost(wire_bytes, W).bytes_per_event
        units = _saturating_units_add(state.comm_units,
                                      torch.full_like(state.comm_units, W))
        return theta_stack, state._replace(
            comm_units=units, comm_bytes=self._derived_bytes(per_event, W, units))

    def comm_cost(self, param_bytes: int, num_workers: int) -> CommCost:
        # ring all-reduce: 2 * (W-1)/W * P per step, every step
        return CommCost(2.0 * (num_workers - 1) / num_workers * param_bytes, 1.0)


# ---------------------------------------------------------------------------
# EASGD (center variable)
# ---------------------------------------------------------------------------

@register_protocol("easgd")
class EASGD(Protocol):
    """Alg. 2: elastic averaging against an explicit center variable."""
    uses_center = True
    per_worker_gate = False   # all workers exchange with the center together

    def init_center(self, params_stack: PyTree) -> PyTree:
        # center initialized to the common init (= worker 0's replica)
        return tree_map(lambda x: x[0].clone(), params_stack)

    def center_step(self, theta_stack: PyTree, center: PyTree, active, step=None,
                    group=None):
        """Alg. 2 lines 5-7, gated: z_i = alpha gate_i (theta_i - center).
        Returns (delta, center') with delta = -z per worker. ``active`` is a
        [W] mask (sim engine) or one shared gate (dist engine, where
        ``group`` sums z over the ranks' rows)."""
        from repro_torch.core.consensus import worker_sum
        a = self.cfg.moving_rate if step is None else self.alpha_at(step)
        W = _first_leaf(theta_stack).shape[0]
        act = torch.as_tensor(active, device=_first_leaf(theta_stack).device).float().expand(W)
        deltas, centers = {}, {}
        for k in theta_stack:
            x, c = theta_stack[k], center[k]
            gate = act.reshape((W,) + (1,) * (x.dim() - 1))
            z = a * gate * (x.float() - c.float()[None])
            deltas[k] = (-z).to(x.dtype)
            centers[k] = c + worker_sum(z, group).to(c.dtype)
        return deltas, centers

    def comm_update(self, gen, active, theta_stack, state, step=None,
                    transmit=None, wire_bytes=None, peers=None, wire_faults=None):
        delta, center_new = self.center_step(theta_stack, state.center, active, step=step)
        theta_new = {k: theta_stack[k] + delta[k] for k in theta_stack}
        rounds = state.comm_rounds + torch.any(active).to(torch.int32)
        units, bytes_ = self._accrue_bytes(state, active, theta_stack, wire_bytes)
        return theta_new, state._replace(center=center_new, comm_rounds=rounds,
                                         comm_units=units, comm_bytes=bytes_)

    def comm_cost(self, param_bytes: int, num_workers: int) -> CommCost:
        # send local, receive center (center egress excluded: worker-side view)
        return CommCost(2.0 * param_bytes, self.events_per_step())


# ---------------------------------------------------------------------------
# Pairwise gossip family
# ---------------------------------------------------------------------------

class PairwiseGossip(Protocol):
    """Peer-exchange protocols: the ``pairwise`` flag activates the base
    comm_update (mix over sampled peers); the default cost is one replica
    to/from one peer per participating event."""
    pairwise = True

    def comm_cost(self, param_bytes: int, num_workers: int) -> CommCost:
        return CommCost(float(param_bytes), self.events_per_step())


@register_protocol("elastic_gossip")
class ElasticGossip(PairwiseGossip):
    """Alg. 4/5: symmetric elastic pairwise exchange — the paper's method."""

    def mix_matrix(self, peers, active, step=None):
        a = self.cfg.moving_rate if step is None else self.alpha_at(step)
        return topology.elastic_gossip_mix(peers, active, a)

    def pair_gate_coef(self, my_active, peer_active):
        # fires if either endpoint selected the pair (passive peers respond)
        return torch.maximum(my_active, peer_active), self.cfg.moving_rate


@register_protocol("gossiping_pull")
class GossipingPull(PairwiseGossip):
    """Alg. 3: pull-Gossiping SGD — theta_i <- (theta_i + theta_k')/2."""

    def mix_matrix(self, peers, active, step=None):
        return topology.gossip_pull_mix(peers, active)

    def pair_gate_coef(self, my_active, peer_active):
        return my_active, 0.5


@register_protocol("gossiping_push")
class GossipingPush(PairwiseGossip):
    """Alg. 6: push-Gossiping SGD — theta_i <- mean({theta_i} U pushers)."""

    def mix_matrix(self, peers, active, step=None):
        return topology.gossip_push_mix(peers, active)

    def pair_gate_coef(self, my_active, peer_active):
        return peer_active, 0.5


# The robust mixing protocols (clipped_gossip / trimmed_gossip) live in their
# own module but register into the same registry; importing here keeps
# "import repro_torch.api" sufficient for name resolution.
from repro_torch.api import robust as _robust  # noqa: E402,F401
