"""GossipTrainer facade — the port's entry point (port of
``repro.api.trainer`` for ``engine="sim"``, ``"dist"`` and ``"async"``).

    from repro_torch.api.trainer import GossipTrainer

    trainer = GossipTrainer(engine="sim", protocol=proto, optimizer=opt,
                            loss_fn=loss_fn, num_workers=8)      # on "cuda"
    state = trainer.init_state(seed=0, params=params)
    for step in range(steps):
        state, metrics = trainer.step(state, (x, y))

Everything runs on ``device`` ("cuda" unless the caller passes another);
asking for CUDA without a card raises, nothing moves to the CPU quietly.

Engines:

- ``engine="sim"``: exact Alg. 1-6 on W stacked replicas in one process
  (:class:`repro_torch.core.gossip_sim.SimTrainer`). The step updates the
  resident buffers of ``state`` in place; metrics are device tensors (no
  host sync per step).
- ``engine="dist"``: one process per gossip worker
  (:class:`repro_torch.train.step.DistTrainer` over
  :mod:`repro_torch.core.gossip_dist`). Each rank builds its own facade with
  ``group=`` (its :class:`~repro_torch.launch.mesh.WorkerGroup`, e.g. from
  :func:`repro_torch.launch.mesh.spawn_workers`) and steps it on its own
  batch ``(x [pw, ...], y [pw])``. Scheduling is host-side and replayable
  (:class:`repro_torch.core.scheduler.GossipSchedule` from ``seed + 1``,
  equal on every rank); ``comm_bytes`` is a host float64 accumulator and
  ``loss`` the fleet mean (a gloo all-reduce per step).

- ``engine="async"``: the virtual-time heterogeneous-fleet engine
  (:class:`repro_torch.core.gossip_async.AsyncTrainer`, ``hetero=`` a
  :class:`~repro_torch.common.config.HeteroConfig`): one :meth:`step` is one
  event window; metrics add ``virtual_time``, ``window_size`` and the
  staleness sums; a constant fleet reproduces ``engine="sim"`` bit for bit.

``fleet=`` (a :class:`~repro_torch.common.config.FleetConfig`: partitioned
exchanges, flow control; the host-resident plane on async only) runs on the
sim and async engines; the dist engine refuses it.

``shard=`` (a :class:`~repro_torch.common.config.ShardConfig`,
:mod:`repro_torch.shard`) pads the flat plane to S equal column shards on
all three engines: the codec encodes per shard (seeds ``worker * S +
shard``) and ``comm_bytes`` counts the per-device wire. On the dist engine
each rank holds its row as S shard rows and the mesh's ``fsdp`` must be S.

``obs=`` (an :class:`~repro_torch.common.config.ObsConfig`,
:mod:`repro_torch.obs`) records typed trace events and per-step metrics;
:meth:`GossipTrainer.export_obs` writes them. On the dist engine rank 0
records the fleet's events from the host schedule. The all-default
``ShardConfig()`` and ``ObsConfig()`` change nothing.

The engines expose the shared matching schedule (:meth:`matching_partners`,
:attr:`num_gossip_rounds`) and one communication round as the parity
surface :meth:`gossip_exchange` (the mixing-matrix oracle on the sim
engine, the real exchange on the dist engine).

Checkpoints (:meth:`save_checkpoint` / :meth:`load_checkpoint`) are the
reference's v2 files (:mod:`repro_torch.checkpoint.io`): either package
loads the other's. The dist engine writes the whole ``[W, total]`` plane
from rank 0 after a gather, with the schedule and ``comm_bytes`` in the
metadata, and every rank reads its own row back. The async engine adds its
host clocks (``hetero_clock``) and the hetero, fault and fleet descriptors,
and refuses a checkpoint written under another fleet. A sharded trainer
writes its ``shard`` descriptor; a restore across shard layouts is refused
before any array is read.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.api import registry
from repro_torch.api.protocols import CommCost
from repro_torch.common.config import (HeteroConfig, MeshConfig, OptimizerConfig,
                                       ProtocolConfig, TrainConfig)
from repro_torch.common.pytree import tree_map
from repro_torch.obs import schema as obs_schema
from repro_torch.serving.engine import consensus_params

PyTree = Any


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def _sharded(shard) -> bool:
    return shard is not None and shard.enabled()


def _validate_shard_meta(facade, meta) -> None:
    """Refuse to restore across shard layouts, BEFORE any array is touched:
    the saved shard descriptor (n_shards / axes / quantum) must match the
    trainer's, field by field, since the resident widths and the codec
    streams are functions of it. The bucket totals are then held by the
    FlatSpec manifest check of the restore."""
    from repro_torch.shard import shard_descriptor
    meta = meta or {}
    cur = shard_descriptor(facade.shard, facade.codec) if _sharded(facade.shard) else None
    if "shard" in meta:
        if cur is None:
            raise ValueError(
                "checkpoint was written under a sharded plane "
                f"({meta['shard']!r}) but this trainer is un-sharded — the "
                "resident buffer widths and codec streams depend on the "
                "layout; pass the same ShardConfig (shard=...) to resume")
        _diff_descriptor("shard", meta["shard"], cur)
    elif cur is not None:
        raise ValueError(
            "checkpoint was written WITHOUT a sharded plane but this "
            "trainer configures one — restoring would reinterpret the "
            "un-padded buffers under the sharded layout; drop shard= or "
            "start a fresh run")


def _diff_descriptor(name: str, saved: dict, current: dict) -> None:
    """Raise a field-by-field ValueError when a persisted descriptor
    (hetero / fault / fleet / shard plane) differs from the live trainer's."""
    diffs = sorted(k for k in set(saved) | set(current)
                   if saved.get(k) != current.get(k))
    if diffs:
        detail = ", ".join(
            f"{k}: saved={saved.get(k)!r} != current={current.get(k)!r}"
            for k in diffs)
        raise ValueError(
            f"checkpoint was written under a different {name} config — "
            f"{detail}. Restore with the matching config (the virtual-time "
            "and fault draws are pure functions of it) or start a fresh run")


def _init_params(facade, seed, params):
    """``params``, or ``init_fn`` called with a generator on the facade's
    device seeded by ``seed``."""
    if params is not None:
        return params
    if facade.init_fn is None:
        raise ValueError("provide init_fn at construction or params here")
    gen = torch.Generator(device=facade.device)
    gen.manual_seed(int(seed))
    return facade.init_fn(gen)


class _Backend:
    """What the engines share: the host-side matching schedule (hypercube or
    random matchings), through the protocol's ONE overridable
    :meth:`~repro_torch.api.protocols.Protocol.schedule_partners` hook; and
    the checkpoint hooks as the sim engine needs them, whose gate and peer
    draws live in ``FlatState.key`` and ``comm_bytes`` in ``ProtocolState``,
    both saved with the state. An engine with a host schedule sets
    ``sched``."""
    sched = None

    def matching_partners(self, round_idx: int) -> np.ndarray:
        mcfg = self._sched_mesh_cfg()
        return self.facade.impl.schedule_partners(round_idx, mcfg.num_workers,
                                                  mesh_cfg=mcfg)

    @property
    def num_gossip_rounds(self) -> int:
        mcfg = self._sched_mesh_cfg()
        return self.facade.impl.schedule_rounds(mcfg.num_workers, mesh_cfg=mcfg)

    def schedule_state(self) -> dict:
        return {} if self.sched is None else self.sched.state()

    def restore_schedule(self, sched_state: dict) -> None:
        if self.sched is not None:
            self.sched.restore(sched_state)

    def wire_bytes(self) -> int:
        """Wire bytes per exchange and worker (per device on a sharded
        plane), as ``comm_bytes`` counts them; known after init_state."""
        if self.wire is None:
            raise ValueError("wire size unknown before init_state; pass param_bytes")
        return self.wire

    def checkpoint_extra(self) -> dict:
        return {}

    def validate_checkpoint_meta(self, meta) -> None:
        _validate_shard_meta(self.facade, meta)

    def save_state(self, path, state, meta) -> None:
        from repro_torch.checkpoint import io
        io.save_state(path, state, meta=meta, schedule=self.sched)

    def restore_state(self, path, state_like, meta):
        from repro_torch.checkpoint import io
        return io.restore_state(path, state_like, meta=meta)

    def on_checkpoint_loaded(self, state, meta) -> None:
        pass


class _SimBackend(_Backend):
    engine_name = "sim"

    def __init__(self, facade, kw: dict):
        if kw["loss_fn"] is None or kw["num_workers"] is None:
            raise ValueError(f'engine="{self.engine_name}" requires loss_fn and num_workers')
        self.facade = facade
        self.num_workers = kw["num_workers"]
        self.mesh_cfg = kw["mesh_cfg"]
        self.sim = self._build(kw, dict(fused_update=facade.fused_update, faults=kw["faults"],
                                        fleet=kw["fleet"], shard=kw["shard"]))
        self.codec = self.sim.codec
        self.wire = None

    def _build(self, kw: dict, common: dict):
        from repro_torch.core.gossip_sim import SimTrainer
        if kw["hetero"] is not None:
            raise ValueError('hetero= is the async engine\'s (engine="async")')
        return SimTrainer(kw["loss_fn"], self.num_workers, self.facade.protocol,
                          self.facade.optimizer, **common)

    def _sched_mesh_cfg(self) -> MeshConfig:
        return self.mesh_cfg or MeshConfig(data=self.num_workers, model=1, pods=1,
                                           workers_per_pod=self.num_workers)

    def init_state(self, seed, params):
        params = _init_params(self.facade, seed, params)
        W = self.num_workers
        stacked = tree_map(lambda x: x.to(self.facade.device)[None].expand(
            (W,) + tuple(x.shape)), params)
        self.wire = int(self.facade.impl.wire_stack_bytes(stacked))
        state = self.sim.init(stacked, int(seed))
        if self.sim.shard_layout is not None:
            # the per-device wire, the engine's own account
            self.wire = int(self.sim._wire_bytes(state.spec))
        return state

    def step(self, state, x, y, draws=None):
        state, m = self.sim.step(state, x, y, draws=draws)
        metrics = dict(m)
        metrics["loss"] = m["loss_mean"]
        metrics["fired"] = m["comm_active"] > 0
        metrics["comm_round"] = state.proto.comm_rounds
        metrics["comm_bytes"] = state.proto.comm_bytes
        return state, metrics

    def gossip_exchange(self, params_stack, active, round_idx: int):
        """Mixing-matrix oracle over the shared matching schedule: exactly
        Alg. 3/4/6 restricted to the round's perfect matching, on the flat
        plane. With a codec, off-diagonal contributions read the
        decode(encode(theta)) reconstruction, seeded by (round, worker) as
        the dist engine's wire; under a sharded plane, per shard row, seeded
        by (round, worker * S + shard) as a sharded dist rank's."""
        from repro_torch import comm
        from repro_torch import shard as shard_plane
        from repro_torch.common.flat import FlatSpec
        from repro_torch.core import topology
        spec = FlatSpec.build(params_stack, leading=1)
        bufs = spec.flatten(params_stack)
        dev = next(iter(bufs.values())).device
        peers = torch.as_tensor(self.matching_partners(round_idx), device=dev)
        gate = torch.as_tensor(np.asarray(active), device=dev) > 0
        mix = self.facade.impl.mix_matrix(peers, gate)
        codec = self.codec
        if codec is None:
            return spec.unflatten(topology.apply_mix(mix, bufs))
        W = spec.lead_shape[0]
        if _sharded(self.facade.shard):
            # the parity surface may run before init_state: the layout of
            # the stack's own spec (the same spec gives the same layout)
            layout = shard_plane.build_layout(spec, self.facade.shard, codec)
            rows = layout.shard_rows(shard_plane.pad_bufs(bufs, layout))
            seeds = comm.codec_seeds(round_idx, torch.arange(W * layout.n_shards, device=dev))
            hat, _ = comm.roundtrip_bufs(codec, rows, seeds)
            hat = shard_plane.slice_bufs(layout.unshard_rows(hat), spec.totals)
        else:
            hat, _ = comm.roundtrip_bufs(codec, bufs,
                                         comm.codec_seeds(round_idx, torch.arange(W, device=dev)))
        hat = {k: v.to(bufs[k].dtype) for k, v in hat.items()}
        return spec.unflatten(topology.apply_mix_split(mix, bufs, hat))

    def rank0_params(self, state):
        return self.sim.rank0_params(state)

    def attach_observer(self, observer) -> None:
        self.sim.obs = observer


class _AsyncBackend(_SimBackend):
    """The virtual-time async engine behind the sim backend's surface: one
    facade ``step`` is one event window, metrics add ``virtual_time`` /
    ``window_size`` / the staleness sums, and the host clock mirrors persist
    through the checkpoint metadata (``hetero_clock``)."""
    engine_name = "async"

    def _build(self, kw: dict, common: dict):
        from repro_torch.core.gossip_async import AsyncTrainer
        return AsyncTrainer(kw["loss_fn"], self.num_workers, self.facade.protocol,
                            self.facade.optimizer, hetero=kw["hetero"], **common)

    def schedule_state(self) -> dict:
        # the sim engine's schedule lives in the state's generator; the async
        # engine adds its host-side virtual-time position
        return {"hetero_clock": self.sim.clock_state()}

    def restore_schedule(self, sched_state: dict) -> None:
        hc = (sched_state or {}).get("hetero_clock")
        if hc:
            self.sim.anchor(hc["clocks"], hc["steps_done"])

    def checkpoint_extra(self) -> dict:
        # float64 clocks round-trip JSON exactly; the descriptors make a
        # resumed run refuse another fleet (every later draw depends on them)
        extra = {"hetero_clock": self.sim.clock_state(),
                 "hetero": dataclasses.asdict(self.sim.hetero)}
        if self.sim.faults is not None:
            from repro_torch.faults import fault_descriptor
            extra["faults"] = fault_descriptor(self.sim.faults)
        fleet = self.sim.fleet
        if fleet is not None and fleet.enabled():
            extra["fleet"] = dataclasses.asdict(fleet)
        return extra

    def validate_checkpoint_meta(self, meta) -> None:
        """Refuse to restore under a different virtual fleet: the saved
        ``hetero`` / ``faults`` / ``fleet`` descriptors must match this
        trainer's (files written without them restore unvalidated)."""
        super().validate_checkpoint_meta(meta)
        from repro_torch.faults import fault_descriptor
        meta = meta or {}
        if "hetero" in meta:
            _diff_descriptor("hetero", meta["hetero"], dataclasses.asdict(self.sim.hetero))
        faults = self.sim.faults
        if "faults" in meta:
            if faults is None:
                raise ValueError(
                    "checkpoint was written with a fault plane "
                    f"({meta['faults']!r}) but this trainer has none — pass "
                    "the same FaultConfig (faults=...) to resume this run")
            _diff_descriptor("faults", meta["faults"], fault_descriptor(faults))
        elif faults is not None:
            raise ValueError(
                "checkpoint was written WITHOUT a fault plane but this "
                "trainer configures one — resuming would inject faults into "
                "a run that never had them; drop faults= or start fresh")
        fleet = self.sim.fleet
        cur_fleet = dataclasses.asdict(fleet) if fleet is not None and fleet.enabled() else None
        if "fleet" in meta:
            if cur_fleet is None:
                raise ValueError(
                    "checkpoint was written under a fleet plane "
                    f"({meta['fleet']!r}) but this trainer has none — the "
                    "partition/flow draws are pure functions of it; pass the "
                    "same FleetConfig (fleet=...) to resume this run")
            _diff_descriptor("fleet", meta["fleet"], cur_fleet)
        elif cur_fleet is not None:
            raise ValueError(
                "checkpoint was written WITHOUT a fleet plane but this "
                "trainer configures one — resuming would change every "
                "partition/flow draw; drop fleet= or start fresh")

    def on_checkpoint_loaded(self, state, meta) -> None:
        hc = (meta or {}).get("hetero_clock")
        if hc:
            self.sim.anchor(hc["clocks"], hc["steps_done"])
        elif state.proto is not None and state.proto.clocks is not None:
            self.sim.anchor(state.proto.clocks.cpu().numpy().astype(np.float64),
                            state.proto.worker_steps.cpu().numpy().astype(np.int64))


class _DistBackend(_Backend):
    def __init__(self, facade, kw: dict):
        from repro_torch.core.scheduler import GossipSchedule
        from repro_torch.train.step import DistTrainer
        if kw["faults"] is not None:
            raise ValueError(
                'engine="dist" does not support fault injection: the fault '
                'plane rides the single-controller wire boundary (use '
                'engine="sim" or engine="async")')
        if kw["fleet"] is not None:
            raise ValueError(
                'fleet= is the sim and async engines\' plane (partitioned '
                'exchanges, flow control, the host plane); engine="dist" has '
                'no fleet plane')
        if kw["hetero"] is not None:
            raise ValueError('hetero= is the async engine\'s (engine="async")')
        group = kw["group"]
        if kw["loss_fn"] is None or group is None:
            raise ValueError('engine="dist" requires loss_fn and group (the rank\'s '
                             'WorkerGroup, see repro_torch.launch.mesh)')
        mesh_cfg = kw["mesh_cfg"] or group.mesh_cfg
        if kw["num_workers"] not in (None, mesh_cfg.num_workers):
            raise ValueError(f"num_workers={kw['num_workers']} but the mesh has "
                             f"{mesh_cfg.num_workers} workers")
        dev = facade.device
        if dev.type != group.device.type or dev.index not in (None, group.device.index):
            raise ValueError(f"the facade runs on {dev}, the group's rank on "
                             f"{group.device}")
        facade.device = group.device      # "cuda" means the rank's card
        self.facade = facade
        self.group = group
        self.mesh_cfg = mesh_cfg
        self.num_workers = mesh_cfg.num_workers
        tcfg = TrainConfig(protocol=facade.protocol, optimizer=facade.optimizer,
                           fused_update=facade.fused_update)
        self.trainer = DistTrainer(group, mesh_cfg, tcfg, kw["loss_fn"], shard=kw["shard"])
        self.codec = self.trainer._codec
        self.sched = GossipSchedule(facade.protocol, self.num_workers,
                                    seed=int(kw["seed"]) + 1, mesh_cfg=mesh_cfg)
        # host-side float64 accumulator, as the reference's
        self.comm_bytes = 0.0
        self.wire = None
        self._cost = None
        # host mirror of state.step: the schedule is polled with it, so the
        # step never reads the device counter back
        self._host_step = 0
        self._obs = None

    def attach_observer(self, observer) -> None:
        self._obs = observer

    def _sched_mesh_cfg(self) -> MeshConfig:
        return self.mesh_cfg

    def init_state(self, seed, params):
        params = _init_params(self.facade, seed, params)
        self._host_step = 0
        self.comm_bytes = 0.0
        self.wire = int(self.facade.impl.wire_stack_bytes(
            tree_map(lambda x: x[None], params)))
        state = self.trainer.init_state(params)
        if self.trainer.shard_layout is not None:
            # the per-device wire: each shard ships only its own columns
            from repro_torch.shard import wire_per_device
            self.wire = int(wire_per_device(self.trainer.shard_layout, state.spec,
                                            self.codec))
        self._cost = self.facade.impl.comm_cost(self.wire, self.num_workers)
        return state

    def step(self, state, x, y, draws=None):
        if draws is not None:
            raise ValueError('engine="dist" draws from its host schedule; draws= is '
                             'the sim engine\'s parity hook')
        impl = self.facade.impl
        obs = self._obs
        t_start = obs.now() if obs is not None else 0.0
        step_idx = self._host_step
        fire, active, rnd = self.sched.poll(step_idx)
        self._host_step += 1
        # the two programs of the reference: gradient only, or gradient and
        # one gossip round
        if impl.pairwise and fire:
            state, m = self.trainer._train_gossip_step(state, x, y, active, rnd)
        else:
            state, m = self.trainer._train_step(state, x, y,
                                                float(fire) if impl.uses_center else 0.0)
        cost = self._cost
        if not impl.communicates:
            self.comm_bytes += cost.bytes_per_step   # allreduce: every step; none: 0
        elif fire:
            self.comm_bytes += cost.bytes_per_event * float(np.mean(active))
        metrics = dict(m)
        # the loss is the fleet mean; per-worker losses are not gathered,
        # so mean == max == loss (the reference's documented degeneracy)
        metrics["loss_mean"] = m["loss"]
        metrics["loss_max"] = m["loss"]
        metrics["fired"] = bool(fire)
        metrics["comm_active"] = int(np.sum(active)) if fire and active is not None else 0
        metrics["comm_round"] = rnd
        metrics["comm_bytes"] = self.comm_bytes
        if obs is not None:
            obs.on_dist_step(self, t_start, step_idx, fire, active, rnd)
        return state, metrics

    def gossip_exchange(self, params_stack, active, round_idx: int):
        return self.trainer.gossip_exchange(params_stack, active, int(round_idx))

    def rank0_params(self, state):
        """Worker 0's replica, broadcast to every rank (a gather)."""
        return state.spec.with_lead(()).unflatten(
            {k: b[0] for k, b in self.trainer.gather_theta(state).items()})

    # ----------------------------------------------------------- checkpoints
    def checkpoint_extra(self) -> dict:
        # host-side accounting: a resumed run keeps the cumulative egress
        return {"comm_bytes": float(self.comm_bytes)}

    def validate_checkpoint_meta(self, meta) -> None:
        super().validate_checkpoint_meta(meta)
        lead = ((meta or {}).get("flat_spec") or {}).get("lead_shape")
        if lead is not None and lead != [self.num_workers]:
            raise ValueError(f"checkpoint holds {lead} worker rows, this fleet has "
                             f"{self.num_workers} workers")

    def save_state(self, path, state, meta) -> None:
        """Every rank joins the gathers of the whole plane; rank 0 writes
        the file and the others wait for it at a barrier."""
        from repro_torch.checkpoint import io
        whole = self.trainer.gather_state(state)
        if self.group.rank == 0:
            io.save_state(path, whole, meta=meta, schedule=self.sched)
        self.group.barrier()

    def restore_state(self, path, state_like, meta):
        from repro_torch.checkpoint import io
        return io.restore_state(path, state_like, meta=meta, row=self.group.rank)

    def on_checkpoint_loaded(self, state, meta) -> None:
        self._host_step = int(state.step)   # one sync, at load time only
        if meta and "comm_bytes" in meta:
            self.comm_bytes = float(meta["comm_bytes"])


ENGINES = {"sim": _SimBackend, "dist": _DistBackend, "async": _AsyncBackend}


class GossipTrainer:
    """Protocol-agnostic trainer facade over the sim, dist and async engines.

    Arguments: ``engine`` ("sim", "dist" or "async"), ``protocol`` (ProtocolConfig),
    ``optimizer`` (default NAG, as the paper), ``loss_fn(params, x, y)`` for
    one worker, ``num_workers`` (sim; the dist engine takes the mesh's),
    ``init_fn(generator) -> params`` (optional), ``fused_update`` (kernels
    B1/B2 on pairwise + NAG), ``device``, ``codec`` (a registered codec name
    that overrides ``protocol.codec``: "q8" or "topk" compress the gossip
    wire), ``faults`` (sim and async: a
    :class:`~repro_torch.common.config.FaultConfig`; a delay model puts the
    async engine in message mode), ``fleet`` (sim and async: a
    :class:`~repro_torch.common.config.FleetConfig`), ``shard`` (every
    engine: a :class:`~repro_torch.common.config.ShardConfig`), ``obs``
    (every engine: an :class:`~repro_torch.common.config.ObsConfig`),
    ``hetero`` (async: a
    :class:`~repro_torch.common.config.HeteroConfig`), ``mesh_cfg`` (the
    matching schedule's pods x workers layout), ``group`` (dist: the rank's
    :class:`~repro_torch.launch.mesh.WorkerGroup`) and ``seed`` (dist: the
    host schedule draws from ``seed + 1``).
    """

    def __init__(self, *, engine: str = "sim", protocol: ProtocolConfig,
                 optimizer: Optional[OptimizerConfig] = None,
                 init_fn: Optional[Callable] = None,
                 loss_fn: Optional[Callable] = None,
                 num_workers: Optional[int] = None,
                 fused_update: bool = True, device="cuda",
                 codec: Optional[str] = None, hetero: Optional[HeteroConfig] = None,
                 faults=None, fleet=None,
                 shard=None, publish_every: Optional[int] = None, obs=None,
                 mesh_cfg: Optional[MeshConfig] = None, group=None, seed: int = 0):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; ported: {sorted(ENGINES)}")
        if publish_every is not None:
            raise NotImplementedError("publish_every= is not ported yet (port slice 7b, "
                                      "train-while-serve)")
        self.engine = engine
        # an explicit codec= overrides the protocol config's codec
        if codec is not None:
            protocol = dataclasses.replace(protocol, codec=codec)
        self.protocol = protocol
        self.impl = registry.resolve(protocol)
        self.optimizer = optimizer or OptimizerConfig()
        self.fused_update = fused_update
        self.device = resolve_device(device)
        self.init_fn = init_fn
        self.shard = shard
        self._backend = ENGINES[engine](self, dict(
            loss_fn=loss_fn, num_workers=num_workers, hetero=hetero, faults=faults,
            fleet=fleet, shard=shard, mesh_cfg=mesh_cfg, group=group, seed=seed))
        self.num_workers = self._backend.num_workers
        self.codec = self._backend.codec      # the active Codec, or None
        self._host_steps = 0
        # telemetry plane: an ObsConfig that records builds the observer and
        # attaches it to the engine; None or the all-default config builds
        # nothing. On the dist engine rank 0 records the fleet's events.
        self.obs = obs
        self.observer = None
        if obs is not None and obs.enabled() and (engine != "dist" or group.rank == 0):
            from repro_torch.obs import Observer
            self.observer = Observer(obs, engine=engine, num_workers=self.num_workers)
            self._backend.attach_observer(self.observer)

    @property
    def sim(self):
        """The sim engine's :class:`~repro_torch.core.gossip_sim.SimTrainer`."""
        return self._backend.sim

    @property
    def dist(self):
        """The dist engine's :class:`~repro_torch.train.step.DistTrainer`."""
        return self._backend.trainer

    # ------------------------------------------------------------------ core
    def init_state(self, seed=0, params: Optional[PyTree] = None):
        """Fresh trainer state. ``params`` (optional): single-replica params
        (e.g. from :func:`repro_torch.models.simple.params_from_jax`) instead
        of calling ``init_fn`` with a generator seeded by ``seed``; on the
        dist engine every rank must start from the same params."""
        self._host_steps = 0
        return self._backend.init_state(seed, params)

    def step(self, state, batch, draws=None):
        """ONE training step (on the async engine: one event window):
        gradient component + (internally scheduled) communication component.
        Returns (state', metrics). ``draws`` is the sim and async engines'
        parity hook (:meth:`SimTrainer.step`). On the dist engine ``batch``
        is this rank's ``(x [pw, ...], y [pw])``."""
        x, y = (batch["x"], batch["y"]) if isinstance(batch, dict) else batch
        step_idx = self._host_steps
        state, metrics = self._backend.step(state, x, y, draws=draws)
        metrics = obs_schema.normalize_step_metrics(metrics, step=step_idx)
        self._host_steps += 1
        if self.observer is not None:
            self.observer.on_step(step_idx, metrics, state)
        return state, metrics

    def export_obs(self, trace_path: Optional[str] = None,
                   metrics_path: Optional[str] = None) -> dict:
        """Write the recorded telemetry: the Perfetto/Chrome trace JSON and
        the metrics JSONL (paths default to the ObsConfig's). Returns {kind:
        path} of what was written; {} when nothing records."""
        if self.observer is None:
            return {}
        return self.observer.export(trace_path, metrics_path)

    # ------------------------------------------------------- parity surface
    def matching_partners(self, round_idx: int) -> np.ndarray:
        """Partner index per worker in gossip round ``round_idx`` of the
        shared matching schedule (both engines)."""
        return self._backend.matching_partners(round_idx)

    @property
    def num_gossip_rounds(self) -> int:
        return self._backend.num_gossip_rounds

    def gossip_exchange(self, params_stack: PyTree, active, round_idx: int) -> PyTree:
        """ONE communication round on a stacked ``[W, ...]`` params pytree
        over the shared matching schedule: the mixing-matrix oracle on the
        sim engine, the exchange itself on the dist engine (every rank
        passes the same stack and gets the whole result)."""
        return self._backend.gossip_exchange(params_stack, active, round_idx)

    # ---------------------------------------------------------------- params
    def rank0_params(self, state) -> PyTree:
        """Worker 0's replica (paper 'Rank-0 Accuracy')."""
        return self._backend.rank0_params(state)

    def consensus_params(self, state) -> PyTree:
        """Worker-averaged replica (paper 'Aggregate Accuracy')."""
        if self.engine == "dist":
            from repro_torch.core.consensus import aggregate
            return aggregate(state.params, group=self._backend.group)
        return consensus_params(state)

    aggregate_params = consensus_params

    # ------------------------------------------------------------ scheduling
    def schedule_state(self) -> dict:
        """Serializable communication-schedule state ({} for engine="sim",
        whose draws come from the state's generator; the virtual-time
        position ``hetero_clock`` for engine="async")."""
        return self._backend.schedule_state()

    def restore_schedule(self, sched_state: dict) -> None:
        self._backend.restore_schedule(sched_state)

    # ---------------------------------------------------------- checkpointing
    def save_checkpoint(self, path: str, state, meta: Optional[dict] = None) -> None:
        """The state in checkpoint format v2 (the resident flat buffers plus
        the FlatSpec manifest), atomically, with the protocol config, the
        schedule and the host accounting in the metadata. On the dist
        engine every rank calls it; rank 0 writes the whole plane."""
        meta = dict(meta or {})
        meta.setdefault("protocol", dataclasses.asdict(self.protocol))
        if _sharded(self.shard):
            from repro_torch.shard import shard_descriptor
            meta.setdefault("shard", shard_descriptor(self.shard, self.codec))
        meta.update(self._backend.checkpoint_extra())
        self._backend.save_state(path, state, meta)

    def load_checkpoint(self, path: str, state_like):
        """Restore a checkpoint (v2, or a v1 per-leaf file, converted
        bit-exactly) into the structure of ``state_like``, on its device,
        and rewind the schedule and host accounting to the saved position.
        On the dist engine every rank reads its own row. Returns
        (state, meta)."""
        from repro_torch.checkpoint import io
        meta = io.load_meta(path)
        self._backend.validate_checkpoint_meta(meta)
        state = self._backend.restore_state(path, state_like, meta)
        if self._backend.sched is not None:
            io.restore_schedule(path, self._backend.sched)
        self._backend.on_checkpoint_loaded(state, meta)
        return state, meta

    # ------------------------------------------------------------ accounting
    def comm_cost(self, param_bytes: Optional[int] = None) -> CommCost:
        """Analytic expected egress (bytes/worker/step); ``param_bytes``
        defaults to the live wire size per event (known after init_state):
        the codec's wire when a codec is active, else the raw params."""
        if param_bytes is None:
            param_bytes = self._backend.wire_bytes()
        return self.impl.comm_cost(param_bytes, self.num_workers)
