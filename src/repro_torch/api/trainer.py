"""GossipTrainer facade — the port's entry point (port of
``repro.api.trainer`` for ``engine="sim"``).

    from repro_torch.api.trainer import GossipTrainer

    trainer = GossipTrainer(engine="sim", protocol=proto, optimizer=opt,
                            loss_fn=loss_fn, num_workers=8)      # on "cuda"
    state = trainer.init_state(seed=0, params=params)
    for step in range(steps):
        state, metrics = trainer.step(state, (x, y))

Everything runs on ``device`` ("cuda" unless the caller passes another);
asking for CUDA without a card raises, nothing moves to the CPU quietly.
The step updates the resident buffers of ``state`` in place (see
:mod:`repro_torch.core.gossip_sim`). Metrics carry
:data:`repro_torch.obs.schema.CORE_STEP_KEYS` as device tensors (no host
sync per step).

Only the sim engine is ported. ``gossip_exchange``/``matching_partners``
(they need the dist engine's schedules) and checkpoints come in later
slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.api import registry
from repro_torch.api.protocols import CommCost
from repro_torch.common.config import OptimizerConfig, ProtocolConfig
from repro_torch.common.pytree import tree_map
from repro_torch.obs import schema as obs_schema
from repro_torch.serving.engine import consensus_params

PyTree = Any

PORTED_LATER = {"dist": "port slice 5", "async": "port slice 4"}


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


class GossipTrainer:
    """Protocol-agnostic trainer facade over the sim engine.

    Arguments: ``protocol`` (ProtocolConfig), ``optimizer`` (default NAG, as
    the paper), ``loss_fn(params, x, y)`` for one worker, ``num_workers``,
    ``init_fn(generator) -> params`` (optional), ``fused_update`` (kernel B1
    on pairwise + NAG), ``device``, ``codec`` (a registered codec name that
    overrides ``protocol.codec``: "q8" or "topk" compress the gossip wire),
    ``faults`` (a :class:`~repro_torch.common.config.FaultConfig`: the
    message-level fault plane of :mod:`repro_torch.faults`).
    """

    def __init__(self, *, engine: str = "sim", protocol: ProtocolConfig,
                 optimizer: Optional[OptimizerConfig] = None,
                 init_fn: Optional[Callable] = None,
                 loss_fn: Optional[Callable] = None,
                 num_workers: Optional[int] = None,
                 fused_update: bool = True, device="cuda",
                 codec: Optional[str] = None, faults=None, fleet=None,
                 shard=None, publish_every: Optional[int] = None, obs=None):
        if engine in PORTED_LATER:
            raise NotImplementedError(
                f'engine="{engine}" is not ported yet ({PORTED_LATER[engine]})')
        if engine != "sim":
            raise ValueError(f"unknown engine {engine!r}; ported: ['sim']")
        for name, value, where in (("publish_every", publish_every, "port slice 7"),
                                   ("obs", obs, "port slice 6")):
            if value is not None:
                raise NotImplementedError(f"{name}= is not ported yet ({where})")
        if loss_fn is None or num_workers is None:
            raise ValueError('engine="sim" requires loss_fn and num_workers')
        from repro_torch.core.gossip_sim import SimTrainer
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
        self.num_workers = num_workers
        self.sim = SimTrainer(loss_fn, num_workers, protocol, self.optimizer,
                              fused_update=fused_update, faults=faults,
                              fleet=fleet, shard=shard)
        self.codec = self.sim.codec      # the active Codec, or None
        self._host_steps = 0
        self._wire = None

    # ------------------------------------------------------------------ core
    def init_state(self, seed=0, params: Optional[PyTree] = None):
        """Fresh trainer state. ``params`` (optional): single-replica params
        to broadcast (e.g. from :func:`repro_torch.models.simple.
        params_from_jax`) instead of calling ``init_fn`` with a generator
        seeded by ``seed``."""
        self._host_steps = 0
        if params is None:
            if self.init_fn is None:
                raise ValueError("provide init_fn at construction or params here")
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
            params = self.init_fn(gen)
        W = self.num_workers
        stacked = tree_map(lambda x: x.to(self.device)[None].expand((W,) + tuple(x.shape)),
                           params)
        self._wire = int(self.impl.wire_stack_bytes(stacked))
        return self.sim.init(stacked, int(seed))

    def step(self, state, batch, draws=None):
        """ONE training step: gradient component + (internally scheduled)
        communication component. Returns (state', metrics). ``draws`` is the
        parity hook of :meth:`SimTrainer.step`."""
        x, y = (batch["x"], batch["y"]) if isinstance(batch, dict) else batch
        state, m = self.sim.step(state, x, y, draws=draws)
        metrics = dict(m)
        metrics["loss"] = m["loss_mean"]
        metrics["fired"] = m["comm_active"] > 0
        metrics["comm_round"] = state.proto.comm_rounds
        metrics["comm_bytes"] = state.proto.comm_bytes
        metrics = obs_schema.normalize_step_metrics(metrics, step=self._host_steps)
        self._host_steps += 1
        return state, metrics

    # ---------------------------------------------------------------- params
    def rank0_params(self, state) -> PyTree:
        """Worker 0's replica (paper 'Rank-0 Accuracy')."""
        return self.sim.rank0_params(state)

    def consensus_params(self, state) -> PyTree:
        """Worker-averaged replica (paper 'Aggregate Accuracy')."""
        return consensus_params(state)

    aggregate_params = consensus_params

    # ------------------------------------------------------------ accounting
    def comm_cost(self, param_bytes: Optional[int] = None) -> CommCost:
        """Analytic expected egress (bytes/worker/step); ``param_bytes``
        defaults to the live wire size per event (known after init_state):
        the codec's wire when a codec is active, else the raw params."""
        if param_bytes is None:
            if self._wire is None:
                raise ValueError("wire size unknown before init_state; pass param_bytes")
            param_bytes = self._wire
        return self.impl.comm_cost(param_bytes, self.num_workers)
