"""Host-side communication scheduler (port of ``repro.core.scheduler``,
copied: numpy ``RandomState`` gives the reference's (fire, active, round)
sequence bit for bit).

The training loop decides on the host, per step, whether the communication
component fires and with which per-worker participation mask — from a shared
seed, so every process in a real multi-controller deployment derives the same
schedule (the paper's synchronous setting). Bernoulli(p) gives Alg. 5 / GoSGD
semantics; period tau gives Alg. 2/3/4/6.

Protocol behavior is driven by registry capability flags
(:mod:`repro_torch.api.registry`), not method-name dispatch: non-communicating
protocols never fire, center-based protocols (EASGD) draw ONE shared gate,
pairwise gossip draws per-worker Bernoulli gates and advances the round
counter. ``state()``/``restore()`` round-trip the full scheduler state so a
checkpoint resume replays the exact schedule (same PRNG stream position).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.api import registry
from repro_torch.common.config import MeshConfig, ProtocolConfig


@dataclasses.dataclass
class GossipSchedule:
    cfg: ProtocolConfig
    num_workers: int
    seed: int = 0
    round_counter: int = 0
    # matching decomposition for partners() — None: one flat worker group
    mesh_cfg: Optional[MeshConfig] = None

    def __post_init__(self):
        self._rng = np.random.RandomState(self.seed)
        self._impl = registry.resolve(self.cfg)

    # ----------------------------------------------------- topology surface
    def partners(self, round_idx: Optional[int] = None) -> Optional[np.ndarray]:
        """Partner index per worker for ``round_idx`` (default: the current
        ``round_counter``) — surfaced from the protocol's ONE overridable
        :meth:`~repro_torch.api.protocols.Protocol.schedule_partners` hook, so
        hypercube vs. random matching vs. any time-varying topology is a
        protocol-class decision, not scheduler code. None for non-pairwise
        protocols."""
        if not self._impl.pairwise:
            return None
        r = self.round_counter if round_idx is None else round_idx
        return self._impl.schedule_partners(r, self.num_workers,
                                            mesh_cfg=self.mesh_cfg)

    def num_rounds(self) -> int:
        """Distinct rounds in the matching schedule (cycled by round index)."""
        return self._impl.schedule_rounds(self.num_workers,
                                          mesh_cfg=self.mesh_cfg)

    def poll(self, step: int) -> Tuple[bool, Optional[np.ndarray], int]:
        """-> (fire, active mask [W] float32, round_idx). Advances PRNG every
        step regardless of firing (keeps multi-controller replicas aligned)."""
        cfg, impl = self.cfg, self._impl
        if not impl.communicates:
            return False, None, 0
        if cfg.comm_period:
            fire = step % cfg.comm_period == 0
            active = np.full((self.num_workers,), float(fire), np.float32)
        elif impl.per_worker_gate:
            active = (self._rng.rand(self.num_workers) < cfg.comm_probability).astype(np.float32)
            fire = bool(active.any())
        else:  # one shared draw (EASGD-style center exchange)
            fire = bool(self._rng.rand() < cfg.comm_probability)
            active = np.full((self.num_workers,), float(fire), np.float32)
        if not impl.pairwise:
            return fire, active, 0
        rnd = self.round_counter
        if fire:
            self.round_counter += 1
        return fire, active, rnd

    def state(self) -> dict:
        return {"round_counter": self.round_counter,
                "rng_state": self._rng.get_state()[1].tolist(),
                "rng_pos": int(self._rng.get_state()[2]),
                # topology descriptors: partners() is pure in (round_counter,
                # these), so restoring the counter restores the full partner
                # sequence too — persisted for validation on restore
                "num_workers": self.num_workers,
                "topology": self.cfg.topology}

    def restore(self, state: dict) -> None:
        """Inverse of :meth:`state`: rewind to a saved schedule position so a
        resumed run fires the exact same (fire, active, round, partners)
        sequence. Older snapshots without the topology fields restore too."""
        if "num_workers" in state and int(state["num_workers"]) != self.num_workers:
            raise ValueError(
                f"schedule snapshot is for {state['num_workers']} workers, "
                f"this scheduler drives {self.num_workers}")
        if "topology" in state and state["topology"] != self.cfg.topology:
            raise ValueError(
                f"schedule snapshot used topology {state['topology']!r}, "
                f"this scheduler uses {self.cfg.topology!r}")
        self.round_counter = int(state["round_counter"])
        self._rng.set_state(("MT19937",
                             np.asarray(state["rng_state"], np.uint32),
                             int(state["rng_pos"]), 0, 0.0))
