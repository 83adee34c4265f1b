"""FlatState — the flat-RESIDENT trainer state (port of ``repro.api.state``).

params and velocity are ONE lane-aligned ``[W, total]`` buffer per dtype
bucket, from init on; pytrees appear only as lazy slice views
(:attr:`FlatState.params`, :attr:`FlatState.velocity`).

Unlike the reference, whose jitted step donates the state, the port's step
updates ``theta`` and ``opt.mu`` IN PLACE and returns a new FlatState that
holds the same buffers. Callers that need the pre-step values clone them.
``key`` holds the run's ``torch.Generator`` (the gate and peer draws),
which the step advances in place too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.common.flat import FlatSpec

PyTree = Any
Buffers = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FlatState:
    """Flat-resident trainer state."""

    spec: FlatSpec                    # static layout
    theta: Buffers                    # resident params, [*lead, total] per dtype
    opt: Any                          # OptState with buffer-dict mu/nu
    center: Optional[Buffers] = None  # dist EASGD center (unused by sim)
    proto: Optional[Any] = None       # sim ProtocolState (center + accounting)
    comm: Any = None                  # CommState: top-k residual buffers or None
    key: Optional[torch.Generator] = None   # gate / peer draws
    step: Any = None                  # int32 0-d step counter on the device

    # ------------------------------------------------------- lazy tree views
    @property
    def params(self) -> PyTree:
        """Parameter pytree as slice/reshape VIEWS of the resident buffers."""
        return self.spec.unflatten(self.theta)

    @property
    def velocity(self) -> Optional[PyTree]:
        """Velocity (NAG) pytree view, or None (e.g. sgd)."""
        mu = getattr(self.opt, "mu", None)
        return self.spec.unflatten(mu) if mu else None

    def replace(self, **kw) -> "FlatState":
        return dataclasses.replace(self, **kw)
