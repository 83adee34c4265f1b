"""FlatState — the flat-RESIDENT trainer state (port of ``repro.api.state``).

params and velocity are ONE lane-aligned ``[W, total]`` buffer per dtype
bucket, from init on; pytrees appear only as lazy slice views
(:attr:`FlatState.params`, :attr:`FlatState.velocity`).

Unlike the reference, whose jitted step donates the state, the port's step
updates ``theta`` and ``opt.mu`` IN PLACE and returns a new FlatState that
holds the same buffers. Callers that need the pre-step values clone them.
``key`` holds the run's ``torch.Generator`` (the gate and peer draws),
which the step advances in place too.

Checkpoints (:meth:`FlatState.state_dict`, the v2 payload of
:mod:`repro_torch.checkpoint.io`) carry the reference's entries. A
generator cannot become a threefry key, so ``key`` is written as what
``jax.random.PRNGKey(seed)`` gives for the generator's initial seed (a
uint32 ``[2]`` the reference's restore accepts), and the generator's own
state goes under ``torch_key::<device type>``, which only the port reads.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.common.flat import FlatSpec

PyTree = Any
Buffers = Dict[str, torch.Tensor]

# ProtocolState fields an engine seeds only when it uses them (the
# checkpoint's VIRTUAL_TIME_KEYS)
OPTIONAL_PROTO_FIELDS = ("clocks", "worker_steps", "stale_time", "stale_steps",
                         "stale_events", "wire_dropped", "wire_corrupt",
                         "exch_timeouts", "exch_retries", "tokens", "flow_skipped",
                         "chunk_units")


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

    def state_dict(self) -> Dict[str, Any]:
        """Named nested dict of the state's tensors: the checkpoint v2
        payload, the reference's paths (``spec`` is absent: it is the
        manifest). The generator, if any, becomes ``key`` (uint32 ``[2]``,
        ``[0, initial seed]``) and ``torch_key`` (``{device type: its
        get_state() bytes}``)."""
        opt, proto = self.opt, self.proto
        d = {
            "theta": self.theta,
            "opt": {"step": opt.step, "mu": opt.mu, "nu": opt.nu},
            "center": self.center,
            "proto": (None if proto is None else {
                "center": proto.center,
                "comm_rounds": proto.comm_rounds,
                "comm_units": proto.comm_units,
                "comm_bytes": proto.comm_bytes,
                # the async engine's virtual time and the fault and fleet
                # planes' fields: None (absent) where no engine seeded them
                **{k: getattr(proto, k) for k in OPTIONAL_PROTO_FIELDS},
            }),
            "comm": {"residual": getattr(self.comm, "residual", None)},
            "key": None,
            "step": self.step,
        }
        gen = self.key
        if gen is not None:
            d["key"] = np.array([0, gen.initial_seed() & 0xFFFFFFFF], dtype=np.uint32)
            d["torch_key"] = {gen.device.type: gen.get_state().numpy()}
        return d

    def from_state_dict(self, d: Dict[str, Any]) -> "FlatState":
        """Rebuild a FlatState from :meth:`state_dict`'s form, reusing this
        state's spec and container types. The generator: the saved
        ``torch_key`` of this state's device type if there is one (a resume
        on the same kind of device draws exactly what the uninterrupted run
        draws), else a fresh generator seeded from ``key`` and the step (a
        reference file, or a file from another device type)."""
        opt = type(self.opt)(d["opt"]["step"], d["opt"]["mu"], d["opt"]["nu"])
        proto = self.proto
        if proto is not None:
            p = d["proto"]
            proto = proto._replace(center=p["center"], comm_rounds=p["comm_rounds"],
                                   comm_units=p["comm_units"], comm_bytes=p["comm_bytes"],
                                   **{k: p.get(k) for k in OPTIONAL_PROTO_FIELDS})
        comm = self.comm
        if comm is not None:
            comm = type(comm)(d["comm"]["residual"])
        key = self.key
        if key is not None:
            saved = (d.get("torch_key") or {}).get(key.device.type)
            if saved is not None:
                key = torch.Generator(device=key.device)
                key.set_state(torch.from_numpy(np.array(saved, dtype=np.uint8)))
            elif d.get("key") is not None:
                key = generator_from_key(d["key"], int(d["step"]), key.device)
        return FlatState(spec=self.spec, theta=d["theta"], opt=opt,
                         center=d["center"], proto=proto, comm=comm,
                         key=key, step=d["step"])


def generator_from_key(key, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from a saved uint32 ``[2]`` key and
    the step it was saved at: the step is mixed in so that a resume from a
    file whose key does not advance (the port writes its initial seed)
    does not replay the run's first draws."""
    hi, lo = (int(w) for w in np.asarray(key, dtype=np.uint32).reshape(-1)[:2])
    seed = ((hi << 32) | lo) ^ ((int(step) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
