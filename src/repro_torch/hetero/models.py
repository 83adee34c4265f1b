"""Pluggable compute-time models for the virtual-time async engine (port
of ``repro.hetero.models``).

Each model answers one question for the event loop of
:mod:`repro_torch.core.gossip_async`: given a worker's virtual clock and how
many local steps it has completed, when does its next step complete? The
engine never sees wall time, so a run simulates stragglers, a mixed fleet or
a flapping node on one card, deterministically.

Models are classes registered under a name (``@register_time_model``),
selected by ``HeteroConfig.time_model``:

- ``constant``     every step takes ``mean_step_time``: the homogeneous
  fleet, whose async run equals the ``engine="sim"`` run bit for bit;
- ``lognormal``    i.i.d. lognormal durations per (worker, step) with
  log-space std ``sigma``, mean-preserving (heavy-tailed stragglers);
- ``slow_node``    worker ``slow_worker`` is ``slow_factor`` times slower;
- ``fail_rejoin``  constant fleet, but ``slow_worker`` (``-1``: everyone)
  is offline during ``[fail_at, rejoin_at)``: a step overlapping the
  outage is lost and re-runs after rejoin.

Every draw is a pure hash of ``(HeteroConfig.seed, worker, step)``:
murmur3-style mixing in uint64 masked to 32 bits, in numpy float64, so the
draws equal the reference's bit for bit and no host RNG stream is read. The
fault plane (:mod:`repro_torch.faults`) draws its host-side masks from
:func:`hetero_hash` too; its in-step draws use the torch mirror
:func:`repro_torch.faults.models.fault_hash`.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.common.config import HeteroConfig

_M32 = np.uint64(0xFFFFFFFF)


def _fmix32(h: np.ndarray) -> np.ndarray:
    """murmur3 finalizer on 32-bit lanes (held in uint64 to avoid overflow)."""
    h = h & _M32
    h = h ^ (h >> np.uint64(16))
    h = (h * np.uint64(0x85EBCA6B)) & _M32
    h = h ^ (h >> np.uint64(13))
    h = (h * np.uint64(0xC2B2AE35)) & _M32
    return h ^ (h >> np.uint64(16))


def hetero_hash(seed: int, worker, step, salt: int = 0) -> np.ndarray:
    """uint32 hash of (seed, worker, step, salt), held in uint64, vectorized
    over ``worker`` and ``step``."""
    w = np.asarray(worker, np.uint64)
    k = np.asarray(step, np.uint64)
    h = ((np.uint64(seed & 0xFFFFFFFF) + np.uint64(1)) * np.uint64(2654435761)) & _M32
    h = _fmix32(h ^ ((w * np.uint64(0x9E3779B9) + np.uint64(0x85EBCA6B)) & _M32))
    h = _fmix32(h ^ ((k * np.uint64(2246822519)
                      + np.uint64(salt & 0xFFFFFFFF) * np.uint64(2654435761)) & _M32))
    return h


def hetero_uniform(seed: int, worker, step, salt: int = 0) -> np.ndarray:
    """Deterministic Uniform(0, 1) draw per (worker, step): open interval,
    safe under ``log``."""
    return (hetero_hash(seed, worker, step, salt).astype(np.float64) + 0.5) / 2.0 ** 32


def hetero_normal(seed: int, worker, step, salt: int = 0) -> np.ndarray:
    """Deterministic standard-normal draw per (worker, step) (Box-Muller over
    two independent hash lanes)."""
    u1 = hetero_uniform(seed, worker, step, 2 * salt)
    u2 = hetero_uniform(seed, worker, step, 2 * salt + 1)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, type] = {}


def register_time_model(name: str) -> Callable[[type], type]:
    """Class decorator: register a ComputeTimeModel subclass under ``name``."""
    def deco(cls: type) -> type:
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"time model {name!r} already registered "
                             f"({_REGISTRY[name].__qualname__})")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def available_time_models() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_time_model(name: str) -> type:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown time model {name!r}; "
                         f"registered: {sorted(_REGISTRY)}") from None


def unregister_time_model(name: str) -> None:
    _REGISTRY.pop(name, None)


def resolve_time_model(cfg: HeteroConfig) -> "ComputeTimeModel":
    """HeteroConfig -> ComputeTimeModel instance for ``cfg.time_model``."""
    return get_time_model(cfg.time_model)(cfg)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

class ComputeTimeModel:
    """Base class: a virtual-time cost model for one fleet, an immutable
    view over a frozen :class:`HeteroConfig` (clocks and step counts belong
    to the engine). Subclasses implement :meth:`step_duration`; models with
    availability windows also override :meth:`next_completion`."""

    name = ""   # set by @register_time_model

    def __init__(self, cfg: HeteroConfig):
        self.cfg = cfg

    def step_duration(self, worker: np.ndarray, step: np.ndarray) -> np.ndarray:
        """Virtual seconds worker ``worker`` spends on its ``step``-th local
        step (vectorized; pure in (cfg.seed, worker, step))."""
        raise NotImplementedError

    def next_completion(self, steps_done: np.ndarray, clocks: np.ndarray) -> np.ndarray:
        """Virtual completion time of each worker's NEXT local step, given its
        clock and completed-step count. float64[W]."""
        w = np.arange(len(clocks))
        return (np.asarray(clocks, np.float64)
                + self.step_duration(w, np.asarray(steps_done)))

    def outage_window(self, steps_done: np.ndarray, clocks: np.ndarray):
        """The virtual time the fleet comes back when NO worker can complete
        a step from the current clocks (a full-fleet outage), else None."""
        return None


@register_time_model("constant")
class ConstantTime(ComputeTimeModel):
    """Homogeneous fleet: every step takes ``mean_step_time`` exactly."""

    def step_duration(self, worker, step):
        return np.full(np.broadcast(worker, step).shape, self.cfg.mean_step_time,
                       np.float64)


@register_time_model("lognormal")
class LognormalTime(ComputeTimeModel):
    """Heavy-tailed stragglers: duration ~ mean * LogNormal(-sigma^2/2, sigma)
    i.i.d. per (worker, step), mean-preserving."""

    def step_duration(self, worker, step):
        z = hetero_normal(self.cfg.seed, worker, step)
        s = self.cfg.sigma
        return self.cfg.mean_step_time * np.exp(s * z - 0.5 * s * s)


@register_time_model("slow_node")
class SlowNodeTime(ComputeTimeModel):
    """One persistent straggler: worker ``slow_worker`` runs ``slow_factor``
    times slower than the constant-speed rest."""

    def step_duration(self, worker, step):
        w = np.broadcast_arrays(np.asarray(worker), np.asarray(step))[0]
        dur = np.full(w.shape, self.cfg.mean_step_time, np.float64)
        return np.where(w == self.cfg.slow_worker, dur * self.cfg.slow_factor, dur)


@register_time_model("fail_rejoin")
class FailRejoinTime(ComputeTimeModel):
    """Availability fault: worker ``slow_worker`` is offline during virtual
    ``[fail_at, rejoin_at)``; a step overlapping the outage is lost and
    re-runs from ``rejoin_at``. ``slow_worker = -1`` fails the whole fleet,
    which the async engine surfaces as an empty event window."""

    def step_duration(self, worker, step):
        return np.full(np.broadcast(worker, step).shape, self.cfg.mean_step_time,
                       np.float64)

    def _affected(self, w: np.ndarray) -> np.ndarray:
        if self.cfg.slow_worker < 0:
            return np.ones(w.shape, bool)
        return w == self.cfg.slow_worker

    def next_completion(self, steps_done, clocks):
        cfg = self.cfg
        start = np.asarray(clocks, np.float64)
        t = ComputeTimeModel.next_completion(self, steps_done, clocks)
        if cfg.rejoin_at <= cfg.fail_at:
            return t
        w = np.arange(len(t))
        dur = self.step_duration(w, np.asarray(steps_done))
        lost = self._affected(w) & (t >= cfg.fail_at) & (start < cfg.rejoin_at)
        return np.where(lost, cfg.rejoin_at + dur, t)

    def outage_window(self, steps_done, clocks):
        cfg = self.cfg
        if cfg.slow_worker >= 0 or cfg.rejoin_at <= cfg.fail_at:
            return None
        start = np.asarray(clocks, np.float64)
        nat = ComputeTimeModel.next_completion(self, steps_done, clocks)
        # nobody can complete before the window and nobody has crossed it:
        # one empty event advances the clocks to rejoin_at
        if np.all(nat >= cfg.fail_at) and np.all(start < cfg.rejoin_at):
            return float(cfg.rejoin_at)
        return None
