"""Message-level fault and delay models (port of ``repro.faults.models``).

A fault model answers, deterministically: *what goes wrong with the wire
worker w publishes at step k?* ``drop`` loses it outright, ``corrupt`` flips
one byte of the packed uint8 wire (the checksum of
:mod:`repro_torch.faults.wire` detects it and the wire is discarded),
``byzantine_scale`` / ``byzantine_noise`` model adversarial workers that
always publish garbage rows.

Every draw is a pure hash of ``(FaultConfig.seed, worker, step)``. The host
draws (:func:`bernoulli_np`) hash with the copied
:func:`repro_torch.hetero.models.hetero_hash`; the draws inside a step
(:func:`bernoulli`) hash the device step counter with :func:`fault_hash`,
its torch mirror in int64 arithmetic masked to 32 bits (torch has no CPU
``>>`` for uint32). Both equal the reference's hashes bit for bit, and no
draw reads the step counter back to the host.

One deliberate difference: the reference draws ``byzantine_noise`` rows
from threefry (``fold_in(PRNGKey(seed), step)``), which torch cannot
reproduce. Here the noise is Box-Muller over a counter-based integer hash of
(seed, step, worker, bucket, element): pure in (seed, step, worker) as the
reference demands, with other values.

The delay models answer *when does the wire arrive?* for the async
engine's message mode (:mod:`repro_torch.core.gossip_async`): ``none``,
``constant``, ``uniform`` (U(0, 2 delay)) and ``lognormal``, pure numpy
hashes of (seed, worker, step, attempt), bit-equal to the reference's.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.common.config import FaultConfig
from repro_torch.hetero.models import hetero_hash, hetero_normal, hetero_uniform
from repro_torch.kernels.ref import as_u32, mul_u32

# Hash salts: one per independent draw family (the reference's values).
SALT_DROP = 101
SALT_CORRUPT = 202
SALT_DELAY = 303
SALT_BYTE = 404
# the port's Byzantine noise lanes (no reference counterpart: see above)
SALT_NOISE = 505

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# in-step hash mirror (int64 lanes masked to 32 bits; == hetero_hash)
# ---------------------------------------------------------------------------

def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul_u32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def fault_hash(seed: int, worker, step, salt: int = 0) -> torch.Tensor:
    """Hash of (seed, worker, step, salt) as an int64 tensor holding uint32
    values; ``worker`` and ``step`` may be device tensors (the step counter
    stays on the device) and broadcast against each other. Bit-identical to
    :func:`repro_torch.hetero.models.hetero_hash` and to the reference's
    ``fault_hash_jnp``."""
    dev = next((t.device for t in (step, worker) if isinstance(t, torch.Tensor)), None)
    w = as_u32(worker if isinstance(worker, torch.Tensor)
               else torch.as_tensor(np.asarray(worker, np.int64), device=dev))
    k = as_u32(step if isinstance(step, torch.Tensor)
               else torch.as_tensor(np.asarray(step, np.int64), device=dev))
    w, k = w.to(dev), k.to(dev)
    h0 = (((seed & _M32) + 1) & _M32) * 2654435761 & _M32
    h = _fmix32(h0 ^ ((mul_u32(w, 0x9E3779B9) + 0x85EBCA6B) & _M32))
    salt_term = (salt & _M32) * 2654435761 & _M32
    return _fmix32(h ^ ((mul_u32(k, 2246822519) + salt_term) & _M32))


def _bernoulli_threshold(rate: float) -> int:
    """Integer threshold for an exact Bernoulli(rate) over a uint32 hash:
    fires iff hash < threshold (no float comparison, so the host and the
    in-step draws agree bit for bit)."""
    if rate <= 0.0:
        return 0
    if rate >= 1.0:
        return 1 << 32
    return int(round(rate * float(1 << 32)))


def bernoulli_np(seed: int, worker, step, rate: float, salt: int) -> np.ndarray:
    thr = _bernoulli_threshold(rate)
    h = hetero_hash(seed, worker, step, salt)
    if thr >= (1 << 32):
        return np.ones(h.shape, bool)
    return (h < np.uint64(thr)).astype(bool)


def bernoulli(seed: int, worker, step, rate: float, salt: int) -> torch.Tensor:
    """:func:`bernoulli_np` on the device of ``worker``/``step``: bool."""
    thr = _bernoulli_threshold(rate)
    h = fault_hash(seed, worker, step, salt)
    if thr >= (1 << 32):
        return torch.ones(h.shape, dtype=torch.bool, device=h.device)
    return h < thr


def _hash_uniform(idx: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """f32 in [0, 1) per element: a murmur-style mix of (element index,
    per-row base hash), the 24 top bits, as the codecs' rounding noise."""
    x = idx ^ base
    x = mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = mul_u32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def hash_normal(seed: int, workers: torch.Tensor, step, n: int, salt: int) -> torch.Tensor:
    """[len(workers), n] f32 standard normals, pure in (seed, worker, step,
    salt, element): Box-Muller over two hash lanes, ``u1`` in (0, 1] and
    ``u2`` in [0, 1). Device ops only."""
    idx = torch.arange(n, dtype=torch.int64, device=workers.device)[None, :]
    b1 = fault_hash(seed, workers, step, salt)[:, None]
    b2 = fault_hash(seed, workers, step, salt + 1)[:, None]
    u1 = 1.0 - _hash_uniform(idx, b1)
    u2 = _hash_uniform(idx, b2)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_FAULTS: Dict[str, type] = {}
_DELAYS: Dict[str, type] = {}


def register_fault_model(name: str) -> Callable[[type], type]:
    """Class decorator: register a FaultModel subclass under ``name``."""
    def deco(cls: type) -> type:
        if name in _FAULTS and _FAULTS[name] is not cls:
            raise ValueError(f"fault model {name!r} already registered "
                             f"({_FAULTS[name].__qualname__})")
        cls.name = name
        _FAULTS[name] = cls
        return cls
    return deco


def register_delay_model(name: str) -> Callable[[type], type]:
    """Class decorator: register a DelayModel subclass under ``name``."""
    def deco(cls: type) -> type:
        if name in _DELAYS and _DELAYS[name] is not cls:
            raise ValueError(f"delay model {name!r} already registered "
                             f"({_DELAYS[name].__qualname__})")
        cls.name = name
        _DELAYS[name] = cls
        return cls
    return deco


def available_fault_models() -> Tuple[str, ...]:
    return tuple(sorted(_FAULTS))


def available_delay_models() -> Tuple[str, ...]:
    return tuple(sorted(_DELAYS))


def get_fault_model(name: str) -> type:
    try:
        return _FAULTS[name]
    except KeyError:
        raise ValueError(f"unknown fault model {name!r}; "
                         f"registered: {sorted(_FAULTS)}") from None


def get_delay_model(name: str) -> type:
    try:
        return _DELAYS[name]
    except KeyError:
        raise ValueError(f"unknown delay model {name!r}; "
                         f"registered: {sorted(_DELAYS)}") from None


def unregister_fault_model(name: str) -> None:
    _FAULTS.pop(name, None)


def unregister_delay_model(name: str) -> None:
    _DELAYS.pop(name, None)


def resolve_fault_model(cfg: FaultConfig) -> "FaultModel":
    return get_fault_model(cfg.fault_model)(cfg)


def resolve_delay_model(cfg: FaultConfig) -> "DelayModel":
    return get_delay_model(cfg.delay_model)(cfg)


# ---------------------------------------------------------------------------
# fault models
# ---------------------------------------------------------------------------

class FaultModel:
    """Base class: what goes wrong with the wire worker ``w`` publishes at
    step ``k``. Instances are immutable views over a frozen
    :class:`FaultConfig`; all draws are pure in (cfg.seed, worker, step).

    The capability flags tell the engine which wiring to run, so a model
    that injects nothing adds no work to the step.
    """

    name = ""                  # set by @register_fault_model
    injects_drop = False       # drop masks can be non-False
    injects_corrupt = False    # corrupt masks can be non-False (checksum path)
    injects_byzantine = False  # garble_bufs can rewrite rows

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg

    # -- host draws (numpy; the async engine and host-side checks) -----------
    def drop_mask(self, worker, step) -> np.ndarray:
        """bool[...]: is the wire (sender ``worker``, step ``step``) lost?"""
        return np.zeros(np.broadcast(np.asarray(worker), np.asarray(step)).shape, bool)

    def corrupt_mask(self, worker, step) -> np.ndarray:
        """bool[...]: is the wire corrupted in flight? (detected by checksum)"""
        return np.zeros(np.broadcast(np.asarray(worker), np.asarray(step)).shape, bool)

    # -- in-step draws (the sim wire boundary; ``step`` a device tensor) -----
    def drop_mask_dev(self, step: torch.Tensor, num_workers: int) -> torch.Tensor:
        return torch.zeros(num_workers, dtype=torch.bool, device=step.device)

    def corrupt_mask_dev(self, step: torch.Tensor, num_workers: int) -> torch.Tensor:
        return torch.zeros(num_workers, dtype=torch.bool, device=step.device)

    # -- Byzantine workers ---------------------------------------------------
    def num_byzantine(self, num_workers: int) -> int:
        return 0

    def byzantine_mask(self, num_workers: int) -> np.ndarray:
        """bool[W]: which workers always publish garbage (the first
        ``round(fault_frac * W)``, fixed for the run)."""
        return np.arange(num_workers) < self.num_byzantine(num_workers)

    def garble_bufs(self, bufs: dict, step, num_workers: int) -> dict:
        """What the workers publish instead of ``bufs`` (the per-bucket
        ``[W, N]`` dict): identity unless ``injects_byzantine``. Never writes
        into ``bufs``."""
        return bufs

    def garble_row(self, row_bufs: dict, worker: int, step, num_workers: int) -> dict:
        """What worker ``worker`` publishes for ONE captured wire (a
        ``{bucket: [n]}`` single-row dict), the message mode's realization of
        :meth:`garble_bufs`: the same row the plane path would publish."""
        return row_bufs


@register_fault_model("none")
class NoFault(FaultModel):
    """Nothing goes wrong. The engine still runs the fault wiring when a
    FaultConfig is given, which is how the zero-fault bit-exactness contract
    is exercised."""


@register_fault_model("drop")
class DropFault(FaultModel):
    """Each wire is lost i.i.d. with probability ``fault_rate`` per (sender,
    step). The receiver keeps its own row for the lost share, so rows of the
    mixing matrix still sum to 1."""

    injects_drop = True

    def drop_mask(self, worker, step):
        return bernoulli_np(self.cfg.seed, worker, step, self.cfg.fault_rate, SALT_DROP)

    def drop_mask_dev(self, step, num_workers):
        return bernoulli(self.cfg.seed, torch.arange(num_workers, device=step.device),
                         step, self.cfg.fault_rate, SALT_DROP)


@register_fault_model("corrupt")
class CorruptFault(FaultModel):
    """Each wire has one byte flipped in flight i.i.d. with probability
    ``fault_rate`` per (sender, step); the checksum detects it and the wire
    is discarded like a drop, never applied."""

    injects_corrupt = True

    def corrupt_mask(self, worker, step):
        return bernoulli_np(self.cfg.seed, worker, step, self.cfg.fault_rate, SALT_CORRUPT)

    def corrupt_mask_dev(self, step, num_workers):
        return bernoulli(self.cfg.seed, torch.arange(num_workers, device=step.device),
                         step, self.cfg.fault_rate, SALT_CORRUPT)


class _Byzantine(FaultModel):
    injects_byzantine = True

    def num_byzantine(self, num_workers):
        return int(round(self.cfg.fault_frac * num_workers))


@register_fault_model("byzantine_scale")
class ByzantineScale(_Byzantine):
    """The first ``round(fault_frac * W)`` workers publish their row scaled
    by ``cfg.scale``: a large-magnitude adversary that plain averaging
    absorbs straight into every neighbour."""

    def garble_bufs(self, bufs, step, num_workers):
        k = self.num_byzantine(num_workers)
        if k == 0:
            return bufs
        out = {}
        for name, buf in bufs.items():
            byz = (torch.arange(num_workers, device=buf.device) < k)[:, None]
            s = torch.where(byz, torch.full((), self.cfg.scale, dtype=buf.dtype,
                                            device=buf.device),
                            torch.ones((), dtype=buf.dtype, device=buf.device))
            out[name] = buf * s
        return out

    def garble_row(self, row_bufs, worker, step, num_workers):
        if worker >= self.num_byzantine(num_workers):
            return row_bufs
        return {k: v * torch.full((), self.cfg.scale, dtype=v.dtype, device=v.device)
                for k, v in row_bufs.items()}


@register_fault_model("byzantine_noise")
class ByzantineNoise(_Byzantine):
    """The first ``round(fault_frac * W)`` workers publish pure noise rows
    (std ``noise_std``) instead of parameters. Row w of bucket i (sorted
    bucket order) is ``noise_std * hash_normal(seed, w, step)`` on the salt
    pair ``SALT_NOISE + 2i``: pure in (seed, step, worker)."""

    def garble_bufs(self, bufs, step, num_workers):
        k = self.num_byzantine(num_workers)
        if k == 0:
            return bufs
        out = {}
        for i, (name, buf) in enumerate(sorted(bufs.items())):
            rows = torch.arange(k, device=buf.device)
            noise = self.cfg.noise_std * hash_normal(self.cfg.seed, rows, step,
                                                     buf.shape[1], SALT_NOISE + 2 * i)
            out[name] = torch.cat([noise.to(buf.dtype), buf[k:]], dim=0)
        return out

    def garble_row(self, row_bufs, worker, step, num_workers):
        if worker >= self.num_byzantine(num_workers):
            return row_bufs
        out = {}
        for i, (name, buf) in enumerate(sorted(row_bufs.items())):
            rows = torch.full((1,), worker, dtype=torch.int64, device=buf.device)
            noise = self.cfg.noise_std * hash_normal(self.cfg.seed, rows, step,
                                                     buf.shape[0], SALT_NOISE + 2 * i)
            out[name] = noise[0].to(buf.dtype)
        return out


# ---------------------------------------------------------------------------
# delay models (async engine)
# ---------------------------------------------------------------------------

class DelayModel:
    """Base class: wire latency. ``wire_delay(worker, step, attempt)`` is the
    virtual-seconds delay of the wire worker ``worker`` dispatches at step
    ``step``; retries salt the draw with the attempt index, so each
    re-dispatch sees a fresh (reproducible) latency."""

    name = ""            # set by @register_delay_model

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg

    def wire_delay(self, worker, step, attempt: int = 0) -> np.ndarray:
        raise NotImplementedError


@register_delay_model("none")
class NoDelay(DelayModel):
    """Wires arrive instantly: the async engine keeps its in-window path."""

    def wire_delay(self, worker, step, attempt=0):
        return np.zeros(np.broadcast(np.asarray(worker), np.asarray(step)).shape)


@register_delay_model("constant")
class ConstantDelay(DelayModel):
    def wire_delay(self, worker, step, attempt=0):
        return np.full(np.broadcast(np.asarray(worker), np.asarray(step)).shape,
                       self.cfg.delay, np.float64)


@register_delay_model("uniform")
class UniformDelay(DelayModel):
    """delay ~ U(0, 2 * cfg.delay): mean-preserving jitter."""

    def wire_delay(self, worker, step, attempt=0):
        u = hetero_uniform(self.cfg.seed, worker, step, SALT_DELAY + attempt)
        return 2.0 * self.cfg.delay * u


@register_delay_model("lognormal")
class LognormalDelay(DelayModel):
    """delay ~ cfg.delay * LogNormal(-sigma^2/2, sigma), mean-preserving."""

    def wire_delay(self, worker, step, attempt=0):
        z = hetero_normal(self.cfg.seed, worker, step, SALT_DELAY + attempt)
        s = self.cfg.delay_sigma
        return self.cfg.delay * np.exp(s * z - 0.5 * s * s)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def fault_descriptor(cfg: FaultConfig) -> dict:
    """JSON-able descriptor of the fault plane (checkpoint meta)."""
    import dataclasses
    return dataclasses.asdict(cfg)


def delays_active(cfg: FaultConfig) -> bool:
    """Does this config route exchanges through the async pending-wire queue
    (message mode) instead of the in-window path?"""
    return cfg.delay_model != "none" or cfg.rendezvous or cfg.timeout > 0.0
