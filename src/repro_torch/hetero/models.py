"""Integer-hash draws per (seed, worker, step) (the hash family of
``repro.hetero.models``, copied).

Pure numpy: the murmur3-style mixing runs in uint64 masked to 32 bits, so
the values equal the reference's bit for bit. The fault plane
(:mod:`repro_torch.faults`) draws its host-side masks from
:func:`hetero_hash`; its in-step draws use the torch mirror
:func:`repro_torch.faults.models.fault_hash`. The compute-time models of the
async engine come with that engine.
"""
from __future__ import annotations

import numpy as np

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
