"""Up-front fleet memory validation: fail fast, not deep in init (port of
``repro.fleet.memory``).

Estimates what a W-worker run needs BEFORE any buffer is allocated and
raises one clear error instead of an out-of-memory deep in a step:

- **device-resident** (``plane="device"``): the ``[W, total]`` theta and
  velocity planes, the gradient stack of the vmapped ``grad_and_value`` and
  the mixing/epilogue temporaries, ~``DEVICE_RESIDENT_FACTOR`` replica sizes
  per worker, against the free memory of the card
  (``torch.cuda.mem_get_info``), or of the host on the CPU;
- **host-resident** (``plane="host"``, :mod:`repro_torch.fleet.hostplane`):
  theta and velocity in host RAM (2 replica sizes per worker), against
  MemAvailable (``/proc/meminfo``).

With a sharded plane (``n_shards = S > 1``, :mod:`repro_torch.shard`) the
reference's estimate is per device: each device holds 1/S of every buffer
(:func:`plane_bytes`). On the port's one card every shard of every replica
sits on that card, so against the card's free memory the whole plane is
held, and the per-device figure is given beside it.

The factors are the reference's estimates, not a measurement of the port.
"""
from __future__ import annotations

from typing import Optional

import torch

# replica sizes of simultaneously live memory per worker on the device plane:
# theta + mu + grad stack + comm/mixing temporaries + headroom
DEVICE_RESIDENT_FACTOR = 6.0
# host-resident plane: theta + mu in host RAM
HOST_RESIDENT_FACTOR = 2.0
# refuse above this fraction of what is available
SAFETY_FRACTION = 0.7


def available_host_bytes() -> Optional[int]:
    """MemAvailable from /proc/meminfo, or None when unreadable."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def available_bytes(plane: str, device=None) -> Optional[int]:
    """Free bytes for ``plane``: the card's free memory for the device plane
    on a CUDA ``device``, else the host's MemAvailable."""
    dev = torch.device(device) if device is not None else None
    if plane != "host" and dev is not None and dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[0])
    return available_host_bytes()


def plane_bytes(num_workers: int, replica_bytes: int, plane: str,
                n_shards: int = 1) -> int:
    """Estimated bytes the resident plane (plus step intermediates for the
    device plane) needs for W workers of ``replica_bytes`` each, per device:
    with ``n_shards > 1`` each device holds 1/``n_shards`` of every buffer
    (the reference's formula)."""
    factor = HOST_RESIDENT_FACTOR if plane == "host" else DEVICE_RESIDENT_FACTOR
    return int(num_workers * replica_bytes * factor / max(1, n_shards))


def validate_fleet_memory(num_workers: int, replica_bytes: int, plane: str, *,
                          available: Optional[int] = None, what: str = "model",
                          device=None, n_shards: int = 1) -> int:
    """Raise ValueError when a W-worker run of ``replica_bytes``-sized
    replicas cannot fit the ``plane`` budget; return the estimated need in
    bytes otherwise. ``available`` overrides the probe of
    :func:`available_bytes` (for ``device``).

    The need is the per-device :func:`plane_bytes` with ``n_shards``, as the
    reference's, except for the device plane on a CUDA ``device``: the port
    keeps every shard of every replica on that one card, so the card is held
    to the whole plane (``n_shards`` does not divide it)."""
    on_card = (plane != "host" and device is not None
               and torch.device(device).type == "cuda")
    per_device = plane_bytes(num_workers, replica_bytes, plane, n_shards)
    need = plane_bytes(num_workers, replica_bytes, plane) if on_card else per_device
    avail = available_bytes(plane, device) if available is None else available
    if avail is None:                      # unknown platform: best effort
        return need
    budget = int(avail * SAFETY_FRACTION)
    if need > budget:
        gib = 1024.0 ** 3
        factor = HOST_RESIDENT_FACTOR if plane == "host" else DEVICE_RESIDENT_FACTOR
        shard_note = ""
        if plane == "host":
            hint = "reduce --workers"
        elif n_shards > 1 and on_card:
            shard_note = (f"; all {n_shards} shards on this card, "
                          f"~{per_device / gib:.1f} GiB per shard")
            hint = (f"the {n_shards} shards of every replica share this card, so more "
                    "shards do not lower its need; run with --plane host "
                    "(host-resident FlatState, repro_torch.fleet) or reduce --workers")
        elif n_shards > 1:
            shard_note = f" / {n_shards} shards"
            hint = "raise --shard (more plane shards per replica) or reduce --workers"
        else:
            hint = ("run with --plane host (host-resident FlatState, repro_torch.fleet) "
                    "or reduce --workers")
        raise ValueError(
            f"workers={num_workers} needs ~{need / gib:.1f} GiB for the "
            f"{plane}-resident plane of {what} "
            f"({replica_bytes / gib:.2f} GiB/replica x {factor:.0f}{shard_note}), "
            f"but only ~{budget / gib:.1f} GiB is safely available "
            f"({avail / gib:.1f} GiB {'free on the card' if on_card else 'MemAvailable'} "
            f"x {SAFETY_FRACTION}); {hint}")
    return need
