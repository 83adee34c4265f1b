"""Shard-aware flat-plane layout: each dtype bucket's ``total`` dim split
into ``n_shards`` equal column shards (port of ``repro.shard.layout``).

The flat plane (:mod:`repro_torch.common.flat`) is one lane-aligned
``[W, total]`` buffer per dtype bucket. A :class:`ShardLayout` splits every
bucket's ``total`` dim into ``n_shards`` EQUAL contiguous column shards.
Three invariants everything downstream leans on:

- **Equal, quantum-aligned shards.** Each bucket total is padded up to a
  multiple of ``n_shards * quantum``, where ``quantum`` is the codec block
  when a codec rides the wire, else the lane width. Shard boundaries
  therefore fall on codec-block boundaries: encoding the plane per shard
  gives the same block layout as encoding the whole padded plane, so the
  sim and dist wires stay bit-identical.
- **Tail-only padding.** Every :class:`~repro_torch.common.flat.LeafSlot`
  keeps its offset, so ``unflatten`` and ``views`` slice the padded
  buffers unchanged; a leaf that straddles a shard boundary is a column
  range of the (contiguous) buffer.
- **Exact per-device wire accounting.** :func:`shard_wire_bytes` gives each
  shard's wire (raw: the real leaf elements inside its columns; codec: the
  codec wire of one ``shard_size`` row, equal for every shard) and
  :func:`wire_per_device` their mean: the per-exchange, per-device egress
  the engines count in ``comm_bytes``. Raw per-shard wires sum exactly to
  the un-sharded raw wire.

:meth:`ShardLayout.shard_rows` and :meth:`ShardLayout.unshard_rows` are
``view``s of contiguous buffers, never copies: row ``w * n_shards + s`` of
``[W * n_shards, shard_size]`` is worker w's shard s.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.common import flat as flat_plane

__all__ = [
    "ShardLayout", "build_layout", "padded_spec", "pad_bufs", "slice_bufs",
    "shard_manifest", "shard_wire_bytes", "wire_per_device",
    "shard_descriptor", "shard_quantum",
]


def shard_quantum(codec=None, align: int = flat_plane.LANE) -> int:
    """Shard-size granularity: the codec block when a codec rides the wire
    (a lane multiple by the Codec contract), else the lane width."""
    if codec is not None:
        return int(codec.block)
    return int(align)


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Static shard layout of a FlatSpec (built once per trainer).
    ``totals`` are the shard-PADDED bucket totals; every bucket's
    ``shard_sizes[b] = totals[b] // n_shards`` is a ``quantum`` multiple."""
    n_shards: int
    axes: Tuple[str, ...]
    quantum: int
    totals: Dict[str, int]
    shard_sizes: Dict[str, int]
    bounds: Dict[str, Tuple[Tuple[int, int], ...]]   # bucket -> per-shard (lo, hi)

    def __hash__(self):
        return hash((self.n_shards, self.axes, self.quantum,
                     tuple(sorted(self.totals.items()))))

    def shard_rows(self, bufs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``[W, totals[b]]`` -> ``[W * n_shards, shard_sizes[b]]``, a view:
        row ``w * n_shards + s`` is worker w's shard s, the order of the
        dist engine's ``worker * n_shards + shard`` seed coordinate."""
        S = self.n_shards
        return {k: b.view(b.shape[0] * S, self.shard_sizes[k]) for k, b in bufs.items()}

    def unshard_rows(self, bufs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Inverse of :meth:`shard_rows`, a view."""
        S = self.n_shards
        return {k: b.view(b.shape[0] // S, S * b.shape[1]) for k, b in bufs.items()}


def build_layout(spec: flat_plane.FlatSpec, shard, codec=None) -> ShardLayout:
    """ShardLayout for ``spec`` under ``shard`` (a
    :class:`~repro_torch.common.config.ShardConfig`) and the active codec,
    which fixes the quantum. Works for any (total, n_shards): tiny buckets
    get shards with no real element."""
    S = int(shard.n_shards)
    if S < 1:
        raise ValueError(f"n_shards must be >= 1, got {shard.n_shards}")
    q = shard_quantum(codec, spec.align)
    totals = {b: flat_plane._align(int(n), S * q) for b, n in spec.totals.items()}
    sizes = {b: t // S for b, t in totals.items()}
    bounds = {b: tuple((s * sizes[b], (s + 1) * sizes[b]) for s in range(S))
              for b in totals}
    return ShardLayout(S, tuple(shard.axes), q, totals, sizes, bounds)


def padded_spec(spec: flat_plane.FlatSpec, layout: ShardLayout) -> flat_plane.FlatSpec:
    """``spec`` bound to the shard-padded bucket totals. Slots are untouched
    (the padding is tail-only), so views and unflatten resolve every leaf."""
    return dataclasses.replace(spec, totals=dict(layout.totals))


def pad_bufs(bufs: Dict[str, torch.Tensor], layout: ShardLayout) -> Dict[str, torch.Tensor]:
    """Each bucket zero-padded at its tail up to the shard-padded total, as a
    fresh contiguous buffer (the buffer itself when already padded)."""
    out = {}
    for k, b in bufs.items():
        pad = layout.totals[k] - b.shape[-1]
        if pad < 0:
            raise ValueError(f"bucket {k!r} of width {b.shape[-1]} exceeds the "
                             f"layout's {layout.totals[k]}")
        out[k] = b if pad == 0 else torch.nn.functional.pad(b, (0, pad))
    return out


def slice_bufs(bufs: Dict[str, torch.Tensor], totals: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """The shard-padding tail columns dropped back to ``totals`` (the inverse
    boundary of :func:`pad_bufs`)."""
    return {k: b[..., :totals[k]] for k, b in bufs.items()}


# ---------------------------------------------------------------------------
# manifest and exact wire accounting
# ---------------------------------------------------------------------------

def _overlap(lo: int, hi: int, slot) -> int:
    return max(0, min(hi, slot.offset + slot.size) - max(lo, slot.offset))


def shard_manifest(layout: ShardLayout, spec: flat_plane.FlatSpec) -> dict:
    """JSON-able per-shard manifest: column bounds and REAL element counts
    (slot overlap, lane and shard padding excluded) per bucket per shard."""
    real = {b: [0] * layout.n_shards for b in layout.totals}
    for s in spec.slots:
        for i, (lo, hi) in enumerate(layout.bounds[s.bucket]):
            real[s.bucket][i] += _overlap(lo, hi, s)
    return {
        "n_shards": layout.n_shards,
        "quantum": layout.quantum,
        "totals": {b: int(n) for b, n in layout.totals.items()},
        "bounds": {b: [[int(lo), int(hi)] for lo, hi in bs]
                   for b, bs in layout.bounds.items()},
        "real_elements": real,
    }


def shard_wire_bytes(layout: ShardLayout, spec: flat_plane.FlatSpec,
                     codec=None) -> Tuple[float, ...]:
    """Per-shard wire bytes of ONE replica row. Raw (``codec`` None): the
    real leaf elements inside the shard's columns (padding never ships), so
    the shards sum exactly to the un-sharded raw wire. With a codec: the
    codec wire of one ``shard_sizes`` row, the same for every shard."""
    if codec is None:
        return tuple(float(sum(_overlap(*layout.bounds[s.bucket][i], s) * s.dtype.itemsize
                               for s in spec.slots))
                     for i in range(layout.n_shards))
    one = float(sum(codec.wire_bytes(layout.shard_sizes[b], getattr(torch, b).itemsize)
                    for b in layout.shard_sizes))
    return tuple(one for _ in range(layout.n_shards))


def wire_per_device(layout: ShardLayout, spec: flat_plane.FlatSpec, codec=None) -> float:
    """Mean per-shard wire bytes: the per-exchange, per-DEVICE egress the
    engines count under a sharded plane (raw: exactly ``raw_wire /
    n_shards``; codec: the wire of one shard row)."""
    return float(sum(shard_wire_bytes(layout, spec, codec))) / layout.n_shards


def shard_descriptor(shard, codec=None, align: int = flat_plane.LANE) -> dict:
    """Config-level shard descriptor kept in checkpoint metadata and held
    field by field on restore (the bucket totals are held by the FlatSpec
    manifest check that follows)."""
    return {"n_shards": int(shard.n_shards), "axes": list(shard.axes),
            "quantum": shard_quantum(codec, align)}
