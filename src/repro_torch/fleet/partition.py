"""Partitioned gossip exchanges: ship ONE chunk of the plane per exchange
(port of ``repro.fleet.partition``).

``partition=P`` splits every dtype bucket's ``[total]`` dim into P
contiguous slices ``[lo_c, hi_c)`` with ``lo_c = (c * total) // P`` (an
exact split for any total), and each exchange ships chunk ``c =
hash(seed, worker, step) % P``, pure in ``(seed, worker, step)``, so the sim
and async engines schedule the same chunks.

Mixing is the engines' matrix realization restricted chunk by chunk: for
chunk ``c`` the participation mask is ``active & (chunk_of(worker) == c)``,
the protocol's ``mix_matrix`` is built from it, and the chunk's columns are
mixed with ``apply_mix`` / ``apply_mix_split``. The robust protocols get
per-chunk clip/trim coefficients (chunk-local norms across buckets) and
apply kernel B8 to each chunk's columns in place in the output plane: the
kernel takes the column slice ``x[:, lo:hi]`` with its row stride, so
nothing is copied per chunk.

Accounting is exact: ``ProtocolState.chunk_units`` (int32[P], saturating)
counts applied exchanges per chunk id, and ``comm_bytes = sum_c
per_event[c] * chunk_units[c] / W`` is derived from it every update.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.api import protocols as api_protocols
from repro_torch.core import topology
from repro_torch.faults.models import fault_hash
from repro_torch.fleet.flow import SALT_PARTITION
from repro_torch.hetero.models import hetero_hash


# ---------------------------------------------------------------------------
# chunk schedule
# ---------------------------------------------------------------------------

def chunk_bounds(total: int, partition: int) -> Tuple[Tuple[int, int], ...]:
    """P contiguous ``(lo, hi)`` slices covering ``[0, total)`` exactly:
    ``lo_c = (c * total) // P``. Sizes differ by at most one element."""
    P = int(partition)
    assert P >= 1, partition
    return tuple(((c * total) // P, ((c + 1) * total) // P) for c in range(P))


def partition_ids(seed: int, step: torch.Tensor, num_workers: int,
                  partition: int) -> torch.Tensor:
    """int32[W] chunk id each worker ships at ``step`` (a device scalar), on
    its device."""
    h = fault_hash(seed, torch.arange(num_workers, device=step.device), step, SALT_PARTITION)
    return (h % partition).to(torch.int32)


def partition_ids_np(seed: int, step: int, num_workers: int,
                     partition: int) -> np.ndarray:
    """Numpy mirror of :func:`partition_ids`, bit-identical."""
    h = hetero_hash(seed, np.arange(num_workers), step, SALT_PARTITION)
    return (h % np.uint64(partition)).astype(np.int32)


# ---------------------------------------------------------------------------
# plan (static layout, built once per FlatSpec)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Static per-spec partition layout: chunk slices per bucket (chunk c's
    wire is every bucket's slice c) and the per-chunk wire bytes feeding
    the exact ``comm_bytes`` derivation."""
    partition: int
    bounds: Dict[str, Tuple[Tuple[int, int], ...]]
    wire_bytes: Tuple[int, ...]          # per chunk id, summed over buckets

    def col_chunks(self, bucket: str, total: int) -> np.ndarray:
        """int32[total] column -> chunk-id map for one bucket."""
        out = np.empty((total,), np.int32)
        for c, (lo, hi) in enumerate(self.bounds[bucket]):
            out[lo:hi] = c
        return out


def build_plan(spec, partition: int, codec=None) -> PartitionPlan:
    """PartitionPlan for ``spec`` under ``codec`` (None = raw slices). Chunks
    slice the resident plane (``spec.totals``, lane padding included); a raw
    chunk's bytes count only its overlap with the real leaf elements, so the
    chunks' raw wires sum to the full-replica raw wire exactly."""
    from repro_torch import comm
    P = int(partition)
    bounds = {b: chunk_bounds(int(n), P) for b, n in spec.totals.items()}
    if codec is None:
        wire = tuple(
            int(sum(
                max(0, min(bounds[s.bucket][c][1], s.offset + s.size)
                    - max(bounds[s.bucket][c][0], s.offset))
                * s.dtype.itemsize
                for s in spec.slots))
            for c in range(P))
    else:
        wire = comm.wire_partition_bytes(codec, spec, bounds)
    return PartitionPlan(P, bounds, wire)


# ---------------------------------------------------------------------------
# partitioned comm update (the engines' partition-plane realization)
# ---------------------------------------------------------------------------

def partitioned_comm_update(impl, active, theta_stack, state, *, peers, step=None,
                            transmit=None, wire_faults=None, part_ids, plan: PartitionPlan):
    """Partition-plane counterpart of ``Protocol.comm_update`` for pairwise
    protocols: the same peers (drawn by the engine), fault discard and
    mixing matrices, restricted chunk by chunk. ``part_ids`` is the int32[W]
    chunk schedule of this step (:func:`partition_ids`).

    Robust protocols (those with ``robust_coeffs``) get one (scale, thr)
    pair per chunk from chunk-local row norms accumulated across buckets,
    and B8 writes each chunk into its columns of the output plane. Returns
    ``(theta_new, state_new)``; theta_new holds new tensors."""
    W = active.shape[0]
    P = plan.partition
    if state.chunk_units is None:
        raise ValueError("partitioned comm needs ProtocolState.chunk_units seeded "
                         "(engine init with a FleetConfig(partition>1))")
    lost = wire_faults.lost() if wire_faults is not None else None
    robust = hasattr(impl, "robust_coeffs")

    mixes, engaged = [], []
    for c in range(P):
        a_c = active & (part_ids == c)
        m = impl.mix_matrix(peers, a_c, step=step)
        if lost is not None:
            m = topology.discard_lost(m, lost)
            engaged.append(a_c & ~lost)
        else:
            engaged.append(a_c)
        mixes.append(m)

    def mixed_chunk(c, b, lo, hi):
        sl = {b: theta_stack[b][:, lo:hi]}
        if transmit is None:
            return topology.apply_mix(mixes[c], sl)[b]
        return topology.apply_mix_split(mixes[c], sl, {b: transmit[b][:, lo:hi]})[b]

    new_bufs = {b: torch.empty_like(x) for b, x in theta_stack.items()}
    if not robust:
        for b in theta_stack:
            for c, (lo, hi) in enumerate(plan.bounds[b]):
                new_bufs[b][:, lo:hi] = mixed_chunk(c, b, lo, hi)
    else:
        from repro_torch.kernels import ops
        dev = active.device
        stale = impl.stale_scale(peers, state)
        theta_sq = [torch.zeros(W, dtype=torch.float32, device=dev) for _ in range(P)]
        delta_sq = [torch.zeros(W, dtype=torch.float32, device=dev) for _ in range(P)]
        row_elems = [0] * P
        deltas = {b: [None] * P for b in theta_stack}
        for b, x in theta_stack.items():
            for c, (lo, hi) in enumerate(plan.bounds[b]):
                sl = x[:, lo:hi].to(torch.float32)
                d = mixed_chunk(c, b, lo, hi).to(torch.float32) - sl
                deltas[b][c] = d
                theta_sq[c] = theta_sq[c] + torch.sum(sl * sl, dim=1)
                delta_sq[c] = delta_sq[c] + torch.sum(d * d, dim=1)
                row_elems[c] += int(hi - lo)
        coeffs = []
        for c in range(P):
            scale, thr = impl.robust_coeffs(theta_sq[c], delta_sq[c], max(row_elems[c], 1))
            if stale is not None:
                scale = scale * stale
            coeffs.append((scale, thr))
        for b, x in theta_stack.items():
            for c, (lo, hi) in enumerate(plan.bounds[b]):
                if hi > lo:
                    ops.robust_flat_apply(x[:, lo:hi], deltas[b][c], *coeffs[c],
                                          out=new_bufs[b][:, lo:hi])

    # exact per-chunk applied-exchange accounting
    counts = torch.stack([torch.sum(e.to(torch.int32)) for e in engaged]).to(torch.int32)
    chunk_units = api_protocols._saturating_units_add(state.chunk_units, counts)
    units = api_protocols._saturating_units_add(state.comm_units,
                                                torch.sum(counts).to(torch.int32))
    per_event = torch.tensor([impl.comm_cost(bc, W).bytes_per_event for bc in plan.wire_bytes],
                             dtype=torch.float32, device=active.device)
    bytes_ = torch.dot(per_event, chunk_units.to(torch.float32)) / W
    rounds = state.comm_rounds + torch.any(active).to(torch.int32)
    state = impl._count_wire_faults(state, active, wire_faults)
    return new_bufs, state._replace(comm_rounds=rounds, comm_units=units,
                                    comm_bytes=bytes_, chunk_units=chunk_units)
