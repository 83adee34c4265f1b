"""Dist engine exchange: one process per gossip worker, one send and one
recv per dtype bucket per round (port of ``repro.core.gossip_dist``).

The reference stacks the replicas on a leading worker dim sharded over the
``('pod', 'worker')`` mesh axes and runs a gossip round as ONE
collective-permute per dtype bucket inside ``shard_map``, the participation
gate riding in the tail element of the first bucket. Here every rank holds
its own row of the flat plane (``{bucket: [1, total]}``, the resident
buffers of its :class:`~repro_torch.api.state.FlatState`) and a round is a
point-to-point swap with the round's partner through its
:class:`~repro_torch.launch.mesh.WorkerGroup`: the first bucket with the
gate appended as one more element, then each further bucket, each one send
and one recv. Every rank exchanges on every firing step, whatever its own
gate, as the reference's collective does: a rank that skipped its exchange
would leave its partner waiting.

The schedule is the reference's static matching schedule, copied
(:func:`build_schedule`, :func:`partner_of`): hypercube dims on 'worker'
then 'pod', or precomputed random matchings. The round index and the
participation mask come from the host scheduler, equal on every rank.

With a codec (:mod:`repro_torch.comm`) the wire is the codec's packed uint8
buffer with the gate in the tail byte: the rank encodes its plane (rounding
seeded by ``codec_seeds(round, worker)``, the stream the sim engine uses),
exchanges the packed bytes and decodes the peer's. A stateful codec's
residual advances only where the rank's own gate fired.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch import comm
from repro_torch.api import registry
from repro_torch.common.config import MeshConfig, ProtocolConfig
from repro_torch.core import topology
from repro_torch.kernels import ops

Buffers = Dict[str, torch.Tensor]


def build_schedule(mesh_cfg: MeshConfig, kind: str = "hypercube", num_random_rounds: int = 16,
                   seed: int = 0) -> List[Tuple[str, List[Tuple[int, int]]]]:
    """List of (mesh_axis, pairs) rounds, cycled by round index.

    hypercube: log2(workers_per_pod) rounds on 'worker' + log2(pods) on 'pod'.
    random: precomputed random matchings on 'worker' (+ the pod hypercube
    rounds appended, so cross-pod mixing still happens).
    """
    rounds: List[Tuple[str, List[Tuple[int, int]]]] = []
    if kind == "hypercube":
        if mesh_cfg.workers_per_pod > 1:
            rounds += [("worker", m) for m in topology.hypercube_schedule(mesh_cfg.workers_per_pod)]
        if mesh_cfg.pods > 1:
            rounds += [("pod", m) for m in topology.hypercube_schedule(mesh_cfg.pods)]
    elif kind == "random":
        if mesh_cfg.workers_per_pod > 1:
            rounds += [("worker", m) for m in
                       topology.random_matching_schedule(mesh_cfg.workers_per_pod,
                                                         num_random_rounds, seed)]
        if mesh_cfg.pods > 1:
            rounds += [("pod", m) for m in topology.hypercube_schedule(mesh_cfg.pods)]
    else:
        raise ValueError(kind)
    assert rounds, "need at least 2 gossip workers"
    return rounds


def partner_of(schedule, round_idx: int, worker: int, mesh_cfg: MeshConfig) -> int:
    """Host-side: global worker index of ``worker``'s partner in round_idx."""
    axis, pairs = schedule[round_idx % len(schedule)]
    wpp = mesh_cfg.workers_per_pod
    pod, w = divmod(worker, wpp)
    part = dict(pairs)
    if axis == "worker":
        return pod * wpp + part[w]
    return part[pod] * wpp + w


def make_gossip_step(group, mesh_cfg: MeshConfig, cfg: ProtocolConfig,
                     schedule_kind: str = "hypercube", mode: str = "apply", codec=None):
    """Build this rank's gossip step over its local flat buffers
    (``{bucket: [1, total]}``). ``active`` is the host's ``[W]``
    participation mask (every rank passes the same), ``round_idx`` a python
    int.

    mode="apply": ``gossip_step(bufs, active, round_idx)`` -> the exchanged
    buffers (new tensors; the facade parity surface and the unfused path).
    mode="peer": -> ``(peer_bufs, gate*coef [1])`` with the elastic move NOT
    applied.
    mode="fused": ``gossip_step(bufs, velocity, grads, active, round_idx,
    eta, mu)`` -> ``(bufs, velocity)``: the exchange and the whole NAG +
    elastic update (Alg. 5 lines 3/7/9, simultaneous) as kernel B1, in
    place on ``bufs`` and ``velocity``.

    ``codec``: the active codec (default: ``cfg.codec``'s). A stateful one
    adds a ``residual`` buffer dict after the params (after the grads in
    fused mode) and a residual output at the end.
    """
    assert mode in ("apply", "peer", "fused"), mode
    schedule = build_schedule(mesh_cfg, schedule_kind)
    impl = registry.resolve(cfg)
    if codec is None and impl.pairwise:
        codec = comm.active_codec(cfg)
    stateful = codec is not None and codec.stateful
    rank, dev = group.rank, group.device

    def switch_exchange(bufs: Buffers, act: torch.Tensor, round_idx: int):
        """ONE send and one recv per bucket with this round's partner, the
        gate in the first bucket's tail element. Returns (peer, peer_act)."""
        partner = partner_of(schedule, round_idx, rank, mesh_cfg)
        buckets = list(bufs)
        carrier = bufs[buckets[0]]
        cat = torch.cat([carrier, act.reshape(1, 1).to(carrier.dtype)], dim=-1)
        got = group.exchange([cat] + [bufs[k] for k in buckets[1:]], partner)
        # a fresh [1, total] buffer: a view of the wider carrier would keep
        # its row stride, which byte views of a packed wire cannot take
        peer = {buckets[0]: got[0][0, :-1].clone()[None]}
        peer.update(zip(buckets[1:], got[1:]))
        return peer, got[0][0, -1].to(torch.float32)

    def exchange_flat(bufs: Buffers, residual, act: torch.Tensor, round_idx: int):
        """One gossip round over the local flat plane. Returns (peer_bufs,
        peer_act, new_residual_bufs or None)."""
        if codec is None:
            peer, peer_act = switch_exchange(bufs, act, round_idx)
            return peer, peer_act, None
        seeds = comm.codec_seeds(round_idx, torch.full((1,), rank, dtype=torch.int64,
                                                       device=dev))
        wires, new_res = {}, {}
        for k, b in bufs.items():
            r = residual[k] if stateful else None
            wire, r2 = codec.encode(b, seeds, r)
            wires[k] = codec.pack(wire)
            if stateful:
                new_res[k] = torch.where(act > 0, r2, r)
        peer_wires, peer_act = switch_exchange(wires, act, round_idx)
        peer = {k: codec.decode_wire(peer_wires[k], b.shape[1]).to(b.dtype)
                for k, b in bufs.items()}
        return peer, peer_act, (new_res if stateful else None)

    def gate_coef(act, peer_act) -> torch.Tensor:
        gate, coef = impl.pair_gate_coef(act, peer_act)
        return (gate * coef).to(torch.float32)

    def my_active(active) -> torch.Tensor:
        # a fill, not a host-to-device copy
        return torch.full((), float(active[rank]), dtype=torch.float32, device=dev)

    def local_update(bufs, residual, active, round_idx):
        act = my_active(active)
        peer, peer_act, new_res = exchange_flat(bufs, residual, act, round_idx)
        gc = gate_coef(act, peer_act)
        if mode == "peer":
            out = (peer, gc.reshape(1))
        else:
            # in the storage dtype, as the reference
            out = ({k: b - gc.to(b.dtype) * (b - peer[k]) for k, b in bufs.items()},)
        if stateful:
            out = out + (new_res,)
        return out[0] if len(out) == 1 else out

    def local_fused(bufs, velocity, grads, residual, active, round_idx, eta, mu):
        act = my_active(active)
        peer, peer_act, new_res = exchange_flat(bufs, residual, act, round_idx)
        ops.fused_bufs_elastic_nag(bufs, peer, velocity, grads, gate_coef(act, peer_act),
                                   eta, mu)
        outs = (bufs, velocity)
        return outs + (new_res,) if stateful else outs

    if mode == "fused":
        if stateful:
            def gossip_step(bufs, velocity, grads, residual, active, round_idx, eta, mu):
                return local_fused(bufs, velocity, grads, residual, active, round_idx, eta, mu)
        else:
            def gossip_step(bufs, velocity, grads, active, round_idx, eta, mu):
                return local_fused(bufs, velocity, grads, None, active, round_idx, eta, mu)
    elif stateful:
        def gossip_step(bufs, residual, active, round_idx):
            return local_update(bufs, residual, active, round_idx)
    else:
        def gossip_step(bufs, active, round_idx):
            return local_update(bufs, None, active, round_idx)

    gossip_step.num_rounds = len(schedule)
    gossip_step.schedule = schedule
    gossip_step.stateful_codec = stateful
    return gossip_step
