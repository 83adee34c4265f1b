"""Robust pairwise gossip mixing (port of ``repro.api.robust``).

Plain elastic averaging absorbs whatever a peer publishes: one Byzantine
worker scaling its row by 100x walks the whole fleet away. The robust
protocols subclass :class:`ElasticGossip`, form the mixing displacement
``delta_i = (M theta)_i - theta_i`` in f32 and pass it through ONE per-row
transform before applying it:

- ``clipped_gossip`` norm-clips it against the local row:
  ``scale_i = min(1, robust_clip * ||theta_i|| / ||delta_i||)``;
- ``trimmed_gossip`` zeroes coordinates larger than
  ``robust_trim * RMS(theta_i)``.

The apply is one elementwise pass over each ``[W, N]`` bucket, kernel B8
(:func:`repro_torch.kernels.ops.robust_bufs_apply`); the per-row statistics
feeding it (the delta, two sums of squares, the coefficients) are plain
PyTorch, as the reference computes them with jnp outside its kernel. No
statistic is read back to the host.

The staleness-adaptive rate (``stale_adapt``) scales the displacement by
``1 / (1 + stale_adapt * |steps_i - steps_peer|)`` from the async engine's
per-worker step counts; the sim state has none, so :meth:`stale_scale`
returns None there, as the reference's does on its sync engines.

The async engine's message mode applies ONE arrived exchange at a time:
:meth:`RobustGossip.robust_pair_apply` is the reference's per-row hook, and
:meth:`RobustGossip.robust_rows_apply` the same transform on a stack of
rows, which the engine uses to move both ends of an exchange with one B8
launch, the staleness gap of the wire scaling the rate.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.api.protocols import ElasticGossip, ProtocolState
from repro_torch.api.registry import register_protocol
from repro_torch.common.pytree import tree_leaves
from repro_torch.core import topology


def _row_sumsq(tree) -> Tuple[torch.Tensor, int]:
    """(f32 sum of squares per leading row, total elements per row) over a
    stacked dict of buffers, accumulated bucket by bucket in the dict's
    leaf order, as the reference does."""
    leaves = tree_leaves(tree)
    W = leaves[0].shape[0]
    sq = torch.zeros(W, dtype=torch.float32, device=leaves[0].device)
    n = 0
    for x in leaves:
        flat = x.reshape(W, -1).to(torch.float32)
        sq = sq + torch.sum(flat * flat, dim=1)
        n += flat.shape[1]
    return sq, n


class RobustGossip(ElasticGossip):
    """Base: elastic mixing with a per-row displacement transform.

    Subclasses implement :meth:`robust_coeffs`: given the per-row sums of
    squares of the local rows and of the mixing displacement, return the
    (scale, thr) pair the flat-plane apply consumes. Peer sampling, fault
    discard and applied-exchange accounting are the base protocol's.
    """

    def robust_coeffs(self, theta_sq: torch.Tensor, delta_sq: torch.Tensor,
                      row_elems: int) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def stale_scale(self, peers: torch.Tensor, state: ProtocolState) -> Optional[torch.Tensor]:
        """1/(1 + stale_adapt * |steps_i - steps_peer_i|), or None when
        disabled or when no per-worker step counts are tracked (always the
        case on the sim engine, whose state has no ``worker_steps``)."""
        steps = getattr(state, "worker_steps", None)
        if self.cfg.stale_adapt <= 0.0 or steps is None:
            return None
        gap = torch.abs((steps - steps[peers]).to(torch.float32))
        return 1.0 / (1.0 + self.cfg.stale_adapt * gap)

    def comm_update(self, gen, active, theta_stack, state, step=None,
                    transmit=None, wire_bytes=None, peers=None, wire_faults=None):
        W = active.shape[0]
        if peers is None:
            peers = self.sample_peers(gen, W)
        mix = self.mix_matrix(peers, active, step=step)
        lost = wire_faults.lost() if wire_faults is not None else None
        if lost is not None:
            mix = topology.discard_lost(mix, lost)
        if transmit is None:
            mixed = topology.apply_mix(mix, theta_stack)
        else:
            mixed = topology.apply_mix_split(mix, theta_stack, transmit)
        delta = {k: mixed[k].to(torch.float32) - theta_stack[k].to(torch.float32)
                 for k in theta_stack}
        del mixed

        theta_sq, row_elems = _row_sumsq(theta_stack)
        delta_sq, _ = _row_sumsq(delta)
        scale, thr = self.robust_coeffs(theta_sq, delta_sq, row_elems)
        s = self.stale_scale(peers, state)
        if s is not None:
            scale = scale * s
        theta_new = self._apply_delta(theta_stack, delta, scale, thr)

        rounds = state.comm_rounds + torch.any(active).to(torch.int32)
        units, bytes_ = self._accrue_bytes(state, active, theta_stack, wire_bytes,
                                           lost=lost)
        state = self._count_wire_faults(state, active, wire_faults)
        return theta_new, state._replace(comm_rounds=rounds, comm_units=units,
                                         comm_bytes=bytes_)

    def robust_rows_apply(self, local, recv, coef, gap=None):
        """Message-mode realization for stacked rows: ``local`` / ``recv``
        are ``{bucket: [R, n]}`` dicts, row r moving toward ``recv`` row r
        by the pair moving rate ``coef`` through the robust transform
        (per-row coefficients); ``gap`` is the wire's |step-count|
        staleness. Returns the new ``{bucket: [R, n]}`` rows (one B8 launch
        per bucket on the card)."""
        delta = {k: coef * (recv[k].to(torch.float32) - local[k].to(torch.float32))
                 for k in local}
        theta_sq, row_elems = _row_sumsq(local)
        delta_sq, _ = _row_sumsq(delta)
        scale, thr = self.robust_coeffs(theta_sq, delta_sq, row_elems)
        if self.cfg.stale_adapt > 0.0 and gap is not None:
            g = torch.abs(torch.as_tensor(gap, dtype=torch.float32, device=scale.device))
            scale = scale / (1.0 + self.cfg.stale_adapt * g)
        return self._apply_delta(local, delta, scale, thr)

    def robust_pair_apply(self, local, recv, coef, gap=None):
        """The reference's hook for ONE applied exchange: ``local`` /
        ``recv`` are single-row ``{bucket: [n]}`` dicts; returns the
        robustified new local row (the plane path's transform on a [1, n]
        view)."""
        out = self.robust_rows_apply({k: v[None] for k, v in local.items()},
                                     {k: v[None] for k, v in recv.items()}, coef, gap)
        return {k: v[0] for k, v in out.items()}

    @staticmethod
    def _apply_delta(theta_stack, delta, scale, thr):
        """theta + scale * trim(delta, thr) per bucket, into new tensors
        (kernel B8 on the card); theta itself is never written."""
        from repro_torch.kernels import ops
        flat_t = {k: t.reshape(t.shape[0], -1) for k, t in theta_stack.items()}
        flat_d = {k: d.reshape(d.shape[0], -1) for k, d in delta.items()}
        out = ops.robust_bufs_apply(flat_t, flat_d, scale, thr)
        return {k: out[k].reshape(theta_stack[k].shape) for k in theta_stack}


@register_protocol("clipped_gossip")
class ClippedGossip(RobustGossip):
    """Norm-clipped elastic gossip: the received displacement is scaled down
    to at most ``robust_clip`` of the local row norm."""

    def robust_coeffs(self, theta_sq, delta_sq, row_elems):
        t_norm = torch.sqrt(theta_sq)
        d_norm = torch.sqrt(delta_sq)
        # d_norm == 0 -> the displacement is zero anyway; keep scale = 1
        scale = torch.clamp(self.cfg.robust_clip * t_norm / torch.clamp(d_norm, min=1e-30),
                            max=1.0)
        return scale, torch.full_like(scale, float("inf"))


@register_protocol("trimmed_gossip")
class TrimmedGossip(RobustGossip):
    """Coordinate-trimmed elastic gossip: displacement coordinates larger
    than ``robust_trim * RMS(theta_row)`` are zeroed before applying."""

    def robust_coeffs(self, theta_sq, delta_sq, row_elems):
        rms = torch.sqrt(theta_sq / max(row_elems, 1))
        thr = self.cfg.robust_trim * rms
        return torch.ones_like(thr), thr
