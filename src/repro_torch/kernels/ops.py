"""Dispatch for the port's kernels (port of ``repro.kernels.ops``, the
fused-update part).

A CUDA tensor always goes to the hand-written kernel, which launches or
raises. A CPU tensor goes to the plain version in :mod:`ref`, whose result
is copied back into theta and v so that both devices share one in-place
contract.
"""
from __future__ import annotations

from repro_torch.kernels import fused_update as _fu
from repro_torch.kernels import ref


def fused_flat_elastic_nag_update(theta, peer, v, g, coef, eta, mu):
    """[W, N] flat-buffer fused update, IN PLACE on theta and v; per-replica
    coef, scalar eta/mu. Returns (theta, v)."""
    if theta.device.type == "cpu":
        t_new, v_new = ref.fused_flat_elastic_nag_update(theta, peer, v, g, coef, eta, mu)
        theta.copy_(t_new)
        v.copy_(v_new)
        return theta, v
    return _fu.fused_flat_elastic_nag_update(theta, peer, v, g, coef, eta, mu)


def fused_bufs_elastic_nag(theta_bufs, peer_bufs, v_bufs, g_bufs, coef, eta, mu):
    """Per-dtype-bucket dispatch of the fused update over flat-buffer dicts —
    the sim engine's hot path. Updates theta and v in place; returns
    (theta_bufs, v_bufs)."""
    for k in theta_bufs:
        fused_flat_elastic_nag_update(theta_bufs[k], peer_bufs[k], v_bufs[k],
                                      g_bufs[k], coef, eta, mu)
    return theta_bufs, v_bufs
