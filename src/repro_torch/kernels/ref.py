"""Plain PyTorch versions of the port's kernels (the allclose targets, port
of ``repro.kernels.ref``). Pure functions: they return new tensors."""
from __future__ import annotations

import torch


def _per_replica(c, W: int, device) -> torch.Tensor:
    """Scalar or [W] -> [W, 1] f32 column (broadcasts over the flat axis)."""
    if not isinstance(c, torch.Tensor):
        c = torch.full((), float(c), dtype=torch.float32, device=device)
    return c.to(device=device, dtype=torch.float32).reshape(-1).expand(W)[:, None]


def fused_flat_elastic_nag_update(theta, peer, v, g, coef, eta, mu):
    """Flat-plane fused update (paper Alg. 5 lines 3/7/9, simultaneous) on
    ``[W, N]`` buffers, per-replica ``coef`` (scalar or [W]), scalar
    ``eta``/``mu`` (python numbers or 0-d tensors), computed in f32:

        v'     = mu * v - eta * g
        theta' = theta - coef * (theta - peer) - eta * g + mu * v'

    Returns (theta', v') in theta's / v's dtypes."""
    W, dev = theta.shape[0], theta.device
    c = _per_replica(coef, W, dev)
    e = _per_replica(eta, W, dev)
    m = _per_replica(mu, W, dev)
    tf, pf = theta.float(), peer.float()
    vf, gf = v.float(), g.float()
    eg = e * gf
    v_new = m * vf - eg
    theta_new = tf - c * (tf - pf) - eg + m * v_new
    return theta_new.to(theta.dtype), v_new.to(v.dtype)
