"""Consensus and divergence diagnostics across worker replicas (port of
``repro.core.consensus``).

Every function reduces over the worker axis. On the sim engine that is dim 0
of a stacked ``[W, ...]`` pytree. On the dist engine each rank holds only its
own ``[1, ...]`` row, and ``group`` (a
:class:`~repro_torch.launch.mesh.WorkerGroup`) makes the same reduction a
collective over the ranks; every rank gets the result.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.common.pytree import tree_leaves, tree_map

PyTree = Any


def worker_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the worker axis, which is reduced away: ``x.sum(0)`` of a
    stacked tensor, or the sum of the ranks' ``[1, ...]`` rows."""
    if group is None:
        return torch.sum(x, dim=0)
    return group.all_reduce_sum(x)[0]


def num_workers(x: torch.Tensor, group=None) -> int:
    return x.shape[0] if group is None else group.world


def aggregate(params_stack: PyTree, group=None) -> PyTree:
    """Parameter average over the worker axis (paper 'Aggregate Accuracy'
    model): one replica's pytree."""
    return tree_map(lambda x: worker_sum(x, group) / num_workers(x, group), params_stack)


def divergence_metrics(params_stack: PyTree, group=None) -> Dict[str, torch.Tensor]:
    """How far replicas have drifted apart, the 'strain' on the elastic
    (paper §3.3's elastic-modulus analogy).

    consensus_dist: mean_i ||theta_i - mean||; rel_dist normalizes by ||mean||.
    """
    flat = [x.reshape(x.shape[0], -1).float() for x in tree_leaves(params_stack)]
    theta = torch.cat(flat, dim=1)                           # [W or 1, P]
    center = worker_sum(theta, group)[None] / num_workers(theta, group)
    dists = torch.linalg.norm(theta - center, dim=1)
    if group is not None:
        dists = group.all_gather(dists)                      # [W]
    center_norm = torch.linalg.norm(center)
    return {
        "consensus_dist_mean": torch.mean(dists),
        "consensus_dist_max": torch.max(dists),
        "consensus_rel": torch.mean(dists) / (center_norm + 1e-12),
        "param_norm": center_norm,
    }


def total_sum(params_stack: PyTree, group: Optional[Any] = None) -> torch.Tensor:
    """sum_i sum(theta_i) in f32: conserved by any elastic-symmetric
    communication update (tests rely on this invariant)."""
    local = sum(torch.sum(x.float()) for x in tree_leaves(params_stack))
    if group is None:
        return local
    return group.all_reduce_sum(local.reshape(1))[0]
