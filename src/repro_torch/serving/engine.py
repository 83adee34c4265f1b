"""Consensus reduction over the flat plane (port of the part of
``repro.serving.engine`` that training uses; the serving program itself is
a later slice)."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.api.state import FlatState

PyTree = Any


def consensus_bufs(theta) -> dict:
    """Mean over the ``W`` replica rows of ``{bucket: [W, total]}`` buffers:
    sum in f32, divided by W, cast back to the storage dtype."""
    return {k: (torch.sum(v.float(), dim=0) / v.shape[0]).to(v.dtype)
            for k, v in theta.items()}


def consensus_params(state: FlatState) -> PyTree:
    """Worker-averaged parameters (paper 'Aggregate'): the mean over the
    resident buffers, then one-replica views."""
    return state.spec.with_lead(()).unflatten(consensus_bufs(state.theta))
