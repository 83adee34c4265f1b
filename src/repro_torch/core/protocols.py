"""Functional protocol shims over :mod:`repro_torch.api` (port of
``repro.core.protocols``): each dispatches through the registry."""
from __future__ import annotations

from typing import Any

from repro_torch.api import registry
from repro_torch.api.protocols import CommCost, ProtocolState  # noqa: F401  (re-export)
from repro_torch.common.config import ProtocolConfig

PyTree = Any


def init_state(cfg: ProtocolConfig, params_stack: PyTree) -> ProtocolState:
    return registry.resolve(cfg).init_state(params_stack)


def alpha_at(cfg: ProtocolConfig, step):
    return registry.resolve(cfg).alpha_at(step)


def comm_gate(cfg: ProtocolConfig, gen, step, num_workers: int):
    """Per-worker participation for this step: bool[W]."""
    return registry.resolve(cfg).comm_gate(gen, step, num_workers)


def gradient_transform(cfg: ProtocolConfig, grads_stack: PyTree) -> PyTree:
    return registry.resolve(cfg).gradient_transform(grads_stack)


def comm_update(cfg: ProtocolConfig, gen, active, theta_stack: PyTree,
                state: ProtocolState, step=None, transmit=None, wire_bytes=None,
                peers=None, wire_faults=None):
    """Communication-related component on stacked params [W, ...].
    ``wire_faults`` is forwarded only when set, so a registered protocol
    whose ``comm_update`` predates the fault plane keeps working."""
    kw = {} if wire_faults is None else {"wire_faults": wire_faults}
    return registry.resolve(cfg).comm_update(gen, active, theta_stack, state,
                                             step=step, transmit=transmit,
                                             wire_bytes=wire_bytes, peers=peers, **kw)


def comm_cost(cfg: ProtocolConfig, param_bytes: int, num_workers: int) -> CommCost:
    return registry.resolve(cfg).comm_cost(param_bytes, num_workers)
