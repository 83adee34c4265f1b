"""Token-account flow control: who gets to INITIATE a gossip exchange (port
of ``repro.fleet.flow``).

With W in the hundreds, every worker firing its Bernoulli gate every step
floods the wire. Flow control throttles initiations with a per-worker token
balance: a completed local step earns ``token_rate`` tokens (capped at
``token_capacity``), an initiated exchange spends one, and a worker whose
gate fired but whose account cannot cover the spend SKIPS the exchange. A
skip never reaches ``comm_units`` / ``comm_bytes``; it is counted in
``ProtocolState.flow_skipped``.

Every model is a :class:`FlowControl` registered under a name
(``@register_flow_control``) and selected by
``FleetConfig(flow_control=...)``. The randomized model's initiation draw
hashes ``(FleetConfig.seed, worker, step)``: the torch draw on the device
(:meth:`FlowControl.allow`, through
:func:`repro_torch.faults.models.fault_hash`) and the numpy draw of the
host plane (:meth:`FlowControl.allow_np`) compare the same uint32 hash lane
against the same f32 threshold, so they agree with each other and with the
reference bit for bit.
"""
from __future__ import annotations

from typing import Dict, Type

import numpy as np
import torch

from repro_torch.common.config import FleetConfig
from repro_torch.faults.models import fault_hash
from repro_torch.hetero.models import hetero_hash

# fleet-plane hash salts (the reference's; distinct from the fault plane's
# 101/202/303/404)
SALT_PARTITION = 505   # which chunk a worker ships this step
SALT_FLOW = 606        # randomized token-account initiation draw

_FLOW: Dict[str, Type["FlowControl"]] = {}


def register_flow_control(name: str):
    """Class decorator: register a :class:`FlowControl` under ``name``."""
    def deco(cls):
        if not (isinstance(cls, type) and issubclass(cls, FlowControl)):
            raise TypeError(f"{cls!r} must subclass FlowControl")
        if name in _FLOW:
            raise ValueError(f"flow control {name!r} already registered "
                             f"({_FLOW[name].__qualname__})")
        cls.name = name
        _FLOW[name] = cls
        return cls
    return deco


def available_flow_controls():
    return sorted(_FLOW)


def get_flow_control(name: str) -> Type["FlowControl"]:
    if name not in _FLOW:
        raise KeyError(f"unknown flow control {name!r}; available: "
                       f"{available_flow_controls()}")
    return _FLOW[name]


def unregister_flow_control(name: str) -> None:
    _FLOW.pop(name, None)


def resolve_flow_control(cfg: FleetConfig):
    """FleetConfig -> FlowControl instance, or None for the trivial model
    (the engines then add no work)."""
    model = get_flow_control(cfg.flow_control)(cfg)
    return None if model.trivial else model


class FlowControl:
    """One initiation-throttling policy. Balances live in
    ``ProtocolState.tokens`` (f32[W], checkpointed); the model is stateless.

    The engine calls :meth:`allow` on the PRE-step balances to mask the comm
    gate, then :meth:`update` with the masks of workers that completed a
    local step (credit) and that actually initiated (debit)."""

    name = ""          # set by @register_flow_control
    trivial = False    # True -> resolve_flow_control returns None

    def __init__(self, cfg: FleetConfig):
        self.cfg = cfg
        self.capacity = float(cfg.token_capacity)
        self.rate = float(cfg.token_rate)
        self.threshold = float(cfg.token_threshold)
        self.init_balance = (self.capacity if cfg.token_init < 0
                             else float(cfg.token_init))
        assert self.capacity > 0 and self.threshold > 0, cfg

    def init_tokens(self, num_workers: int, device=None) -> torch.Tensor:
        return torch.full((num_workers,), self.init_balance, dtype=torch.float32,
                          device=device)

    def allow(self, step: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """bool[W] on the device: may worker w initiate at ``step`` (a device
        scalar) given balances ``tokens``?"""
        raise NotImplementedError

    def allow_np(self, step: int, tokens: np.ndarray) -> np.ndarray:
        """Numpy mirror of :meth:`allow` for the host plane; equal to it bit
        for bit given the same balances."""
        raise NotImplementedError

    def update(self, tokens, stepped, initiated):
        """New balances: credit ``token_rate`` per completed local step
        (capped at capacity), debit 1 per initiated exchange (floored at 0).
        ``stepped``/``initiated`` are bool[W]; torch tensors or numpy arrays
        alike."""
        if isinstance(tokens, np.ndarray):
            credited = tokens + self.rate * stepped.astype(tokens.dtype)
            credited = np.minimum(credited, tokens.dtype.type(self.capacity))
            return np.maximum(credited - initiated.astype(tokens.dtype), 0.0)
        credited = torch.clamp(tokens + self.rate * stepped.to(tokens.dtype), max=self.capacity)
        return torch.clamp(credited - initiated.to(tokens.dtype), min=0.0)


@register_flow_control("none")
class NoFlowControl(FlowControl):
    """Every gated initiation goes through (resolves to None)."""
    trivial = True


@register_flow_control("token_account")
class TokenAccount(FlowControl):
    """Deterministic account: initiate iff the balance covers the spend
    (>= 1 token)."""

    def allow(self, step, tokens):
        return tokens >= 1.0

    def allow_np(self, step, tokens):
        return tokens >= np.float32(1.0)


@register_flow_control("randomized_token_account")
class RandomizedTokenAccount(FlowControl):
    """Below the threshold A a worker initiates with probability
    ``balance / A`` (full balance: always), an exact comparison of a 24-bit
    hash lane against the f32 probability."""

    def allow(self, step, tokens):
        W = tokens.shape[0]
        h = fault_hash(self.cfg.seed, torch.arange(W, device=tokens.device), step, SALT_FLOW)
        u = (h >> 8).to(torch.float32) / float(1 << 24)
        p = torch.clamp(tokens / torch.tensor(self.threshold, dtype=tokens.dtype,
                                              device=tokens.device), 0.0, 1.0)
        return (tokens >= 1.0) & (u < p)

    def allow_np(self, step, tokens):
        W = tokens.shape[0]
        h = hetero_hash(self.cfg.seed, np.arange(W), step, SALT_FLOW)
        u = (h >> np.uint64(8)).astype(np.float32) / np.float32(1 << 24)
        p = np.clip(tokens / np.asarray(self.threshold, tokens.dtype), 0.0, 1.0)
        return (tokens >= np.float32(1.0)) & (u < p)
