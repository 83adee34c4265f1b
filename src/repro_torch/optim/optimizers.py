"""Optimizers as functions over buffer dicts / pytrees (port of
``repro.optim.optimizers``: ``sgd``, ``nag`` and ``adamw``).

``nag`` is the velocity form of the paper's Algorithm 5:

    v   <- mu * v - eta * g          (line 3)
    theta <- theta - eta*g + mu*v    (line 9, with the *updated* v)

Everything here is elementwise and returns new tensors; the sim engine's
fused path is what updates the resident buffers in place. Products with the
learning rate (a 0-d f32 tensor) promote as the reference's do: see
:func:`_scaled`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.common.config import OptimizerConfig
from repro_torch.common.pytree import global_norm, tree_map, tree_zeros_like
from repro_torch.optim.schedule import lr_at

PyTree = Any


class OptState(NamedTuple):
    step: torch.Tensor    # int32 0-d
    mu: PyTree            # velocity (nag) / first moment (adamw)
    nu: PyTree            # second moment (adamw); empty dict otherwise


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], OptState]
    update: Callable[[PyTree, OptState, PyTree], tuple]
    cfg: OptimizerConfig


def _device_of(tree: PyTree):
    return next(iter(tree.values())).device if isinstance(tree, dict) and tree else None


def _scaled(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``c * x`` for a 0-d f32 tensor ``c`` (a learning rate), promoted as in
    the reference: there ``c`` is a strongly typed f32 array,
    so a bf16 ``x`` gives an f32 product, where torch would keep bf16 for a
    0-d operand. On an f32 plane this is the plain product."""
    return c * x.to(torch.promote_types(x.dtype, c.dtype))


def _clip(cfg: OptimizerConfig, grads: PyTree) -> PyTree:
    if cfg.grad_clip <= 0:
        return grads
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gn + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    def zero_step(params):
        return torch.zeros((), dtype=torch.int32, device=_device_of(params))

    if cfg.name == "sgd":
        def init(params):
            return OptState(zero_step(params), {}, {})

        def update(grads, state, params):
            grads = _clip(cfg, grads)
            eta = lr_at(cfg, state.step)
            new = tree_map(lambda p, g: p - _scaled(eta, g.to(p.dtype)), params, grads)
            if cfg.weight_decay:
                new = tree_map(lambda n, p: n - _scaled(eta * cfg.weight_decay, p),
                               new, params)
            return new, OptState(state.step + 1, {}, {})

    elif cfg.name == "nag":
        def init(params):
            return OptState(zero_step(params), tree_zeros_like(params), {})

        def update(grads, state, params):
            grads = _clip(cfg, grads)
            eta = lr_at(cfg, state.step)
            mu = cfg.momentum
            v_new = tree_map(lambda v, g: mu * v - _scaled(eta, g.to(v.dtype)),
                             state.mu, grads)
            new = tree_map(lambda p, g, v: p - _scaled(eta, g.to(p.dtype)) + mu * v.to(p.dtype),
                           params, grads, v_new)
            return new, OptState(state.step + 1, v_new, {})

    elif cfg.name == "adamw":
        def init(params):
            return OptState(zero_step(params), tree_zeros_like(params),
                            tree_zeros_like(params))

        def update(grads, state, params):
            grads = _clip(cfg, grads)
            eta = lr_at(cfg, state.step)
            t = state.step + 1
            b1, b2 = cfg.beta1, cfg.beta2
            mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(m.dtype), state.mu, grads)
            nu = tree_map(lambda n, g: b2 * n + (1 - b2) * torch.square(g.to(n.dtype)),
                          state.nu, grads)
            c1 = 1 - b1 ** t.float()
            c2 = 1 - b2 ** t.float()

            def upd(p, m, n):
                step = (m / c1) / (torch.sqrt(n / c2) + cfg.eps)
                # decoupled weight decay, scaled by eta with the step
                return p - _scaled(eta, step.to(p.dtype) + cfg.weight_decay * p)

            return tree_map(upd, params, mu, nu), OptState(t, mu, nu)

    else:
        raise ValueError(f"unknown optimizer {cfg.name!r}")

    return Optimizer(init=init, update=update, cfg=cfg)


def velocity_update(cfg: OptimizerConfig, state: OptState, grads: PyTree):
    """Split-phase NAG (paper Alg. 5): the new velocity only (line 3)."""
    assert cfg.name == "nag"
    grads = _clip(cfg, grads)
    eta = lr_at(cfg, state.step)
    v_new = tree_map(lambda v, g: cfg.momentum * v - _scaled(eta, g.to(v.dtype)),
                     state.mu, grads)
    return v_new, OptState(state.step + 1, v_new, {})


def param_update(cfg: OptimizerConfig, step, params: PyTree, grads: PyTree,
                 v_new: PyTree) -> PyTree:
    """Line 9 of Alg. 5: theta <- theta - eta*g + mu*v_new."""
    eta = lr_at(cfg, step)
    return tree_map(lambda p, g, v: (p - _scaled(eta, g.to(p.dtype))
                                     + cfg.momentum * v.to(p.dtype)),
                    params, grads, v_new)
