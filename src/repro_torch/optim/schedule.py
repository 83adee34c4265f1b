"""Learning-rate schedules (port of ``repro.optim.schedule``).

:func:`lr_at` returns a 0-d float32 tensor on the step counter's device,
built with device ops only, so a step reads its learning rate without a
host round trip.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common.config import OptimizerConfig


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a 0-d integer tensor), on its device."""
    lr = torch.full((), cfg.learning_rate, dtype=torch.float32, device=step.device)
    step = step.float()
    if cfg.schedule == "constant":
        pass
    elif cfg.schedule == "step":
        for boundary in cfg.step_anneal_at:
            lr = lr * torch.where(step >= boundary,
                                  torch.full_like(lr, cfg.step_anneal_factor),
                                  torch.ones_like(lr))
    elif cfg.schedule == "cosine":
        decay = max(cfg.decay_steps, 1)
        frac = torch.clamp((step - cfg.warmup_steps) / decay, 0.0, 1.0)
        lr = lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    if cfg.warmup_steps > 0:
        warm = torch.clamp((step + 1) / cfg.warmup_steps, 0.0, 1.0)
        lr = lr * warm
    return lr
