"""Shared model building blocks (port of ``repro.models.common``, the part
the MLP uses). Every ``init_*`` returns ``(params, axes)``."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               axes: Tuple[Optional[str], ...], dtype=torch.float32,
               fan_in: Optional[int] = None, scale: float = 1.0):
    """He/Kaiming-style variance scaling (paper §4.1 uses Kaiming init),
    ``std = scale * sqrt(2 / fan_in)``, drawn from ``gen`` on its device."""
    fi = fan_in if fan_in is not None else shape[0]
    std = scale * float(np.sqrt(2.0 / max(fi, 1)))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * std).to(dtype), axes


def split_tree(pairs: dict) -> Tuple[dict, dict]:
    """{'name': (param, axes)} possibly nested -> (params, axes) trees."""
    params, axes = {}, {}
    for k, v in pairs.items():
        if isinstance(v, dict):
            params[k], axes[k] = split_tree(v)
        else:
            params[k], axes[k] = v
    return params, axes
