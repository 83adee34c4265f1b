"""Shared model building blocks (port of ``repro.models.common``).

Every ``init_*`` returns ``(params, axes)``: parallel dicts whose axes
leaves name each array dim logically, as the reference's do. The
reference's ``maybe_shard`` (a sharding hint to GSPMD) has no
counterpart: tensor-parallel serving slices the parameters by the sharding
rules instead (:mod:`repro_torch.serving.tensor_parallel`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               axes: Tuple[Optional[str], ...], dtype=torch.float32,
               fan_in: Optional[int] = None, scale: float = 1.0):
    """He/Kaiming-style variance scaling (paper §4.1 uses Kaiming init),
    ``std = scale * sqrt(2 / fan_in)``, drawn from ``gen`` on its device."""
    fi = fan_in if fan_in is not None else shape[0]
    std = scale * float(np.sqrt(2.0 / max(fi, 1)))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * std).to(dtype), axes


def zeros_init(shape, axes, dtype=torch.float32, device=None):
    return torch.zeros(shape, dtype=dtype, device=device), axes


def ones_init(shape, axes, dtype=torch.float32, device=None):
    return torch.ones(shape, dtype=dtype, device=device), axes


def split_tree(pairs: dict) -> Tuple[dict, dict]:
    """{'name': (param, axes)} possibly nested -> (params, axes) trees."""
    params, axes = {}, {}
    for k, v in pairs.items():
        if isinstance(v, dict):
            params[k], axes[k] = split_tree(v)
        else:
            params[k], axes[k] = v
    return params, axes


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def upcast_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32, where the reference computes in f32; f64 stays f64, so a whole
    model can run in f64 as a reference."""
    return dtype if dtype == torch.float64 else torch.float32


def upcast(x: torch.Tensor) -> torch.Tensor:
    return x.to(upcast_dtype(x.dtype))


def init_rmsnorm(d: int, dtype=torch.float32, device=None):
    return ones_init((d,), ("act_embed",), dtype, device)


def rmsnorm(w, x, eps: float = 1e-5, plus_one: bool = False):
    """RMS norm in f32 (f64 stays f64), cast back to ``x``'s dtype."""
    xf = upcast(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = (1.0 + upcast(w)) if plus_one else upcast(w)
    return (y * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    # a fill, not torch.tensor: the latter cannot run on the meta device
    # under a gradient transform (the planning tools count there)
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] or [S]. Rotates the split
    halves by f32 angles, as the reference does."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # [hd/2]
    ang = positions[..., :, None].float() * freqs              # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]                      # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(upcast(x), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2 logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default form


def activation_fn(name: str):
    return {
        "relu": F.relu,
        "gelu": _gelu_tanh,
        "silu": F.silu,
        "swiglu": F.silu,   # gating handled by the MLP module
        "geglu": _gelu_tanh,
    }[name]
