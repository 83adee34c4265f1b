"""Feed-forward blocks: SwiGLU/GeGLU (gated) and plain 2-layer MLPs (port of
``repro.models.mlp``). The products are ``torch.matmul``, as the reference
leaves them to XLA."""
from __future__ import annotations

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models.common import activation_fn, dense_init, split_tree


def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype=torch.float32):
    if activation in ("swiglu", "geglu"):
        return split_tree({
            "w_gate": dense_init(gen, (d_model, d_ff), ("embed", "ffn"), dtype),
            "w_up": dense_init(gen, (d_model, d_ff), ("embed", "ffn"), dtype),
            "w_down": dense_init(gen, (d_ff, d_model), ("ffn", "embed"), dtype, fan_in=d_ff),
        })
    return split_tree({
        "w_up": dense_init(gen, (d_model, d_ff), ("embed", "ffn"), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), ("ffn", "embed"), dtype, fan_in=d_ff),
    })


def ffn_forward(p, x, activation: str):
    act = activation_fn(activation)
    if "w_gate" in p:
        h = act(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    else:
        h = act(x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


def init_ffn_cfg(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32):
    return init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype)
