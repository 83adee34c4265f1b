"""The paper's MNIST MLP (§4.1), port of ``repro.models.simple``.

3 dense layers of 1024 ReLU units, Kaiming init, dropout p=0.2 at input /
0.5 at hidden (only when a generator is given), 10-way softmax. Parameters
are a plain dict of tensors with the reference's names and shapes
(``w0``/``b0``/.../``w_out``/``b_out``); the CNN is not ported yet.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.common import dense_init, split_tree

PyTree = Any


def init_mlp(gen: torch.Generator, in_dim: int = 784, hidden: int = 1024,
             depth: int = 3, num_classes: int = 10, dtype=torch.float32):
    """(params, axes) on ``gen``'s device."""
    tree = {}
    d = in_dim
    for i in range(depth):
        tree[f"w{i}"] = dense_init(gen, (d, hidden), ("embed", "ffn"), dtype)
        tree[f"b{i}"] = (torch.zeros((hidden,), dtype=dtype, device=gen.device), (None,))
        d = hidden
    tree["w_out"] = dense_init(gen, (d, num_classes), ("ffn", None), dtype)
    tree["b_out"] = (torch.zeros((num_classes,), dtype=dtype, device=gen.device), (None,))
    return split_tree(tree)


def mlp_logits(params, x, *, dropout_gen: Optional[torch.Generator] = None,
               p_in: float = 0.2, p_hidden: float = 0.5):
    depth = sum(1 for k in params if k.startswith("w") and k != "w_out")

    def drop(h, p):
        keep = torch.rand(h.shape, generator=dropout_gen, device=h.device) < (1 - p)
        return h * keep.to(h.dtype) / (1 - p)

    h = x
    if dropout_gen is not None:
        h = drop(h, p_in)
    for i in range(depth):
        h = torch.relu(h @ params[f"w{i}"] + params[f"b{i}"])
        if dropout_gen is not None:
            h = drop(h, p_hidden)
    return h @ params["w_out"] + params["b_out"]


def xent_loss(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))


def accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())


def params_from_jax(tree, device) -> PyTree:
    """The reference's parameter dict (leaves as numpy arrays, e.g. via
    ``np.asarray``) -> the port's dict of tensors on ``device``, with the
    same names, shapes and dtypes (bfloat16 leaves go through float32)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)
