"""The paper's own models, port of ``repro.models.simple``: the MNIST MLP
(§4.1) and the CIFAR-style CNN (§4.2).

MLP: 3 dense layers of 1024 ReLU units, Kaiming init, dropout p=0.2 at
input / 0.5 at hidden (only when a generator is given), 10-way softmax.
CNN: a pre-activation residual net (stem + 3 stages of one residual block,
widths ``width * 2**s``) with a parameter-free per-example norm, depth
reduced as the reference's.

Parameters are plain dicts of tensors with the reference's names, shapes
and layouts (dense ``[in, out]``, conv HWIO), and the CNN takes NHWC
images, so the reference's parameters and ``load_cifar_like`` data carry
over unchanged; the convolutions permute to NCHW inside. They run in f32
with TF32 off (:func:`repro_torch.common.precision.full_f32`).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.precision import full_f32
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


def init_cnn(gen: torch.Generator, num_classes: int = 10, width: int = 32,
             dtype=torch.float32):
    """Pre-activation residual CNN: stem + 3 stages x 1 residual block.
    (params, axes) on ``gen``'s device; conv weights are HWIO."""
    def conv(cin, cout, k=3):
        return dense_init(gen, (k, k, cin, cout), (None, None, None, "ffn"), dtype,
                          fan_in=k * k * cin)

    tree = {"stem": conv(3, width)}
    c = width
    for s in range(3):
        cout = width * (2 ** s)
        tree[f"s{s}_c1"] = conv(c, cout)
        tree[f"s{s}_c2"] = conv(cout, cout)
        if c != cout:
            tree[f"s{s}_proj"] = conv(c, cout, k=1)
        c = cout
    tree["head"] = dense_init(gen, (c, num_classes), ("ffn", None), dtype)
    tree["head_b"] = (torch.zeros((num_classes,), dtype=dtype, device=gen.device), (None,))
    return split_tree(tree)


def _same_pad(size: int, k: int, stride: int):
    """(low, high) padding of XLA's "SAME": ceil(size / stride) outputs,
    the low side gets the smaller half (at stride 2 on an even size that is
    0 before and 1 after, which ``F.conv2d(padding=1)`` does not give)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv_nchw(x, w, stride: int = 1):
    """"SAME" convolution of NCHW ``x`` with an HWIO weight."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    ph, pw = _same_pad(int(x.shape[2]), kh, stride), _same_pad(int(x.shape[3]), kw, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _conv2d(x, w, stride: int = 1):
    """The reference's ``_conv2d``: NHWC ``x``, HWIO ``w``, "SAME", NHWC out."""
    return _conv_nchw(x.permute(0, 3, 1, 2), w, stride).permute(0, 2, 3, 1)


def _norm(x):
    """Parameter-free per-example norm over every non-batch dim (population
    std, as ``jnp.std``), the layout's order immaterial."""
    mu = torch.mean(x, dim=(1, 2, 3), keepdim=True)
    sd = torch.std(x, dim=(1, 2, 3), correction=0, keepdim=True) + 1e-5
    return (x - mu) / sd


def cnn_logits(params, x, **_):
    """Logits of NHWC images ``x``: the reference's net, computed in NCHW."""
    with full_f32():
        h = _conv_nchw(x.permute(0, 3, 1, 2), params["stem"])
        for s in range(3):
            stride = 1 if s == 0 else 2
            r = torch.relu(_norm(h))
            y = _conv_nchw(r, params[f"s{s}_c1"], stride)
            y = _conv_nchw(torch.relu(_norm(y)), params[f"s{s}_c2"])
            skip = (_conv_nchw(r, params[f"s{s}_proj"], stride)
                    if f"s{s}_proj" in params else h)
            h = skip + y
        h = torch.mean(torch.relu(_norm(h)), dim=(2, 3))
        return h @ params["head"] + params["head_b"]


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
