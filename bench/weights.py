"""The weights of a run, made from its seed: one ``torch.randn`` on the
device for every random leaf (a ``torch.Generator`` on that device), each
leaf a view of it scaled in place by its He standard deviation, ``scale *
sqrt(2 / fan_in)``; the deterministic leaves (norm weights, Mamba2's A_log,
dt bias and skip) filled. The same seed on the same device gives the same
bits, so the reference makes them again after the window instead of keeping
a copy."""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from bench.reference.train import nest


def make(table: List[Tuple[tuple, tuple, tuple]], seed: int, device) -> dict:
    """The nested parameter dict of ``table`` ([(path, shape, init)])."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n = sum(math.prod(shape) for _, shape, init in table if init[0] == "normal")
    flat = torch.randn(n, generator=gen, dtype=torch.float32, device=device)
    out, off = {}, 0
    for path, shape, init in table:
        kind = init[0]
        if kind == "normal":
            size = math.prod(shape)
            t = flat[off:off + size].view(shape)
            t.mul_(init[2] * math.sqrt(2.0 / max(init[1], 1)))
            off += size
        elif kind == "ones":
            t = torch.ones(shape, dtype=torch.float32, device=device)
        elif kind == "zeros":
            t = torch.zeros(shape, dtype=torch.float32, device=device)
        elif kind == "log_linspace":
            row = torch.log(torch.linspace(init[1], init[2], shape[-1], device=device))
            t = row.expand(shape).contiguous()
        else:
            raise ValueError(f"unknown init {init!r} for {'/'.join(path)}")
        out["/".join(path)] = t
    return nest(out)
