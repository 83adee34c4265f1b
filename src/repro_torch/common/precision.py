"""Full f32 on the card: no TF32 inside a block.

On an H100 PyTorch lets cuDNN run f32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32``), about 1e-3 relative error, where the
reference computes in f32. The flags are read when each kernel launches,
and the backward convolutions launch inside ``torch.func.grad_and_value``,
so the engines hold this context around the whole gradient computation,
forward and backward. It also picks cuDNN's deterministic algorithms, so a
resumed run repeats the uninterrupted one bit for bit. On the CPU it turns
oneDNN off: the engines' vmap makes each convolution a grouped one, and
oneDNN's grouped weight gradient was seen 1.1e-3 off at one element of a
3.7e-2 gradient, where ATen's own kernel agrees with the reference within
2e-7. The process's own settings come back on exit; importing this module
changes nothing.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """cuBLAS matmuls and cuDNN convolutions in f32 (TF32 off), cuDNN
    deterministic and not autotuned, and oneDNN off, inside the block."""
    cudnn, matmul, mkldnn = torch.backends.cudnn, torch.backends.cuda.matmul, torch.backends.mkldnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
             mkldnn.enabled)
    matmul.allow_tf32 = cudnn.allow_tf32 = mkldnn.enabled = False
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
         mkldnn.enabled) = saved
