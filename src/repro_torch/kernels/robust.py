"""Kernel B8 on Hopper: the robust-gossip displacement apply on the flat
plane.

Replaces the Pallas TPU kernel ``repro/kernels/robust.py::_robust_kernel``
(wrapper ``robust_flat_apply``). The CUDA C++ source is
``csrc/robust.cu``: one streaming pass that reads theta and delta once and
writes theta' once, three streams against 4 flops per element, so the
card's memory bandwidth bounds it. Each operand may be a row-strided view
whose last dimension is contiguous (the column chunk ``x[:, lo:hi]`` of the
partitioned mixing), and ``out=`` writes into such a view: the kernel takes
each operand's leading dimension, so no chunk is copied.

This wrapper takes CUDA tensors only and raises on anything else; callers
reach it through :mod:`repro_torch.kernels.ops`, which sends CPU tensors to
the plain version in :mod:`repro_torch.kernels.ref`. ``LAUNCHES`` counts
launches of the kernel (and nothing else).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.fused_update import _scalar_col

LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _fn():
    global _FN
    if _FN is None:
        from repro_torch.kernels import build
        f = build.load("robust").repro_robust_flat_apply
        f.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + [
            ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def _check_rows_view(name, t, like) -> None:
    """A CUDA ``[W, n]`` operand of ``like``'s shape on its device whose
    rows are contiguous (any row stride)."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dim() != 2 or t.shape != like.shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"[W, N] = {tuple(like.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1 or t.stride(0) < t.shape[1]:
        raise ValueError(f"{name} must have contiguous rows (strides {t.stride()})")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, theta on {like.device}")


def robust_flat_apply(theta, delta, scale, thr, out=None):
    """``theta + scale * (delta * (|delta| <= thr))`` on CUDA ``[W, N]``
    buffers; theta is not written.

    theta is float32 or bfloat16, delta float32, both of one shape on one
    device, each with contiguous rows and any row stride (column slices of
    a wider plane); scale and thr are python numbers, 0-d or [W] tensors on
    that device (made into a [W, 2] f32 block with device ops, so nothing is
    copied from the host). The result goes into ``out`` (same shape and
    dtype as theta, contiguous rows, any row stride) when given, else into a
    new contiguous tensor. Returns it."""
    global LAUNCHES
    _check_rows_view("theta", theta, theta)
    _check_rows_view("delta", delta, theta)
    if theta.dtype not in _DTYPE_CODE:
        raise ValueError(f"theta must be float32 or bfloat16, got {theta.dtype}")
    if delta.dtype != torch.float32:
        raise ValueError(f"delta must be float32, got {delta.dtype}")
    if out is None:
        out = torch.empty(theta.shape, dtype=theta.dtype, device=theta.device)
    else:
        _check_rows_view("out", out, theta)
        if out.dtype != theta.dtype:
            raise ValueError(f"out must be {theta.dtype}, got {out.dtype}")
    W, n = theta.shape
    dev = theta.device
    sc = torch.stack([_scalar_col(scale, W, dev), _scalar_col(thr, W, dev)],
                     dim=1).contiguous()
    ops = (out, theta, delta)
    vec4 = int(n % 4 == 0 and all(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0
                                  for t in ops))
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPE_CODE[theta.dtype], out.data_ptr(), theta.data_ptr(),
                 delta.data_ptr(), sc.data_ptr(), W, n, *(t.stride(0) for t in ops),
                 vec4, stream)
    if err != 0:
        raise RuntimeError(f"robust_flat_apply kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
