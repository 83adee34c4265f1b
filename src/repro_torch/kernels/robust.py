"""Kernel B8 on Hopper: the robust-gossip displacement apply on the flat
plane.

Replaces the Pallas TPU kernel ``repro/kernels/robust.py::_robust_kernel``
(wrapper ``robust_flat_apply``). The CUDA C++ source is
``csrc/robust.cu``: one streaming pass that reads theta and delta once and
writes theta' once, three streams against 4 flops per element, so the
card's memory bandwidth bounds it.

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
        f.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def robust_flat_apply(theta, delta, scale, thr):
    """``theta + scale * (delta * (|delta| <= thr))`` on CUDA ``[W, N]``
    buffers, into a NEW tensor of theta's dtype (theta is not written).

    theta is float32 or bfloat16, delta float32, both contiguous rows of the
    same shape on one device; scale and thr are python numbers, 0-d or [W]
    tensors on that device (made into a [W, 2] f32 block with device ops, so
    nothing is copied from the host)."""
    global LAUNCHES
    for name, t in (("theta", theta), ("delta", delta)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got "
                             f"{getattr(t, 'device', type(t))}")
        if t.dim() != 2 or t.shape != theta.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"[W, N] = {tuple(theta.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous [W, N] rows")
        if t.device != theta.device:
            raise ValueError(f"{name} is on {t.device}, theta on {theta.device}")
    if theta.dtype not in _DTYPE_CODE:
        raise ValueError(f"theta must be float32 or bfloat16, got {theta.dtype}")
    if delta.dtype != torch.float32:
        raise ValueError(f"delta must be float32, got {delta.dtype}")
    W, n = theta.shape
    dev = theta.device
    sc = torch.stack([_scalar_col(scale, W, dev), _scalar_col(thr, W, dev)],
                     dim=1).contiguous()
    out = torch.empty_like(theta)
    vec4 = int(n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (theta, delta, out)))
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPE_CODE[theta.dtype], out.data_ptr(), theta.data_ptr(),
                 delta.data_ptr(), sc.data_ptr(), W, n, vec4, stream)
    if err != 0:
        raise RuntimeError(f"robust_flat_apply kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
