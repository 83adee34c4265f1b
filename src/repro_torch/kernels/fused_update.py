"""Kernel B1 on Hopper: the fused elastic-gossip + NAG update of the flat
plane, in place.

Replaces the Pallas TPU kernel ``repro/kernels/fused_update.py::_flat_kernel``
(wrapper ``fused_flat_elastic_nag_update``). The CUDA C++ source is
``csrc/fused_update.cu``: one streaming pass that reads theta/peer/v/g once
and writes theta/v once — six streams against ~9 flops per element, so the
card's memory bandwidth bounds it and fusing the three sweeps of Alg. 5
(lines 3, 7, 9) is the whole gain.

This wrapper takes CUDA tensors only and raises on anything else; callers
reach it through :mod:`repro_torch.kernels.ops`, which sends CPU tensors to
the plain version in :mod:`repro_torch.kernels.ref`. ``LAUNCHES`` counts
launches of the kernel (and nothing else).
"""
from __future__ import annotations

import ctypes

import torch

LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _fn():
    global _FN
    if _FN is None:
        from repro_torch.kernels import build
        f = build.load("fused_update").repro_fused_flat_elastic_nag
        f.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def _scalar_col(c, W: int, device) -> torch.Tensor:
    """A python number, 0-d or [W] tensor -> [W] f32 on ``device``, made with
    device ops (no host-to-device copy, so no stream sync)."""
    if isinstance(c, torch.Tensor):
        if c.device != device:
            raise ValueError(f"scalar operand on {c.device}, buffers on {device}")
        return c.to(torch.float32).reshape(-1).expand(W)
    return torch.full((W,), float(c), dtype=torch.float32, device=device)


def fused_flat_elastic_nag_update(theta, peer, v, g, coef, eta, mu):
    """In place on CUDA ``[W, N]`` buffers:

        v     <- mu * v - eta * g
        theta <- theta - coef * (theta - peer) - eta * g + mu * v

    theta/peer/g share one storage type T (float32 or bfloat16); v is T or
    float32; coef is a scalar or [W], eta and mu scalars (0-d tensors on the
    same device, or python numbers). ``peer`` may be ``theta``. Returns
    (theta, v), the same tensors, updated."""
    global LAUNCHES
    bufs = {"theta": theta, "peer": peer, "v": v, "g": g}
    for name, t in bufs.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got "
                             f"{getattr(t, 'device', type(t))}")
        if t.dim() != 2 or t.shape != theta.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"[W, N] = {tuple(theta.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != theta.device:
            raise ValueError(f"{name} is on {t.device}, theta on {theta.device}")
    if theta.dtype not in _DTYPE_CODE or peer.dtype != theta.dtype or g.dtype != theta.dtype:
        raise ValueError(f"theta/peer/g must share float32 or bfloat16, got "
                         f"{theta.dtype}/{peer.dtype}/{g.dtype}")
    if v.dtype not in (theta.dtype, torch.float32):
        raise ValueError(f"v must be {theta.dtype} or float32, got {v.dtype}")
    W, n = theta.shape
    dev = theta.device
    sc = torch.stack([_scalar_col(coef, W, dev), _scalar_col(eta, W, dev),
                      _scalar_col(mu, W, dev)], dim=1).contiguous()
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPE_CODE[theta.dtype], _DTYPE_CODE[v.dtype], theta.data_ptr(),
                 peer.data_ptr(), v.data_ptr(), g.data_ptr(), sc.data_ptr(),
                 W, n, stream)
    if err != 0:
        raise RuntimeError(f"fused_flat_elastic_nag kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return theta, v
