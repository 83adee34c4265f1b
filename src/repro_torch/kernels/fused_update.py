"""Kernels B1, B2 and B3 on Hopper: the fused NAG updates of the flat plane.

- B1 (:func:`fused_flat_elastic_nag_update`) replaces the Pallas TPU kernel
  ``repro/kernels/fused_update.py::_flat_kernel``: the elastic-gossip + NAG
  update, in place. One streaming pass reads theta/peer/v/g once and writes
  theta/v once — six streams against ~9 flops per element, so the card's
  memory bandwidth bounds it and fusing the three sweeps of Alg. 5 (lines
  3, 7, 9) is the whole gain. With ``rows=`` (an int32 device list) it
  updates the listed rows only and neither reads nor writes the others:
  the async engine's partial event windows.
- B2 (:func:`fused_flat_nag_update`) replaces ``_flat_nag_kernel``: B1
  without the peer stream (five streams), the dist engine's non-firing step.
- B3 (:func:`fused_elastic_nag_update`) replaces ``_kernel``: B1's math on
  one array of any shape with a scalar ``coef_gate``, returning new arrays.
  It runs B1's CUDA kernel over ``[1, numel]`` copies.

The CUDA C++ source of all three is ``csrc/fused_update.cu``. These wrappers
take CUDA tensors only and raise on anything else; callers reach them
through :mod:`repro_torch.kernels.ops`, which sends CPU tensors to the plain
versions in :mod:`repro_torch.kernels.ref`. ``LAUNCHES`` (B1),
``NAG_LAUNCHES`` (B2) and ``ARRAY_LAUNCHES`` (B3) count each wrapper's
launches of its kernel (and nothing else).
"""
from __future__ import annotations

import ctypes

import torch

LAUNCHES = 0
NAG_LAUNCHES = 0
ARRAY_LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FN = None
_NAG_FN = None


def _fn():
    global _FN
    if _FN is None:
        from repro_torch.kernels import build
        f = build.load("fused_update").repro_fused_flat_elastic_nag
        f.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def _nag_fn():
    global _NAG_FN
    if _NAG_FN is None:
        from repro_torch.kernels import build
        f = build.load("fused_update").repro_fused_flat_nag
        f.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _NAG_FN = f
    return _NAG_FN


def _check_plane(theta, v, others) -> None:
    """The kernels' contract: contiguous CUDA ``[W, N]`` buffers of one shape
    on one device; theta and ``others`` (name -> tensor) share float32 or
    bfloat16, v is theta's type or float32."""
    bufs = {"theta": theta, **others, "v": v}
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
    if theta.dtype not in _DTYPE_CODE or any(t.dtype != theta.dtype for t in others.values()):
        names = "/".join(["theta", *others])
        dts = "/".join(str(t.dtype) for t in (theta, *others.values()))
        raise ValueError(f"{names} must share float32 or bfloat16, got {dts}")
    if v.dtype not in (theta.dtype, torch.float32):
        raise ValueError(f"v must be {theta.dtype} or float32, got {v.dtype}")


def _check_rows(rows, theta) -> None:
    """A row list: a 1-d contiguous int32 CUDA tensor on theta's device (its
    values, distinct rows in [0, W), are the caller's promise: checking them
    would read the device back)."""
    if not isinstance(rows, torch.Tensor) or rows.device != theta.device:
        raise ValueError(f"rows must be a tensor on {theta.device}, got "
                         f"{getattr(rows, 'device', type(rows))}")
    if rows.dtype != torch.int32 or rows.dim() != 1 or not rows.is_contiguous():
        raise ValueError(f"rows must be a contiguous 1-d int32 tensor, got "
                         f"{rows.dtype} of shape {tuple(rows.shape)}")


def _launch_elastic(theta, peer, v, g, coef, eta, mu, rows=None) -> None:
    """B1's kernel on checked buffers (all rows, or the listed ones); raises
    on a failed launch."""
    W, n = theta.shape
    dev = theta.device
    sc = torch.stack([_scalar_col(coef, W, dev), _scalar_col(eta, W, dev),
                      _scalar_col(mu, W, dev)], dim=1).contiguous()
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPE_CODE[theta.dtype], _DTYPE_CODE[v.dtype], theta.data_ptr(),
                 peer.data_ptr(), v.data_ptr(), g.data_ptr(), sc.data_ptr(),
                 None if rows is None else rows.data_ptr(),
                 0 if rows is None else rows.numel(), W, n, stream)
    if err != 0:
        raise RuntimeError(f"fused_flat_elastic_nag kernel launch failed: "
                           f"cudaError {err}")


def _scalar_col(c, W: int, device) -> torch.Tensor:
    """A python number, 0-d or [W] tensor -> [W] f32 on ``device``, made with
    device ops (no host-to-device copy, so no stream sync)."""
    if isinstance(c, torch.Tensor):
        if c.device != device:
            raise ValueError(f"scalar operand on {c.device}, buffers on {device}")
        return c.to(torch.float32).reshape(-1).expand(W)
    return torch.full((W,), float(c), dtype=torch.float32, device=device)


def fused_flat_elastic_nag_update(theta, peer, v, g, coef, eta, mu, rows=None):
    """In place on CUDA ``[W, N]`` buffers:

        v     <- mu * v - eta * g
        theta <- theta - coef * (theta - peer) - eta * g + mu * v

    theta/peer/g share one storage type T (float32 or bfloat16); v is T or
    float32; coef is a scalar or [W], eta and mu scalars (0-d tensors on the
    same device, or python numbers). ``peer`` may be ``theta``. ``rows``
    (optional): an int32 device tensor of distinct row indices; only those
    rows are updated, the others are neither read nor written, and an empty
    list launches nothing. Returns (theta, v), the same tensors, updated."""
    global LAUNCHES
    _check_plane(theta, v, {"peer": peer, "g": g})
    if rows is not None:
        _check_rows(rows, theta)
        if rows.numel() == 0:
            return theta, v
    _launch_elastic(theta, peer, v, g, coef, eta, mu, rows)
    LAUNCHES += 1
    return theta, v


def fused_flat_nag_update(theta, v, g, eta, mu):
    """B2, in place on CUDA ``[W, N]`` buffers:

        v     <- mu * v - eta * g
        theta <- theta - eta * g + mu * v

    theta/g share float32 or bfloat16, v is theirs or float32; eta and mu
    are scalars (0-d tensors on the same device, or python numbers).
    Returns (theta, v), the same tensors, updated."""
    global NAG_LAUNCHES
    _check_plane(theta, v, {"g": g})
    W, n = theta.shape
    dev = theta.device
    sc = torch.stack([_scalar_col(eta, W, dev), _scalar_col(mu, W, dev)],
                     dim=1).contiguous()
    fn = _nag_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPE_CODE[theta.dtype], _DTYPE_CODE[v.dtype], theta.data_ptr(),
                 v.data_ptr(), g.data_ptr(), sc.data_ptr(), W, n, stream)
    if err != 0:
        raise RuntimeError(f"fused_flat_nag kernel launch failed: cudaError {err}")
    NAG_LAUNCHES += 1
    return theta, v


def fused_elastic_nag_update(theta, peer, v, g, coef_gate, *, eta, mu):
    """B3: B1's update on CUDA arrays of any (equal) shape, scalar
    ``coef_gate``, scalar eta/mu; returns NEW (theta', v') and never writes
    its inputs. theta/peer/g share float32 or bfloat16, v is theirs or
    float32. Runs B1's kernel once over ``[1, numel]`` copies of theta and v
    (peer and g are read through contiguous views)."""
    global ARRAY_LAUNCHES
    shapes = {t.shape for t in (theta, peer, v, g) if isinstance(t, torch.Tensor)}
    if len(shapes) != 1:
        raise ValueError(f"theta/peer/v/g must share one shape, got {sorted(map(tuple, shapes))}")
    if isinstance(coef_gate, torch.Tensor) and coef_gate.numel() != 1:
        raise ValueError(f"coef_gate must be a scalar, got shape {tuple(coef_gate.shape)}")
    n = theta.numel()
    t2 = theta.reshape(1, n).clone()
    v2 = v.reshape(1, n).clone()
    p2 = peer.contiguous().reshape(1, n)
    g2 = g.contiguous().reshape(1, n)
    _check_plane(t2, v2, {"peer": p2, "g": g2})
    _launch_elastic(t2, p2, v2, g2, coef_gate, eta, mu)
    ARRAY_LAUNCHES += 1
    return t2.reshape(theta.shape), v2.reshape(v.shape)
