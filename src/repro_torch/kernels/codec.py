"""Kernels B4-B7 on Hopper: the gossip-compression codecs (q8 and top-k) on
the flat plane.

Replace the Pallas TPU kernels of ``repro/kernels/codec.py``
(``_q8_encode_kernel``, ``_q8_decode_kernel``, ``_topk_encode_kernel``,
``_topk_decode_kernel``). The CUDA C++ source is ``csrc/codec.cu``; its
header says what bounds each kernel and how each matches its plain version
in :mod:`repro_torch.kernels.ref` bit for bit.

These wrappers take CUDA tensors only and raise on anything else; callers
reach them through :mod:`repro_torch.kernels.ops`, which sends CPU tensors
to the plain versions. ``LAUNCHES[name]`` counts launches of each kernel
(and nothing else).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import as_u32

LAUNCHES = {"q8_encode": 0, "q8_decode": 0, "topk_encode": 0, "topk_decode": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int64
_ARGTYPES = {
    "q8_encode": [_P, _P, _P, _P, _I, _I, _I, _P],
    "q8_decode": [_P, _P, _P, _I, _I, _I, _I, _P],
    "topk_encode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "topk_decode": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
}
_FNS = {}


def _fn(name: str):
    f = _FNS.get(name)
    if f is None:
        from repro_torch.kernels import build
        f = getattr(build.load("codec"), f"repro_{name}")
        f.argtypes = _ARGTYPES[name]
        f.restype = ctypes.c_int
        _FNS[name] = f
    return f


# Signatures that passed the checks with no conversion: (kernel, its static
# arguments, and the shape, strides, dtype and device of each tensor). A
# call with a signature seen before skips the checks, as B9's wrapper does:
# at ~0.04 ms of device work a call, the checks would be most of its time.
_CHECKED = set()
_MAX_CHECKED = 256


def _signature(name: str, statics, *ts):
    try:
        return (name, statics) + tuple((t.shape, t.stride(), t.dtype, t.device) for t in ts)
    except (AttributeError, TypeError):
        return None


def _remember(key) -> None:
    if key is None:
        return
    if len(_CHECKED) >= _MAX_CHECKED:
        _CHECKED.clear()
    _CHECKED.add(key)


def _check(name: str, t, dtype=None, shape=None, device=None) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _f32_rows(name: str, buf) -> torch.Tensor:
    _check(name, buf)
    if buf.dim() != 2 or not buf.is_floating_point() or 0 in buf.shape:
        raise ValueError(f"{name} must be a non-empty [W, N] float tensor, got "
                         f"{tuple(buf.shape)} {buf.dtype}")
    return buf if buf.dtype == torch.float32 else buf.to(torch.float32)


def _launch(name: str, device, *args) -> None:
    # the raw stream handle, and no device context unless the tensors are on
    # another card than the current one
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        err = _fn(name)(*args, stream)
    else:
        with torch.cuda.device(device):
            err = _fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _nb(n: int, block: int) -> int:
    return max(1, -(-n // block))


def _check_block(block: int) -> None:
    if block <= 0 or block % 128:
        raise ValueError(f"block must be a positive multiple of 128, got {block}")


def _check_k(k: int, block: int) -> None:
    if not 0 < k <= block:
        raise ValueError(f"k must be in [1, block], got {k}")


def q8_encode(buf, seeds, *, block: int):
    """B4. buf: CUDA [W, N] float bucket; seeds: [W] per-row seeds (uint32
    values). Returns (values int8 [W, nb*block], scales f32 [W, nb])."""
    key = _signature("q8_encode", block, buf, seeds)
    if key in _CHECKED:
        x, sd = buf, seeds
    else:
        _check_block(block)
        x = _f32_rows("buf", buf)
        sd = seeds if isinstance(seeds, torch.Tensor) and seeds.dtype == torch.int64 \
            else as_u32(seeds).to(x.device)
        _check("seeds", sd, torch.int64, (x.shape[0],), x.device)
        if x is buf and sd is seeds:
            _remember(key)
    W, n = x.shape
    nb = _nb(n, block)
    values = torch.empty((W, nb * block), dtype=torch.int8, device=x.device)
    scales = torch.empty((W, nb), dtype=torch.float32, device=x.device)
    _launch("q8_encode", x.device, x.data_ptr(), sd.data_ptr(), values.data_ptr(),
            scales.data_ptr(), W, n, block)
    return values, scales


def q8_decode(values, scales, n: int, *, block: int):
    """B5. (values int8 [W, nb*block], scales f32 [W, nb]) -> f32 [W, n]."""
    key = _signature("q8_decode", (n, block), values, scales)
    if key not in _CHECKED:
        _check_block(block)
        _check("scales", scales, torch.float32)
        W, nb = scales.shape
        _check("values", values, torch.int8, (W, nb * block), scales.device)
        if W == 0 or not 0 < n <= nb * block:
            raise ValueError(f"n={n} outside the wire's {nb * block} elements (W={W})")
        _remember(key)
    W, nb = scales.shape
    out = torch.empty((W, n), dtype=torch.float32, device=values.device)
    _launch("q8_decode", values.device, values.data_ptr(), scales.data_ptr(),
            out.data_ptr(), W, n, block, nb)
    return out


def topk_encode(buf, residual, *, k: int, block: int):
    """B6. buf: CUDA [W, N] float bucket; residual: f32 [W, N]. Returns
    (values f32 [W, nb*k], in-block indices int32 [W, nb*k], residual' f32
    [W, N])."""
    key = _signature("topk_encode", (k, block), buf, residual)
    if key in _CHECKED:
        x = buf
    else:
        _check_block(block)
        _check_k(k, block)
        x = _f32_rows("buf", buf)
        _check("residual", residual, torch.float32, x.shape, x.device)
        if x is buf:
            _remember(key)
    W, n = x.shape
    nb = _nb(n, block)
    vals = torch.empty((W, nb * k), dtype=torch.float32, device=x.device)
    idx = torch.empty((W, nb * k), dtype=torch.int32, device=x.device)
    res = torch.empty((W, n), dtype=torch.float32, device=x.device)
    _launch("topk_encode", x.device, x.data_ptr(), residual.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), res.data_ptr(), W, n, block, k)
    return vals, idx, res


def topk_decode(values, idx, n: int, *, k: int, block: int):
    """B7. (values f32 [W, nb*k], indices int32 [W, nb*k]) -> f32 [W, n]."""
    key = _signature("topk_decode", (n, k, block), values, idx)
    if key not in _CHECKED:
        _check_block(block)
        _check_k(k, block)
        _check("values", values, torch.float32)
        W, m = values.shape
        _check("idx", idx, torch.int32, (W, m), values.device)
        if W == 0 or m % k or not 0 < n <= m // k * block:
            raise ValueError(f"wire of {m} pairs does not hold n={n} at k={k}, block={block}")
        _remember(key)
    W, m = values.shape
    out = torch.empty((W, n), dtype=torch.float32, device=values.device)
    _launch("topk_decode", values.device, values.data_ptr(), idx.data_ptr(),
            out.data_ptr(), W, n, block, k, m // k)
    return out
