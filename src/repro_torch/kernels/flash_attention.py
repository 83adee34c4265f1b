"""Kernel B9 on Hopper: blockwise online-softmax (flash) attention.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::_kernel``
(wrapper ``flash_attention``). The CUDA C++ source is
``csrc/flash_attention.cu``: one block per (batch row, kv head, 8 query rows
of the heads that share it), its warps splitting the visible keys into
32-key tiles and merging their online-softmax states at the end; causal,
``q_offset``, sliding window, logit softcap, GQA, a ``kv_len`` and the
per-row ``kv_start`` bound of continuous batching.

This wrapper takes CUDA tensors only and raises on anything else; callers
reach it through :mod:`repro_torch.kernels.ops`, which sends CPU tensors to
the plain version :func:`repro_torch.kernels.ref.attention`. ``LAUNCHES``
counts launches of the kernel (and nothing else).
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
        f = build.load("flash_attention").repro_flash_attention
        f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6
                      + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                         ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p])
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def _scalar(x, name, dev):
    """A python int -> (x, None); a one-element integer tensor on ``dev`` ->
    (0, int32 0-d tensor) whose pointer the kernel reads."""
    if isinstance(x, torch.Tensor):
        if x.device != dev or x.numel() != 1 or x.dtype.is_floating_point:
            raise ValueError(f"{name} must be a python int or a one-element integer "
                             f"tensor on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        return 0, x.reshape(()).to(torch.int32)
    return int(x), None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset=0, kv_len=None, kv_start=None):
    """Attention of CUDA ``q [B, Sq, H, hd]`` over ``k, v [B, Skv, Hkv, hd]``
    (BSHD, any strides with the head dim contiguous and 16-byte aligned
    rows); returns a new BSHD tensor in q's dtype.

    ``q_offset`` and ``kv_len`` are python ints or one-element integer
    tensors on the card (read there by the kernel: no host sync);
    ``kv_start`` is None or a ``[B]`` integer tensor on the card. ``window``
    is a python int (0 = none), ``softcap`` a python float (0 = none)."""
    global LAUNCHES
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got "
                             f"{getattr(t, 'device', type(t))}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d BSHD, got shape {tuple(t.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is {q.dtype} on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q, k, v must be float32 or bfloat16, got {q.dtype}")
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if v.shape[-1] != hd:
        raise ValueError(f"values of width {v.shape[-1]} != head dim {hd} (MLA's "
                         "latent values are not supported by B9)")
    if k.shape != (B, Skv, Hkv, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"[B, Skv, Hkv, hd] with B={B}, hd={hd}")
    if Hkv == 0 or H % Hkv != 0:
        raise ValueError(f"heads {H} must be a multiple of kv heads {Hkv}")
    if hd % 8 != 0 or not 8 <= hd <= 256:
        raise ValueError(f"head dim must be a multiple of 8 in [8, 256], got {hd}")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"window must be a python int >= 0, got {window!r}")
    dev = q.device
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev)
    size = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                (t.stride(i) * size) % 16 for i in range(3)):
            raise ValueError(f"{name} needs a contiguous head dim and 16-byte aligned "
                             f"rows, got strides {t.stride()}")
    qo, qo_t = _scalar(q_offset, "q_offset", dev)
    kl, kl_t = _scalar(Skv if kv_len is None else kv_len, "kv_len", dev)
    ks_t = None
    if kv_start is not None:
        if (not isinstance(kv_start, torch.Tensor) or kv_start.device != dev
                or kv_start.numel() != B or kv_start.dtype.is_floating_point):
            raise ValueError(f"kv_start must be an integer [B={B}] tensor on {dev}")
        ks_t = kv_start.reshape(B).to(torch.int32).contiguous()
    strides = (ctypes.c_int64 * 12)(*(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), B, Sq, Skv, H, Hkv, hd, strides, int(bool(causal)),
                 window, float(softcap), qo, ptr(qo_t), kl, ptr(kl_t), ptr(ks_t), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
