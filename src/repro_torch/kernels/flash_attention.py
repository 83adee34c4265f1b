"""Kernel B9 on Hopper: blockwise online-softmax (flash) attention.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::_kernel``
(wrapper ``flash_attention``): causal, ``q_offset``, sliding window, logit
softcap, GQA, a ``kv_len`` and the per-row ``kv_start`` bound of continuous
batching, and values narrower than the keys (MLA's 576-wide keys over its
512-wide latent values). The CUDA C++ source is ``csrc/flash_attention.cu``,
in four forms that :func:`_form` picks from host-known shapes: ``"wgmma"``
(bf16 prefill at head dims 64, 80, 128 and 256 with values as wide, on
Hopper's warpgroup MMA: K and V by TMA from a producer warpgroup, two
consumer warpgroups of 64 query rows), ``"mma"`` (bf16 prefill at MLA's
576-wide keys over their 512-wide prefix as values, ``mma.sync`` in a
kernel of its own), ``"split"`` (decode as split-KV in two launches, a
split per 32 cache rows, then a merge) and ``"simt"`` (f32 on the CUDA
cores: every f32 prefill, and bf16 prefill at the shapes no path runs,
MLA's with values of their own among them).

This wrapper takes CUDA tensors only and raises on anything else; callers
reach it through :mod:`repro_torch.kernels.ops`, which sends CPU tensors to
the plain version :func:`repro_torch.kernels.ref.attention`. ``LAUNCHES``
counts the calls that launched the kernel (one per call, whatever the
form), and ``FORM_LAUNCHES[form]`` the same calls by form.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

LAUNCHES = 0
FORM_LAUNCHES = {"wgmma": 0, "mma": 0, "split": 0, "simt": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FORM_CODE = {"simt": 0, "mma": 1, "split": 2, "wgmma": 3}
SPLIT_ROWS = 16                  # most query rows per kv head in the split form
SPLIT_KEYS = 32                  # cache rows per split
WGMMA_HEAD_DIMS = (64, 80, 128, 256)   # hd = dv of the wgmma form
MLA_DIMS = (576, 512)            # (hd, dv) of the mma form (MLA's kernel), v in k
MAX_HEAD_DIM = 576               # MLA: kv_lora_rank 512 + qk_rope_head_dim 64
_FN = None


def _form(dtype, B: int, Sq: int, H: int, Hkv: int, hd: int, Skv: int,
          dv: Optional[int] = None, v_in_k: bool = False) -> str:
    """The kernel form for these shapes, from what the host knows (never
    from ``kv_len``, a device scalar): ``"split"`` when at most 16 query
    rows share a kv head (decode), else ``"wgmma"`` for bf16 at a head dim
    of 64, 80, 128 or 256 with values as wide (``dv`` None or ``hd``),
    ``"mma"`` for bf16 at MLA's keys of 576 over values of 512 that are
    their prefix (``v_in_k``, :func:`_v_in_k`), else ``"simt"``. ``B`` and
    ``Skv`` do not change the choice; ``Skv`` sets the split form's number
    of splits."""
    if H // Hkv * Sq <= SPLIT_ROWS:
        return "split"
    if dtype == torch.bfloat16:
        if hd in WGMMA_HEAD_DIMS and dv in (None, hd):
            return "wgmma"
        if (hd, dv) == MLA_DIMS and v_in_k:
            return "mma"
    return "simt"


def _v_in_k(k, v) -> bool:
    """Whether ``v`` is a prefix view of ``k``'s last dim (the same storage
    pointer and batch, sequence and head strides), as the kernel tests it;
    MLA passes its values so, as ``kk[..., :512]``."""
    return v.data_ptr() == k.data_ptr() and v.stride()[:3] == k.stride()[:3]


class _Plan(ctypes.Structure):
    """The C side's ``struct Plan``: what every call with one signature of
    q, k and v passes."""
    _fields_ = [("form", ctypes.c_int32), ("dtype", ctypes.c_int32),
                ("B", ctypes.c_int64), ("Sq", ctypes.c_int64), ("Skv", ctypes.c_int64),
                ("H", ctypes.c_int64), ("Hkv", ctypes.c_int64), ("hd", ctypes.c_int64),
                ("dv", ctypes.c_int64), ("nsplit", ctypes.c_int64),
                ("strides", ctypes.c_int64 * 12)]


def _fn():
    global _FN
    if _FN is None:
        from repro_torch.kernels import build
        f = build.load("flash_attention").repro_flash_attention
        f.argtypes = ([ctypes.POINTER(_Plan)] + [ctypes.c_void_p] * 4
                      + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p])
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def _scalar(x, name, dev):
    """A python int -> (x, None); a one-element integer tensor on ``dev`` ->
    (0, an int32 tensor of that one element) whose pointer the kernel reads."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.int32 and x.device == dev and x.numel() == 1:
            return 0, x
        if x.device != dev or x.numel() != 1 or x.dtype.is_floating_point:
            raise ValueError(f"{name} must be a python int or a one-element integer "
                             f"tensor on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        return 0, x.reshape(()).to(torch.int32)
    return int(x), None


# (shapes, strides, dtypes, devices of q, k, v, whether v starts where k
# does) -> _plan(q, k, v), a pure function of that key, so calls with a
# signature seen before skip the checks
_PLANS = {}
_MAX_PLANS = 256


def _plan(q, k, v):
    """Check q, k, v once per signature (device, dtype, shapes, strides) and
    return (form, a pointer to the C plan every call with that signature
    passes, dims, the split form's scratch size in floats)."""
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
    Skv, Hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    if k.shape != (B, Skv, Hkv, hd) or v.shape != (B, Skv, Hkv, dv):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"[B, Skv, Hkv, hd] and [B, Skv, Hkv, dv] with B={B}, hd={hd}")
    if Hkv == 0 or H % Hkv != 0:
        raise ValueError(f"heads {H} must be a multiple of kv heads {Hkv}")
    if hd % 8 != 0 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 8 in [8, {MAX_HEAD_DIM}], got {hd}")
    if dv % 8 != 0 or not 8 <= dv <= hd:
        raise ValueError(f"value width must be a multiple of 8 in [8, hd={hd}], got {dv}")
    size = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any((t.stride(i) * size) % 16 for i in range(3)):
            raise ValueError(f"{name} needs a contiguous head dim and 16-byte aligned "
                             f"rows, got strides {t.stride()}")
    form = _form(q.dtype, B, Sq, H, Hkv, hd, Skv, dv, _v_in_k(k, v))
    nsplit = max(1, -(-Skv // SPLIT_KEYS)) if form == "split" else 0
    out_strides = (Sq * H * dv, H * dv, dv)   # of the new contiguous output
    strides = (ctypes.c_int64 * 12)(*(t.stride(i) for t in (q, k, v) for i in range(3)),
                                    *out_strides)
    c_plan = ctypes.pointer(_Plan(_FORM_CODE[form], _DTYPE_CODE[q.dtype], B, Sq, Skv, H, Hkv,
                                  hd, dv, nsplit, strides))
    part = B * Hkv * nsplit * SPLIT_ROWS * (dv + 2)   # the split form's (m, l, acc)
    return form, c_plan, (B, Sq, Skv, H, dv), part


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset=0, kv_len=None, kv_start=None):
    """Attention of CUDA ``q [B, Sq, H, hd]`` over ``k [B, Skv, Hkv, hd]``
    and ``v [B, Skv, Hkv, dv]``, ``dv <= hd`` (BSHD, any strides with the
    head dim contiguous and 16-byte aligned rows; ``v`` may be a prefix view
    of ``k``, whose values the kernel then reads from its K tiles); returns
    a new ``[B, Sq, H, dv]`` tensor in q's dtype.

    ``q_offset`` and ``kv_len`` are python ints or one-element integer
    tensors on the card (read there by the kernel: no host sync);
    ``kv_start`` is None or a ``[B]`` integer tensor on the card. ``window``
    is a python int (0 = none), ``softcap`` a python float (0 = none)."""
    global LAUNCHES
    try:
        key = (q.shape, q.stride(), k.shape, k.stride(), v.shape, v.stride(),
               q.dtype, k.dtype, v.dtype, q.device, k.device, v.device,
               v.data_ptr() == k.data_ptr())
        plan = _PLANS.get(key)
    except (AttributeError, TypeError):
        key, plan = None, None
    if plan is None:
        plan = _plan(q, k, v)
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        _PLANS[key] = plan
    form, c_plan, (B, Sq, Skv, H, dv), part_size = plan
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("q, k and v need 16-byte aligned rows")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"window must be a python int >= 0, got {window!r}")
    dev = q.device
    qo, qo_t = _scalar(q_offset, "q_offset", dev)
    kl, kl_t = _scalar(Skv if kv_len is None else kv_len, "kv_len", dev)
    ks_t = None
    if kv_start is not None:
        if (not isinstance(kv_start, torch.Tensor) or kv_start.device != dev
                or kv_start.numel() != B or kv_start.dtype.is_floating_point):
            raise ValueError(f"kv_start must be an integer [B={B}] tensor on {dev}")
        ks_t = kv_start if kv_start.dtype == torch.int32 and kv_start.is_contiguous() \
            else kv_start.reshape(B).to(torch.int32).contiguous()
    out = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=dev)
    part = torch.empty(part_size, dtype=torch.float32, device=dev) if part_size else None
    ptr = (lambda t: None if t is None else t.data_ptr())
    args = (c_plan, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            1 if causal else 0, window, float(softcap), qo, ptr(qo_t), kl, ptr(kl_t),
            ptr(ks_t), ptr(part))
    fn = _fn()
    # the raw stream handle: torch.cuda.current_stream() builds a Python
    # Stream object on every call, and a decode step makes one call a layer
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({form} form): "
                           f"cudaError {err}")
    LAUNCHES += 1
    FORM_LAUNCHES[form] += 1
    return out
