"""Attention: GQA with sliding window and logit softcap (port of
``repro.models.attention``; cross-attention and MLA come with a later
slice, see ROADMAP.md).

The core is :func:`chunked_attention`, the reference's signature over the
port's attention op: a call that needs a gradient runs
:func:`online_softmax_attention` (the reference's differentiable chunk
loop; kernel B9 is forward-only, in both packages), any other call kernel
B9 on a CUDA tensor and its plain version on a CPU tensor. Decode writes
the new K/V rows into the cache IN PLACE (the reference donates the cache
and returns an updated copy).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, dense_init, split_tree, upcast

PyTree = Any

NEG_INF = -1e30


def online_softmax_attention(q, k, v, *, causal: bool = True, window: int = 0,
                             logit_softcap: float = 0.0, q_offset=0,
                             kv_len: Optional[torch.Tensor] = None,
                             kv_start: Optional[torch.Tensor] = None, chunk: int = 1024):
    """The reference's ``chunked_attention`` body as a differentiable torch
    function: an online softmax over ``chunk``-key blocks in f32 (f64 stays
    f64), the keys zero-padded to whole chunks and masked, with its causal,
    window, ``kv_len`` and ``kv_start`` masks (the finite -1e30) and logit
    softcap. The training path of :func:`chunked_attention`.

    q: [B, Sq, H, hd]; k, v: [B, Skv, Hkv, hd | dv] with H % Hkv == 0.
    Autograd keeps each chunk's scores for the backward: the reference's
    ``jax.checkpoint`` per chunk has no counterpart under ``torch.func``
    transforms (ROADMAP.md §C)."""
    with torch.profiler.record_function("online_softmax_attention"):
        return _online_softmax(q, k, v, causal, window, logit_softcap, q_offset, kv_len,
                               kv_start, chunk)


def _online_softmax(q, k, v, causal, window, logit_softcap, q_offset, kv_len, kv_start,
                    chunk):
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = H // Hkv
    dev = q.device
    qf = upcast(q).reshape(B, Sq, Hkv, G, hd)
    acc_dt = qf.dtype
    scale = hd ** -0.5
    q_pos = q_offset + torch.arange(Sq, device=dev)
    nchunks = max(1, (Skv + chunk - 1) // chunk)
    pad = nchunks * chunk - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=acc_dt, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=acc_dt, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, dv), dtype=acc_dt, device=dev)
    for c in range(nchunks):
        kb = upcast(k[:, c * chunk:(c + 1) * chunk])
        vb = upcast(v[:, c * chunk:(c + 1) * chunk])
        kv_pos = c * chunk + torch.arange(chunk, device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb) * scale
        if logit_softcap:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        mask = kv_pos[None, :] < (Skv if kv_len is None else kv_len)
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window > 0:
            mask = mask & ((q_pos[:, None] - kv_pos[None, :]) < window)
        if kv_start is None:
            mask = mask[None, None, None]                      # [1, 1, 1, Sq, c]
        else:
            ks = torch.as_tensor(kv_start, device=dev).reshape(B, 1, 1)
            mask = (mask[None] & (kv_pos[None, None, :] >= ks))[:, None, None]
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.movedim(3, 1).reshape(B, Sq, H, dv).to(q.dtype)


def wants_grad(*ts) -> bool:
    """True when a gradient may flow through ``ts``: grad mode on and a
    tensor that requires grad, or a tensor wrapped by a ``torch.func``
    transform (the engines' ``vmap(grad_and_value(...))``), whose storage a
    kernel cannot read."""
    if any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in ts):
        return True
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def chunked_attention(q, k, v, *, causal: bool = True, window=0, logit_softcap: float = 0.0,
                      q_offset=0, kv_len: Optional[torch.Tensor] = None,
                      kv_start: Optional[torch.Tensor] = None, chunk: int = 1024):
    """Online-softmax attention.

    q: [B, Sq, H, hd]; k, v: [B, Skv, Hkv, hd] with H % Hkv == 0.
    window: 0 = full; >0 = attend to keys with q_pos - k_pos in [0, window)
            (a python int: the port's layer loop is python).
    kv_len: optional count of valid cache entries (int or device scalar).
    kv_start: optional [B] first valid cache position per batch row, the
              continuous-batching slot boundary (repro_torch.serve).
    q_offset: absolute position of q[0] (int or device scalar).
    chunk: the key block of the training path, min(chunk, Skv); B9 picks
    its own tiles.

    A call that needs a gradient (:func:`wants_grad`) runs
    :func:`online_softmax_attention` on either device (B9 is forward-only,
    as the reference's Pallas kernel is); every other call runs
    :func:`repro_torch.kernels.ops.attention`: B9 on a CUDA tensor, its
    plain version on a CPU tensor.
    """
    if v.shape[-1] != q.shape[-1]:
        raise NotImplementedError(
            "values wider or narrower than the head dim (MLA) wait for the MLA "
            "port (ROADMAP.md, slice 7)")
    if wants_grad(q, k, v):
        return online_softmax_attention(q, k, v, causal=causal, window=int(window),
                                        logit_softcap=logit_softcap, q_offset=q_offset,
                                        kv_len=kv_len, kv_start=kv_start,
                                        chunk=min(chunk, k.shape[1]))
    return ops.attention(q, k, v, causal=causal, window=int(window), softcap=logit_softcap,
                         q_offset=q_offset, kv_len=kv_len, kv_start=kv_start)


# ---------------------------------------------------------------------------
# GQA self-attention module
# ---------------------------------------------------------------------------

def init_gqa(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> Tuple[PyTree, PyTree]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    return split_tree({
        "wq": dense_init(gen, (d, H, hd), ("embed", "heads", None), dtype),
        "wk": dense_init(gen, (d, Hkv, hd), ("embed", "kv_heads", None), dtype),
        "wv": dense_init(gen, (d, Hkv, hd), ("embed", "kv_heads", None), dtype),
        "wo": dense_init(gen, (H, hd, d), ("heads", None, "embed"), dtype, fan_in=H * hd),
    })


def in_proj(x, w):
    """einsum('bsd,dhk->bshk') as one matmul."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def out_proj(o, wo):
    """einsum('bshk,hkd->bsd') as one matmul."""
    h, k, d = wo.shape
    return o.flatten(-2) @ wo.to(o.dtype).reshape(h * k, d)


def gqa_qkv(p, x, positions, theta):
    q = apply_rope(in_proj(x, p["wq"]), positions, theta)
    k = apply_rope(in_proj(x, p["wk"]), positions, theta)
    return q, k, in_proj(x, p["wv"])


def gqa_forward(p, x, cfg: ModelConfig, *, window=0, positions=None, chunk: int = 1024):
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device) if positions is None else positions
    q, k, v = gqa_qkv(p, x, positions, cfg.rope_theta)
    o = chunked_attention(q, k, v, causal=True, window=window,
                          logit_softcap=cfg.attn_logit_softcap, chunk=min(chunk, S))
    return out_proj(o, p["wo"]), (k, v)


def gqa_decode(p, x, cache_k, cache_v, pos, cfg: ModelConfig, *, window=0,
               kv_start=None, chunk: int = 1024):
    """x: [B, 1, d]; cache_[kv]: [B, Smax, Hkv, hd]; pos: int32 device
    scalar, the next index. kv_start: optional [B] per-slot first valid cache
    row (see :func:`chunked_attention`). Writes k, v at row ``pos`` of the
    caches in place and returns (out, cache_k, cache_v)."""
    positions = pos.reshape(1)
    q, k, v = gqa_qkv(p, x, positions, cfg.rope_theta)
    idx = positions.long()
    cache_k.index_copy_(1, idx, k.to(cache_k.dtype))
    cache_v.index_copy_(1, idx, v.to(cache_v.dtype))
    o = chunked_attention(q, cache_k, cache_v, causal=True, window=window,
                          logit_softcap=cfg.attn_logit_softcap,
                          q_offset=pos, kv_len=pos + 1, kv_start=kv_start, chunk=chunk)
    return out_proj(o, p["wo"]), cache_k, cache_v
