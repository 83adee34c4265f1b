"""Attention: GQA with sliding window and logit softcap (port of
``repro.models.attention``; cross-attention and MLA come with a later
slice, see ROADMAP.md).

The core is :func:`chunked_attention`, the reference's signature over the
port's attention op: kernel B9 on a CUDA tensor, its plain version on a
CPU tensor. Decode writes the new K/V rows into the cache IN PLACE (the
reference donates the cache and returns an updated copy).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, dense_init, split_tree

PyTree = Any


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
    chunk: accepted for the reference's signature; B9 picks its own tiles.
    """
    del chunk
    if v.shape[-1] != q.shape[-1]:
        raise NotImplementedError(
            "values wider or narrower than the head dim (MLA) wait for the MLA "
            "port (ROADMAP.md, slice 7)")
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
