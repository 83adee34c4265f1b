"""Attention: GQA with sliding window and logit softcap, gated
cross-attention to a conditioning sequence, and MLA (port of
``repro.models.attention``).

The core is :func:`chunked_attention`, the reference's signature over the
port's attention op: a call that needs a gradient, and every call within
:func:`train_route` (which the training forward sets around each block,
rematerialised or not), runs :func:`online_softmax_attention` (the
reference's differentiable chunk loop, each key chunk checkpointed as
there; kernel B9 is forward-only, in both packages); any other call runs
kernel B9 on a CUDA tensor and its plain version on a CPU tensor. Decode
writes the new K/V rows into the cache IN PLACE (the reference donates the
cache and returns an updated copy).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Optional, Tuple

import torch

from repro_torch.common.config import MLAConfig, ModelConfig
from repro_torch.common.remat import checkpoint
from repro_torch.kernels import ops
from repro_torch.models.common import (apply_rope, dense_init, rmsnorm, split_tree, upcast,
                                       zeros_init)
from repro_torch.obs import spans

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
    Each chunk goes through :func:`repro_torch.common.remat.checkpoint`,
    as the reference's body goes through ``jax.checkpoint``: the backward
    keeps the running (m, l, acc) of each chunk and recomputes the chunk's
    scores, whatever ``cfg.remat`` says."""
    with spans.span("online_softmax_attention"):
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
        # the reference's jax.checkpoint(body): only the carries stay per
        # chunk, the chunk's scores are recomputed in the backward
        m, l, acc = checkpoint(
            _chunk_step, (c, chunk, Skv, causal, window, logit_softcap, scale),
            m, l, acc, qf, k[:, c * chunk:(c + 1) * chunk], v[:, c * chunk:(c + 1) * chunk],
            q_pos, kv_len, kv_start, label=None)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.movedim(3, 1).reshape(B, Sq, H, dv).to(q.dtype)


def _chunk_step(const, m, l, acc, qf, k, v, q_pos, kv_len, kv_start):
    """One key chunk of the online softmax: (m, l, acc) and the chunk's
    keys and values -> the new (m, l, acc). ``const`` holds the chunk's
    index and the python settings; ``q_pos``, ``kv_len`` and ``kv_start``
    are not differentiated."""
    c, chunk, Skv, causal, window, logit_softcap, scale = const
    B, dev = qf.shape[0], qf.device
    kb, vb = upcast(k), upcast(v)
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
    return m_new, l, acc


# the training route, decided by the training forward outside a
# checkpointed layer and carried into it: the layer's forward runs with
# grad mode off, and its recompute may run on autograd's device thread
_TRAIN_ROUTE = contextvars.ContextVar("train_route", default=False)


@contextlib.contextmanager
def train_route(on: bool = True):
    """Within it (when ``on``) :func:`chunked_attention` takes the
    differentiable online softmax whatever its inputs are, never B9."""
    token = _TRAIN_ROUTE.set(on)
    try:
        yield
    finally:
        _TRAIN_ROUTE.reset(token)


def wants_grad(*ts) -> bool:
    """True when a gradient may flow through ``ts``: grad mode on and a
    tensor that requires grad, or a tensor wrapped by a ``torch.func``
    transform (the engines' ``vmap(grad_and_value(...))``), whose storage a
    kernel cannot read; and always within :func:`train_route`."""
    if _TRAIN_ROUTE.get():
        return True
    if any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in ts):
        return True
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def chunked_attention(q, k, v, *, causal: bool = True, window=0, logit_softcap: float = 0.0,
                      q_offset=0, kv_len: Optional[torch.Tensor] = None,
                      kv_start: Optional[torch.Tensor] = None, chunk: int = 1024):
    """Online-softmax attention.

    q: [B, Sq, H, hd]; k: [B, Skv, Hkv, hd]; v: [B, Skv, Hkv, dv] with
    H % Hkv == 0 and dv <= hd (MLA's latent values are narrower than its
    keys; the output is [B, Sq, H, dv]).
    window: 0 = full; >0 = attend to keys with q_pos - k_pos in [0, window)
            (a python int: the port's layer loop is python).
    kv_len: optional count of valid cache entries (int or device scalar).
    kv_start: optional [B] first valid cache position per batch row, the
              continuous-batching slot boundary (repro_torch.serve).
    q_offset: absolute position of q[0] (int or device scalar).
    chunk: the key block of the training path, min(chunk, Skv); B9 picks
    its own tiles.

    A call that needs a gradient (:func:`wants_grad`, true within
    :func:`train_route`) runs :func:`online_softmax_attention` on either
    device (B9 is forward-only, as the reference's Pallas kernel is); every
    other call runs
    :func:`repro_torch.kernels.ops.attention`: B9 on a CUDA tensor, its
    plain version on a CPU tensor.
    """
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


# ---------------------------------------------------------------------------
# Cross-attention (VLM image layers / MusicGen conditioning)
# ---------------------------------------------------------------------------

def init_cross_attn(gen: torch.Generator, cfg: ModelConfig, kv_dim: int, dtype=torch.float32):
    """``wq [d, H, hd]``, ``wk`` / ``wv [kv_dim, Hkv, hd]``, ``wo [H, hd, d]``
    and the residual's ``gate [1]``, zero at init (Llama-3.2-V's tanh gate)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    return split_tree({
        "wq": dense_init(gen, (d, H, hd), ("embed", "heads", None), dtype),
        "wk": dense_init(gen, (kv_dim, Hkv, hd), ("embed", "kv_heads", None), dtype),
        "wv": dense_init(gen, (kv_dim, Hkv, hd), ("embed", "kv_heads", None), dtype),
        "wo": dense_init(gen, (H, hd, d), ("heads", None, "embed"), dtype, fan_in=H * hd),
        "gate": zeros_init((1,), (None,), dtype, gen.device),
    })


def cross_attn_forward(p, x, cond, cfg: ModelConfig, chunk: int = 1024):
    """x: [B, S, d]; cond: [B, T, kv_dim] (the stubbed modality embeddings,
    cast to x's dtype). ``tanh(gate) * wo(attention(q, k, v))``, non-causal
    over all T keys, which are recomputed from ``cond`` at every call (at
    every decode step too, as the reference does: there is no cross-KV
    cache)."""
    c = cond.to(x.dtype)
    q = in_proj(x, p["wq"])
    k = in_proj(c, p["wk"])
    v = in_proj(c, p["wv"])
    o = chunked_attention(q, k, v, causal=False, chunk=min(chunk, cond.shape[1]))
    y = out_proj(o, p["wo"])
    return torch.tanh(upcast(p["gate"]))[0].to(y.dtype) * y


# ---------------------------------------------------------------------------
# MLA: Multi-head Latent Attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32):
    m: MLAConfig = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return split_tree({
        "wq": dense_init(gen, (d, H, qk_dim), ("embed", "heads", None), dtype),
        "kv_down": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", None),
                              dtype),
        "k_up": dense_init(gen, (m.kv_lora_rank, H, m.qk_nope_head_dim), (None, "heads", None),
                           dtype, fan_in=m.kv_lora_rank),
        "v_up": dense_init(gen, (m.kv_lora_rank, H, m.v_head_dim), (None, "heads", None), dtype,
                           fan_in=m.kv_lora_rank),
        "wo": dense_init(gen, (H, m.v_head_dim, d), ("heads", None, "embed"), dtype,
                         fan_in=H * m.v_head_dim),
        "kv_norm": (torch.ones((m.kv_lora_rank,), dtype=dtype, device=gen.device),
                    ("act_embed",)),
    })


def _mla_qc(p, x, cfg: ModelConfig, positions):
    """Shared projections: q (nope + rope), the latent cache entries (c_kv,
    k_rope)."""
    m = cfg.mla
    q = in_proj(x, p["wq"])
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    down = x @ p["kv_down"].to(x.dtype)
    c_kv, k_rope = down[..., :m.kv_lora_rank], down[..., m.kv_lora_rank:]
    c_kv = rmsnorm(p["kv_norm"], c_kv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(p, q_nope, q_rope, kk, cfg: ModelConfig, **kw):
    """The absorbed attention, in the reference's order: ``q_lat`` absorbs
    ``k_up``, ``qq * scale_fix``, attention with head dim ``r + rope`` over
    the keys ``kk = [c_kv ; k_rope]`` ([B, S, 1, r + rope]) and the values
    ``c_kv`` as the view ``kk[..., :r]`` (B9 then reads them from its key
    tiles), then ``v_up`` and ``wo``."""
    m = cfg.mla
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, p["k_up"].to(q_nope.dtype))
    qq = torch.cat([q_lat, q_rope], dim=-1)
    scale_fix = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5 / (qq.shape[-1] ** -0.5)
    o_lat = chunked_attention(qq * scale_fix, kk, kk[..., :m.kv_lora_rank], causal=True,
                              **kw)                                         # [B, S, H, r]
    o = torch.einsum("bshr,rhv->bshv", o_lat, p["v_up"].to(o_lat.dtype))
    return out_proj(o, p["wo"])


def mla_forward(p, x, cfg: ModelConfig, *, positions=None, chunk: int = 1024):
    """Training / prefill with the ABSORBED formulation: scores and values
    are computed against the compact latent c_kv, so no [B, S, H, hd] K/V
    are ever materialised. Returns (out, (c_kv, k_rope))."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device) if positions is None else positions
    q_nope, q_rope, c_kv, k_rope = _mla_qc(p, x, cfg, positions)
    kk = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]                   # Hkv = 1
    out = _mla_attend(p, q_nope, q_rope, kk, cfg, chunk=min(chunk, S))
    return out, (c_kv, k_rope)


def mla_decode(p, x, cache_c, cache_kr, pos, cfg: ModelConfig, *, kv_start=None,
               chunk: int = 2048):
    """x: [B, 1, d]; cache_c: [B, Smax, r]; cache_kr: [B, Smax, rope_dim];
    pos: int32 device scalar, the next index. Writes c_kv and k_rope at row
    ``pos`` of the caches in place, builds the keys ``[c_kv ; k_rope]`` once
    and returns (out, cache_c, cache_kr)."""
    positions = pos.reshape(1)
    q_nope, q_rope, c_kv, k_rope = _mla_qc(p, x, cfg, positions)
    idx = positions.long()
    cache_c.index_copy_(1, idx, c_kv.to(cache_c.dtype))
    cache_kr.index_copy_(1, idx, k_rope.to(cache_kr.dtype))
    kk = torch.cat([cache_c, cache_kr], dim=-1)[:, :, None, :].to(x.dtype)
    out = _mla_attend(p, q_nope, q_rope, kk, cfg, q_offset=pos, kv_len=pos + 1,
                      kv_start=kv_start, chunk=chunk)
    return out, cache_c, cache_kr
