"""Block assembly (port of ``repro.models.blocks``), with the reference's
init / forward / prefill / decode / cache interface. Kinds:

  attn         self-attention (GQA or MLA) + FFN (dense or MoE)
  attn_cross   self-attention + cross-attention (conditioning) + FFN (MusicGen)
  mamba        Mamba2 SSD block
  mlstm/slstm  xLSTM blocks
  cross_blk    standalone gated cross-attention block (Llama-3.2-V insertions)

Prefill, decode and the caches take ``tp``: None on one device, else the
rank's :class:`~repro_torch.serving.tensor_parallel.Part` of a
tensor-parallel program. The blocks then run on the rank's slice of the
parameters: attention over the rank's heads (``tp.attn_cfg``), each
partial sum (self- and cross-attention, the FFN, the MoE layer, the
recurrent mixers' output projections) summed over the ranks where its group
is split, and the norms whole.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.common import init_rmsnorm, rmsnorm, split_tree, upcast
from repro_torch.models.mlp import ffn_forward, init_ffn_cfg

PyTree = Any


RECURRENT = ("mamba", "mlstm", "slstm")
_INIT = {"mamba": ssm.init_mamba2, "mlstm": ssm.init_mlstm, "slstm": ssm.init_slstm}
_FORWARD = {"mamba": ssm.mamba2_forward, "mlstm": ssm.mlstm_forward,
            "slstm": ssm.slstm_forward}
_PREFILL = {"mamba": ssm.mamba2_prefill, "mlstm": ssm.mlstm_prefill,
            "slstm": ssm.slstm_prefill}
_DECODE = {"mamba": ssm.mamba2_decode, "mlstm": ssm.mlstm_decode, "slstm": ssm.slstm_decode}
_CACHE = {"mamba": ssm.mamba2_init_cache, "mlstm": ssm.mlstm_init_cache,
          "slstm": ssm.slstm_init_cache}


ATTN = ("attn", "attn_cross")
KINDS = ATTN + RECURRENT + ("cross_blk",)


def _require_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, kind: str, cfg: ModelConfig, *, use_moe: bool = False,
               dtype=torch.float32) -> Tuple[PyTree, PyTree]:
    _require_kind(kind)
    dev = gen.device
    if kind in RECURRENT:
        p, a = _INIT[kind](gen, cfg, dtype)
        n, na = init_rmsnorm(cfg.d_model, dtype, dev)
        return {"ln": n, "mixer": p}, {"ln": na, "mixer": a}
    if kind == "cross_blk":
        kv_dim = cfg.vlm.image_embed_dim if cfg.vlm is not None else cfg.d_model
        return split_tree({
            "ln1": init_rmsnorm(cfg.d_model, dtype, dev),
            "xattn": attn.init_cross_attn(gen, cfg, kv_dim, dtype),
            "ln2": init_rmsnorm(cfg.d_model, dtype, dev),
            "ffn": init_ffn_cfg(gen, cfg, dtype),
            "ffn_gate": (torch.zeros((1,), dtype=dtype, device=dev), (None,)),
        })
    attn_init = attn.init_mla if cfg.mla is not None else attn.init_gqa
    tree = {
        "ln1": init_rmsnorm(cfg.d_model, dtype, dev),
        "attn": attn_init(gen, cfg, dtype),
        "ln2": init_rmsnorm(cfg.d_model, dtype, dev),
        "ffn": (moe_mod.init_moe(gen, cfg, dtype) if use_moe
                else init_ffn_cfg(gen, cfg, dtype)),
    }
    if cfg.post_norms:
        tree["post_ln1"] = init_rmsnorm(cfg.d_model, dtype, dev)
        tree["post_ln2"] = init_rmsnorm(cfg.d_model, dtype, dev)
    if kind == "attn_cross":
        tree["ln_x"] = init_rmsnorm(cfg.d_model, dtype, dev)
        tree["xattn"] = attn.init_cross_attn(gen, cfg, cfg.d_model, dtype)
    return split_tree(tree)


# ---------------------------------------------------------------------------
# forward (training, full sequence, no cache)
# ---------------------------------------------------------------------------

def _sum(tp, y, group: str):
    """``y``, summed over the ranks under ``tp`` where ``group`` ("heads",
    "ffn") is split over them."""
    return y if tp is None else tp.sum(y, group)


def _attn_cfg(cfg: ModelConfig, tp) -> ModelConfig:
    """The config attention reads: the rank's heads and kv heads under ``tp``."""
    return cfg if tp is None else tp.attn_cfg


def _ffn_apply(p_ffn, x, cfg: ModelConfig, use_moe: bool, tp=None):
    """(y, aux): the MoE FFN and its load-balance loss, or the dense FFN and
    an f32 zero."""
    if use_moe:
        return moe_mod.moe_forward(p_ffn, x, cfg, tp=tp)
    return (_sum(tp, ffn_forward(p_ffn, x, cfg.activation), "ffn"),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _ffn_half(p, x, cfg: ModelConfig, use_moe: bool, tp=None):
    """The block's second residual half: (x + post_ln2(ffn(ln2(x))), aux)."""
    y, aux = _ffn_apply(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, use_moe, tp)
    if cfg.post_norms:
        y = rmsnorm(p["post_ln2"], y, cfg.norm_eps)
    return x + y, aux


def _attn_residual(kind: str, p, x, y, cfg: ModelConfig, cond, tp=None):
    """x + post_ln1(y), then (``attn_cross``) + cross_attn(ln_x(x), cond)."""
    y = _sum(tp, y, "heads")
    if cfg.post_norms:
        y = rmsnorm(p["post_ln1"], y, cfg.norm_eps)
    x = x + y
    if kind == "attn_cross":
        x = x + _sum(tp, attn.cross_attn_forward(p["xattn"], rmsnorm(p["ln_x"], x, cfg.norm_eps),
                                                 cond, cfg), "heads")
    return x


def _cross_block(p, x, cfg: ModelConfig, cond, tp=None):
    """The standalone gated block: x + cross_attn(ln1(x), cond), then
    + tanh(ffn_gate) * ffn(ln2(x))."""
    x = x + _sum(tp, attn.cross_attn_forward(p["xattn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                                             cond, cfg), "heads")
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    g = torch.tanh(upcast(p["ffn_gate"]))[0].to(x.dtype)
    return x + g * _sum(tp, ffn_forward(p["ffn"], h, cfg.activation), "ffn")


def block_forward(kind: str, p, x, cfg: ModelConfig, *, use_moe: bool = False,
                  window=0, cond=None):
    """Returns (x, aux_loss)."""
    _require_kind(kind)
    if kind in RECURRENT:
        h = rmsnorm(p["ln"], x, cfg.norm_eps)
        return (x + _FORWARD[kind](p["mixer"], h, cfg),
                torch.zeros((), dtype=torch.float32, device=x.device))
    if kind == "cross_blk":
        return (_cross_block(p, x, cfg, cond),
                torch.zeros((), dtype=torch.float32, device=x.device))
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.mla is not None:
        y, _ = attn.mla_forward(p["attn"], h, cfg)
    else:
        y, _ = attn.gqa_forward(p["attn"], h, cfg, window=window)
    x = _attn_residual(kind, p, x, y, cfg, cond)
    return _ffn_half(p, x, cfg, use_moe)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_block_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     *, dtype=torch.float32, window: int = 0, device=None, tp=None):
    """Returns (cache, axes). window > 0 -> bounded ring buffer (sw decode).
    MLA caches the latent ``c_kv [B, size, r]`` and ``k_rope [B, size,
    rope_dim]``; GQA ``k``, ``v [B, size, Hkv, hd]``; the recurrent kinds
    their state and conv buffer (sLSTM: c, n, h, m), f32 whatever
    ``dtype``, as the reference's; ``cross_blk`` none (its keys come from
    ``cond`` at every step). Under ``tp`` the rank's heads (the sLSTM's
    whole state)."""
    _require_kind(kind)
    if kind in RECURRENT:
        return _CACHE[kind](cfg, batch, torch.float32, device, **_mixer_tp(kind, tp))
    if kind == "cross_blk":
        return {}, {}
    cfg = _attn_cfg(cfg, tp)
    size = min(window, max_len) if window else max_len
    if cfg.mla is not None:
        m = cfg.mla
        cache = {"c_kv": torch.zeros((batch, size, m.kv_lora_rank), dtype=dtype, device=device),
                 "k_rope": torch.zeros((batch, size, m.qk_rope_head_dim), dtype=dtype,
                                       device=device)}
        axes = {"c_kv": ("batch", "seq_kv", None), "k_rope": ("batch", "seq_kv", None)}
        return cache, axes
    hd, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    cache = {"k": torch.zeros((batch, size, hkv, hd), dtype=dtype, device=device),
             "v": torch.zeros((batch, size, hkv, hd), dtype=dtype, device=device)}
    axes = {"k": ("batch", "seq_kv", "kv_heads", None),
            "v": ("batch", "seq_kv", "kv_heads", None)}
    return cache, axes


# ---------------------------------------------------------------------------
# decode (one token, cache updated in place)
# ---------------------------------------------------------------------------

def _attn_decode(p_attn, h, cache, pos, cfg: ModelConfig, window: int, window_mask=0,
                 kv_start=None):
    """window (python int): 0 = full cache at max_len; >0 = ring buffer of
    that size (keys already roped at absolute positions; every live entry
    is within the window by construction). window_mask (python int): extra
    local-attention mask in full-cache mode (gemma2 local layers). kv_start
    (optional [B]): per-slot first valid cache row, full-cache mode only.
    Both modes write the new K/V row in place and attend through B9. MLA
    (full-cache mode only) writes its latent row and attends over
    [c_kv ; k_rope]."""
    if cfg.mla is not None:
        if window:
            raise ValueError("MLA decodes over the full cache: ring-buffer window mode "
                             "has no MLA form")
        y, cc, ckr = attn.mla_decode(p_attn, h, cache["c_kv"], cache["k_rope"], pos, cfg,
                                     kv_start=kv_start)
        return y, {"c_kv": cc, "k_rope": ckr}
    if window:
        if kv_start is not None:
            raise ValueError(
                "per-slot kv_start is not supported in ring-buffer window mode "
                "(cache rows are recycled mod window, so an absolute lower bound "
                "has no fixed row)")
        size = cache["k"].shape[1]
        positions = pos.reshape(1)
        q, k, v = attn.gqa_qkv(p_attn, h, positions, cfg.rope_theta)
        slot = torch.remainder(positions, size).long()
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        valid = torch.clamp(pos + 1, max=size)
        o = attn.chunked_attention(q, cache["k"], cache["v"], causal=False, kv_len=valid,
                                   logit_softcap=cfg.attn_logit_softcap, chunk=min(1024, size))
        return attn.out_proj(o, p_attn["wo"]), cache
    y, ck, cv = attn.gqa_decode(p_attn, h, cache["k"], cache["v"], pos, cfg,
                                window=window_mask, kv_start=kv_start, chunk=2048)
    return y, {"k": ck, "v": cv}


def _mixer_tp(kind: str, tp) -> dict:
    """The recurrent mixer's ``tp`` keyword where it is split over the
    ranks (Mamba2, mLSTM); else none: a mixer M does not split, and the
    sLSTM, run whole on every rank."""
    return {"tp": tp} if tp is not None and tp.lay.mixer and kind != "slstm" else {}


def block_decode(kind: str, p, x, cache, pos, cfg: ModelConfig, *, use_moe: bool = False,
                 window: int = 0, window_mask=0, cond=None, kv_start=None, tp=None):
    """x: [B, 1, d]. Returns (x, cache) with the cache written in place.
    kv_start (optional [B]): per-slot first valid cache row, threaded into
    the attention mask (continuous batching); the recurrent caches isolate
    a slot by their zero reset instead."""
    _require_kind(kind)
    if kind in RECURRENT:
        y, cache = _DECODE[kind](p["mixer"], rmsnorm(p["ln"], x, cfg.norm_eps), cache, cfg,
                                 **_mixer_tp(kind, tp))
        return x + y, cache
    if kind == "cross_blk":
        return _cross_block(p, x, cfg, cond, tp), cache
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, new_cache = _attn_decode(p["attn"], h, cache, pos, _attn_cfg(cfg, tp), window,
                                window_mask, kv_start=kv_start)
    x = _attn_residual(kind, p, x, y, cfg, cond, tp)
    return _ffn_half(p, x, cfg, use_moe, tp)[0], new_cache


# ---------------------------------------------------------------------------
# prefill (full sequence, returns a cache padded to max_len rows)
# ---------------------------------------------------------------------------

def block_prefill(kind: str, p, x, cfg: ModelConfig, *, use_moe: bool = False,
                  window=0, cond=None, cache_dtype=torch.float32, max_len: int = 0, tp=None):
    """Returns (x, cache) covering positions [0, S), zero-padded to max_len
    rows; the cache entries (K/V, or MLA's c_kv / k_rope) are cast to
    ``cache_dtype`` as the reference's are. The recurrent kinds run their
    forward and return the terminal state (f32, no position axis)."""
    _require_kind(kind)
    if kind in RECURRENT:
        y, cache = _PREFILL[kind](p["mixer"], rmsnorm(p["ln"], x, cfg.norm_eps), cfg,
                                  **_mixer_tp(kind, tp))
        return x + y, cache
    if kind == "cross_blk":
        return _cross_block(p, x, cfg, cond, tp), {}
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    acfg = _attn_cfg(cfg, tp)
    if cfg.mla is not None:
        y, (c_kv, k_rope) = attn.mla_forward(p["attn"], h, acfg)
        entries = (("c_kv", c_kv), ("k_rope", k_rope))
    else:
        y, (k, v) = attn.gqa_forward(p["attn"], h, acfg, window=window)
        entries = (("k", k), ("v", v))
    B, S = x.shape[:2]
    rows = max(max_len, S)
    cache = {}
    for name, t in entries:
        buf = torch.zeros((B, rows) + tuple(t.shape[2:]), dtype=cache_dtype, device=x.device)
        buf[:, :S] = t
        cache[name] = buf
    x = _attn_residual(kind, p, x, y, cfg, cond, tp)
    return _ffn_half(p, x, cfg, use_moe, tp)[0], cache
