"""State-space / recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM, sLSTM)
(port of ``repro.models.ssm``).

Both Mamba2's SSD and the mLSTM are instances of *gated linear attention*:

    S_t = g_t * S_{t-1} + k_t v_t^T        (per head; g_t in (0,1])
    y_t = q_t^T S_t

so one chunked core (:func:`gla_chunked`) serves both: intra-chunk terms by
masked matmuls, inter-chunk by a python loop over the chunk states (the
reference's ``lax.scan``). Decode is the O(1) recurrence (:func:`gla_step`).

The reference keeps q / k / v in their storage dtype and accumulates the
products in f32 (``preferred_element_type``); a torch product of two bf16
tensors rounds its output to bf16, so the port upcasts the operands before
each product (a bf16 product is exact in f32, so the sums are the
reference's). f64 stays f64. Where the reference rounds on purpose (the
chunk state cast to q's dtype before ``q S``) the port rounds the same way.

Decode (:func:`mamba2_decode`, :func:`mlstm_decode`, :func:`slstm_decode`)
writes the recurrent state and the conv buffer into the cache IN PLACE,
as MLA's decode writes its latent rows; the reference returns new arrays.
The recurrent caches are f32 whatever the serving dtype, as the
reference's are. There is no kernel on this path: the reference has no
Pallas kernel for it either.

Served tensor-parallel, the Mamba2 and mLSTM prefill, decode and caches
take ``tp``, the rank's :class:`~repro_torch.serving.tensor_parallel.Part`
(None: the whole block), and ``p`` holds the rank's slice
(``tensor_parallel.slice_leaf``): by heads, with the whole of what every
head reads (Mamba2's B and C with one group, the mLSTM's conv input). Their
norm runs over the whole inner row, its sum of squares summed over the
ranks (:meth:`Part.rmsnorm`), and the output projection's partial product
is summed by one all-reduce. The sLSTM runs whole on every rank: its
weights are small, and its gates mix every head.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig, SSMConfig, XLSTMConfig
from repro_torch.models.common import (dense_init, ones_init, rmsnorm, split_tree, upcast,
                                       upcast_dtype, zeros_init)
from repro_torch.obs import spans

PyTree = Any


# ---------------------------------------------------------------------------
# Chunked gated linear attention core
# ---------------------------------------------------------------------------

def gla_chunked(q, k, v, log_g, *, chunk: int = 256, initial_state=None):
    """q, k: [B, S, H, dk]; v: [B, S, H, dv]; log_g: [B, S, H] (<= 0).

    Returns (y [B, S, H, dv] in q's dtype, final_state [B, H, dk, dv] in
    f32). Its ops run inside the ``gla_chunked`` profiler range."""
    with spans.span("gla_chunked"):
        return _gla_chunked(q, k, v, log_g, chunk, initial_state)


def _gla_chunked(q, k, v, log_g, chunk, initial_state):
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    N = S // Q
    acc = upcast_dtype(q.dtype)

    qc = q.reshape(B, N, Q, H, dk)
    kc = k.reshape(B, N, Q, H, dk)
    vc = v.reshape(B, N, Q, H, dv)
    a = torch.cumsum(log_g.reshape(B, N, Q, H).to(acc), dim=2)      # inclusive cum log decay
    a_tot = a[:, :, -1]                                              # [B, N, H]

    # intra-chunk: coefficient exp(a_t - a_s) for s <= t. The exponent is
    # masked BEFORE exp: for s > t it is positive and exp would overflow to
    # inf, which the later where() turns into NaN gradients.
    att = torch.einsum("bnqhk,bnshk->bnhqs", qc.to(acc), kc.to(acc))
    a_t = a.movedim(3, 2)                                            # [B, N, H, Q]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    zero = torch.zeros((), dtype=acc, device=q.device)
    diff = torch.where(mask, a_t[..., :, None] - a_t[..., None, :], zero)
    att = torch.where(mask, att * torch.exp(diff), zero)
    y_intra = torch.einsum("bnhqs,bnshv->bnqhv", att, vc.to(acc))

    # chunk state contribution: sum_s exp(a_tot - a_s) k_s v_s^T
    k_scaled = kc * torch.exp(a_tot[:, :, None] - a)[..., None].to(kc.dtype)
    chunk_states = torch.einsum("bnshk,bnshv->bnhkv", k_scaled.to(acc), vc.to(acc))
    q_scaled = qc * torch.exp(a)[..., None].to(qc.dtype)              # [B, N, Q, H, dk]

    # y_inter inside the loop, so the per-chunk entering states are never
    # stacked (the reference's scan does the same)
    state = (torch.zeros((B, H, dk, dv), dtype=acc, device=q.device) if initial_state is None
             else initial_state.to(acc))
    y_inter = []
    for n in range(N):
        y_inter.append(torch.einsum("bqhk,bhkv->bqhv", q_scaled[:, n].to(acc),
                                    state.to(q.dtype).to(acc)))
        state = torch.exp(a_tot[:, n])[..., None, None] * state + chunk_states[:, n]
    y = (y_intra + torch.stack(y_inter, dim=1)).reshape(B, S, H, dv)
    return y.to(q.dtype), state


def gla_step(q, k, v, log_g, state):
    """One-token recurrence. q, k: [B, H, dk]; v: [B, H, dv]; log_g: [B, H];
    state: [B, H, dk, dv]. Returns (y [B, H, dv], new_state in state's
    dtype)."""
    acc = upcast_dtype(state.dtype)
    g = torch.exp(log_g.to(acc))[..., None, None]
    new_state = g * state.to(acc) + torch.einsum("bhk,bhv->bhkv", k.to(acc), v.to(acc))
    y = torch.einsum("bhk,bhkv->bhv", q.to(acc), new_state)
    return y.to(q.dtype), new_state.to(state.dtype)


# ---------------------------------------------------------------------------
# Causal depthwise conv (width cw), with decode buffer
# ---------------------------------------------------------------------------

def causal_conv(w, x):
    """w: [cw, C]; x: [B, S, C] -> silu of the causal depthwise conv, [B, S, C]."""
    cw, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i][None, None] for i in range(cw))
    return F.silu(out)


def causal_conv_step(w, buf, x1):
    """buf: [B, cw-1, C] previous inputs; x1: [B, C]. Returns (y [B, C], the
    new buffer). The window takes the wider of buf's and x1's dtypes, as the
    reference's concatenate does (an f32 buffer makes a bf16 step f32)."""
    cw = w.shape[0]
    dt = torch.promote_types(buf.dtype, x1.dtype)
    window = torch.cat([buf.to(dt), x1[:, None].to(dt)], dim=1)     # [B, cw, C]
    y = torch.einsum("bwc,wc->bc", window, w.to(torch.promote_types(dt, w.dtype)))
    return F.silu(y), (window[:, 1:] if cw > 1 else buf)


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def _mamba2_dims(cfg: ModelConfig, tp=None):
    """(ssm config, inner width, heads): the model's, or with ``tp`` the
    rank's heads (one group, so B and C are every head's)."""
    s = cfg.ssm
    nheads = s.expand * cfg.d_model // s.head_dim // (1 if tp is None else tp.model)
    return s, nheads * s.head_dim, nheads


def _norm(w, x, eps: float, tp):
    """The block's RMS norm over its whole inner row: with ``tp`` the
    rank's channels, the sum of squares summed over the ranks."""
    return rmsnorm(w, x, eps) if tp is None else tp.rmsnorm(w, x, eps)


def _summed(y, tp):
    """An output projection's product, summed over the ranks under ``tp``."""
    return y if tp is None else tp.all_reduce(y)


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32
                ) -> Tuple[PyTree, PyTree]:
    s, d_inner, nheads = _mamba2_dims(cfg)
    d, dev = cfg.d_model, gen.device
    conv_ch = d_inner + 2 * s.ngroups * s.state_dim
    proj_out = 2 * d_inner + 2 * s.ngroups * s.state_dim + nheads
    tree = {
        "in_proj": dense_init(gen, (d, proj_out), ("embed", "inner"), dtype),
        "conv_w": dense_init(gen, (s.conv_dim, conv_ch), (None, "inner"), dtype,
                             fan_in=s.conv_dim),
        "a_log": (torch.log(torch.linspace(1.0, 16.0, nheads, device=dev)).to(dtype), (None,)),
        "dt_bias": zeros_init((nheads,), (None,), dtype, dev),
        "d_skip": ones_init((nheads,), (None,), dtype, dev),
        "norm": ones_init((d_inner,), ("act_embed",), dtype, dev),
        "out_proj": dense_init(gen, (d_inner, d), ("inner", "embed"), dtype, fan_in=d_inner),
    }
    return split_tree(tree)


def _mamba2_split(p, x, s: SSMConfig, d_inner, nheads):
    proj = x @ p["in_proj"].to(x.dtype)
    z, xbc_dt = proj[..., :d_inner], proj[..., d_inner:]
    cut = d_inner + 2 * s.ngroups * s.state_dim
    return z, xbc_dt[..., :cut], xbc_dt[..., cut:]


def _mamba2_qkvg(p, xbc, dt_pre, s: SSMConfig, d_inner, nheads):
    gs = s.ngroups * s.state_dim
    xs, B_, C_ = xbc[..., :d_inner], xbc[..., d_inner:d_inner + gs], xbc[..., d_inner + gs:]
    shape = tuple(xs.shape[:-1])
    heads_per_group = nheads // s.ngroups
    v = xs.reshape(shape + (nheads, s.head_dim))
    k = torch.repeat_interleave(B_.reshape(shape + (s.ngroups, s.state_dim)), heads_per_group,
                                dim=-2)
    q = torch.repeat_interleave(C_.reshape(shape + (s.ngroups, s.state_dim)), heads_per_group,
                                dim=-2)
    dt = F.softplus(upcast(dt_pre) + upcast(p["dt_bias"]))
    A = -torch.exp(upcast(p["a_log"]))
    log_g = dt * A                                                   # [.., H]
    v_dt = upcast(v) * dt[..., None]
    return q, k, v_dt.to(v.dtype), log_g, v, dt


def _mamba2_mix(p, x, cfg: ModelConfig, chunk: int, tp=None):
    """The Mamba2 mixer over a sequence: (out [B, S, d], final state, the
    conv's input xbc)."""
    s, d_inner, nheads = _mamba2_dims(cfg, tp)
    z, xbc, dt_pre = _mamba2_split(p, x, s, d_inner, nheads)
    xbc_c = causal_conv(p["conv_w"].to(x.dtype), xbc)
    q, k, v_dt, log_g, v, dt = _mamba2_qkvg(p, xbc_c, dt_pre, s, d_inner, nheads)
    y, state = gla_chunked(q, k, v_dt, log_g, chunk=chunk)
    y = y + upcast(p["d_skip"])[None, None, :, None] * upcast(v)
    B, S = x.shape[:2]
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = _norm(p["norm"], y * F.silu(z), cfg.norm_eps, tp)
    return _summed(y @ p["out_proj"].to(x.dtype), tp), state, xbc


def mamba2_forward(p, x, cfg: ModelConfig):
    """x: [B, S, d] -> [B, S, d]."""
    return _mamba2_mix(p, x, cfg, cfg.ssm.chunk_size)[0]


def mamba2_prefill(p, x, cfg: ModelConfig, tp=None):
    """The forward over a prompt and the terminal cache: the GLA state and
    the conv's last cw - 1 inputs (f32)."""
    s = cfg.ssm
    y, state, xbc = _mamba2_mix(p, x, cfg, min(s.chunk_size, x.shape[1]), tp)
    return y, {"state": state, "conv": upcast(xbc[:, -(s.conv_dim - 1):, :])}


def mamba2_init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None, tp=None):
    s, d_inner, nheads = _mamba2_dims(cfg, tp)
    conv_ch = d_inner + 2 * s.ngroups * s.state_dim
    cache = {"state": torch.zeros((batch, nheads, s.state_dim, s.head_dim), dtype=dtype,
                                  device=device),
             "conv": torch.zeros((batch, s.conv_dim - 1, conv_ch), dtype=dtype, device=device)}
    axes = {"state": ("batch", "inner", None, None), "conv": ("batch", None, "inner")}
    return cache, axes


def _write(cache, new):
    """Write ``new``'s entries into the cache's tensors in place."""
    for name, t in new.items():
        cache[name].copy_(t)
    return cache


def mamba2_decode(p, x, cache, cfg: ModelConfig, tp=None):
    """x: [B, 1, d]. Returns (out [B, 1, d], cache) with the state and the
    conv buffer written in place."""
    s, d_inner, nheads = _mamba2_dims(cfg, tp)
    z, xbc, dt_pre = _mamba2_split(p, x[:, 0], s, d_inner, nheads)
    xbc, conv_new = causal_conv_step(p["conv_w"].to(x.dtype), cache["conv"], xbc)
    q, k, v_dt, log_g, v, dt = _mamba2_qkvg(p, xbc, dt_pre, s, d_inner, nheads)
    y, state_new = gla_step(q, k, v_dt, log_g, cache["state"])
    y = y + upcast(p["d_skip"])[None, :, None] * upcast(v)
    y = y.reshape(x.shape[0], d_inner).to(x.dtype)
    y = _norm(p["norm"], y * F.silu(z), cfg.norm_eps, tp)
    out = _summed(y @ p["out_proj"].to(x.dtype), tp)[:, None]
    return out, _write(cache, {"state": state_new, "conv": conv_new})


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM): matrix memory through the GLA core
# ---------------------------------------------------------------------------

def _xlstm_dims(cfg: ModelConfig, tp=None):
    """(xlstm config, inner width, heads, head width): with ``tp`` the
    rank's heads (the inner width and head width stay the model's)."""
    xl: XLSTMConfig = cfg.xlstm
    d_in = int(cfg.d_model * xl.proj_factor)
    H = cfg.num_heads
    return xl, d_in, H if tp is None else H // tp.model, d_in // H


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32
               ) -> Tuple[PyTree, PyTree]:
    x, d_in, H, dh = _xlstm_dims(cfg)
    d, dev = cfg.d_model, gen.device
    tree = {
        "up": dense_init(gen, (d, 2 * d_in), ("embed", "inner"), dtype),
        "conv_w": dense_init(gen, (x.conv_dim, d_in), (None, "inner"), dtype, fan_in=x.conv_dim),
        "wq": dense_init(gen, (d_in, H, dh), ("inner", "heads", None), dtype, fan_in=d_in),
        "wk": dense_init(gen, (d_in, H, dh), ("inner", "heads", None), dtype, fan_in=d_in),
        "wv": dense_init(gen, (d_in, H, dh), ("inner", "heads", None), dtype, fan_in=d_in),
        "w_if": dense_init(gen, (d_in, 2 * H), ("inner", None), dtype, fan_in=d_in),
        "f_bias": (3.0 * torch.ones((H,), dtype=dtype, device=dev), (None,)),   # long memory
        "norm": ones_init((d_in,), ("act_embed",), dtype, dev),
        "down": dense_init(gen, (d_in, d), ("inner", "embed"), dtype, fan_in=d_in),
    }
    return split_tree(tree)


def _heads(xc, w):
    """einsum('...c,chk->...hk') as one matmul."""
    c, h, k = w.shape
    return (xc @ w.to(xc.dtype).reshape(c, h * k)).unflatten(-1, (h, k))


def _mlstm_qkvg(p, xc, H, dh):
    q = _heads(xc, p["wq"]) * dh ** -0.5
    k = _heads(xc, p["wk"])
    v = _heads(xc, p["wv"])
    if_pre = xc @ p["w_if"].to(xc.dtype)
    i_pre, f_pre = if_pre[..., :H], if_pre[..., H:]
    i_gate = torch.sigmoid(upcast(i_pre))
    log_f = F.logsigmoid(upcast(f_pre) + upcast(p["f_bias"]))
    k = k * i_gate[..., None].to(k.dtype)                            # input gate folded into k
    # v with a ones column for the normaliser n_t
    v_aug = torch.cat([v, torch.ones(tuple(v.shape[:-1]) + (1,), dtype=v.dtype,
                                     device=v.device)], dim=-1)
    return q, k, v_aug, log_f


def _mlstm_out(y_aug):
    y, den = y_aug[..., :-1], y_aug[..., -1:]
    return y / torch.clamp(torch.abs(den), min=1.0)


def _mlstm_mix(p, x, cfg: ModelConfig, tp=None):
    xl, d_in, H, dh = _xlstm_dims(cfg, tp)
    up = x @ p["up"].to(x.dtype)
    xi, z = up[..., :d_in], up[..., d_in:]
    xc = causal_conv(p["conv_w"].to(x.dtype), xi)
    q, k, v_aug, log_f = _mlstm_qkvg(p, xc, H, dh)
    y_aug, state = gla_chunked(q, k, v_aug, log_f, chunk=min(256, x.shape[1]))
    y = _mlstm_out(upcast(y_aug))
    B, S = x.shape[:2]
    y = y.reshape(B, S, H * dh).to(x.dtype)
    y = _norm(p["norm"], y, cfg.norm_eps, tp) * F.silu(z)
    return _summed(y @ p["down"].to(x.dtype), tp), state, xi


def mlstm_forward(p, x, cfg: ModelConfig):
    return _mlstm_mix(p, x, cfg)[0]


def mlstm_prefill(p, x, cfg: ModelConfig, tp=None):
    y, state, xi = _mlstm_mix(p, x, cfg, tp)
    return y, {"state": state, "conv": upcast(xi[:, -(cfg.xlstm.conv_dim - 1):, :])}


def mlstm_init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None, tp=None):
    xl, d_in, H, dh = _xlstm_dims(cfg, tp)
    cache = {"state": torch.zeros((batch, H, dh, dh + 1), dtype=dtype, device=device),
             "conv": torch.zeros((batch, xl.conv_dim - 1, d_in), dtype=dtype, device=device)}
    axes = {"state": ("batch", "heads", None, None), "conv": ("batch", None, "inner")}
    return cache, axes


def mlstm_decode(p, x, cache, cfg: ModelConfig, tp=None):
    xl, d_in, H, dh = _xlstm_dims(cfg, tp)
    up = x[:, 0] @ p["up"].to(x.dtype)
    xi, z = up[..., :d_in], up[..., d_in:]
    xc, conv_new = causal_conv_step(p["conv_w"].to(x.dtype), cache["conv"], xi)
    q, k, v_aug, log_f = _mlstm_qkvg(p, xc, H, dh)
    y_aug, state_new = gla_step(q, k, v_aug, log_f, cache["state"])
    y = _mlstm_out(upcast(y_aug)).reshape(x.shape[0], H * dh).to(x.dtype)
    y = _norm(p["norm"], y, cfg.norm_eps, tp) * F.silu(z)
    out = _summed(y @ p["down"].to(x.dtype), tp)[:, None]
    return out, _write(cache, {"state": state_new, "conv": conv_new})


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): scalar memory, sequential loop, exp-gate stabiliser
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32
               ) -> Tuple[PyTree, PyTree]:
    x, d_in, H, dh = _xlstm_dims(cfg)
    d, dev = cfg.d_model, gen.device
    tree = {
        "up": dense_init(gen, (d, d_in), ("embed", "inner"), dtype),
        "w_gates": dense_init(gen, (d_in, 4 * d_in), ("inner", "inner"), dtype, fan_in=d_in),
        "r_gates": dense_init(gen, (H, dh, 4 * dh), ("heads", None, None), dtype,
                              fan_in=dh, scale=0.5),
        "g_bias": zeros_init((4 * d_in,), (None,), dtype, dev),
        "norm": ones_init((d_in,), ("act_embed",), dtype, dev),
        "down": dense_init(gen, (d_in, d), ("inner", "embed"), dtype, fan_in=d_in),
    }
    return split_tree(tree)


def _slstm_cell(p, xg, state, H, dh):
    """xg: [B, 4 d_in], the input's contribution; state: {c, n, h, m} of
    [B, d_in]. Returns the new state."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    B = h.shape[0]
    rec = torch.einsum("bhd,hde->bhe", h.reshape(B, H, dh),
                       p["r_gates"].to(h.dtype)).reshape(B, 4 * H * dh)
    pre = upcast(xg + rec + p["g_bias"].to(xg.dtype))
    z_pre, i_pre, f_pre, o_pre = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    log_i = i_pre
    log_f = F.logsigmoid(f_pre)                                      # sigmoid forget variant
    m_new = torch.maximum(log_f + m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None):
    d_in = _xlstm_dims(cfg)[1]
    cache = {k: torch.zeros((batch, d_in), dtype=dtype, device=device) for k in ("c", "n", "h")}
    cache["m"] = torch.full((batch, d_in), -1e30, dtype=dtype, device=device)
    axes = {k: ("batch", "inner") for k in ("c", "n", "h", "m")}
    return cache, axes


def _slstm_mix(p, x, cfg: ModelConfig):
    xl, d_in, H, dh = _xlstm_dims(cfg)
    B, S, _ = x.shape
    xi = x @ p["up"].to(x.dtype)
    xg = xi @ p["w_gates"].to(x.dtype)                               # [B, S, 4 d_in]
    state = slstm_init_cache(cfg, B, upcast_dtype(x.dtype), x.device)[0]
    hs = []
    with spans.span("slstm loop"):
        for t in range(S):                                           # the reference's scan
            state = _slstm_cell(p, xg[:, t], state, H, dh)
            hs.append(state["h"])
    y = torch.stack(hs, dim=1).to(x.dtype)                           # [B, S, d_in]
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return y @ p["down"].to(x.dtype), state


def slstm_forward(p, x, cfg: ModelConfig):
    return _slstm_mix(p, x, cfg)[0]


def slstm_prefill(p, x, cfg: ModelConfig):
    return _slstm_mix(p, x, cfg)


def slstm_decode(p, x, cache, cfg: ModelConfig):
    xl, d_in, H, dh = _xlstm_dims(cfg)
    xi = x[:, 0] @ p["up"].to(x.dtype)
    xg = xi @ p["w_gates"].to(x.dtype)
    st = _slstm_cell(p, xg, cache, H, dh)
    y = rmsnorm(p["norm"], st["h"].to(x.dtype), cfg.norm_eps)
    return (y @ p["down"].to(x.dtype))[:, None], _write(cache, st)
