"""Mixture-of-Experts with capacity-based sort/scatter dispatch (port of
``repro.models.moe``).

Expert weights are stacked ``[E, d, f]``. Dispatch is the reference's
capacity scheme: tokens are routed top-k, sorted by expert, placed into an
``[E, C, d]`` buffer (overflow dropped), processed with batched matmuls and
combined back with the router weights. DeepSeek-style shared experts are a
plain always-on FFN added to the routed output; the load-balance auxiliary
loss is the reference's (Switch eq. 4).

Every integer the reference computes is computed the same way here, so the
routing ids, the capacity ``C``, ``dest`` and ``keep`` are bit-equal:

- ``jax.lax.top_k`` breaks ties toward the lower index; ``torch.topk``
  promises no order, so the top k is a stable descending sort, sliced.
- ``C`` is python arithmetic on host ints, as in the reference; at decode
  (8 tokens, DeepSeek's 64 experts top-6) it is 1 and tokens are dropped.
- The overflow row ``E * C`` takes every dropped token's write and is thrown
  away (``index_copy`` tolerates the duplicate index).
- Every op is out of place and every count a ``scatter_add`` of ones into
  an ``[E]`` zero vector, so the layer runs under the engines'
  ``vmap(grad_and_value(...))`` (in-place index ops refuse a batched
  source there, and ``bincount`` has no batching rule and reads its
  input's max back to the host).
- ``dispatch_shards = n > 1`` routes in n independent shards of C / n (a
  loop for the reference's ``vmap``); its ``dispatch_axes`` pin the shards
  to a mesh, which one card does not have.

The combine's ``.at[s_tok].add`` is ``index_add``: on the card it sums a
token's k rows in no fixed order, a float difference only (ROADMAP.md §C).
The expert products stay ``torch.matmul``, as the reference leaves them to
XLA outside any Pallas kernel.

Served tensor-parallel (``tp``, a rank's
:class:`~repro_torch.serving.tensor_parallel.Part`), every rank routes every
token with the whole router, as above, and fills only its own experts' rows
of the buffer (capacity C from the global T); its experts' products, its
slice of the shared experts and the combine give a partial ``[T, d]``
summed by one all-reduce a layer.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig, MoEConfig
from repro_torch.models.common import activation_fn, dense_init, split_tree
from repro_torch.models.mlp import ffn_forward, init_ffn
from repro_torch.obs import spans

PyTree = Any


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> Tuple[PyTree, PyTree]:
    m: MoEConfig = cfg.moe
    d = cfg.d_model
    dff = m.d_ff_expert or cfg.d_ff
    gated = cfg.activation in ("swiglu", "geglu")
    # drawn in the order of the reference's keys: router, w_gate, w_up,
    # w_down, shared
    tree = {"router": dense_init(gen, (d, m.num_experts), ("embed", "expert"), dtype)}
    if gated:
        tree["w_gate"] = dense_init(gen, (m.num_experts, d, dff), ("expert", "embed", "ffn"),
                                    dtype, fan_in=d)
    tree["w_up"] = dense_init(gen, (m.num_experts, d, dff), ("expert", "embed", "ffn"), dtype,
                              fan_in=d)
    tree["w_down"] = dense_init(gen, (m.num_experts, dff, d), ("expert", "ffn", "embed"), dtype,
                                fan_in=dff)
    if m.num_shared_experts:
        tree["shared"] = init_ffn(gen, d, m.num_shared_experts * dff, cfg.activation, dtype)
    return split_tree(tree)


def _route(logits, top_k: int):
    """softmax -> top-k -> renormalise (DeepSeek / Mixtral convention), in
    f32 whatever the logits' dtype, as the reference routes. The top k is a
    stable descending sort, so ties go to the lower expert id as
    ``jax.lax.top_k`` gives them."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[..., :top_k], ids[..., :top_k]
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    return probs, weights, ids


def _counts(ids, E: int):
    """``bincount(ids, minlength=E)`` for ids in [0, E), as a ``scatter_add``
    of ones: it batches under ``vmap`` and syncs nothing to the host."""
    return torch.zeros(E, dtype=torch.int64, device=ids.device).scatter_add(
        0, ids.long(), torch.ones_like(ids, dtype=torch.int64))


def _build_buffer(xt, ids, weights, E: int, k: int, C: int, lo: int = 0,
                  n: Optional[int] = None):
    """Route one token shard into its [E, C, d] buffer. Returns
    (buffer, dest, s_tok, s_w, keep); the combine happens after the expert
    compute. With ``n`` < E only experts [lo, lo + n) get rows: the buffer
    is [n, C, d], ``keep`` marks the slots that landed in it and every other
    slot goes to the overflow row."""
    T, d = xt.shape
    dev = xt.device
    flat_ids = ids.reshape(-1)                                        # [T*k]
    flat_tok = torch.arange(T, device=dev).repeat_interleave(k)       # source token of each slot
    flat_w = weights.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)                      # group by expert
    s_ids, s_tok, s_w = flat_ids[order], flat_tok[order], flat_w[order]
    # rank within expert = position - first position of that expert
    counts = _counts(flat_ids, E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * k, device=dev) - starts[s_ids]
    keep = rank < C                                                   # capacity drop
    dest = torch.where(keep, s_ids * C + rank, torch.full_like(rank, E * C))   # overflow row
    if n is not None and n != E:
        keep = keep & (s_ids >= lo) & (s_ids < lo + n)
        dest = torch.where(keep, dest - lo * C, torch.full_like(dest, n * C))
        E = n
    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=dev).index_copy(0, dest, xt[s_tok])
    return buf[:-1].reshape(E, C, d), dest, s_tok, s_w, keep


def _expert_ffn(h, p, cfg: ModelConfig):
    """h: [ds, E, C, d] -> [ds, E, C, d]: the reference's
    ``secd,edf->secf`` products as one batched matmul per expert weight,
    the shards folded into the rows."""
    ds, E, C, d = h.shape
    act = activation_fn(cfg.activation)
    he = h.transpose(0, 1).reshape(E, ds * C, d)                      # [E, ds*C, d]
    with spans.span("moe expert matmuls"):
        up = torch.bmm(he, p["w_up"].to(h.dtype))
        if "w_gate" in p:
            hidden = act(torch.bmm(he, p["w_gate"].to(h.dtype))) * up
        else:
            hidden = act(up)
        out = torch.bmm(hidden, p["w_down"].to(h.dtype))              # [E, ds*C, d]
    return out.reshape(E, ds, C, d).transpose(0, 1)


def _combine_one(out, dest, s_tok, s_w, keep, T: int):
    E, C, d = out.shape
    out_flat = torch.cat([out.reshape(E * C, d), out.new_zeros((1, d))], dim=0)
    gathered = out_flat[dest] * (s_w * keep).to(out.dtype)[:, None]   # [T*k, d]
    return out.new_zeros((T, d)).index_add(0, s_tok, gathered)


def capacity(cfg: ModelConfig, T: int, capacity_factor: float = 0.0) -> int:
    """The reference's expert capacity for T tokens: python arithmetic on
    host ints, ``max(int(T * k / (E * ds) * cf), 1)``."""
    m = cfg.moe
    cf = capacity_factor or m.capacity_factor
    ds = max(1, m.dispatch_shards)
    return max(int(T * m.top_k / (m.num_experts * ds) * cf), 1)


def moe_forward(p, x, cfg: ModelConfig, capacity_factor: float = 0.0, tp=None):
    """x: [B, S, d] -> (y, aux_loss).

    With ``moe.dispatch_shards = n > 1`` tokens are routed independently in
    n shards, each with capacity C / n (the reference's local dispatch).
    ``tp``: the rank's part of a tensor-parallel program; ``p`` then holds
    its experts (``w_up [E / M, d, f]``, or every expert's ffn slice where
    M does not divide E) and its slice of the shared experts.
    """
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = m.num_experts, m.top_k
    ds = max(1, m.dispatch_shards)
    assert T % ds == 0, (T, ds)
    C = capacity(cfg, T, capacity_factor)

    xt = x.reshape(T, d)
    with spans.span("moe route"):
        probs, weights, ids = _route(xt @ p["router"].to(x.dtype), k)   # [T,E],[T,k],[T,k]
    El = p["w_up"].shape[0]                                          # the rank's experts
    lo = 0 if El == E else tp.rank * El
    Tl = T // ds
    xs, ids_s, w_s = xt.reshape(ds, Tl, d), ids.reshape(ds, Tl, k), weights.reshape(ds, Tl, k)
    with spans.span("moe sort + scatter"):
        shards = [_build_buffer(xs[i], ids_s[i], w_s[i], E, k, C, lo, El) for i in range(ds)]
    h = torch.stack([s[0] for s in shards])                          # [ds, E, C, d]
    out = _expert_ffn(h, p, cfg)
    with spans.span("moe gather + combine"):
        y = torch.cat([_combine_one(out[i], *shards[i][1:], Tl) for i in range(ds)])
    y = y.to(x.dtype)

    if tp is not None:
        parts = [(y, tp.lay.experts or tp.lay.expert_ffn)]
        if m.num_shared_experts:
            parts.append((ffn_forward(p["shared"], xt, cfg.activation), tp.lay.shared_ffn))
        y = tp.combine(parts)
    elif m.num_shared_experts:
        y = y + ffn_forward(p["shared"], xt, cfg.activation)

    # ---- load-balance aux (Switch eq. 4) ---------------------------------
    frac_tokens = _counts(ids[:, 0], E).to(probs.dtype) / T
    frac_probs = torch.mean(probs, dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y.reshape(B, S, d), aux


def router_stats(p, x, cfg: ModelConfig):
    """Router diagnostics (consensus metrics measure how far gossiping
    replicas' routers have drifted apart)."""
    m = cfg.moe
    logits = x.reshape(-1, x.shape[-1]) @ p["router"].to(x.dtype)
    probs, _, ids = _route(logits, m.top_k)
    load = _counts(ids.reshape(-1), m.num_experts) / ids.numel()
    return {"expert_load": load,
            "router_entropy": -torch.mean(torch.sum(probs * torch.log(probs + 1e-9), -1))}
