"""Transformer LM (port of ``repro.models.transformer``): segment-planned,
with train / prefill / decode entry points.

The dense and MoE architectures (``"attn"`` segments with GQA or MLA
attention and dense or MoE FFNs, cut at ``moe.first_dense_layers``;
gemma2's per-layer local/global windows included). SSM / hybrid models
raise NotImplementedError until ROADMAP.md 7b.4c, audio and vision models
until 7b.4d. The parameter tree is the reference's, layers stacked on a
leading ``[count]`` axis per segment, so ``FlatSpec`` offsets equal the
reference's and a snapshot flattens to the same buffers. The reference's
``lax.scan`` over layers is a python loop over the layers' views (one
``unbind`` per stacked leaf, whose backward is one ``stack``), and decode
writes the KV cache in place. Training (:func:`lm_loss`) keeps every
layer's activations: the reference's ``cfg.remat`` (``jax.checkpoint``)
has no counterpart under the engines' ``torch.func`` transforms, which
refuse saved-tensor hooks (ROADMAP.md §C).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.pytree import tree_flatten, tree_map, tree_unflatten
from repro_torch.models import blocks
from repro_torch.models.common import (dense_init, init_rmsnorm, rmsnorm, softcap, upcast,
                                       upcast_dtype)

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    kind: str                 # blocks.py kind
    count: int
    use_moe: bool = False
    windows: Optional[Tuple[int, ...]] = None   # per-layer window (gemma2)


@dataclasses.dataclass(frozen=True)
class Plan:
    events: Tuple[Tuple[str, Any], ...]
    segments: Tuple[Segment, ...]
    num_cross: int = 0
    num_shared_blocks: int = 0
    num_shared_sites: int = 0


def make_plan(cfg: ModelConfig) -> Plan:
    """The reference's plan for a dense or MoE model: ``attn`` segments cut
    at ``moe.first_dense_layers`` (DeepSeek: ``seg0_attn`` of 1 layer, then
    ``seg1_attn_moe``; Grok: one ``seg0_attn_moe``), gemma2's even layers
    local (``local_window``), odd ones global."""
    if cfg.arch_type in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: arch_type {cfg.arch_type!r} waits for slice 7b.4c (SSM / "
            "hybrid, ROADMAP.md); the port serves dense and MoE models")
    if cfg.arch_type not in ("dense", "moe") or cfg.vlm is not None or cfg.audio is not None:
        raise NotImplementedError(
            f"{cfg.name}: arch_type {cfg.arch_type!r} waits for slice 7b.4d "
            "(cross-attention, ROADMAP.md); the port serves dense and MoE models")
    segments: List[Segment] = []
    first_dense = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    cuts = [c for c in sorted({first_dense, cfg.num_layers}) if 0 < c <= cfg.num_layers]
    start = 0
    for c in cuts:
        count = c - start
        if count > 0:
            use_moe = cfg.moe is not None and start >= first_dense
            windows = None
            if cfg.local_window:
                windows = tuple(cfg.local_window if (start + j) % 2 == 0 else 0
                                for j in range(count))
            name = f"seg{len(segments)}_attn" + ("_moe" if use_moe else "")
            segments.append(Segment(name, "attn", count, use_moe, windows))
        start = c
    return Plan(tuple(("seg", s.name) for s in segments), tuple(segments))


def _layer_windows(seg: Segment, default: int) -> List[int]:
    return list(seg.windows) if seg.windows is not None else [default] * seg.count


def _layers(seg_params, count: int) -> List[PyTree]:
    """The ``count`` layers of a stacked segment as views, one ``unbind``
    per leaf: the backward stacks the layers' gradients once per leaf,
    where indexing ``t[i]`` would fill and add a zeroed leaf per layer."""
    leaves, treedef = tree_flatten(seg_params)
    cols = [t.unbind(0) for t in leaves]
    return [tree_unflatten(treedef, [c[i] for c in cols]) for i in range(count)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_lm(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> Tuple[PyTree, PyTree]:
    """(params, axes) on ``gen``'s device, in the reference's tree:
    ``embed [1, V, d]``, ``segments/<seg>/...`` stacked ``[count, ...]``,
    ``final_norm [d]`` and ``lm_head [1, d, V]`` (unless tied). Each
    segment's ``[count, ...]`` leaves are allocated once and filled layer by
    layer in the draw order (a layer's leaves drawn in f32 and cast to
    ``dtype``), so the peak is the model plus one layer."""
    plan = make_plan(cfg)
    params: dict = {}
    axes: dict = {}
    params["embed"], axes["embed"] = dense_init(
        gen, (1, cfg.vocab_size, cfg.d_model), (None, "vocab", "embed"), dtype,
        fan_in=cfg.d_model, scale=0.5)
    segs_p, segs_a = {}, {}
    for seg in plan.segments:
        stacked = None
        for i in range(seg.count):
            p, a = blocks.init_block(gen, seg.kind, cfg, use_moe=seg.use_moe, dtype=dtype)
            if stacked is None:
                stacked = tree_map(lambda t: torch.empty((seg.count,) + tuple(t.shape),
                                                         dtype=t.dtype, device=t.device), p)
                segs_a[seg.name] = _lead_axes(a)
            tree_map(lambda dst, src: dst[i].copy_(src), stacked, p)
        segs_p[seg.name] = stacked
    params["segments"], axes["segments"] = segs_p, segs_a
    params["final_norm"], axes["final_norm"] = init_rmsnorm(cfg.d_model, dtype, gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"], axes["lm_head"] = dense_init(
            gen, (1, cfg.d_model, cfg.vocab_size), (None, "embed", "vocab"), dtype,
            fan_in=cfg.d_model)
    return params, axes


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is ``meta``: ``init_lm`` through it
    gives shapes and dtypes and allocates nothing."""

    @property
    def device(self):
        return torch.device("meta")


def abstract_lm(cfg: ModelConfig, dtype=torch.float32):
    """(params on the ``meta`` device, axes) without allocating anything:
    the reference's ``abstract_lm`` (shapes and dtypes, e.g. for
    ``validate_fleet_memory`` before a run allocates)."""
    return init_lm(_MetaGenerator(), cfg, dtype)


def _lead_axes(a):
    if isinstance(a, dict):
        return {k: _lead_axes(v) for k, v in a.items()}
    return (None,) + tuple(a)


def params_from_jax(tree, device, dtype=None) -> PyTree:
    """The reference's ``init_lm`` parameters (leaves as numpy arrays, e.g.
    via ``np.asarray``) -> the port's tensors on ``device`` with the same
    keys and shapes; cast to ``dtype`` when given, else the leaves' own
    dtypes (bfloat16 leaves go through float32)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


# ---------------------------------------------------------------------------
# embedding / head helpers
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens):
    """tokens: [B, S] -> [B, S, d]."""
    return params["embed"][0][tokens.long()]


def lm_logits(params, cfg: ModelConfig, x):
    """x: [B, S, d] -> [B, S, V]."""
    head = params["embed"][0].t() if cfg.tie_embeddings else params["lm_head"][0]
    logits = x @ head.to(x.dtype)
    if cfg.final_logit_softcap:
        logits = softcap(upcast(logits), cfg.final_logit_softcap).to(logits.dtype)
    return logits


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens, cond=None):
    """Training forward. tokens: [B, S]. Returns (hidden [B, S, d], aux)."""
    plan = make_plan(cfg)
    x = embed_tokens(params, cfg, tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg in plan.segments:
        layers = _layers(params["segments"][seg.name], seg.count)
        for p, w in zip(layers, _layer_windows(seg, 0)):
            x, aux = blocks.block_forward(seg.kind, p, x, cfg,
                                          use_moe=seg.use_moe, window=w, cond=cond)
            aux_total = aux_total + aux
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux_total


def chunked_ce_loss(params, cfg: ModelConfig, hidden, labels, chunk: int = 256):
    """Cross-entropy without materialising [B, S, V]: a loop over sequence
    chunks, each chunk's logits in f32 (the reference's scan).

    hidden: [B, S, d]; labels: [B, S]. Positions with label < 0 are
    masked; the mean is over the unmasked ones."""
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    assert S % chunk == 0
    heads = params["embed"].transpose(1, 2) if cfg.tie_embeddings else params["lm_head"]
    labels_k = labels if labels.dim() == 3 else labels[:, None]       # [B, K, S]
    acc = upcast_dtype(hidden.dtype)
    tot = torch.zeros((), dtype=acc, device=hidden.device)
    cnt = torch.zeros((), dtype=acc, device=hidden.device)
    for i in range(S // chunk):
        h = hidden[:, i * chunk:(i + 1) * chunk]                      # [B, c, d]
        lab = labels_k[..., i * chunk:(i + 1) * chunk]                # [B, K, c]
        logits = upcast(torch.einsum("bcd,kdv->bkcv", h, heads.to(h.dtype)))
        if cfg.final_logit_softcap:
            logits = softcap(logits, cfg.final_logit_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab.clamp_min(0).long()[..., None])[..., 0]
        mask = (lab >= 0).to(acc)
        tot = tot + torch.sum((lse - gold) * mask)
        cnt = cnt + torch.sum(mask)
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, cfg: ModelConfig, tokens, labels, cond=None, aux_coef: float = 0.01):
    """(loss, {"ce", "aux"}): the training forward's chunked cross-entropy
    plus ``aux_coef`` times its auxiliary loss (0 for the dense kinds)."""
    hidden, aux = forward(params, cfg, tokens, cond)
    ce = chunked_ce_loss(params, cfg, hidden, labels)
    return ce + aux_coef * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# caches / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=torch.float32,
               window: int = 0, device=None) -> Tuple[PyTree, PyTree]:
    """({"segments": {seg: {"k", "v": [count, B, size, Hkv, hd]}}, "pos":
    int32 0-d}, axes) (MLA: ``"c_kv" [count, B, size, r]`` and ``"k_rope"
    [count, B, size, rope_dim]``); size = max_len, or ``window`` for the
    ring buffer."""
    plan = make_plan(cfg)
    cache = {"segments": {}, "pos": torch.zeros((), dtype=torch.int32, device=device)}
    axes = {"segments": {}, "pos": ()}
    for seg in plan.segments:
        c, a = blocks.init_block_cache(seg.kind, cfg, batch, max_len, dtype=dtype,
                                       window=window, device=device)
        cache["segments"][seg.name] = {k: torch.zeros((seg.count,) + tuple(t.shape),
                                                      dtype=t.dtype, device=device)
                                       for k, t in c.items()}
        axes["segments"][seg.name] = _lead_axes(a)
    return cache, axes


def decode_step(params, cfg: ModelConfig, cache, tokens, cond=None, *, window: int = 0,
                kv_start=None):
    """One-token decode. tokens: [B, 1]. kv_start (optional [B]): per-row
    first valid cache position, the continuous-batching slot boundary.
    The cache's K/V rows at ``pos`` are written IN PLACE; the returned cache
    holds the same K/V tensors and a new ``pos + 1``.
    Returns (logits [B, V], cache)."""
    plan = make_plan(cfg)
    pos = cache["pos"]
    x = embed_tokens(params, cfg, tokens)
    new_cache = {"segments": {}, "pos": pos + 1}
    for seg in plan.segments:
        sc = cache["segments"][seg.name]
        layers = zip(_layers(params["segments"][seg.name], seg.count),
                     _layers(sc, seg.count), _layer_windows(seg, window))
        for p, c, w in layers:
            # `window` (python int) selects the ring-buffer mode; the
            # per-layer `w` masks gemma2's local layers in full-cache mode
            x, _ = blocks.block_decode(seg.kind, p, x, c, pos, cfg,
                                       use_moe=seg.use_moe, window=window, window_mask=w,
                                       cond=cond, kv_start=kv_start)
        new_cache["segments"][seg.name] = sc
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x)[:, 0], new_cache


def prefill(params, cfg: ModelConfig, tokens, cond=None, cache_dtype=torch.float32,
            max_len: int = 0):
    """Full-sequence prefill: returns (last-token logits [B, V], cache).
    Attention caches are zero-padded to ``max_len`` rows so decode can
    continue in place."""
    plan = make_plan(cfg)
    x = embed_tokens(params, cfg, tokens)
    S = x.shape[1]
    cache = {"segments": {}, "pos": torch.full((), S, dtype=torch.int32, device=x.device)}
    for seg in plan.segments:
        layers = []
        for p, w in zip(_layers(params["segments"][seg.name], seg.count),
                        _layer_windows(seg, 0)):
            x, c = blocks.block_prefill(seg.kind, p, x, cfg, use_moe=seg.use_moe,
                                        window=w, cond=cond, cache_dtype=cache_dtype,
                                        max_len=max_len)
            layers.append(c)
        cache["segments"][seg.name] = {k: torch.stack([c[k] for c in layers])
                                       for k in layers[0]}
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x[:, -1:])[:, 0], cache
