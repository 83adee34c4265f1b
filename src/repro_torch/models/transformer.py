"""Transformer LM (port of ``repro.models.transformer``): segment-planned,
with train / prefill / decode entry points.

A model is a list of *events*:
  ("seg", name)     a loop over a stacked homogeneous segment of blocks
  ("cross", i)      one standalone cross-attention block (Llama-3.2-V)
  ("shared", site)  one application of a shared block (Zamba2)

Every architecture of the reference: the dense and MoE ones (``"attn"``
segments with GQA or MLA attention and dense or MoE FFNs, cut at
``moe.first_dense_layers``; gemma2's per-layer local/global windows
included), the audio one (MusicGen: ``"attn_cross"`` segments, K codebooks
summed in the embedding and K heads), the vision one (Llama-3.2-V:
``"attn"`` segments cut after each cross-attention layer, a
``("cross", i)`` event there), the SSM ones (xLSTM's ``mlstm`` /
``slstm`` runs, Mamba2) and the hybrid (Zamba2: Mamba2 segments with
shared attention blocks between them). The cross-attention blocks read
``cond``, the stubbed modality embeddings ``[B, T, e]``. The parameter
tree is the reference's, layers stacked on a leading ``[count]`` axis per
segment (the cross blocks on ``[num_cross]``, the shared blocks on
``[num_shared_blocks]``), so ``FlatSpec`` offsets equal the reference's
and a snapshot flattens to the same buffers.
The reference's ``lax.scan`` over layers is a python loop over the layers'
views (one ``unbind`` per stacked leaf, whose backward is one ``stack``),
and decode writes the caches in place. Training (:func:`lm_loss`)
rematerialises as the reference does: with ``cfg.remat`` (the default)
each block of the training forward is checkpointed
(:mod:`repro_torch.common.remat`, which runs under the engines'
``torch.func`` transforms), and each key chunk of the training attention
always is.

``prefill``, ``decode_step`` and ``init_cache`` take ``tp``: None on one
device, else the rank's part of a tensor-parallel program
(:class:`~repro_torch.serving.tensor_parallel.Part`), which embeds, runs
every block on the rank's slice and gathers the logits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.pytree import tree_flatten, tree_map, tree_unflatten
from repro_torch.common.remat import checkpoint
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.common import (dense_init, init_rmsnorm, rmsnorm, softcap, upcast,
                                       upcast_dtype)
from repro_torch.obs import spans

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
    """The reference's plan. Dense, MoE, audio and vision: segments cut at
    ``moe.first_dense_layers`` (DeepSeek: ``seg0_attn`` of 1 layer, then
    ``seg1_attn_moe``; Grok: one ``seg0_attn_moe``) and after each of
    ``vlm.cross_attn_layers``, each cut followed by a ``("cross", i)``
    event (Llama-3.2-V: 8 segments and 8 cross blocks), of kind
    ``attn_cross`` for audio (MusicGen) and ``attn`` for the others;
    gemma2's even layers local (``local_window``), odd ones global. xLSTM:
    runs of ``mlstm`` / ``slstm`` layers, layer i an sLSTM where ``i %
    slstm_every == slstm_offset``. Mamba2: one ``mamba`` segment. Hybrid
    (Zamba2): ``mamba`` segments of ``shared_attn_every`` layers with a
    ``("shared", site)`` event after each but the last."""
    if cfg.arch_type not in ("dense", "audio", "vlm", "moe", "ssm", "hybrid"):
        raise ValueError(cfg.arch_type)
    events: List[Tuple[str, Any]] = []
    segments: List[Segment] = []

    def add_seg(kind, count, use_moe=False, windows=None):
        name = f"seg{len(segments)}_{kind}" + ("_moe" if use_moe else "")
        segments.append(Segment(name, kind, count, use_moe, windows))
        events.append(("seg", name))

    if cfg.arch_type in ("dense", "audio", "vlm", "moe"):
        kind = "attn_cross" if cfg.arch_type == "audio" else "attn"
        xlayers = set(cfg.vlm.cross_attn_layers) if cfg.vlm is not None else set()
        first_dense = cfg.moe.first_dense_layers if cfg.moe is not None else 0
        cuts = sorted({first_dense, cfg.num_layers} | {i + 1 for i in xlayers})
        start, n_cross = 0, 0
        for c in (c for c in cuts if 0 < c <= cfg.num_layers):
            count = c - start
            if count > 0:
                windows = None
                if cfg.local_window:
                    windows = tuple(cfg.local_window if (start + j) % 2 == 0 else 0
                                    for j in range(count))
                add_seg(kind, count, cfg.moe is not None and start >= first_dense, windows)
            if c - 1 in xlayers:
                events.append(("cross", n_cross))
                n_cross += 1
            start = c
        return Plan(tuple(events), tuple(segments), num_cross=n_cross)
    if cfg.arch_type == "ssm" and cfg.xlstm is not None:
        x = cfg.xlstm
        pattern = ["slstm" if i % x.slstm_every == x.slstm_offset else "mlstm"
                   for i in range(cfg.num_layers)]
        i = 0
        while i < cfg.num_layers:
            j = i
            while j < cfg.num_layers and pattern[j] == pattern[i]:
                j += 1
            add_seg(pattern[i], j - i)
            i = j
        return Plan(tuple(events), tuple(segments))
    if cfg.arch_type == "ssm":
        add_seg("mamba", cfg.num_layers)
        return Plan(tuple(events), tuple(segments))
    h = cfg.hybrid
    n_sites, start = 0, 0
    while start < cfg.num_layers:
        count = min(h.shared_attn_every, cfg.num_layers - start)
        add_seg("mamba", count)
        start += count
        if start < cfg.num_layers:
            events.append(("shared", n_sites))
            n_sites += 1
    return Plan(tuple(events), tuple(segments), num_shared_blocks=h.num_shared_blocks,
                num_shared_sites=n_sites)


def _segment(plan: Plan, name: str) -> Segment:
    return next(s for s in plan.segments if s.name == name)


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

def init_lm(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
            keep=None) -> Tuple[PyTree, PyTree]:
    """(params, axes) on ``gen``'s device, in the reference's tree:
    ``embed [K, V, d]`` (K the audio codebooks, else 1),
    ``segments/<seg>/...`` stacked ``[count, ...]``, the vision model's
    ``cross/...`` stacked ``[num_cross, ...]``, the hybrid's ``shared/...``
    stacked ``[num_shared_blocks, ...]``, ``final_norm [d]`` and ``lm_head
    [K, d, V]`` (unless tied). Each
    segment's ``[count, ...]`` leaves are allocated once and filled layer by
    layer in the draw order (a layer's leaves drawn in f32 and cast to
    ``dtype``), so the peak is the model plus one layer.

    ``keep(path, leaf)`` (optional) keeps a part of each leaf as it is
    drawn (``path`` the leaf's keys from the root; a stacked leaf comes one
    layer at a time, without its ``[count]`` axis): the tree then holds only
    the kept parts, the same values as keeping them from the whole tree, and
    the peak is the kept parts plus one layer (a tensor-parallel rank's
    slice, :meth:`~repro_torch.serving.tensor_parallel.TPServeProgram.init_params`)."""
    plan = make_plan(cfg)
    params: dict = {}
    axes: dict = {}

    def kept(path, t):
        return t if keep is None else keep(path, t).clone()

    K = cfg.audio.num_codebooks if cfg.audio is not None else 1
    params["embed"], axes["embed"] = dense_init(
        gen, (K, cfg.vocab_size, cfg.d_model), (None, "vocab", "embed"), dtype,
        fan_in=cfg.d_model, scale=0.5)
    params["embed"] = kept(("embed",), params["embed"])
    segs_p, segs_a = {}, {}
    for seg in plan.segments:
        segs_p[seg.name], segs_a[seg.name] = _init_stacked(
            gen, seg.kind, seg.count, cfg, seg.use_moe, dtype, keep, ("segments", seg.name))
    params["segments"], axes["segments"] = segs_p, segs_a
    if plan.num_cross:
        params["cross"], axes["cross"] = _init_stacked(gen, "cross_blk", plan.num_cross, cfg,
                                                       False, dtype, keep, ("cross",))
    if plan.num_shared_blocks:
        params["shared"], axes["shared"] = _init_stacked(gen, "attn", plan.num_shared_blocks,
                                                         cfg, False, dtype, keep, ("shared",))
    params["final_norm"], axes["final_norm"] = init_rmsnorm(cfg.d_model, dtype, gen.device)
    params["final_norm"] = kept(("final_norm",), params["final_norm"])
    if not cfg.tie_embeddings:
        params["lm_head"], axes["lm_head"] = dense_init(
            gen, (K, cfg.d_model, cfg.vocab_size), (None, "embed", "vocab"), dtype,
            fan_in=cfg.d_model)
        params["lm_head"] = kept(("lm_head",), params["lm_head"])
    return params, axes


def _keep_tree(keep, prefix: tuple, tree):
    if isinstance(tree, dict):
        return {k: _keep_tree(keep, prefix + (k,), v) for k, v in tree.items()}
    return keep(prefix, tree)


def _init_stacked(gen, kind: str, count: int, cfg: ModelConfig, use_moe: bool, dtype,
                  keep=None, prefix: tuple = ()):
    """``count`` blocks of ``kind`` drawn one after another, stacked on a
    leading axis allocated once (of each leaf's kept part, under ``keep``)."""
    stacked = axes = None
    for i in range(count):
        p, a = blocks.init_block(gen, kind, cfg, use_moe=use_moe, dtype=dtype)
        if keep is not None:
            p = _keep_tree(keep, prefix, p)
        if stacked is None:
            stacked = tree_map(lambda t: torch.empty((count,) + tuple(t.shape), dtype=t.dtype,
                                                     device=t.device), p)
            axes = _lead_axes(a)
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, p)
    return stacked, axes


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is ``meta``: ``init_lm`` through it
    gives shapes and dtypes and allocates nothing."""

    @property
    def device(self):
        return torch.device("meta")


def meta_generator() -> torch.Generator:
    """A generator whose draws land on the ``meta`` device (shapes only)."""
    return _MetaGenerator()


def abstract_lm(cfg: ModelConfig, dtype=torch.float32):
    """(params on the ``meta`` device, axes) without allocating anything:
    the reference's ``abstract_lm`` (shapes and dtypes, e.g. for
    ``validate_fleet_memory`` before a run allocates)."""
    return init_lm(meta_generator(), cfg, dtype)


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
    """tokens: [B, S] (audio: [B, K, S]) -> [B, S, d]; the audio codebooks'
    embeddings are summed in codebook order (MusicGen's interleave
    collapsed), as the reference's ``sum``."""
    emb = params["embed"]
    if cfg.audio is not None:
        tokens = tokens.long()
        return sum(emb[k][tokens[:, k]] for k in range(cfg.audio.num_codebooks))
    return emb[0][tokens.long()]


def lm_logits(params, cfg: ModelConfig, x):
    """x: [B, S, d] -> [B, S, V] (audio: [B, K, S, V], a head a codebook)."""
    if cfg.audio is not None:
        heads = params["embed"].transpose(1, 2) if cfg.tie_embeddings else params["lm_head"]
        logits = torch.einsum("bsd,kdv->bksv", x, heads.to(x.dtype))
    else:
        head = params["embed"][0].t() if cfg.tie_embeddings else params["lm_head"][0]
        logits = x @ head.to(x.dtype)
    if cfg.final_logit_softcap:
        logits = softcap(upcast(logits), cfg.final_logit_softcap).to(logits.dtype)
    return logits


def _last_logits(params, cfg: ModelConfig, x):
    """The logits of x's last position: [B, V] (audio: [B, K, V])."""
    logits = lm_logits(params, cfg, x[:, -1:])
    return logits[:, :, 0] if cfg.audio is not None else logits[:, 0]


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens, cond=None):
    """Training forward. tokens: [B, S] (audio: [B, K, S]); cond: the
    stubbed modality embeddings [B, T, e] of the audio and vision models.
    Returns (hidden [B, S, d], aux).

    When a gradient is wanted and ``cfg.remat`` is set, every segment layer
    and every standalone cross / shared block goes through
    :func:`~repro_torch.common.remat.checkpoint` (the reference's
    ``jax.checkpoint`` of its scan body and of ``one_block``): the backward
    keeps each block's input and recomputes the block. Whether a gradient
    is wanted is decided here, once, and carried into each block as the
    attention's training route (B9 never runs in training)."""
    plan = make_plan(cfg)
    x = embed_tokens(params, cfg, tokens)
    route = attn.wants_grad(x)
    remat = cfg.remat and route

    def block(kind, p, x, cond=None, use_moe=False, window=0):
        if remat:
            return checkpoint(_block, route, kind, p, x, cfg, use_moe, window, cond)
        return _block(route, kind, p, x, cfg, use_moe, window, cond)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    shared, cross = _stacked_layers(params, "shared", plan), _stacked_layers(params, "cross", plan)
    for ev, arg in plan.events:
        if ev == "seg":
            seg = _segment(plan, arg)
            layers = _layers(params["segments"][arg], seg.count)
            for p, w in zip(layers, _layer_windows(seg, 0)):
                x, aux = block(seg.kind, p, x, cond, seg.use_moe, w)
                aux_total = aux_total + aux
        elif ev == "cross":
            x, _ = block("cross_blk", cross[arg], x, cond)
        else:
            x, aux = block("attn", shared[arg % plan.num_shared_blocks], x)
            aux_total = aux_total + aux
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux_total


def _block(route: bool, kind: str, p, x, cfg: ModelConfig, use_moe: bool, window: int, cond):
    """One block of the training forward, (y, aux), on the attention's
    training route when ``route``."""
    with attn.train_route(route):
        return blocks.block_forward(kind, p, x, cfg, use_moe=use_moe, window=window,
                                    cond=cond)


def _stacked_layers(params, key: str, plan: Plan) -> List[PyTree]:
    """The vision model's cross blocks (``key`` "cross") or the hybrid's
    shared blocks ("shared") as views; none for the other kinds."""
    count = plan.num_cross if key == "cross" else plan.num_shared_blocks
    return _layers(params[key], count) if count else []


def chunked_ce_loss(params, cfg: ModelConfig, hidden, labels, chunk: int = 256):
    """Cross-entropy without materialising [B, S, V]: a loop over sequence
    chunks, each chunk's logits in f32 (the reference's scan).

    hidden: [B, S, d]; labels: [B, S] (audio: [B, K, S], a head a
    codebook). Positions with label < 0 are masked; the mean is over the
    unmasked ones."""
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
    plus ``aux_coef`` times its auxiliary loss (0 for the dense kinds).

    The head and the loss run in the ``lm head + loss`` span, its backward
    through the span's grad marks. While it records, the span counts the
    ``tokens`` it scores (B * S * K, every ``vmap`` row) and the head's
    ``flops``: 6 * tokens * d * V, the forward's logits and the backward's
    gradients of the hidden state and of the head."""
    hidden, aux = forward(params, cfg, tokens, cond)
    with spans.span("lm head + loss") as rec:
        if rec is not None:
            d = hidden.shape[-1]
            n = spans.physical_numel(hidden) // d * (labels.shape[1] if labels.dim() == 3 else 1)
            rec.counts.update(tokens=n, flops=6 * n * d * cfg.vocab_size)
        (hidden,) = spans.mark_inputs(rec, hidden)
        ce = spans.mark_output(rec, chunked_ce_loss(params, cfg, hidden, labels))
    return ce + aux_coef * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# caches / prefill / decode
# ---------------------------------------------------------------------------

def _stacked_cache(kind: str, count: int, cfg: ModelConfig, batch: int, max_len: int,
                   dtype, window: int, device, tp=None):
    c, a = blocks.init_block_cache(kind, cfg, batch, max_len, dtype=dtype, window=window,
                                   device=device, tp=tp)
    stacked = {k: torch.empty((count,) + tuple(t.shape), dtype=t.dtype, device=device)
               .copy_(t) for k, t in c.items()}
    return stacked, _lead_axes(a)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=torch.float32,
               window: int = 0, device=None, tp=None) -> Tuple[PyTree, PyTree]:
    """({"segments": {seg: {"k", "v": [count, B, size, Hkv, hd]}}, "pos":
    int32 0-d}, axes) (MLA: ``"c_kv" [count, B, size, r]`` and ``"k_rope"
    [count, B, size, rope_dim]``; the recurrent kinds their f32 state and
    conv buffer, sLSTM's ``m`` at -1e30; the hybrid's ``"shared_sites"``
    the shared blocks' K/V, ``[num_shared_sites, B, size, Hkv, hd]``);
    size = max_len, or ``window`` for the ring buffer. Under ``tp`` the
    rank's heads (``blocks.init_block_cache``)."""
    plan = make_plan(cfg)
    cache = {"segments": {}, "pos": torch.zeros((), dtype=torch.int32, device=device)}
    axes = {"segments": {}, "pos": ()}
    for seg in plan.segments:
        cache["segments"][seg.name], axes["segments"][seg.name] = _stacked_cache(
            seg.kind, seg.count, cfg, batch, max_len, dtype, window, device, tp)
    if plan.num_shared_sites:
        cache["shared_sites"], axes["shared_sites"] = _stacked_cache(
            "attn", plan.num_shared_sites, cfg, batch, max_len, dtype, window, device, tp)
    return cache, axes


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=torch.float32,
                   window: int = 0) -> Tuple[PyTree, PyTree]:
    """(cache on the ``meta`` device, axes) without allocating anything: the
    reference's ``abstract_cache`` (e.g. for the serving cache's specs)."""
    return init_cache(cfg, batch, max_len, dtype=dtype, window=window, device="meta")


def decode_step(params, cfg: ModelConfig, cache, tokens, cond=None, *, window: int = 0,
                kv_start=None, tp=None):
    """One-token decode. tokens: [B, 1] (audio: [B, K, 1]). kv_start
    (optional [B]): per-row first valid cache position, the
    continuous-batching slot boundary. The cache's K/V rows at ``pos`` and
    the recurrent states are written IN PLACE; the returned cache holds the
    same tensors and a new ``pos + 1``. The cross blocks attend over all of
    ``cond``. Returns (logits [B, V] (audio: [B, K, V]), cache)."""
    plan = make_plan(cfg)
    pos = cache["pos"]
    x = embed_tokens(params, cfg, tokens) if tp is None else tp.embed(params, tokens)
    new_cache = {"segments": {}, "pos": pos + 1}
    shared, cross = _stacked_layers(params, "shared", plan), _stacked_layers(params, "cross", plan)
    if plan.num_shared_sites:
        sites = _layers(cache["shared_sites"], plan.num_shared_sites)
        new_cache["shared_sites"] = cache["shared_sites"]
    for ev, arg in plan.events:
        if ev == "seg":
            seg = _segment(plan, arg)
            sc = cache["segments"][arg]
            layers = zip(_layers(params["segments"][arg], seg.count),
                         _layers(sc, seg.count), _layer_windows(seg, window))
            for p, c, w in layers:
                # `window` (python int) selects the ring-buffer mode; the
                # per-layer `w` masks gemma2's local layers in full-cache mode
                x, _ = blocks.block_decode(seg.kind, p, x, c, pos, cfg,
                                           use_moe=seg.use_moe, window=window, window_mask=w,
                                           cond=cond, kv_start=kv_start, tp=tp)
            new_cache["segments"][arg] = sc
        elif ev == "cross":
            x, _ = blocks.block_decode("cross_blk", cross[arg], x, {}, pos, cfg, cond=cond,
                                       tp=tp)
        else:
            x, _ = blocks.block_decode("attn", shared[arg % plan.num_shared_blocks], x,
                                       sites[arg], pos, cfg, window=window, kv_start=kv_start,
                                       tp=tp)
    return _final_logits(params, cfg, x, tp), new_cache


def _final_logits(params, cfg: ModelConfig, x, tp):
    """The final norm, then the last position's logits (gathered over the
    vocab under ``tp``)."""
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _last_logits(params, cfg, x) if tp is None else tp.logits(params, x)


def prefill(params, cfg: ModelConfig, tokens, cond=None, cache_dtype=torch.float32,
            max_len: int = 0, tp=None):
    """Full-sequence prefill: returns (last-token logits [B, V] (audio:
    [B, K, V]), cache). Attention caches are zero-padded to ``max_len`` rows
    so decode can continue in place; the recurrent ones hold the terminal
    state."""
    plan = make_plan(cfg)
    x = embed_tokens(params, cfg, tokens) if tp is None else tp.embed(params, tokens)
    S = x.shape[1]
    cache = {"segments": {}, "pos": torch.full((), S, dtype=torch.int32, device=x.device)}
    shared, cross = _stacked_layers(params, "shared", plan), _stacked_layers(params, "cross", plan)
    sites = []
    for ev, arg in plan.events:
        if ev == "seg":
            seg = _segment(plan, arg)
            layers = []
            for p, w in zip(_layers(params["segments"][arg], seg.count),
                            _layer_windows(seg, 0)):
                x, c = blocks.block_prefill(seg.kind, p, x, cfg, use_moe=seg.use_moe,
                                            window=w, cond=cond, cache_dtype=cache_dtype,
                                            max_len=max_len, tp=tp)
                layers.append(c)
            cache["segments"][arg] = _stack(layers)
        elif ev == "cross":
            x, _ = blocks.block_prefill("cross_blk", cross[arg], x, cfg, cond=cond, tp=tp)
        else:
            x, c = blocks.block_prefill("attn", shared[arg % plan.num_shared_blocks], x, cfg,
                                        cache_dtype=cache_dtype, max_len=max_len, tp=tp)
            sites.append(c)
    if sites:
        cache["shared_sites"] = _stack(sites)
    return _final_logits(params, cfg, x, tp), cache


def _stack(caches: List[dict]) -> dict:
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
