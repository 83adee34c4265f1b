"""Tensor-parallel serving of the dense attention models over ``model``
ranks: the reference's ``make_serve_program`` on a mesh with ``model = M
> 1``, where GSPMD splits the parameters by ``serve_rules`` and inserts
the collectives.

Every rank of a :class:`~repro_torch.launch.mesh.ModelGroup` runs the same
calls on the same tokens (multi-controller, as the dist engine) and gets
the whole logits. Each leaf is sliced by its spec's ``model`` entry
(:mod:`repro_torch.launch.sharding`):

- ``wq`` and ``wo`` by heads: the attention's output projection is a
  partial product over the rank's heads, summed by ``all_reduce_sum``;
  ``wk`` / ``wv`` by kv heads. Where the spec leaves the kv heads whole
  (fewer kv heads than ranks, e.g. MQA) the rank keeps the kv heads its q
  heads read (``h // G``), so attention is kernel B9 over the rank's
  ``H / M`` heads and its kv heads, at the local GQA ratio. B9 picks its
  form from the local shapes; where the kv heads split, the local ratio
  is the model's (TinyLlama: 8 at M = 1, 2 and 4), so a decode step stays
  in the ``split`` form ((H / Hkv) * Sq <= 16) and a bf16 prefill in
  ``mma``;
- the FFN's gate and up projections by ffn, its down projection by ffn,
  summed by ``all_reduce_sum``;
- ``embed`` by vocab: a masked lookup, summed by ``all_reduce_sum``;
  ``lm_head`` (or the tied embedding) by vocab, joined by ``all_gather``
  (Gemma2's final softcap after it);
- the norms are replicated. A group the spec leaves whole (heads, ffn or
  vocab that M does not divide) runs whole on every rank, with no
  collective, as GSPMD replicates it.

Each rank's KV cache holds its kv heads. Two deliberate differences from
the reference (ROADMAP.md §C), both with equal values: the reference splits
the cache by sequence (``seq_kv``) where the kv heads do not divide M, and
splits the batch over the data axes; the port keeps the whole batch and
every row of its kv heads. The MoE, MLA, SSM / hybrid and cross-attention
models are refused (ROADMAP.md 7b.5d).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.common.config import MeshConfig, ModelConfig
from repro_torch.common.pytree import tree_map
from repro_torch.launch import sharding as shr
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models import transformer as tr
from repro_torch.models.common import rmsnorm, softcap, upcast
from repro_torch.models.mlp import ffn_forward
from repro_torch.serving.engine import ServeProgram, serve_rules

PyTree = Any


def check_arch(cfg: ModelConfig, model: int) -> None:
    """Refuse what the port does not split yet: every kind but the dense
    attention models (ROADMAP.md 7b.5d). A replicated fallback would hide
    the missing split."""
    if model <= 1:
        return
    kind = ("MoE (experts over model)" if cfg.moe is not None
            else "MLA" if cfg.mla is not None
            else f"{cfg.arch_type} (inner over model)" if cfg.arch_type in ("ssm", "hybrid")
            else "cross-attention" if cfg.arch_type in ("audio", "vlm") else None)
    if kind is not None or cfg.arch_type != "dense":
        raise ValueError(f"tensor-parallel serving (model={model}) of {cfg.name}: "
                         f"{kind or cfg.arch_type} is not split yet (ROADMAP.md 7b.5d); "
                         "serve it with model = 1")


@dataclasses.dataclass(frozen=True)
class Layout:
    """What a rank of M holds: which groups are split over ``model``, its
    slice of the heads, kv heads, ffn and vocab, and the local config the
    model code reads (heads, kv heads, head dim)."""
    model: int
    rank: int
    heads: bool                  # wq / wo split (else attention runs whole)
    kv: bool                     # wk / wv split by the spec
    ffn: bool
    vocab: bool
    kv_start: int                # the rank's first kv head, its count in local_cfg
    local_cfg: ModelConfig
    specs: Any                   # the parameters' specs (abstract_lm axes, serve_rules)


def make_layout(cfg: ModelConfig, mesh_cfg: MeshConfig, rank: int) -> Layout:
    """The rank's :class:`Layout` from the parameters' specs under the
    reference's ``serve_rules``."""
    check_arch(cfg, mesh_cfg.model)
    M = mesh_cfg.model
    shapes, axes = tr.abstract_lm(cfg)
    specs = shr.tree_specs(shapes, axes, mesh_cfg, serve_rules(cfg, mesh_cfg))
    seg = specs["segments"][tr.make_plan(cfg).segments[0].name]
    heads = shr.model_dim(seg["attn"]["wq"]) is not None
    kv = shr.model_dim(seg["attn"]["wk"]) is not None
    ffn = shr.model_dim(seg["ffn"]["w_down"]) is not None
    vocab = shr.model_dim(specs["embed"]) is not None
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if not heads:
        hl, kv_start, kvl = H, 0, Hkv
    else:
        hl, G = H // M, H // Hkv
        if kv:
            kv_start, kvl = rank * (Hkv // M), Hkv // M
        elif G % hl == 0:
            # the rank's q heads all read one kv head
            kv_start, kvl = (rank * hl) // G, 1
        else:
            raise ValueError(f"{cfg.name}: {H} heads of {Hkv} kv heads over model={M} "
                             "gives a rank q heads of more than one kv group")
    local = dataclasses.replace(cfg, num_heads=hl, num_kv_heads=kvl, head_dim=hd)
    return Layout(M, rank, heads, kv, ffn, vocab, kv_start, local, specs)


def local_params(params: PyTree, lay: Layout) -> PyTree:
    """The rank's slice of a full single-replica tree, as views of it: each
    leaf split over ``model`` gives its ``rank``-th part, ``wk`` / ``wv``
    of a split attention whose kv heads the spec leaves whole give the kv
    heads the rank reads, every other leaf is whole."""
    def one(path, t, spec):
        if path[-1] in ("wk", "wv") and lay.heads and not lay.kv:
            return t.narrow(t.dim() - 2, lay.kv_start, lay.local_cfg.num_kv_heads)
        d = shr.model_dim(spec)
        if d is None:
            return t
        size = t.shape[d] // lay.model
        return t.narrow(d, lay.rank * size, size)

    def walk(p, s, path):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k], path + (k,)) for k in p}
        return one(path, p, s)
    return walk(params, lay.specs, ())


class TPModel:
    """Prefill and decode of the rank's slice (the counterparts of
    ``transformer.prefill`` / ``decode_step`` for the dense plan), with the
    group's collectives where the split needs them."""

    def __init__(self, cfg: ModelConfig, lay: Layout, group):
        self.cfg, self.lay, self.group = cfg, lay, group
        self.plan = tr.make_plan(cfg)

    # ------------------------------------------------------------- pieces
    def embed(self, params, tokens):
        emb = params["embed"][0]
        if not self.lay.vocab:
            return emb[tokens.long()]
        V = emb.shape[0]
        t = tokens.long() - self.lay.rank * V
        inside = (t >= 0) & (t < V)
        x = emb[t.clamp(0, V - 1)] * inside[..., None].to(emb.dtype)
        return self.group.all_reduce_sum(x)

    def logits(self, params, x):
        """The last position's logits [B, V], gathered over the vocab."""
        cfg = self.cfg
        head = params["embed"][0].t() if cfg.tie_embeddings else params["lm_head"][0]
        logits = x[:, -1] @ head.to(x.dtype)
        if self.lay.vocab:
            logits = self.group.all_gather(logits, dim=-1)
        if cfg.final_logit_softcap:
            logits = softcap(upcast(logits), cfg.final_logit_softcap).to(logits.dtype)
        return logits

    def block(self, p, x, attend):
        """One dense block; ``attend(p_attn, h)`` -> (partial y, extra)."""
        cfg, lay = self.cfg, self.lay
        y, extra = attend(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps))
        if lay.heads:
            y = self.group.all_reduce_sum(y)
        x = blocks._attn_residual("attn", p, x, y, cfg, None)
        f = ffn_forward(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.activation)
        if lay.ffn:
            f = self.group.all_reduce_sum(f)
        if cfg.post_norms:
            f = rmsnorm(p["post_ln2"], f, cfg.norm_eps)
        return x + f, extra

    def _layers(self, params, name):
        seg = tr._segment(self.plan, name)
        return seg, tr._layers(params["segments"][name], seg.count)

    # ------------------------------------------------------------ entries
    def prefill(self, params, tokens, cache_dtype, max_len: int):
        lc = self.lay.local_cfg
        x = self.embed(params, tokens)
        B, S = x.shape[:2]
        rows = max(max_len, S)
        cache = {"segments": {}, "pos": torch.full((), S, dtype=torch.int32, device=x.device)}
        for _, name in self.plan.events:
            seg, layers = self._layers(params, name)
            caches = []
            for p, w in zip(layers, tr._layer_windows(seg, 0)):
                x, (k, v) = self.block(
                    p, x, lambda pa, h, w=w: attn.gqa_forward(pa, h, lc, window=w))
                c = {}
                for key, t in (("k", k), ("v", v)):
                    c[key] = torch.zeros((B, rows) + tuple(t.shape[2:]), dtype=cache_dtype,
                                         device=x.device)
                    c[key][:, :S] = t
                caches.append(c)
            cache["segments"][name] = tr._stack(caches)
        return self.logits(params, rmsnorm(params["final_norm"], x, self.cfg.norm_eps)), cache

    def decode(self, params, cache, tokens, window: int = 0, kv_start=None):
        lc = self.lay.local_cfg
        pos = cache["pos"]
        x = self.embed(params, tokens)
        new_cache = {"segments": {}, "pos": pos + 1}
        for _, name in self.plan.events:
            seg, layers = self._layers(params, name)
            sc = cache["segments"][name]
            for p, c, w in zip(layers, tr._layers(sc, seg.count),
                               tr._layer_windows(seg, window)):
                x, _ = self.block(p, x, lambda pa, h, c=c, w=w: blocks._attn_decode(
                    pa, h, c, pos, lc, window, w, kv_start=kv_start))
            new_cache["segments"][name] = sc
        return self.logits(params, rmsnorm(params["final_norm"], x, self.cfg.norm_eps)), \
            new_cache


def tp_program(cfg: ModelConfig, mesh_cfg: MeshConfig, group, *, batch: int, max_len: int,
               window: int, param_dtype, cache_dtype, with_prefill: bool, device):
    """The :class:`~repro_torch.serving.engine.ServeProgram` surface over
    the group's ranks (called by ``make_serve_program``)."""
    if group is None or group.world != mesh_cfg.model:
        raise ValueError(f"model={mesh_cfg.model} serves over a ModelGroup of as many "
                         "ranks (repro_torch.launch.mesh.spawn_model_group)")
    lay = make_layout(cfg, mesh_cfg, group.rank)
    model = TPModel(cfg, lay, group)

    @torch.no_grad()
    def decode(params, cache, tokens, cond=None):
        return model.decode(params, cache, tokens, window=window)

    @torch.no_grad()
    def decode_slots(params, cache, tokens, cond, kv_start):
        return model.decode(params, cache, tokens, window=window, kv_start=kv_start)

    prefill_fn = None
    if with_prefill:
        @torch.no_grad()
        def prefill_fn(params, tokens, cond=None):
            return model.prefill(params, tokens, cache_dtype, max_len)

    return TPServeProgram(cfg, decode, prefill_fn, batch, max_len, window,
                          decode_slots_fn=decode_slots, param_dtype=param_dtype,
                          cache_dtype=cache_dtype, device=device, group=group, layout=lay)


@dataclasses.dataclass
class TPServeProgram(ServeProgram):
    """A :class:`~repro_torch.serving.engine.ServeProgram` of one rank of a
    tensor-parallel group: ``place_params`` slices, ``init_cache`` holds
    the rank's kv heads."""
    group: Any = None
    layout: Optional[Layout] = None

    def place_params(self, params: PyTree) -> PyTree:
        """The rank's slice of a full single-replica tree on the serving
        device in the serving dtype, each leaf a new contiguous tensor (the
        full tree is not kept: the caller may free it)."""
        return tree_map(lambda t: t.to(device=self.device, dtype=self.param_dtype,
                                       copy=True).contiguous(),
                        local_params(params, self.layout))

    def init_cache(self) -> PyTree:
        cache, _ = tr.init_cache(self.layout.local_cfg, self.batch, self.max_len,
                                 dtype=self.cache_dtype, window=self.window,
                                 device=self.device)
        return cache

    def collectives_per_decode_step(self) -> Dict[str, int]:
        """The exact count a decode step makes: per layer one all-reduce
        for split heads and one for a split FFN; one all-reduce for a split
        embedding and one all-gather for a split head."""
        lay, layers = self.layout, self.model_cfg.num_layers
        return {"all_reduce": layers * (int(lay.heads) + int(lay.ffn)) + int(lay.vocab),
                "all_gather": int(lay.vocab)}
