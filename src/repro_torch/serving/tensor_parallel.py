"""Tensor-parallel serving over ``model`` ranks: the reference's
``make_serve_program`` on a mesh with ``model = M > 1``, where GSPMD splits
the parameters by ``serve_rules`` and inserts the collectives.

Every rank of a :class:`~repro_torch.launch.mesh.ModelGroup` runs the same
calls on the same tokens (multi-controller, as the dist engine) and gets
the whole logits. The model code is the one-device code
(``transformer.prefill`` / ``decode_step``) given the rank's :class:`Part`:
its slice of the parameters, the local config attention reads, and the
group's collectives where a partial sum needs them. Each leaf is sliced by
its spec's ``model`` entry (:mod:`repro_torch.launch.sharding`), except
where noted:

- attention (self, cross, Zamba2's shared blocks; MLA's ``wq``, ``k_up``,
  ``v_up``, ``wo``) by heads: the output projection is a partial product
  over the rank's heads, summed by ``all_reduce_sum``; ``wk`` / ``wv`` by
  kv heads. Where the spec leaves the kv heads whole (fewer kv heads than
  ranks, e.g. MQA) the rank keeps the kv heads its q heads read
  (``h // G``), so attention is kernel B9 over the rank's ``H / M`` heads
  and its kv heads, at the local GQA ratio. MLA's ``kv_down`` and
  ``kv_norm`` are whole and every rank keeps the whole latent cache;
- the dense FFNs by ffn, summed by ``all_reduce_sum``;
- MoE: the experts by ``expert`` (by ``ffn`` where M does not divide E),
  the shared experts by ffn; the router stays whole (its spec splits its
  columns), so every rank routes every token alike, and one all-reduce a
  layer sums the routed and shared partials;
- Mamba2 and mLSTM by heads, each packed projection by its components
  (:func:`slice_leaf`; :mod:`repro_torch.models.ssm`), the inner norm's sum
  of squares summed by a small all-reduce; the sLSTM whole on every rank;
- ``embed`` by vocab: a masked lookup (summed over the codebooks), summed by
  ``all_reduce_sum``; ``lm_head`` (or the tied embedding) by vocab, joined
  by ``all_gather`` (Gemma2's final softcap after it; MusicGen's
  ``[B, K, V]``);
- the norms and the tanh gates are replicated. A group the spec leaves
  whole (heads, ffn, experts or vocab that M does not divide; recurrent
  heads that M does not divide) runs whole on every rank, with no
  collective, as GSPMD replicates it.

Deliberate differences from the reference, all with equal values (ROADMAP.md
§C): the reference splits a cache by sequence (``seq_kv``) where the kv
heads do not divide M (and MLA's latent cache always), splits the batch
over the data axes, splits the router's columns, the recurrent blocks'
packed projections as contiguous ``inner`` slices and the sLSTM's leaves;
the port keeps the whole batch, every row of its kv heads and the whole
latent cache, the whole router and the whole sLSTM, and splits the other
recurrent blocks by their components.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.common.config import MeshConfig, ModelConfig
from repro_torch.common.pytree import tree_map
from repro_torch.launch import sharding as shr
from repro_torch.models import transformer as tr
from repro_torch.models.common import softcap, upcast
from repro_torch.serving.engine import ServeProgram, serve_rules

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Layout:
    """What a rank of M holds: which groups are split over ``model``, its
    slice of the heads and kv heads, and the local config attention reads
    (heads, kv heads, head dim)."""
    model: int
    rank: int
    heads: bool                  # attention's wq / wo split (else attention runs whole)
    kv: bool                     # wk / wv split by the spec
    ffn: bool                    # the dense FFNs
    vocab: bool
    experts: bool                # MoE experts over model
    expert_ffn: bool             # MoE experts' ffn dim (where M does not divide E)
    shared_ffn: bool             # MoE shared experts
    mixer: bool                  # recurrent mixers (Mamba2, mLSTM) by heads
    kv_start: int                # the rank's first kv head, its count in local_cfg
    local_cfg: ModelConfig
    kinds: Dict[str, str]        # segment name -> block kind
    specs: Any                   # the parameters' specs (abstract_lm axes, serve_rules)

    @property
    def moe(self) -> bool:
        """An MoE layer's output is a partial sum."""
        return self.experts or self.expert_ffn or self.shared_ffn


def _split(cfg: ModelConfig, mesh_cfg: MeshConfig, shape, axes) -> Optional[int]:
    """The dim of a leaf of ``shape`` / ``axes`` the serving rules split
    over ``model`` (None: whole)."""
    return shr.model_dim(shr.spec_for(shape, axes, mesh_cfg, serve_rules(cfg, mesh_cfg)))


def _mixer_split(cfg: ModelConfig, M: int) -> bool:
    """Whether the recurrent mixers split over M ranks: by heads, where M
    divides them (Mamba2 with one group: B and C whole on every rank)."""
    if cfg.ssm is not None and cfg.xlstm is None:
        s = cfg.ssm
        heads = s.expand * cfg.d_model // s.head_dim
        if heads % M:
            return False
        if s.ngroups != 1:
            raise ValueError(f"{cfg.name}: Mamba2's {heads} heads in {s.ngroups} groups over "
                             f"model={M}: the split keeps one group's B and C on every rank")
        return True
    return cfg.xlstm is not None and cfg.num_heads % M == 0


def make_layout(cfg: ModelConfig, mesh_cfg: MeshConfig, rank: int) -> Layout:
    """The rank's :class:`Layout` from the reference's ``serve_rules`` on
    each kind's leaves. Raises ValueError where a rank's q heads would read
    more than one kv group."""
    M = mesh_cfg.model
    plan = tr.make_plan(cfg)
    shapes, axes = tr.abstract_lm(cfg)
    specs = shr.tree_specs(shapes, axes, mesh_cfg, serve_rules(cfg, mesh_cfg))
    H, Hkv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model
    heads = _split(cfg, mesh_cfg, (d, H, hd), ("embed", "heads", None)) is not None
    kv = cfg.mla is None and _split(cfg, mesh_cfg, (d, Hkv, hd),
                                    ("embed", "kv_heads", None)) is not None
    ffn = _split(cfg, mesh_cfg, (cfg.d_ff, d), ("ffn", "embed")) is not None
    vocab = shr.model_dim(specs["embed"]) is not None
    experts = expert_ffn = shared_ffn = False
    if cfg.moe is not None:
        m = cfg.moe
        f = m.d_ff_expert or cfg.d_ff
        dim = _split(cfg, mesh_cfg, (m.num_experts, d, f), ("expert", "embed", "ffn"))
        experts, expert_ffn = dim == 0, dim == 2
        shared_ffn = bool(m.num_shared_experts) and _split(
            cfg, mesh_cfg, (m.num_shared_experts * f, d), ("ffn", "embed")) is not None
    if not heads or cfg.mla is not None:
        hl, kv_start, kvl = (H // M if heads else H), 0, Hkv
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
    return Layout(M, rank, heads, kv, ffn, vocab, experts, expert_ffn, shared_ffn,
                  _mixer_split(cfg, M), kv_start, local,
                  {s.name: s.kind for s in plan.segments}, specs)


# ---------------------------------------------------------------------------
# slicing
# ---------------------------------------------------------------------------

def _take(t, dim: int, ranges) -> torch.Tensor:
    """``t``'s ``(start, length)`` ranges along ``dim``, concatenated (a
    view where there is one)."""
    parts = [t.narrow(dim, a, n) for a, n in ranges]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def _mamba_ranges(cfg: ModelConfig, lay: Layout) -> Dict[str, Tuple[int, list]]:
    """Mamba2's leaves by components: the rank's heads of z, x, dt and the
    per-head vectors, the whole of B and C (one group: every head reads
    them); the norm and ``out_proj`` by the rank's inner channels."""
    s, M, r = cfg.ssm, lay.model, lay.rank
    d_inner = s.expand * cfg.d_model
    hl = d_inner // s.head_dim // M
    c0, dl = r * hl * s.head_dim, hl * s.head_dim
    n = s.state_dim
    heads = [(r * hl, hl)]
    return {"in_proj": (-1, [(c0, dl), (d_inner + c0, dl), (2 * d_inner, 2 * n),
                             (2 * (d_inner + n) + r * hl, hl)]),
            "conv_w": (-1, [(c0, dl), (d_inner, 2 * n)]),
            "a_log": (-1, heads), "dt_bias": (-1, heads), "d_skip": (-1, heads),
            "norm": (-1, [(c0, dl)]), "out_proj": (-2, [(c0, dl)])}


def _mlstm_ranges(cfg: ModelConfig, lay: Layout) -> Dict[str, Tuple[int, list]]:
    """mLSTM by heads: ``up``'s xi half whole (the conv feeds q and k from
    every channel, so ``conv_w`` is whole too) and its z half's channels of
    the rank's heads; ``wq`` / ``wk`` / ``wv`` by heads, ``w_if``'s i and f
    columns and ``f_bias`` by heads; the norm and ``down`` by channels."""
    d_in = int(cfg.d_model * cfg.xlstm.proj_factor)
    H, M, r = cfg.num_heads, lay.model, lay.rank
    hl = H // M
    c0, dl = r * d_in // M, d_in // M
    heads = [(r * hl, hl)]
    return {"up": (-1, [(0, d_in), (d_in + c0, dl)]), "wq": (-2, heads), "wk": (-2, heads),
            "wv": (-2, heads), "w_if": (-1, [(r * hl, hl), (H + r * hl, hl)]),
            "f_bias": (-1, heads), "norm": (-1, [(c0, dl)]), "down": (-2, [(c0, dl)])}


def slice_leaf(cfg: ModelConfig, lay: Layout, path: tuple, t) -> torch.Tensor:
    """The rank's part of the leaf at ``path`` (its keys from the root), a
    stacked ``[count, ...]`` leaf or one layer of it: the recurrent mixers'
    leaves by :func:`_mamba_ranges` / :func:`_mlstm_ranges` where they
    split (else whole; the sLSTM always whole), the MoE router whole,
    ``wk`` / ``wv`` of a split attention whose kv heads the spec leaves
    whole the kv heads the rank reads, every other leaf by its spec's
    ``model`` entry."""
    name = path[-1]
    if "mixer" in path:
        kind = lay.kinds[path[1]]
        if not lay.mixer or kind == "slstm":
            return t
        ranges = (_mamba_ranges(cfg, lay) if kind == "mamba"
                  else _mlstm_ranges(cfg, lay)).get(name)
        return t if ranges is None else _take(t, *ranges)
    if name == "router":
        return t
    if name in ("wk", "wv") and lay.heads and not lay.kv:
        return t.narrow(-2, lay.kv_start, lay.local_cfg.num_kv_heads)
    spec = lay.specs
    for k in path:
        spec = spec[k]
    d = shr.model_dim(spec)
    if d is None:
        return t
    d -= len(spec)                            # from the end: a stacked leaf or one layer
    size = t.shape[d] // lay.model
    return t.narrow(d, lay.rank * size, size)


def local_params(cfg: ModelConfig, params: PyTree, lay: Layout) -> PyTree:
    """The rank's slice of a full single-replica tree (:func:`slice_leaf`
    of every leaf; views where a leaf is one range)."""
    def walk(p, path):
        if isinstance(p, dict):
            return {k: walk(v, path + (k,)) for k, v in p.items()}
        return slice_leaf(cfg, lay, path, p)
    return walk(params, ())


# ---------------------------------------------------------------------------
# the rank's part
# ---------------------------------------------------------------------------

class Part:
    """The rank's part of a tensor-parallel program, as the model code reads
    it (``tp=`` of ``transformer.prefill`` / ``decode_step``): the local
    config attention reads, the layout's split groups, and the group's
    collectives."""

    def __init__(self, cfg: ModelConfig, lay: Layout, group):
        self.cfg, self.lay, self.group = cfg, lay, group
        self.rank, self.model = lay.rank, lay.model
        self.attn_cfg = lay.local_cfg

    # ------------------------------------------------------- collectives
    def all_reduce(self, t):
        return self.group.all_reduce_sum(t)

    def all_gather(self, t):
        return self.group.all_gather(t, dim=-1)

    def sum(self, y, group: str):
        """``y`` summed over the ranks where ``group`` (a :class:`Layout`
        flag) is split; else ``y`` (the whole product, on every rank)."""
        return self.all_reduce(y) if getattr(self.lay, group) else y

    def combine(self, parts: List[Tuple[torch.Tensor, bool]]):
        """The sum of ``(y, split)`` parts: a partial product where split,
        else the whole product on every rank. One all-reduce where any part
        is split, the whole parts then added on rank 0 only."""
        split = any(s for _, s in parts)
        own = [y for y, s in parts if s or not split or self.rank == 0]
        total = own[0]
        for y in own[1:]:
            total = total + y
        return self.all_reduce(total) if split else total

    def rmsnorm(self, w, x, eps: float):
        """RMS norm of rows split over the ranks (``x`` and ``w`` the rank's
        channels): the sum of squares summed by one all-reduce."""
        xf = upcast(x)
        ss = self.all_reduce(torch.sum(xf * xf, dim=-1, keepdim=True))
        y = xf * torch.rsqrt(ss / (x.shape[-1] * self.model) + eps)
        return (y * upcast(w)).to(x.dtype)

    # ------------------------------------------------ embedding and head
    def embed(self, params, tokens):
        """tokens [B, S] (audio [B, K, S]) -> [B, S, d]: a masked lookup in
        the rank's vocab slice, the codebooks summed, then summed over the
        ranks."""
        cfg = self.cfg
        if not self.lay.vocab:
            return tr.embed_tokens(params, cfg, tokens)
        emb = params["embed"]
        V = emb.shape[1]

        def lookup(e, t):
            t = t.long() - self.rank * V
            inside = (t >= 0) & (t < V)
            return e[t.clamp(0, V - 1)] * inside[..., None].to(e.dtype)

        if cfg.audio is not None:
            x = sum(lookup(emb[k], tokens[:, k]) for k in range(cfg.audio.num_codebooks))
        else:
            x = lookup(emb[0], tokens)
        return self.all_reduce(x)

    def logits(self, params, x):
        """The last position's logits [B, V] (audio [B, K, V]), gathered over
        the vocab."""
        cfg = self.cfg
        if not self.lay.vocab:
            return tr._last_logits(params, cfg, x)
        if cfg.audio is not None:
            heads = params["embed"].transpose(1, 2) if cfg.tie_embeddings else params["lm_head"]
            logits = torch.einsum("bd,kdv->bkv", x[:, -1], heads.to(x.dtype))
        else:
            head = params["embed"][0].t() if cfg.tie_embeddings else params["lm_head"][0]
            logits = x[:, -1] @ head.to(x.dtype)
        logits = self.all_gather(logits)
        if cfg.final_logit_softcap:
            logits = softcap(upcast(logits), cfg.final_logit_softcap).to(logits.dtype)
        return logits


def tp_program(cfg: ModelConfig, mesh_cfg: MeshConfig, group, *, batch: int, max_len: int,
               window: int, param_dtype, cache_dtype, with_prefill: bool, device):
    """The :class:`~repro_torch.serving.engine.ServeProgram` surface over
    the group's ranks (called by ``make_serve_program``)."""
    if group is None or group.world != mesh_cfg.model:
        raise ValueError(f"model={mesh_cfg.model} serves over a ModelGroup of as many "
                         "ranks (repro_torch.launch.mesh.spawn_model_group)")
    lay = make_layout(cfg, mesh_cfg, group.rank)
    part = Part(cfg, lay, group)

    @torch.no_grad()
    def decode(params, cache, tokens, cond=None):
        return tr.decode_step(params, cfg, cache, tokens, cond, window=window, tp=part)

    @torch.no_grad()
    def decode_slots(params, cache, tokens, cond, kv_start):
        return tr.decode_step(params, cfg, cache, tokens, cond, window=window,
                              kv_start=kv_start, tp=part)

    prefill_fn = None
    if with_prefill:
        @torch.no_grad()
        def prefill_fn(params, tokens, cond=None):
            return tr.prefill(params, cfg, tokens, cond, cache_dtype=cache_dtype,
                              max_len=max_len, tp=part)

    return TPServeProgram(cfg, decode, prefill_fn, batch, max_len, window,
                          decode_slots_fn=decode_slots, param_dtype=param_dtype,
                          cache_dtype=cache_dtype, device=device, group=group, layout=lay,
                          part=part)


@dataclasses.dataclass
class TPServeProgram(ServeProgram):
    """A :class:`~repro_torch.serving.engine.ServeProgram` of one rank of a
    tensor-parallel group: ``place_params`` slices, ``init_params`` draws
    only the rank's slice, ``init_cache`` holds the rank's heads."""
    group: Any = None
    layout: Optional[Layout] = None
    part: Optional[Part] = None

    def place_params(self, params: PyTree) -> PyTree:
        """The rank's slice of a full single-replica tree on the serving
        device in the serving dtype, each leaf a new contiguous tensor (the
        full tree is not kept: the caller may free it)."""
        return tree_map(lambda t: t.to(device=self.device, dtype=self.param_dtype,
                                       copy=True).contiguous(),
                        local_params(self.model_cfg, params, self.layout))

    def init_params(self, gen: torch.Generator) -> PyTree:
        """``init_lm(gen)``'s slice of this rank, drawn in the serving dtype
        on ``gen``'s device keeping only the slice of each leaf as it is
        drawn (no whole tree is built), on the serving device."""
        cfg, lay = self.model_cfg, self.layout
        tree = tr.init_lm(gen, cfg, self.param_dtype,
                          keep=lambda path, t: slice_leaf(cfg, lay, path, t))[0]
        return tree_map(lambda t: t.to(device=self.device), tree)

    def init_cache(self) -> PyTree:
        cache, _ = tr.init_cache(self.model_cfg, self.batch, self.max_len,
                                 dtype=self.cache_dtype, window=self.window,
                                 device=self.device, tp=self.part)
        return cache

    def collectives_by_kind(self) -> Dict[str, Dict[str, int]]:
        """The collectives a prefill or a decode step makes, by block kind
        summed over its layers (``cross_blk`` the vision model's cross
        blocks, ``shared`` Zamba2's shared sites), ``embed`` and
        ``logits``: one all-reduce for each split partial sum (attention,
        cross-attention, a dense FFN, an MoE layer, a Mamba2 or mLSTM
        mixer's output and its norm; none in the sLSTM), one all-reduce for
        a split embedding and one all-gather for a split head."""
        lay, plan = self.layout, tr.make_plan(self.model_cfg)
        h, f, x = int(lay.heads), int(lay.ffn), int(lay.mixer)
        per_layer = {"attn": (h + f, 0), "attn_moe": (h + int(lay.moe), 0),
                     "attn_cross": (2 * h + f, 0), "mamba": (2 * x, 0), "mlstm": (2 * x, 0),
                     "slstm": (0, 0), "cross_blk": (h + f, 0), "shared": (h + f, 0)}
        out: Dict[str, Dict[str, int]] = {}

        def add(kind, n=1):
            ar, ag = per_layer[kind]
            c = out.setdefault(kind, {"all_reduce": 0, "all_gather": 0})
            c["all_reduce"] += n * ar
            c["all_gather"] += n * ag

        for ev, arg in plan.events:
            if ev == "seg":
                seg = tr._segment(plan, arg)
                add("attn_moe" if seg.use_moe else seg.kind, seg.count)
            else:
                add("cross_blk" if ev == "cross" else "shared")
        out["embed"] = {"all_reduce": int(lay.vocab), "all_gather": 0}
        out["logits"] = {"all_reduce": 0, "all_gather": int(lay.vocab)}
        return out

    def collectives_per_decode_step(self) -> Dict[str, int]:
        """The exact count a decode step makes (and a prefill: the same)."""
        by = self.collectives_by_kind().values()
        return {k: sum(c[k] for c in by) for k in ("all_reduce", "all_gather")}
