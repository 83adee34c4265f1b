"""Serving engine: consensus parameters, prefill and batched single-token
decode (port of ``repro.serving.engine``).

Inference uses the consensus (worker-averaged) parameters: gossip is a
training-time protocol. With ``mesh_cfg.model = 1`` (the default) the
program serves on one device. With ``model = M > 1`` it is one rank of a
tensor-parallel group of M processes, the parameters and the KV cache
split over ``model`` by the reference's :func:`serve_rules`
(:mod:`repro_torch.serving.tensor_parallel`, every arch); the reference's
split of the batch over the data axes has no counterpart
(ROADMAP.md §C). Attention in prefill and decode is kernel B9
(:mod:`repro_torch.kernels.flash_attention`) on the card. Decode writes the
KV cache in place where the reference donates it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.common.config import MeshConfig, ModelConfig
from repro_torch.common.pytree import tree_map
from repro_torch.launch import sharding as shr
from repro_torch.models import transformer as tr

PyTree = Any


def serve_rules(cfg: ModelConfig, mesh_cfg: MeshConfig) -> dict:
    """The reference's serving rule table: the batch over the data axes,
    the KV cache by kv heads over ``model`` where they divide it, else by
    sequence (``seq_kv``)."""
    rules = dict(shr.DEFAULT_RULES)
    rules.update({"batch": ("pod", "worker", "fsdp"), "kv_heads": ("model",),
                  "seq_kv": ("model",)})
    if cfg.mla is None and cfg.num_kv_heads % mesh_cfg.model == 0:
        rules["seq_kv"] = ()    # prefer head sharding; keep 'model' free for it
    return rules


class ShapeDtype(NamedTuple):
    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass
class ServeProgram:
    model_cfg: ModelConfig
    decode_fn: Callable          # (params, cache, tokens[, cond]) -> (logits, cache)
    prefill_fn: Optional[Callable]
    batch: int
    max_len: int
    window: int
    # continuous-batching decode: (params, cache, tokens, cond, kv_start[B])
    # -> (logits, cache)
    decode_slots_fn: Optional[Callable] = None
    param_dtype: Any = torch.bfloat16
    cache_dtype: Any = torch.bfloat16
    device: Any = "cuda"

    # ----------------------------------------------------------- swap surface
    def place_params(self, params: PyTree) -> PyTree:
        """A single-replica parameter tree on the serving device, cast to the
        serving dtype (a leaf already there is returned as is, not copied)."""
        return tree_map(lambda x: x.to(device=self.device, dtype=self.param_dtype), params)

    def init_params(self, gen: torch.Generator) -> PyTree:
        """``init_lm(gen)`` drawn in the serving dtype on ``gen``'s device,
        on the serving device."""
        return self.place_params(tr.init_lm(gen, self.model_cfg, self.param_dtype)[0])

    def init_cache(self) -> PyTree:
        """Fresh zero KV cache (pos = 0), the continuous-batching harness's
        starting state."""
        cache, _ = tr.init_cache(self.model_cfg, self.batch, self.max_len,
                                 dtype=self.cache_dtype, window=self.window,
                                 device=self.device)
        return cache

    def token_shapes(self, seq: int = 1) -> ShapeDtype:
        """int32 ``[batch, seq]`` (audio: ``[batch, K, seq]``)."""
        cfg = self.model_cfg
        if cfg.audio is not None:
            return ShapeDtype((self.batch, cfg.audio.num_codebooks, seq), torch.int32)
        return ShapeDtype((self.batch, seq), torch.int32)

    def cond_shapes(self) -> Optional[ShapeDtype]:
        """The stubbed conditioning the audio and vision models read, bf16
        ``[batch, T, e]``; None for the others."""
        cfg = self.model_cfg
        if cfg.audio is not None:
            return ShapeDtype((self.batch, cfg.audio.num_cond_tokens, cfg.d_model),
                              torch.bfloat16)
        if cfg.vlm is not None:
            return ShapeDtype((self.batch, cfg.vlm.num_image_tokens, cfg.vlm.image_embed_dim),
                              torch.bfloat16)
        return None


def make_serve_program(cfg: ModelConfig, *, batch: int, max_len: int, window: int = 0,
                       param_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                       with_prefill: bool = False, device="cuda",
                       mesh_cfg: Optional[MeshConfig] = None, group=None) -> ServeProgram:
    """The serving program of ``cfg`` on one device (``cuda`` unless the
    caller asks for the CPU). ``window > 0`` decodes over a ring buffer of
    that many rows. The audio and vision models take their conditioning
    (:meth:`ServeProgram.cond_shapes`) in every prefill and decode call.

    With ``mesh_cfg.model = M > 1`` the program is the calling rank's of a
    tensor-parallel group (``group``, a
    :class:`~repro_torch.launch.mesh.ModelGroup` of M ranks): the same
    surface, every rank making the same calls and getting the whole
    logits."""
    tr.make_plan(cfg)
    M = 1 if mesh_cfg is None else mesh_cfg.model
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_serve_program: no CUDA device (pass device='cpu' "
                           "to run the plain versions on the CPU)")
    if M > 1:
        from repro_torch.serving import tensor_parallel
        return tensor_parallel.tp_program(
            cfg, mesh_cfg, group, batch=batch, max_len=max_len, window=window,
            param_dtype=param_dtype, cache_dtype=cache_dtype, with_prefill=with_prefill,
            device=device)

    @torch.no_grad()
    def decode(params, cache, tokens, cond=None):
        return tr.decode_step(params, cfg, cache, tokens, cond, window=window)

    @torch.no_grad()
    def decode_slots(params, cache, tokens, cond, kv_start):
        return tr.decode_step(params, cfg, cache, tokens, cond, window=window,
                              kv_start=kv_start)

    prefill_fn = None
    if with_prefill:
        @torch.no_grad()
        def prefill_fn(params, tokens, cond=None):
            return tr.prefill(params, cfg, tokens, cond, cache_dtype=cache_dtype,
                              max_len=max_len)

    return ServeProgram(cfg, decode, prefill_fn, batch, max_len, window,
                        decode_slots_fn=decode_slots, param_dtype=param_dtype,
                        cache_dtype=cache_dtype, device=device)


def consensus_bufs(theta) -> dict:
    """Mean over the ``W`` replica rows of ``{bucket: [W, total]}`` buffers:
    sum in f32, divided by W in place (one replica-sized temporary a
    bucket, not two), cast back to the storage dtype."""
    return {k: torch.sum(v.float(), dim=0).div_(v.shape[0]).to(v.dtype)
            for k, v in theta.items()}


def consensus_params(state) -> PyTree:
    """Worker-averaged parameters (paper 'Aggregate') of a
    :class:`repro_torch.api.FlatState`: the mean over the resident buffers,
    then one-replica views."""
    return state.spec.with_lead(()).unflatten(consensus_bufs(state.theta))
