"""Program builders and input specs for the dry-run (port of
``repro.launch.specs``).

``input_specs(arch, shape)`` returns ``meta`` tensors (shapes and dtypes,
no allocation) for every input of the (arch, shape) step, with the
reference's tree, shapes and dtypes: the global arrays, as the
reference's ``ShapeDtypeStruct`` s. ``build_programs`` returns what one
device runs: :class:`Program` (name, fn, args), its args on ``meta``, for
:mod:`repro_torch.launch.dryrun` to count
(:mod:`repro_torch.analysis.opcount`) and plan.

- ``train`` / ``train_gossip``: one gossip worker's step, rank 0 of a
  :class:`~repro_torch.analysis.opcount.CountingWorkerGroup`
  (``DistTrainer._train_step`` / ``_train_gossip_step``): its
  ``grad_accum`` microbatches, the loss, the backward, the update (B2, or
  the exchange and B1: the gossip program takes the firing branch, every
  worker active) and the fleet-mean loss's all-reduce.
- ``prefill`` / ``decode``: rank 0 of a tensor-parallel group of
  ``mesh.model`` ranks (:mod:`repro_torch.serving.tensor_parallel` over a
  :class:`~repro_torch.analysis.opcount.CountingModelGroup`), its slice of
  the parameters drawn leaf by leaf on the ``meta`` generator and its
  cache with the plan's decode window.

Where the port's deliberate differences from the reference (ROADMAP.md §C)
make a per-device quantity differ from the reference's:

- one process per gossip worker: the worker's state row and batch are
  whole on its device, where the reference shards them over the worker's
  ``fsdp`` x ``model`` devices (and replicates the plane over them), so a
  train program's per-device counts are a whole worker's;
- the serving group keeps the batch it is given: a group serves one
  data-parallel group's share, ``global_batch / (pods x data)`` (the whole
  batch where that does not divide, as GSPMD replicates it), where the
  reference splits the batch over the data axes inside one program;
- the kv cache is split by kv heads only (a rank keeps every row of its kv
  heads; the reference splits by sequence where the kv heads do not
  divide);
- the MLA latent cache and the MoE router are whole on every rank;
- the sLSTM is whole on every rank.

The MoE models' local dispatch: the reference routes a serving program's
tokens in ``pods x data`` shards (:func:`cfg_for_mesh`), one a device; a
serving group's program here routes its share in one shard, which is that
device's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.analysis.opcount import CountingModelGroup, CountingWorkerGroup, tensor_bytes
from repro_torch.common.config import (MeshConfig, ModelConfig, OptimizerConfig,
                                       ProtocolConfig, TrainConfig)
from repro_torch.common.hardware import H100_SXM
from repro_torch.common.pytree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.launch import plans as plans_mod
from repro_torch.models import transformer as tr
from repro_torch.train.step import DistTrainer

PyTree = Any

PARAM_DTYPE = torch.bfloat16
META = torch.device("meta")


def cfg_for_mesh(cfg: ModelConfig, mesh_cfg: MeshConfig, *, kind: str,
                 tokens_per_program: int) -> ModelConfig:
    """Mesh-dependent config tweaks (the reference's): the MoE
    local-dispatch shard count = the number of token shards the batch
    splits into (train: 1, global dispatch inside a worker; serving: all
    data axes), clamped to divide the program's tokens."""
    if cfg.moe is None:
        return cfg
    if kind == "train":
        shards, axes = 1, ("fsdp",)
    else:
        shards = mesh_cfg.pods * mesh_cfg.workers_per_pod * mesh_cfg.fsdp
        axes = ("pod", "worker", "fsdp")
    ds = math.gcd(tokens_per_program, shards)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch_shards=ds, dispatch_axes=axes))


def default_train_config() -> TrainConfig:
    return TrainConfig(
        protocol=ProtocolConfig(method="elastic_gossip", comm_probability=1 / 32,
                                moving_rate=0.5),
        optimizer=OptimizerConfig(name="nag", learning_rate=1e-3, momentum=0.9))


def make_trainer(mesh_cfg: MeshConfig, cfg: ModelConfig, grad_accum: int,
                 train_cfg: Optional[TrainConfig] = None) -> DistTrainer:
    """Rank 0's :class:`DistTrainer` of the LM loss over a counting group
    (no process)."""
    return DistTrainer(CountingWorkerGroup(mesh_cfg), mesh_cfg,
                       train_cfg or default_train_config(), model_cfg=cfg,
                       grad_accum=grad_accum)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _tokens(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    if cfg.audio is not None:
        return _meta((batch, cfg.audio.num_codebooks, seq), torch.int32)
    return _meta((batch, seq), torch.int32)


def _cond(cfg: ModelConfig, batch: int) -> Optional[torch.Tensor]:
    if cfg.audio is not None:
        return _meta((batch, cfg.audio.num_cond_tokens, cfg.d_model), torch.bfloat16)
    if cfg.vlm is not None:
        return _meta((batch, cfg.vlm.num_image_tokens, cfg.vlm.image_embed_dim),
                     torch.bfloat16)
    return None


def _max_len(plan) -> int:
    s = plan.shape
    return min(s.seq_len, plan.decode_window) if plan.decode_window else s.seq_len


def input_specs(arch: str, shape_name: str, *, multi_pod: bool = False) -> Dict[str, PyTree]:
    """``meta`` tensors for every input of the (arch, shape) step program,
    global shapes, as the reference's ``ShapeDtypeStruct`` s."""
    plan = plans_mod.make_plan(arch, shape_name)
    mesh_cfg = plans_mod.mesh_config(plan, multi_pod=multi_pod)
    cfg = get_config(arch)
    shape = plan.shape
    if shape.kind == "train":
        trainer = make_trainer(mesh_cfg, cfg, plan.grad_accum)
        trainer.set_shape(shape.global_batch, shape.seq_len)
        return {
            "state": trainer.state_shapes(tr.abstract_lm(cfg, PARAM_DTYPE)[0]),
            "batch": trainer.batch_shapes(shape.global_batch, shape.seq_len),
            "active": _meta((mesh_cfg.num_workers,), torch.float32),
            "round_idx": _meta((), torch.int32),
        }
    batch = shape.global_batch
    out = {"params": tr.abstract_lm(cfg, PARAM_DTYPE)[0]}
    if shape.kind == "decode":
        out["cache"] = tr.abstract_cache(cfg, batch, _max_len(plan), dtype=torch.bfloat16,
                                         window=plan.decode_window)[0]
        out["tokens"] = _tokens(cfg, batch, 1)
    else:
        out["tokens"] = _tokens(cfg, batch, shape.seq_len)
    out["cond"] = _cond(cfg, batch)
    return out


@dataclasses.dataclass
class Program:
    name: str                    # "train", "train_gossip", "decode" or "prefill"
    fn: Callable
    args: tuple                  # in call order; tensors on meta (PARAM_DTYPE params)
    argument_bytes: int = 0      # the device's parameters + its state or cache + inputs
    temp_bytes: int = 0          # the device's transient (the port's plans)
    refusal: Optional[str] = None  # the port's planner's refusal at the H100's capacity
    serve: Any = None            # a serving program's ServeProgram (its group, layout)


def _bytes(tree) -> int:
    return sum(tensor_bytes(t) for t in tree_leaves(tree))


def _row(state):
    """Rank 0's row of a fleet's ``[W, total]`` state (views)."""
    def row(bufs):
        return None if bufs is None else {k: b[:1] for k, b in bufs.items()}
    return state.replace(spec=state.spec.with_lead((1,)), theta=row(state.theta),
                         opt=state.opt._replace(mu=row(state.opt.mu)),
                         comm=type(state.comm)(row(state.comm.residual)))


def train_programs(cfg: ModelConfig, mesh_cfg: MeshConfig, *, global_batch: int, seq: int,
                   grad_accum: int = 1, gossip_variant: bool = True) -> list:
    """Rank 0's ``train`` (and ``train_gossip``) programs on ``meta``, with
    their memory plan (:func:`repro_torch.launch.train.step_memory`, in the
    parameters' bf16) and its refusal at the H100's 80 GB."""
    from repro_torch.launch import train as train_mod
    trainer = make_trainer(mesh_cfg, cfg, grad_accum)
    trainer.set_shape(global_batch, seq)
    state = _row(trainer.state_shapes(tr.abstract_lm(cfg, PARAM_DTYPE)[0]))
    batch = {k: b[0] for k, b in trainer.batch_shapes(global_batch, seq).items()}
    x = ({"tokens": batch["tokens"], "cond": batch["cond"]} if "cond" in batch
         else batch["tokens"])
    y = batch["labels"]
    tokens = global_batch // mesh_cfg.num_workers // grad_accum * seq
    argument = _bytes((state.theta, state.opt.mu, state.center, state.comm.residual, x, y))
    refusal = None
    try:
        need = train_mod.step_memory(cfg, 1, tokens, seq, None, dtype=PARAM_DTYPE,
                                     avail=H100_SXM.hbm_capacity)
    except ValueError as e:
        need, refusal = train_mod.step_bytes(cfg, 1, tokens, seq, dtype=PARAM_DTYPE), str(e)
    # the two resident planes are arguments; the rest is the step's transient
    temp = need - 2 * _bytes(state.theta)
    kw = dict(argument_bytes=argument, temp_bytes=temp, refusal=refusal)
    progs = [Program("train", trainer._train_step, (state, x, y, 0.0), **kw)]
    if gossip_variant:
        active = np.ones(mesh_cfg.num_workers, np.float32)   # the firing branch
        progs.append(Program("train_gossip", trainer._train_gossip_step,
                             (state, x, y, active, 0), **kw))
    return progs


def _rank_cfg(cfg: ModelConfig, prog) -> ModelConfig:
    """The sizes one rank computes at, for the transient estimate: its heads
    and kv heads (the layout's local config) and its ffn slice."""
    lay = getattr(prog, "layout", None)
    if lay is None:
        return cfg
    return dataclasses.replace(lay.local_cfg,
                               d_ff=cfg.d_ff // lay.model if lay.ffn else cfg.d_ff)


def serve_program(cfg: ModelConfig, kind: str, *, batch: int, seq: int, max_len: int,
                  window: int = 0, mesh_cfg: Optional[MeshConfig] = None) -> Program:
    """One device's ``prefill`` (of ``seq`` tokens) or ``decode`` program on
    ``meta``, bf16: on one device, or rank 0 of ``mesh_cfg.model`` ranks;
    with its memory plan (the parameters and the cache as arguments; the
    prefill's temporaries of :func:`repro_torch.launch.serve_decode.
    prefill_transient_bytes`, the last position's f32 logits and the
    conditioning as the transient) and a refusal where that exceeds the
    H100's 80 GB."""
    from repro_torch.launch import serve_decode as sd
    from repro_torch.serving.engine import make_serve_program
    M = 1 if mesh_cfg is None else mesh_cfg.model
    group = CountingModelGroup(mesh_cfg) if M > 1 else None
    prog = make_serve_program(cfg, batch=batch, max_len=max_len, window=window,
                              param_dtype=PARAM_DTYPE, cache_dtype=PARAM_DTYPE,
                              with_prefill=kind == "prefill", device=META,
                              mesh_cfg=mesh_cfg if M > 1 else None, group=group)
    params = prog.init_params(tr.meta_generator())
    cond = _cond(cfg, batch)
    if kind == "decode":
        cache = prog.init_cache()
        args = (params, cache, _tokens(cfg, batch, 1), cond)
        fn, tokens, s = prog.decode_fn, batch, 1
    else:
        args = (params, _tokens(cfg, batch, seq), cond)
        fn, tokens, s = prog.prefill_fn, batch * seq, seq
    heads = cfg.audio.num_codebooks if cfg.audio is not None else 1
    logits = batch * heads * cfg.vocab_size * 4
    temp = sd.prefill_transient_bytes(_rank_cfg(cfg, prog), tokens, 2, s) + logits
    argument = _bytes(args)
    cap = H100_SXM.hbm_capacity
    refusal = None
    if argument + temp > cap:
        gib = 2.0 ** 30
        refusal = (f"serving {cfg.name} ({kind}, batch {batch}, {max_len} cache rows"
                   + (f", rank 0 of {M}" if M > 1 else "") + f") needs ~"
                   f"{(argument + temp) / gib:.1f} GiB (parameters, cache and inputs "
                   f"{argument / gib:.1f} + transient {temp / gib:.1f}) but the card holds "
                   f"{cap / gib:.1f} GiB")
    return Program(kind, fn, args, argument_bytes=argument, temp_bytes=temp, refusal=refusal,
                   serve=prog)


def _serving_batch(global_batch: int, mesh_cfg: MeshConfig) -> int:
    """The batch one data-parallel group serves: ``global_batch / (pods x
    data)``, or the whole batch where that does not divide."""
    groups = mesh_cfg.pods * mesh_cfg.data
    return global_batch // groups if global_batch % groups == 0 else global_batch


def build_programs(arch: str, shape_name: str, *, multi_pod: bool = False,
                   gossip_variant: bool = True) -> list:
    """Every program of one (arch x shape x mesh) cell, one device's."""
    plan = plans_mod.make_plan(arch, shape_name)
    mesh_cfg = plans_mod.mesh_config(plan, multi_pod=multi_pod)
    cfg = get_config(arch)
    shape = plan.shape
    if shape.kind == "train":
        return train_programs(cfg, mesh_cfg, global_batch=shape.global_batch,
                              seq=shape.seq_len, grad_accum=plan.grad_accum,
                              gossip_variant=gossip_variant)
    batch = _serving_batch(shape.global_batch, mesh_cfg)
    seq = shape.seq_len if shape.kind == "prefill" else 1
    # one dispatch shard: the group's share of the reference's pods x data
    cfg = cfg_for_mesh(cfg, MeshConfig(data=1, model=mesh_cfg.model, pods=1,
                                       workers_per_pod=1),
                       kind=shape.kind, tokens_per_program=batch * seq)
    return [serve_program(cfg, shape.kind, batch=batch, seq=shape.seq_len,
                          max_len=_max_len(plan), window=plan.decode_window,
                          mesh_cfg=mesh_cfg)]
