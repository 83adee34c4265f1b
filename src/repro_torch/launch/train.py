"""End-to-end training CLI, built on ``repro_torch.api`` (port of
``repro.launch.train``, the reference's training CLI).

The CLI is protocol- and engine-agnostic: it builds a
:class:`repro_torch.api.GossipTrainer` for any engine (``--engine
{sim,dist,async}``) over the transformer LM's loss
(:func:`repro_torch.models.transformer.lm_loss`) and calls ONE method a
step, ``trainer.step(state, batch)``, over the flat-resident
:class:`repro_torch.api.FlatState`. Scheduling, communication-byte
accounting and checkpoint/schedule persistence live inside the facade;
protocol, codec, fault, flow-control and time-model names come from the
port's registries.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \\
        --reduced --steps 50 --engine sim --workers 4 --p 0.25 --device cpu

    # TinyLlama-1.1B at full width (22 layers, d 2048, f32) on one card
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \\
        --engine sim --workers 2 --p 0.5 --global-batch 8 --seq 256 --steps 10

    # every arch trains: MoE / MLA, SSM / hybrid, audio / vision alike
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_v2_lite_16b \\
        --reduced --steps 30 --engine sim --workers 4 --p 0.5 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2_2_7b \\
        --reduced --steps 30 --engine sim --workers 4 --p 0.5 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen_large \\
        --reduced --steps 30 --engine sim --workers 4 --p 0.5 --device cpu

    # heterogeneous fleet: a 4x straggler under virtual-time async gossip
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \\
        --reduced --steps 50 --engine async --time-model slow_node \\
        --slow-factor 4 --workers 4 --p 0.25

    # the dist engine: one process per worker (gloo), all on one card
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \\
        --reduced --steps 20 --engine dist --workers 4 --p 0.5

The device defaults to ``cuda`` (kernels B1/B2 for the update, B4-B8 on
the wire); ``--device cpu`` runs their plain versions. Attention in the
training step is the reference's differentiable online softmax, not kernel
B9, which is forward-only (``repro_torch.kernels.ops.attention``).

Differences from the reference's CLI: the dist engine is one process
per worker on this host (``launch.mesh.spawn_workers``; ``--shard S``
gives each rank's mesh fsdp = S) and needs at least 2 workers.
``--production-mesh`` takes the reference's ``MeshConfig(data=16,
model=16, pods=2 if --multi-pod else 1, workers_per_pod=--workers)``:
the reference replicates the resident plane over its ``fsdp`` and
``model`` devices, so each worker is still one process (``--shard N``
must then equal fsdp x model, as in the reference), and
``validate_fleet_memory`` refuses a fleet that does not fit the card;
``--multi-pod`` without ``--production-mesh``, which the reference
ignores, is refused. The model rematerialises as ``cfg.remat`` says (the
reference's default, True: each layer recomputed in the backward; no flag
sets it, as in the reference), and the CLI prints which estimate of the
activations it used.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api import GossipTrainer, available_protocols
from repro_torch.api.trainer import ENGINES
from repro_torch.comm import available_codecs
from repro_torch.common.config import (FaultConfig, FleetConfig, HeteroConfig,
                                       MeshConfig, ModelConfig, ObsConfig, OptimizerConfig,
                                       ProtocolConfig, ShardConfig)
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.consensus import divergence_metrics
from repro_torch.faults import available_delay_models, available_fault_models
from repro_torch.fleet import available_flow_controls
from repro_torch.hetero import available_time_models
from repro_torch.kernels import ops
from repro_torch.models import transformer as tr
from repro_torch.train.losses import lm_loss_fn


def lm_batches(cfg: ModelConfig, num_workers: int, per_worker: int, seq: int, seed: int = 0,
               device=None):
    """Worker-partitioned synthetic token stream (each worker gets a disjoint
    slice, the paper's data-parallel partitioning): the reference's stream,
    token for token. Yields ``{"tokens", "labels"}`` int32 ``[W, pw, seq]``
    tensors on ``device``; for audio they are repeated over the K codebooks
    (``[W, pw, K, seq]``) and ``cond`` is f32 zeros ``[W, pw,
    num_cond_tokens, d_model]``, for vision f32 zeros ``[W, pw,
    num_image_tokens, image_embed_dim]`` (the reference's stubbed
    conditioning)."""
    from repro_torch.data.synthetic import make_lm_tokens
    stream = make_lm_tokens(num_workers * 4_000_000 // max(1, num_workers // 8),
                            cfg.vocab_size, seed)
    shard_len = len(stream) // num_workers
    step = 0
    while True:
        xs = []
        for w in range(num_workers):
            base = w * shard_len + (step * per_worker * (seq + 1)) % (
                shard_len - per_worker * (seq + 1))
            xs.append(stream[base: base + per_worker * (seq + 1)].reshape(per_worker, seq + 1))
        arr = torch.from_numpy(np.stack(xs))
        batch = {"tokens": arr[..., :-1].to(device), "labels": arr[..., 1:].to(device)}
        cond = None
        if cfg.audio is not None:
            K = cfg.audio.num_codebooks
            batch = {k: v[:, :, None].expand(-1, -1, K, -1).contiguous()
                     for k, v in batch.items()}
            cond = (cfg.audio.num_cond_tokens, cfg.d_model)
        elif cfg.vlm is not None:
            cond = (cfg.vlm.num_image_tokens, cfg.vlm.image_embed_dim)
        if cond is not None:
            batch["cond"] = torch.zeros((num_workers, per_worker) + cond, dtype=torch.float32,
                                        device=device)
        yield batch
        step += 1


def engine_batch(batch):
    """An ``lm_batches`` batch as the engines' ``(x, y)``: x the tokens, or
    ``{"tokens", "cond"}`` where the batch carries the conditioning."""
    if "cond" in batch:
        return {"tokens": batch["tokens"], "cond": batch["cond"]}, batch["labels"]
    return batch["tokens"], batch["labels"]


def replica_bytes(cfg: ModelConfig, dtype=torch.float32) -> int:
    """Bytes of one replica, from ``abstract_lm`` (nothing allocated)."""
    abstract, _ = tr.abstract_lm(cfg, dtype)
    return sum(x.numel() * x.element_size() for x in tree_leaves(abstract))


def _attention_width(cfg: ModelConfig, keys: int) -> int:
    """Per token and layer, what autograd keeps of the attention: three
    score rows of the online softmax's key chunks (scores, masked scores,
    probabilities) for each query head, and the heads: GQA's K / V and
    their RoPE halves (4 Hkv hd); MLA's query [H, nope + rope], its absorbed
    queries [H, r + rope] twice (concatenated, scaled), the latent keys
    [r + rope] twice (concatenated, upcast) and its outputs [H, r] and
    [H, v_head_dim]."""
    if cfg.mla is None:
        heads = 4 * cfg.num_kv_heads * cfg.resolved_head_dim
    else:
        m = cfg.mla
        width = m.kv_lora_rank + m.qk_rope_head_dim
        heads = (cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim + 2 * width
                                  + m.kv_lora_rank + m.v_head_dim) + 2 * width)
    return heads + 3 * cfg.num_heads * keys


def _moe_width(cfg: ModelConfig) -> float:
    """Per token, what autograd keeps of an MoE FFN: the router's three
    [E] rows (logits, probabilities, sorted), and per routed slot (top_k x
    capacity_factor of them a token at capacity) the [E, C, d] buffer
    twice (built, regrouped for the experts' bmm), the experts' hidden
    four times (gate, up, activation, product) and their output; the
    top_k gathered rows twice (gathered, weighted) and the shared experts'
    five hidden rows."""
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert or cfg.d_ff
    slots = m.top_k * m.capacity_factor
    return (3 * m.num_experts + slots * (3 * d + 4 * f) + 2 * m.top_k * d
            + 5 * m.num_shared_experts * f)


def _padded(n: int, chunk: int) -> int:
    """The keys an online softmax visits over ``n`` keys: whole chunks of
    min(chunk, n)."""
    c = min(chunk, n)
    return -(-n // c) * c


def _ffn_width(cfg: ModelConfig) -> int:
    """Per token, what autograd keeps of a dense FFN: five FFN-width rows
    for a gated one (swiglu, geglu), three for a plain one (gelu)."""
    return (5 if cfg.activation in ("swiglu", "geglu") else 3) * cfg.d_ff


def _cross_width(cfg: ModelConfig, kv_dim: int, seq: int, keys) -> float:
    """Per token, what autograd keeps of a cross-attention: three score
    rows over ``keys(T)`` of the conditioning's T keys for each query
    head, the queries and outputs [H, hd] and four model-width rows; per
    sequence the keys and values [T, Hkv, hd] and the conditioning
    [T, kv_dim], spread over its ``seq`` tokens."""
    T = cfg.audio.num_cond_tokens if cfg.audio is not None else cfg.vlm.num_image_tokens
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    per_seq = T * (2 * Hkv * hd + kv_dim)
    return 3 * H * keys(T) + 2 * H * hd + 4 * cfg.d_model + per_seq / seq


def _recurrent_width(kind: str, cfg: ModelConfig, seq: int) -> float:
    """Per token, what autograd keeps of a recurrent block. ``mamba``: the
    in-projection's outputs, the causal conv (its padded input, the sum
    and the silu), q and k repeated over the heads and their decayed
    copies [H, N] each, six inner-width rows, the chunked GLA's f32
    temporaries (the scores, the masked exponent, its exp and the masked
    product, [H, Q] each, Q = min(chunk_size, seq)) and per chunk three
    [H, N, hd] states. ``mlstm``: eighteen inner-width rows and the same
    GLA core at its H heads, Q = min(256, seq), states [H, dh, dh + 1].
    ``slstm``: twenty-six inner-width rows (the four gate pre-activations
    and the {c, n, h, m} state kept at every step of the loop, and what
    each step's gates keep)."""
    d = cfg.d_model
    if kind == "mamba":
        s = cfg.ssm
        d_inner = s.expand * d
        H, N = d_inner // s.head_dim, s.state_dim
        gs = s.ngroups * N
        Q = min(s.chunk_size, seq)
        proj = 2 * d_inner + 2 * gs + H
        conv = 3 * (d_inner + 2 * gs)
        return proj + conv + 4 * H * N + 6 * d_inner + 4 * H * Q + 3 * H * N * s.head_dim / Q
    d_in = int(d * cfg.xlstm.proj_factor)
    if kind == "slstm":
        return 26 * d_in
    H = cfg.num_heads
    dh = d_in // H
    Q = min(256, seq)
    return 18 * d_in + 4 * H * Q + 3 * H * dh * (dh + 1) / Q


def _block_widths(cfg: ModelConfig, seq: int, keys) -> list:
    """[(kind, count, per-token width)] of the plan's blocks (``tr.make_plan``),
    each width in elements of what autograd keeps of one such block with
    no rematerialisation; ``keys(n)`` is the count of score columns the
    attention keeps over ``n`` keys. An attention layer (and a hybrid's
    shared site): per token about ten model-width vectors (norms,
    projections, residuals, RoPE halves), the attention
    (:func:`_attention_width`), and the FFN (:func:`_ffn_width`;
    :func:`_moe_width` for an MoE one); an ``attn_cross`` layer adds its
    cross-attention (:func:`_cross_width`), and a vision model's cross block
    is a cross-attention and a dense FFN. A recurrent layer:
    :func:`_recurrent_width`."""
    plan = tr.make_plan(cfg)
    shared = 10 * cfg.d_model + _attention_width(cfg, keys(seq))
    out = []
    for seg in plan.segments:
        if seg.kind in ("attn", "attn_cross"):
            width = shared + (_moe_width(cfg) if seg.use_moe else _ffn_width(cfg))
            if seg.kind == "attn_cross":
                width += _cross_width(cfg, cfg.d_model, seq, keys)
        else:
            width = _recurrent_width(seg.kind, cfg, seq)
        out.append((seg.kind, seg.count, width))
    if plan.num_shared_sites:
        out.append(("attn", plan.num_shared_sites, shared + _ffn_width(cfg)))
    if plan.num_cross:
        out.append(("cross_blk", plan.num_cross,
                    _cross_width(cfg, cfg.vlm.image_embed_dim, seq, keys)
                    + _ffn_width(cfg) + 6 * cfg.d_model))
    return out


def _carry_bytes(kind: str, cfg: ModelConfig, seq: int, chunk: int) -> float:
    """Per token, the f32 carries (m, l, acc) the online softmax keeps per
    key chunk for a block's recompute: (2 + dv) a query head and chunk, over
    the sequence's keys (self-attention) and the conditioning's
    (cross-attention)."""
    def carries(n, dv):
        return -(-n // min(chunk, n)) * cfg.num_heads * (2 + dv) * 4

    dv = cfg.mla.kv_lora_rank if cfg.mla is not None else cfg.resolved_head_dim
    out = 0.0
    if kind in ("attn", "attn_cross"):
        out += carries(seq, dv)
    if kind in ("attn_cross", "cross_blk"):
        T = cfg.audio.num_cond_tokens if cfg.audio is not None else cfg.vlm.num_image_tokens
        out += carries(T, cfg.resolved_head_dim)
    return out


def activation_bytes(cfg: ModelConfig, tokens: int, seq: int, dtype_bytes: int = 4,
                     chunk: int = 1024) -> int:
    """The port's estimate of the activations autograd keeps for one
    training step over ``tokens`` tokens of sequences of ``seq`` (every
    worker's), as ``cfg.remat`` says.

    Without rematerialisation, every block's width (:func:`_block_widths`,
    the attention's scores over all its keys) summed over the plan. Fitted
    at the published widths to 1.1-1.3 times what autograd kept there before
    the key chunks were checkpointed; at the reduced configs it stays above
    it.

    With ``cfg.remat`` (the default): every block's input, d a token; the
    conditioning once (the audio and vision models); the costliest single
    block's internals, its attention at one key chunk's scores, and its
    chunk carries (:func:`_carry_bytes`), which its recompute holds in the
    backward.

    Either way, per token three vocabulary-width rows of the loss's f32
    logits a head (K heads for audio): the chunked cross-entropy is not
    rematerialised, in the reference either."""
    heads = cfg.audio.num_codebooks if cfg.audio is not None else 1
    loss = 3 * heads * cfg.vocab_size * 4
    if not cfg.remat:
        widths = _block_widths(cfg, seq, lambda n: _padded(n, chunk))
        per_token = sum(count * width for _, count, width in widths) * dtype_bytes
        return int(tokens * (per_token + loss))
    widths = _block_widths(cfg, seq, lambda n: min(chunk, n))
    inputs = sum(count for _, count, _ in widths) * cfg.d_model * dtype_bytes
    costliest = max(width * dtype_bytes + _carry_bytes(kind, cfg, seq, chunk)
                    for kind, _, width in widths)
    cond = 0.0
    if cfg.audio is not None:
        cond = cfg.audio.num_cond_tokens * cfg.d_model * dtype_bytes / seq
    elif cfg.vlm is not None:
        cond = cfg.vlm.num_image_tokens * cfg.vlm.image_embed_dim * dtype_bytes / seq
    return int(tokens * (inputs + cond + costliest + loss))


# the backward's working set beside what autograd keeps (the gradients
# flowing back through the layers, a layer's parameter gradients before
# they are stacked), as a share of activation_bytes: fitted to the peaks
# of TinyLlama-1.1B, DeepSeek-V2-Lite-16B at 2 layers, xLSTM-125M and
# Zamba2-2.7B at 6 layers on an H100 with no rematerialisation (PERF.md §6)
BACKWARD_SHARE = 0.75
# with cfg.remat the peak is the larger of two moments, in [W, N] planes:
# after the step, the CLI's consensus reading (theta and velocity beside
# divergence_metrics' copy of the plane, its difference from the mean and
# the mean), above the backward's end (theta, velocity, the gradients' leaf
# stack and their plane); and a block's recompute in the backward (theta,
# velocity and the gradients so far, beside activation_bytes). Fitted to
# the peaks of TinyLlama-1.1B at 256-4,096 tokens, DeepSeek-V2-Lite-16B at
# 2 layers, xLSTM-125M, Zamba2-2.7B at 18 and MusicGen-large at 15 on an
# H100 (PERF.md §6)
REMAT_END_PLANES, REMAT_RECOMPUTE_PLANES = 4.5, 3


def _step_parts(cfg: ModelConfig, workers: int, tokens: int, seq: int, dtype):
    """(planes, the rest) of :func:`step_bytes`, in bytes."""
    size = torch.empty((), dtype=dtype).element_size()
    act = activation_bytes(cfg, tokens, seq, dtype_bytes=size)
    plane = workers * replica_bytes(cfg, dtype)
    if not cfg.remat:
        return 4 * plane, int((1 + BACKWARD_SHARE) * act)
    if REMAT_END_PLANES * plane >= REMAT_RECOMPUTE_PLANES * plane + act:
        return int(REMAT_END_PLANES * plane), 0
    return REMAT_RECOMPUTE_PLANES * plane, act


def step_bytes(cfg: ModelConfig, workers: int, tokens: int, seq: int,
               dtype=torch.float32) -> int:
    """The estimate of a device-plane training step's peak, in ``[W, N]``
    planes of ``dtype`` and the activations (:func:`activation_bytes`, in
    ``dtype``). Without rematerialisation: four planes (theta, velocity,
    the gradients' leaf stack and their plane), the activations and the
    backward's working set (``BACKWARD_SHARE`` of them). With ``cfg.remat``:
    the larger of ``REMAT_END_PLANES`` planes (the step's end and the CLI's
    reading after it) and ``REMAT_RECOMPUTE_PLANES`` planes beside the
    activations (a block's recompute)."""
    return sum(_step_parts(cfg, workers, tokens, seq, dtype))


def step_memory(cfg: ModelConfig, workers: int, tokens: int, seq: int, device,
                dtype=torch.float32, avail: Optional[int] = None) -> int:
    """What a device-plane training step holds at its peak
    (:func:`step_bytes`), checked before anything is allocated. Raises
    ValueError when that exceeds the free memory (``avail`` bytes when
    given, else the card's; the host's on the CPU); returns it in bytes."""
    from repro_torch.fleet import memory
    planes, rest = _step_parts(cfg, workers, tokens, seq, dtype)
    need = planes + rest
    if avail is None:
        avail = memory.available_bytes("device", device)
    if avail is not None and need > avail:
        gib = 2.0 ** 30
        n = planes / (workers * replica_bytes(cfg, dtype))
        how = "rematerialised" if cfg.remat else "no rematerialisation"
        raise ValueError(
            f"a training step of {cfg.name} at W={workers} over {tokens} tokens of {seq} needs "
            f"~{need / gib:.1f} GiB ({n:g} planes {planes / gib:.1f} + activations and the "
            f"backward {rest / gib:.1f}, {how}) but only {avail / gib:.1f} GiB is free; "
            "reduce --workers, --global-batch or --seq")
    return need


def _record(i, m, div) -> dict:
    rec = {"step": i, "loss": float(m["loss"]),
           "consensus_rel": float(div["consensus_rel"]),
           "fired": bool(m["fired"]),
           "comm_mb": round(float(m["comm_bytes"]) / 1e6, 3)}
    if "virtual_time" in m:
        rec["virtual_time"] = round(float(m["virtual_time"]), 3)
        rec["window_size"] = int(m["window_size"])
    return rec


def _train_loop(trainer, state, batches, as_batch, *, steps, log_every, checkpoint_dir,
                arch, group=None, on_step=None, echo=True):
    history = []
    for i in range(steps):
        state, m = trainer.step(state, as_batch(next(batches)))
        if on_step is not None:
            on_step(i, trainer, state, m)
        if i % log_every == 0 or i == steps - 1:
            # diagnostics read the resident flat plane directly
            div = divergence_metrics(state.theta, group=group)
            rec = _record(i, m, div)
            history.append(rec)
            if echo:
                print(json.dumps(rec), flush=True)
        if checkpoint_dir and (i + 1) % 50 == 0:
            trainer.save_checkpoint(f"{checkpoint_dir}/step_{i+1}.npz", state,
                                    meta={"arch": arch, "step": i + 1})
    return state, history


def _dist_rank(group, job):
    """One rank of a dist run (module level, so ``spawn`` can import it):
    the CLI's loop on the rank's row of the batches. Rank 0 prints the
    records. Returns the rank's history, kernel launches (counts set to 0
    just before the loop), sends / receives, comm_bytes, the wire per event
    and what rank 0 exported."""
    cfg = job["cfg"]
    W = group.world
    params = job["params"]
    if params is not None:
        params = tr.params_from_jax(params, group.device)
    trainer = GossipTrainer(
        engine="dist", protocol=job["proto"], optimizer=job["opt"], model_cfg=cfg,
        init_fn=lambda gen: tr.init_lm(gen, cfg)[0], device=group.device, group=group,
        mesh_cfg=group.mesh_cfg, seed=job["seed"], shard=job["shard"], obs=job["obs"])
    state = trainer.init_state(job["seed"], params=params)
    batches = lm_batches(cfg, W, job["global_batch"] // W, job["seq"], job["seed"])
    rank = group.rank

    def as_batch(b):
        return tree_map(lambda t: t[rank].to(group.device), engine_batch(b))

    ops.zero_launch_counts()
    sends0, recvs0 = group.sends, group.recvs
    state, history = _train_loop(trainer, state, batches, as_batch, steps=job["steps"],
                                 log_every=job["log_every"],
                                 checkpoint_dir=job["checkpoint_dir"], arch=job["arch"],
                                 group=group, echo=rank == 0)
    launches = ops.launch_counts()
    return {"rank": rank, "history": history, "launches": launches,
            "sends": group.sends - sends0, "recvs": group.recvs - recvs0,
            "comm_bytes": float(trainer._backend.comm_bytes),
            "wire": int(trainer._backend.wire),
            "exported": trainer.export_obs()}


def run(arch: str, *, reduced: bool, steps: int, method: str, p: float, tau: int,
        alpha: float, workers: int, global_batch: int, seq: int, lr: float,
        seed: int = 0, checkpoint_dir: str = "", log_every: int = 10,
        production_mesh: bool = False, multi_pod: bool = False,
        codec: str = "none", engine: str = "dist",
        time_model: str = "constant", mean_step_time: float = 1.0,
        sigma: float = 0.25, slow_worker: int = 0, slow_factor: float = 4.0,
        fault_model: str = "none", fault_rate: float = 0.0,
        fault_frac: float = 0.0, delay_model: str = "none",
        delay: float = 0.0, timeout: float = 0.0,
        partition: int = 1, flow_control: str = "none",
        plane: str = "device", token_capacity: float = 20.0,
        token_rate: float = 1.0, token_threshold: float = 10.0,
        shard: int = 1, trace: str = "", metrics: str = "",
        sample_every: int = 1, device="cuda", params=None,
        on_step: Optional[Callable] = None, layers: int = 0):
    """The reference's ``run`` with its parameters, plus ``device``
    ("cuda", or "cpu" for tests), ``params`` (single-replica initial
    parameters as numpy arrays, e.g. the reference's ``init_lm``, in place
    of ``init_lm`` from ``seed``), ``on_step(i, trainer, state, metrics)``
    (sim and async: called after every step) and ``layers`` (cut the depth
    to that many layers, widths uncut; 0 keeps it). Returns ``(state, history)``;
    on the dist engine the state stays in the ranks and ``state`` is the
    list of the ranks' summaries (:func:`_dist_rank`)."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    proto = ProtocolConfig(method=method, moving_rate=alpha,
                           comm_probability=p if not tau else 0.0,
                           comm_period=tau, codec=codec)
    opt = OptimizerConfig(name="nag", learning_rate=lr, momentum=0.9)
    # each plane is built only when something in it is enabled, so the
    # default path keeps the plain engines bit for bit
    faults = None
    if fault_model != "none" or delay_model != "none" or timeout > 0:
        faults = FaultConfig(fault_model=fault_model, fault_rate=fault_rate,
                             fault_frac=fault_frac, delay_model=delay_model,
                             delay=delay, timeout=timeout, seed=seed)
    fleet = None
    if partition != 1 or flow_control != "none" or plane != "device":
        fleet = FleetConfig(partition=partition, flow_control=flow_control,
                            plane=plane, token_capacity=token_capacity,
                            token_rate=token_rate,
                            token_threshold=token_threshold, seed=seed)
        if engine == "dist":
            raise ValueError(
                'engine="dist" does not take the fleet plane '
                "(--partition/--flow-control/--plane); use --engine sim or "
                "--engine async")
    shard_cfg = ShardConfig(n_shards=shard) if shard != 1 else None
    obs_cfg = None
    if trace or metrics:
        obs_cfg = ObsConfig(trace_path=trace, metrics_path=metrics,
                            sample_every=sample_every)
    tokens = global_batch * seq
    how = "every layer rematerialised" if cfg.remat else "no rematerialisation"
    print(f"activations (estimate, {how}): "
          f"{activation_bytes(cfg, tokens, seq) / 2**30:.2f} GiB for {tokens} tokens "
          f"of {cfg.name}", flush=True)

    t0 = time.time()
    if engine == "dist":
        if faults is not None:
            raise ValueError(
                'engine="dist" does not support fault injection; use '
                '--engine sim or --engine async for --fault-model/'
                '--delay-model runs')
        if multi_pod and not production_mesh:
            raise ValueError("--multi-pod shapes the production mesh; pass "
                             "--production-mesh with it")
        from repro_torch.fleet import validate_fleet_memory
        from repro_torch.launch.mesh import check_shard_mesh, spawn_workers
        if production_mesh:
            mesh_cfg = MeshConfig(data=16, model=16, pods=2 if multi_pod else 1,
                                  workers_per_pod=workers)
        else:
            mesh_cfg = MeshConfig(data=workers * shard, model=1, pods=1,
                                  workers_per_pod=workers)
        check_shard_mesh(mesh_cfg, shard_cfg)
        validate_fleet_memory(mesh_cfg.num_workers, replica_bytes(cfg), "device",
                              what=f"arch {arch!r}", n_shards=shard, device=device)
        job = dict(cfg=cfg, arch=arch, proto=proto, opt=opt, seed=seed, shard=shard_cfg,
                   obs=obs_cfg, params=params, global_batch=global_batch, seq=seq,
                   steps=steps, log_every=log_every, checkpoint_dir=checkpoint_dir)
        ranks = spawn_workers(_dist_rank, mesh_cfg, device, args=(job,),
                              join_timeout_s=3600.0)
        state, history, exported = ranks, ranks[0]["history"], ranks[0]["exported"]
    else:
        from repro_torch.fleet import validate_fleet_memory
        validate_fleet_memory(workers, replica_bytes(cfg), plane,
                              what=f"arch {arch!r}", n_shards=shard, device=device)
        if plane == "device":
            step_memory(cfg, workers, tokens, seq, device)
        hetero = HeteroConfig(time_model=time_model, mean_step_time=mean_step_time,
                              sigma=sigma, slow_worker=slow_worker,
                              slow_factor=slow_factor, seed=seed)
        trainer = GossipTrainer(
            engine=engine, protocol=proto, optimizer=opt, loss_fn=lm_loss_fn(cfg),
            num_workers=workers, init_fn=lambda gen: tr.init_lm(gen, cfg)[0], seed=seed,
            hetero=hetero if engine == "async" else None, faults=faults,
            fleet=fleet, shard=shard_cfg, obs=obs_cfg, device=device)
        if params is not None:
            params = tr.params_from_jax(params, trainer.device)
        state = trainer.init_state(seed, params=params)
        batches = lm_batches(cfg, workers, global_batch // workers, seq, seed,
                             device=trainer.device)
        state, history = _train_loop(
            trainer, state, batches, engine_batch, steps=steps,
            log_every=log_every, checkpoint_dir=checkpoint_dir, arch=arch,
            on_step=on_step)
        exported = trainer.export_obs()
    print(f"trained {steps} steps in {time.time()-t0:.1f}s; "
          f"final loss {history[-1]['loss']:.4f}")
    for kind, path in exported.items():
        print(f"wrote {kind} -> {path}")
    if "metrics" in exported:
        hint = f"python -m repro_torch.obs.report {exported['metrics']}"
        if "trace" in exported:
            hint += f" --trace {exported['trace']}"
        print(f"summarize: {hint}")
    elif "trace" in exported:
        print(f"view: load {exported['trace']} at https://ui.perfetto.dev")
    return state, history


def parser() -> argparse.ArgumentParser:
    """The reference's flags, names and defaults, with choices from the
    port's registries, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--method", default="elastic_gossip",
                    choices=available_protocols())
    ap.add_argument("--engine", default="dist", choices=tuple(sorted(ENGINES)),
                    help="training engine")
    ap.add_argument("--codec", default="none", choices=available_codecs(),
                    help="gossip-compression codec on the wire (repro_torch.comm)")
    ap.add_argument("--time-model", default="constant",
                    choices=available_time_models(),
                    help="compute-time model for --engine async (repro_torch.hetero)")
    ap.add_argument("--mean-step-time", type=float, default=1.0)
    ap.add_argument("--sigma", type=float, default=0.25,
                    help="lognormal straggler log-space std")
    ap.add_argument("--slow-worker", type=int, default=0)
    ap.add_argument("--slow-factor", type=float, default=4.0)
    ap.add_argument("--fault-model", default="none",
                    choices=available_fault_models(),
                    help="message-level fault model on the gossip wire")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="per-(worker,step) drop/corrupt probability")
    ap.add_argument("--fault-frac", type=float, default=0.0,
                    help="fraction of Byzantine workers (byzantine_* models)")
    ap.add_argument("--delay-model", default="none",
                    choices=available_delay_models(),
                    help="network-delay model for --engine async")
    ap.add_argument("--delay", type=float, default=0.0,
                    help="delay-model scale (mean / constant, virtual time)")
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="per-exchange timeout before skip-and-retry (0 = wait forever)")
    ap.add_argument("--partition", type=int, default=1,
                    help="split each exchange into 1/P of the flat plane")
    ap.add_argument("--flow-control", default="none",
                    choices=available_flow_controls(),
                    help="token-account initiation throttling")
    ap.add_argument("--plane", default="device", choices=["device", "host"],
                    help='FlatState residency: "host" keeps the [W, total] plane in '
                         "host memory (async engine only)")
    ap.add_argument("--shard", type=int, default=1,
                    help="split the flat plane into N shards (repro_torch.shard); "
                         "engine='dist' gives each rank's mesh fsdp = N")
    ap.add_argument("--trace", default="",
                    help="write a Perfetto/Chrome-trace JSON timeline here")
    ap.add_argument("--metrics", default="",
                    help="stream per-step metrics JSONL here (summarize with "
                         "python -m repro_torch.obs.report)")
    ap.add_argument("--sample-every", type=int, default=1,
                    help="record trace events / metrics rows every k-th step")
    ap.add_argument("--token-capacity", type=float, default=20.0)
    ap.add_argument("--token-rate", type=float, default=1.0)
    ap.add_argument("--token-threshold", type=float, default=10.0,
                    help="randomized_token_account aggressiveness threshold")
    ap.add_argument("--p", type=float, default=0.25)
    ap.add_argument("--tau", type=int, default=0)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the kernels) or "cpu" (their plain versions)')
    return ap


def main(argv=None) -> None:
    a = parser().parse_args(argv)
    run(a.arch, reduced=a.reduced, steps=a.steps, method=a.method, p=a.p, tau=a.tau,
        alpha=a.alpha, workers=a.workers, global_batch=a.global_batch, seq=a.seq,
        lr=a.lr, checkpoint_dir=a.checkpoint_dir,
        production_mesh=a.production_mesh, multi_pod=a.multi_pod, codec=a.codec,
        engine=a.engine, time_model=a.time_model,
        mean_step_time=a.mean_step_time, sigma=a.sigma,
        slow_worker=a.slow_worker, slow_factor=a.slow_factor,
        fault_model=a.fault_model, fault_rate=a.fault_rate,
        fault_frac=a.fault_frac, delay_model=a.delay_model,
        delay=a.delay, timeout=a.timeout,
        partition=a.partition, flow_control=a.flow_control, plane=a.plane,
        token_capacity=a.token_capacity, token_rate=a.token_rate,
        token_threshold=a.token_threshold, shard=a.shard,
        trace=a.trace, metrics=a.metrics, sample_every=a.sample_every,
        device=a.device)


if __name__ == "__main__":
    main()
