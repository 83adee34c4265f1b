"""Configuration dataclasses read by the port's engines.

Copies of ``MeshConfig``, ``ProtocolConfig``, ``OptimizerConfig``,
``HeteroConfig``, ``FaultConfig``, ``FleetConfig``, ``ShardConfig``,
``ObsConfig``, the fields of ``TrainConfig`` that the dist engine reads,
and ``ModelConfig`` with the dataclasses it references (the transformer
architectures of :mod:`repro_torch.configs`), from the reference
(``repro.common.config``) with the same fields and defaults, so one set of
knobs configures both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The reference's production mesh: ``pods`` x ``data`` x ``model``
    chips, the data axis factored into (worker, fsdp). The dist engine runs
    one process per gossip worker (``pods * workers_per_pod``); ``model``
    must be 1 there and ``fsdp`` the sharded plane's ``n_shards`` (see
    :mod:`repro_torch.launch.mesh`)."""
    data: int = 16
    model: int = 16
    pods: int = 1
    workers_per_pod: int = 4       # gossip replicas per pod; fsdp = data // workers_per_pod

    @property
    def fsdp(self) -> int:
        assert self.data % self.workers_per_pod == 0, (self.data, self.workers_per_pod)
        return self.data // self.workers_per_pod

    @property
    def num_workers(self) -> int:
        return self.pods * self.workers_per_pod

    @property
    def num_chips(self) -> int:
        return self.pods * self.data * self.model


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    """The paper's knobs (Alg. 1-6)."""
    method: str = "elastic_gossip"   # elastic_gossip | gossiping_pull | gossiping_push
    #                                 | allreduce | easgd | none
    moving_rate: float = 0.5         # alpha (EG, EASGD)
    comm_probability: float = 0.0    # p  (Bernoulli participation, Alg. 5 / GoSGD)
    comm_period: int = 0             # tau (deterministic period, Alg. 2/3/4/6)
    topology: str = "matching"       # matching | uniform
    # beyond-paper: anneal the moving rate from moving_rate to
    # moving_rate_final over alpha_decay_steps
    moving_rate_final: float = -1.0  # <0 -> constant alpha
    alpha_decay_steps: int = 0
    # gossip compression codec (repro_torch.comm registry): none | q8 | topk
    codec: str = "none"
    codec_block: int = 512
    codec_topk_frac: float = 0.05
    # robust mixing knobs (clipped_gossip / trimmed_gossip)
    robust_clip: float = 0.1         # clipped: max displacement / own row norm
    robust_trim: float = 6.0         # trimmed: coordinate cap in units of row RMS
    stale_adapt: float = 0.0         # staleness-adaptive alpha (async engine only)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "nag"                # sgd | nag  (paper uses NAG, Alg. 5)
    learning_rate: float = 1e-3
    momentum: float = 0.99
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 0.0
    schedule: str = "constant"       # constant | step | cosine
    warmup_steps: int = 0
    decay_steps: int = 0
    step_anneal_at: Tuple[int, ...] = ()
    step_anneal_factor: float = 0.5


@dataclasses.dataclass(frozen=True)
class HeteroConfig:
    """Heterogeneous-fleet virtual-time model (:mod:`repro_torch.hetero`,
    ``engine="async"``): a registered compute-time model and its knobs.
    Every duration draw hashes ``(seed, worker, step)``, so a run's virtual
    timeline is bit-reproducible across restarts."""
    time_model: str = "constant"     # constant | lognormal | slow_node
    #                                  | fail_rejoin | any @register_time_model
    mean_step_time: float = 1.0      # mean virtual seconds per local SGD step
    sigma: float = 0.25              # lognormal: log-space std (mean-preserving)
    slow_worker: int = 0             # slow_node / fail_rejoin: affected worker
    slow_factor: float = 4.0         # slow_node: straggler slowdown multiplier
    fail_at: float = 0.0             # fail_rejoin: outage start (virtual time)
    rejoin_at: float = 0.0           # fail_rejoin: outage end; <= fail_at -> off
    seed: int = 0                    # hash-seed for per-(worker, step) draws


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Message-level fault plane (:mod:`repro_torch.faults`).

    Selects a registered fault model (what goes wrong with a wire) and a
    registered delay model (when the wire arrives, async engine only). All
    stochastic draws are pure hashes of ``(seed, worker, step)``, so a fault
    trace is bit-reproducible and independent of any host RNG.
    """
    # fault model: none | drop | corrupt | byzantine_scale | byzantine_noise
    # | any @register_fault_model name
    fault_model: str = "none"
    fault_rate: float = 0.0          # drop/corrupt: per-(sender, step) probability
    fault_frac: float = 0.0          # byzantine_*: fraction of fleet that is
    #                                  Byzantine (first round(frac*W) workers)
    scale: float = 100.0             # byzantine_scale: garbage multiplier
    noise_std: float = 1.0           # byzantine_noise: garbage row std
    seed: int = 0                    # hash-seed for per-(worker, step) draws
    # delay model (async engine): none | constant | uniform | lognormal
    delay_model: str = "none"
    delay: float = 0.0               # mean wire latency (virtual seconds)
    delay_sigma: float = 0.25        # lognormal: log-space std
    rendezvous: bool = False         # apply at the partner's next step boundary
    timeout: float = 0.0             # per-exchange timeout (0 = never)
    max_retries: int = 0             # re-dispatches of a timed-out exchange


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Mega-fleet gossip plane (:mod:`repro_torch.fleet`): partitioned
    exchanges, token-account flow control, and the host-resident plane of
    the async engine.

    The chunk a worker ships and the randomized token-account draw are pure
    hashes of ``(seed, worker, step)``. The all-default config is inert:
    ``partition=1, flow_control="none", plane="device"`` adds no work and
    reproduces the non-fleet engines bit for bit.
    """
    # each exchange ships ONE contiguous chunk (1/partition of every dtype
    # bucket's [total] dim), chosen by hash; 1 = full-replica exchange
    partition: int = 1
    # none | token_account | randomized_token_account | any
    # @register_flow_control name: gates whether a worker INITIATES an
    # exchange; skipped initiations never reach comm_units/comm_bytes
    flow_control: str = "none"
    token_capacity: float = 20.0     # C: max token balance per worker
    token_rate: float = 1.0          # tokens credited per completed local step
    token_threshold: float = 10.0    # A: randomized_token_account initiates
    #                                  with probability min(1, balance / A)
    token_init: float = -1.0         # starting balance; < 0 -> token_capacity
    # async engine: "device" keeps the [W, total] planes on the card, "host"
    # keeps theta and velocity in pinned host memory and moves only the
    # event window's rows to the card
    plane: str = "device"
    seed: int = 0                    # hash-seed for per-(worker, step) draws

    def enabled(self) -> bool:
        """True if any fleet feature departs from the inert default."""
        return (self.partition != 1 or self.flow_control != "none"
                or self.plane != "device")


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Sharded flat plane (:mod:`repro_torch.shard`): each dtype bucket's
    ``total`` dim split into ``n_shards`` equal column shards, the replica
    dim as before.

    The sim and async engines realize the layout on one device: the codec
    encodes per shard row (seeds ``worker * n_shards + shard``) and
    ``comm_bytes`` counts the per-device wire. The dist engine holds each
    rank's padded row as ``n_shards`` shard rows and needs the mesh's
    ``fsdp`` (the ``axes``' product, ``model`` being 1) to equal
    ``n_shards``. The all-default config is inert: ``n_shards=1`` builds no
    layout and reproduces the un-sharded engines bit for bit.
    """
    # number of equal column shards of every dtype bucket; each bucket total
    # is padded up to a multiple of n_shards * quantum (quantum = the codec
    # block when a codec rides the wire, else the lane width), so shard
    # boundaries fall on codec-block boundaries
    n_shards: int = 1
    # mesh axes the plane dim shards over (dist engine), outermost first
    axes: Tuple[str, ...] = ("fsdp", "model")

    def enabled(self) -> bool:
        """True if the plane is actually sharded (inert at n_shards=1)."""
        return self.n_shards != 1


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Telemetry plane (:mod:`repro_torch.obs`): typed event tracing and a
    step-metrics registry over every engine, behind
    ``GossipTrainer(obs=...)``.

    Observation is host-side only: the observer reads the draws a step
    consumed and replays the ``(seed, worker, step)`` hashes, so a
    recording run's trajectory is bit-identical to a non-recording one. The
    all-default config is inert: no observer is built.
    """
    trace: bool = False              # record typed events (TraceRecorder)
    metrics: bool = False            # record per-step metrics (MetricsSink)
    trace_path: str = ""             # non-empty: export a Perfetto/Chrome
    #                                  trace JSON here (implies trace=True)
    metrics_path: str = ""           # non-empty: stream metrics JSONL here
    #                                  (implies metrics=True)
    sample_every: int = 1            # record every k-th facade step (trace
    #                                  step/exchange events + metrics rows);
    #                                  message-mode wire events always record
    max_events: int = 1_000_000      # trace ring bound; overflow counts into
    #                                  TraceRecorder.dropped instead of OOM

    def trace_enabled(self) -> bool:
        return self.trace or bool(self.trace_path)

    def metrics_enabled(self) -> bool:
        return self.metrics or bool(self.metrics_path)

    def enabled(self) -> bool:
        """True if anything records (the all-default config is inert)."""
        return self.trace_enabled() or self.metrics_enabled()


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of the reference's ``TrainConfig`` that the engines read,
    with its defaults. The run fields (steps, seed, dtypes, checkpoint and
    logging cadence, data skew) come with the launcher that reads them."""
    protocol: ProtocolConfig = ProtocolConfig(comm_probability=0.03125)
    optimizer: OptimizerConfig = OptimizerConfig()
    # fused flat-plane update (kernels B1/B2): pairwise protocols only
    fused_update: bool = True
    # gossip-compression codec override: "" inherits protocol.codec
    codec: str = ""


# ---------------------------------------------------------------------------
# Model (copied; pure dataclasses)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    num_shared_experts: int = 0
    d_ff_expert: int = 0           # per-expert hidden size (0 -> use model d_ff)
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01
    # which layers are MoE (deepseek keeps layer 0 dense)
    first_dense_layers: int = 0
    # local dispatch: tokens are routed independently within this many shards
    # (aligned with the batch sharding), each with capacity C/shards — keeps
    # the sort/scatter local to the data shards (MaxText-style). 1 = global.
    dispatch_shards: int = 1
    # mesh axes the dispatch-shard dim lives on (train steps vmap over the
    # worker dim, so only 'fsdp' remains available there; serving uses all
    # data axes) — set by launch.specs.cfg_for_mesh
    dispatch_axes: tuple = ("pod", "worker", "fsdp")


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0           # 0 -> full-rank q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block parameters."""
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_dim: int = 4
    chunk_size: int = 256
    ngroups: int = 1


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    # indices i with (i % slstm_every == slstm_offset) are sLSTM blocks
    slstm_every: int = 6
    slstm_offset: int = 5
    proj_factor: float = 2.0       # up-projection inside m/sLSTM blocks
    conv_dim: int = 4


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: Mamba2 backbone + shared (reused-weights) attention blocks."""
    shared_attn_every: int = 6     # insert a shared attn+mlp block every N ssm layers
    num_shared_blocks: int = 2     # distinct shared blocks, used alternately


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """Llama-3.2-Vision-style cross-attention decoder."""
    cross_attn_layers: Tuple[int, ...] = (3, 8, 13, 18, 23, 28, 33, 38)
    num_image_tokens: int = 1601   # stubbed patch embeddings per image
    image_embed_dim: int = 4096    # dim of the (stubbed) projected patch embeds


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """MusicGen-style decoder over EnCodec tokens."""
    num_codebooks: int = 4
    num_cond_tokens: int = 64      # stubbed conditioning frame embeddings


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # gemma2-style extras
    local_window: int = 0          # >0 -> alternating local/global attention
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    post_norms: bool = False       # gemma2 post-attn/post-ffn norms
    # activation: swiglu (llama) | gelu (gpt) | geglu (gemma) | relu
    activation: str = "swiglu"
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    hybrid: Optional[HybridConfig] = None
    vlm: Optional[VLMConfig] = None
    audio: Optional[AudioConfig] = None
    # serving: archs without sub-quadratic path use a bounded-window decode
    # variant for long_500k (DESIGN.md §4)
    sw_decode_window: int = 8192
    # rematerialize per-layer activations in the training forward (scan body)
    remat: bool = True
    source: str = ""               # citation bracket from the assignment

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs and sanity checks)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        total = V * d  # embed
        if not self.tie_embeddings:
            total += d * V
        if self.audio is not None:
            total += (self.audio.num_codebooks - 1) * V * d      # extra codebook embeds
            total += (self.audio.num_codebooks - 1) * d * V      # extra heads
        per_layer_attn = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
        if self.mla is not None:
            m = self.mla
            q_in = m.q_lora_rank or d
            per_layer_attn = (
                (d * m.q_lora_rank if m.q_lora_rank else 0)
                + q_in * n_q * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * n_q * (m.qk_nope_head_dim + m.v_head_dim)
                + n_q * m.v_head_dim * d
            )
        if self.activation in ("swiglu", "geglu"):
            per_layer_ffn = 3 * d * self.d_ff
        else:
            per_layer_ffn = 2 * d * self.d_ff
        n_attn_layers = L
        n_ffn_layers = L
        if self.arch_type == "ssm" and self.xlstm is not None:
            # xLSTM: no separate FFN; blocks have their own projections
            x = self.xlstm
            d_in = int(d * x.proj_factor)
            per_layer = 2 * d * d_in + 3 * d_in * d_in // 4 + d_in * d  # rough qkv/gates
            total += L * per_layer + L * 2 * d
            return total
        if self.arch_type in ("ssm", "hybrid") and self.ssm is not None:
            s = self.ssm
            d_inner = s.expand * d
            nheads = d_inner // s.head_dim
            per_ssm = (
                d * (2 * d_inner + 2 * s.ngroups * s.state_dim + nheads)  # in_proj
                + s.conv_dim * (d_inner + 2 * s.ngroups * s.state_dim)    # conv
                + nheads * 2                                               # A, D
                + d_inner * d                                              # out_proj
            )
            if self.arch_type == "ssm":
                total += L * (per_ssm + 2 * d)
                return total
            # hybrid: ssm layers + shared attn blocks (counted once)
            h = self.hybrid
            n_shared = h.num_shared_blocks if h else 0
            total += L * (per_ssm + 2 * d)
            total += n_shared * (per_layer_attn + per_layer_ffn + 2 * d)
            return total
        if self.moe is not None:
            m = self.moe
            dff_e = m.d_ff_expert or self.d_ff
            n_moe = L - m.first_dense_layers
            mult = 3 if self.activation in ("swiglu", "geglu") else 2
            per_moe = m.num_experts * mult * d * dff_e + m.num_shared_experts * mult * d * dff_e + d * m.num_experts
            total += m.first_dense_layers * per_layer_ffn + n_moe * per_moe
            total += n_attn_layers * per_layer_attn + L * 2 * d
            return total
        total += n_attn_layers * per_layer_attn + n_ffn_layers * per_layer_ffn + L * 2 * d
        if self.vlm is not None:
            total += len(self.vlm.cross_attn_layers) * (per_layer_attn + per_layer_ffn + 2 * d)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        dff_e = m.d_ff_expert or self.d_ff
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        n_moe = self.num_layers - m.first_dense_layers
        inactive = n_moe * (m.num_experts - m.top_k) * mult * self.d_model * dff_e
        return self.param_count() - inactive
