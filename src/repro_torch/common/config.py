"""Configuration dataclasses read by the port's engines.

Copies of ``MeshConfig``, ``ProtocolConfig``, ``OptimizerConfig``,
``FaultConfig`` and the fields of ``TrainConfig`` that the dist engine reads,
from the reference (``repro.common.config``) with the same fields and
defaults, so one set of knobs configures both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The reference's production mesh: ``pods`` x ``data`` x ``model``
    chips, the data axis factored into (worker, fsdp). The dist engine runs
    one process per gossip worker (``pods * workers_per_pod``); ``fsdp`` and
    ``model`` must be 1 there (see :mod:`repro_torch.launch.mesh`)."""
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
class FaultConfig:
    """Message-level fault plane (:mod:`repro_torch.faults`).

    Selects a registered fault model (what goes wrong with a wire) and a
    registered delay model (when the wire arrives). All stochastic draws are
    pure hashes of ``(seed, worker, step)``, so a fault trace is
    bit-reproducible and independent of any host RNG. The delay, rendezvous,
    timeout and retry fields are read only by the async engine, which is not
    ported yet; they are kept so that one config drives both packages.
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
class TrainConfig:
    """The fields of the reference's ``TrainConfig`` that the dist engine
    reads (the steps, dtypes, checkpoint and logging fields come with the
    launcher)."""
    protocol: ProtocolConfig = ProtocolConfig(comm_probability=0.03125)
    optimizer: OptimizerConfig = OptimizerConfig()
    # fused flat-plane update (kernels B1/B2): pairwise protocols only
    fused_update: bool = True
    # gossip-compression codec override: "" inherits protocol.codec
    codec: str = ""
