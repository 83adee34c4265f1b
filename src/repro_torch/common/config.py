"""Configuration dataclasses read by the port's sim path.

Copies of ``ProtocolConfig`` and ``OptimizerConfig`` from the reference
(``repro.common.config``) with the same fields and defaults, so one set of
knobs configures both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


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
    # robust mixing knobs (clipped_gossip / trimmed_gossip, not ported yet)
    robust_clip: float = 0.1
    robust_trim: float = 6.0
    stale_adapt: float = 0.0


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
