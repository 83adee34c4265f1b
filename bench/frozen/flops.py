"""Closed-form model FLOPs of one training step, from a configuration's
widths: the benchmark's own count, frozen here (no program code is read).

- Matmuls: 6 x the matmul parameters a token uses x the tokens (2 in the
  forward, 4 in the backward): every projection and the output head; not the
  embedding lookup (a gather); in an MoE layer the router, the token's
  ``top_k`` routed experts and the shared experts, whatever the capacity
  rule drops.
- Attention: the score and value products over the causal pairs,
  ``S (S + 1) / 2`` a sequence and head, forward and backward (3x).

Norms, activations, softmax, rotary embedding and remat's recompute are not
counted. ``pairs=`` exists so the count can be held against
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference, which
multiplies every pair (``pairs(S) = S * S``).
"""
from __future__ import annotations

from typing import Callable


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def full_pairs(s: int) -> int:
    return s * s


def matmul_flops(params_per_token: int, tokens: int) -> int:
    return 6 * params_per_token * tokens


def attention_flops(seqs: int, seq: int, heads: int, d_qk: int, d_v: int,
                    pairs: Callable[[int], int] = causal_pairs) -> int:
    return 3 * 2 * seqs * heads * pairs(seq) * (d_qk + d_v)

