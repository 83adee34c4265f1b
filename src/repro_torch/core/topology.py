"""Peer selection and mixing matrices (port of ``repro.core.topology``).

The communication component of every protocol is a mixing matrix over the
worker axis, ``theta_new = M @ theta`` on the stacked ``[W, ...]`` plane:

- Elastic Gossip (Alg. 4): ``M = I - alpha * L(A)``, L the graph Laplacian
  of the symmetric selection graph. Symmetric and row-stochastic, so the sum
  over workers is conserved.
- Gossiping SGD pull (Alg. 3): row i = ``(e_i + e_{k'(i)})/2`` for active i.
- Gossiping SGD push (Alg. 6): row i = mean of ``{e_i} U {e_j : k'(j)=i}``.

Draws come from an explicit ``torch.Generator`` on the run's device; they
cannot reproduce ``jax.random``'s threefry bits, so parity tests inject the
reference's draws instead. The static matching schedules of the dist engine
(:func:`hypercube_schedule`, :func:`random_matching_schedule`) are numpy,
copied bit for bit.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def _eye(W: int, device) -> torch.Tensor:
    return torch.eye(W, dtype=torch.float32, device=device)


def _one_hot(peers: torch.Tensor, W: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(peers.long(), W).float()


# ---------------------------------------------------------------------------
# Peer sampling
# ---------------------------------------------------------------------------

def sample_uniform_peers(gen: torch.Generator, num_workers: int) -> torch.Tensor:
    """k'(i) ~ Uniform(W \\ {i}) for every worker (paper Alg. 4 line 5)."""
    draw = torch.randint(0, num_workers - 1, (num_workers,), generator=gen,
                         device=gen.device)
    idx = torch.arange(num_workers, device=gen.device)
    return torch.where(draw >= idx, draw + 1, draw)


def sample_matching(gen: torch.Generator, num_workers: int) -> torch.Tensor:
    """Uniform random perfect matching: partner[i] (odd W: one self-partner)."""
    perm = torch.randperm(num_workers, generator=gen, device=gen.device)
    partner_of_pos = torch.arange(num_workers, device=gen.device) ^ 1
    if num_workers % 2 == 1:
        partner_of_pos[num_workers - 1] = num_workers - 1
    partner = torch.empty_like(perm)
    partner[perm] = perm[partner_of_pos]
    return partner


def participation(gen: torch.Generator, num_workers: int, p: float) -> torch.Tensor:
    """Bernoulli(p) per worker (Alg. 5 line 4 / GoSGD): bool[W]."""
    return torch.rand(num_workers, generator=gen, device=gen.device) < p


# ---------------------------------------------------------------------------
# Mixing matrices ([W, W] f32)
# ---------------------------------------------------------------------------

def selection_graph(peers: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Symmetric 0/1 adjacency: A[i,k] = 1 iff (active_i and peers[i]==k) or
    (active_k and peers[k]==i); no self-loops."""
    W = peers.shape[0]
    sel = _one_hot(peers, W) * active[:, None].float()
    a = torch.maximum(sel, sel.T)
    return a * (1.0 - _eye(W, peers.device))


def elastic_gossip_mix(peers: torch.Tensor, active: torch.Tensor, alpha) -> torch.Tensor:
    """M = I - alpha * (D - A): Elastic Gossip, exact Alg. 4 incl. fan-in."""
    a = selection_graph(peers, active)
    lap = torch.diag(torch.sum(a, dim=1)) - a
    return _eye(peers.shape[0], peers.device) - alpha * lap


def gossip_pull_mix(peers: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Pull-Gossiping SGD (Alg. 3): theta_i <- (theta_i + theta_k')/2."""
    W = peers.shape[0]
    eye = _eye(W, peers.device)
    act = active.float()[:, None]
    return (1 - act) * eye + act * 0.5 * (eye + _one_hot(peers, W))


def gossip_push_mix(peers: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Push-Gossiping SGD (Alg. 6): theta_i <- mean({theta_i} U pushers)."""
    W = peers.shape[0]
    inbound = (_one_hot(peers, W) * active[:, None].float()).T
    counts = 1.0 + torch.sum(inbound, dim=1, keepdim=True)
    return (_eye(W, peers.device) + inbound) / counts


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).float()


def apply_mix(mix: torch.Tensor, theta_stack: dict) -> dict:
    """theta'[w] = sum_v mix[w,v] theta[v] per buffer (or leaf) of a stacked
    dict: one f32 matmul each, cast back to the storage dtype. Callers keep
    TF32 off on the card so this runs in full f32."""
    return {k: torch.matmul(mix, _rows(x)).reshape(x.shape).to(x.dtype)
            for k, x in theta_stack.items()}


def apply_mix_split(mix: torch.Tensor, theta_stack: dict, transmit_stack: dict) -> dict:
    """:func:`apply_mix` with lossy transmission: each worker's own (diagonal)
    contribution reads exact ``theta``, the received (off-diagonal) ones read
    ``transmit``:

        theta'[w] = mix[w,w] * theta[w] + sum_{v!=w} mix[w,v] * transmit[v]
    """
    d = torch.diagonal(mix)
    off = mix - torch.diag(d)
    out = {}
    for k, x in theta_stack.items():
        o = d[:, None] * _rows(x) + torch.matmul(off, _rows(transmit_stack[k]))
        out[k] = o.reshape(x.shape).to(x.dtype)
    return out


def discard_lost(mix: torch.Tensor, lost: torch.Tensor) -> torch.Tensor:
    """Remove lost senders from a mixing matrix: the weight a receiver gave a
    lost sender returns to its own diagonal, so rows still sum to 1."""
    eye = _eye(mix.shape[0], mix.device).to(mix.dtype)
    lost_f = lost.to(mix.dtype)
    off = mix * (1.0 - eye)
    returned = torch.sum(off * lost_f[None, :], dim=1)
    return mix * (1.0 - lost_f[None, :] * (1.0 - eye)) + torch.diag(returned)


# ---------------------------------------------------------------------------
# Static matching schedules: the dist engine (one send/recv per round)
# ---------------------------------------------------------------------------

def hypercube_schedule(num_workers: int) -> List[List[Tuple[int, int]]]:
    """log2(W) perfect matchings: round r pairs i <-> i XOR 2^r. Cycling
    through rounds gives full mixing in log2(W) gossip rounds."""
    assert num_workers & (num_workers - 1) == 0 and num_workers >= 2, num_workers
    rounds = []
    r = 0
    while (1 << r) < num_workers:
        rounds.append([(i, i ^ (1 << r)) for i in range(num_workers)])
        r += 1
    return rounds


def random_matching_schedule(num_workers: int, num_rounds: int,
                             seed: int = 0) -> List[List[Tuple[int, int]]]:
    """Precomputed random perfect matchings from numpy's ``RandomState``
    (odd W: the last worker of each permutation partners itself)."""
    rng = np.random.RandomState(seed)
    rounds = []
    for _ in range(num_rounds):
        perm = rng.permutation(num_workers)
        partner = np.empty(num_workers, np.int64)
        for j in range(0, num_workers - 1, 2):
            partner[perm[j]], partner[perm[j + 1]] = perm[j + 1], perm[j]
        if num_workers % 2 == 1:
            partner[perm[-1]] = perm[-1]
        rounds.append([(i, int(partner[i])) for i in range(num_workers)])
    return rounds


def matching_partner_array(pairs: List[Tuple[int, int]]) -> np.ndarray:
    partner = np.empty(len(pairs), np.int64)
    for i, k in pairs:
        partner[i] = k
    return partner
