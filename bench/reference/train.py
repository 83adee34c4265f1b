"""The reference training steps: Elastic Gossip (paper Alg. 5) with NAG on
W replicas, plain f32 PyTorch, following the program's first steps on the
same weights, batches and draws.

A step, for every worker w at once: the gradient g_w of its loss on its own
batch; the elastic pull ``theta_comm = M theta`` with ``M = I - alpha (D -
A)``, A the symmetric selection graph of the fired workers and their
peers; then ``v_w <- mu v_w - lr g_w`` and ``theta_w <- theta_comm_w - lr
g_w + mu v_w``.

``tf32=True`` computes the same in TF32 (the control); ``fault=`` plants
one of the faults the check has to catch: ``"half_batch"`` (the loss over
the first half of each batch's rows), ``"no_exchange"`` (M = I)."""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch


def flat_leaves(tree: dict, prefix: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """{"a/b/c": leaf} of a nested dict, in sorted key order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat_leaves(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def mixing_matrix(gate: torch.Tensor, peers: torch.Tensor, alpha: float) -> torch.Tensor:
    W = gate.shape[0]
    sel = torch.zeros(W, W, dtype=torch.float64)
    for i in range(W):
        if bool(gate[i]) and int(peers[i]) != i:
            sel[i, int(peers[i])] = 1.0
    adj = torch.maximum(sel, sel.T)
    return torch.eye(W, dtype=torch.float64) - alpha * (torch.diag(adj.sum(1)) - adj)


@contextlib.contextmanager
def precision(tf32: bool):
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, c.allow_tf32)
    m.allow_tf32 = c.allow_tf32 = tf32
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved


def _grad(model, c, leaves: Dict[str, torch.Tensor], tokens, labels, fault):
    """(loss, {path: gradient}) of one worker's batch."""
    if fault == "half_batch":
        tokens, labels = tokens[: tokens.shape[0] // 2], labels[: labels.shape[0] // 2]
    ps = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
    loss = model.loss(nest(ps), tokens, labels, c)
    gs = torch.autograd.grad(loss, list(ps.values()))
    return float(loss.detach()), dict(zip(ps, gs))


def run(model, c: dict, theta0: dict, batches: List[tuple], draws: List[tuple], *,
        lr: float, momentum: float, alpha: float, tf32: bool = False, fault=None) -> dict:
    """Follow ``len(batches)`` steps from ``theta0`` (one replica, shared by
    every worker). ``batches[i] = (tokens, labels)`` of [W, B, S];
    ``draws[i] = (gate bool[W], peers long[W])``. Returns the losses
    (``[step][w]``), the first step's gradient norms and, after the last
    step, the norms of each worker's change from ``theta0``, by leaf."""
    base = flat_leaves(theta0)
    W = batches[0][0].shape[0]
    theta = [{k: v.clone() for k, v in base.items()} for _ in range(W)]
    vel = [{k: torch.zeros_like(v) for k, v in base.items()} for _ in range(W)]
    losses, grad1 = [], None
    with precision(tf32):
        for (tokens, labels), (gate, peers) in zip(batches, draws):
            out = [_grad(model, c, theta[w], tokens[w], labels[w], fault) for w in range(W)]
            losses.append([o[0] for o in out])
            if grad1 is None:
                grad1 = [{k: float(torch.linalg.vector_norm(g)) for k, g in o[1].items()}
                         for o in out]
            mix = (torch.eye(W, dtype=torch.float64) if fault == "no_exchange"
                   else mixing_matrix(gate.cpu(), peers.cpu(), alpha))
            for k in base:
                old = torch.stack([theta[w][k] for w in range(W)])
                comm = torch.einsum("wv,v...->w...", mix.to(old.dtype).to(old.device), old)
                for w in range(W):
                    g = out[w][1][k]
                    vel[w][k] = momentum * vel[w][k] - lr * g
                    theta[w][k] = comm[w] - lr * g + momentum * vel[w][k]
                del old, comm
            del out
    change = [{k: float(torch.linalg.vector_norm(theta[w][k] - base[k])) for k in base}
              for w in range(W)]
    return {"losses": losses, "grad1": grad1, "change": change}
